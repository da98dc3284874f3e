"""whisper-tiny [audio] — enc-dec, conv frontend stubbed per assignment.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865  [arXiv:2212.04356; unverified]
The conv frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings (B, enc_seq, d_model); the transformer backbone is what we build.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,              # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    enc_seq=1500,            # 30 s of audio at 50 Hz post-conv
    frontend="audio",
    mlp_gated=False,         # whisper uses plain GELU MLPs
    tie_embeddings=True,
    rope_theta=10_000.0,     # backbone uses RoPE in our repro (orig: learned pos)
    notes="enc-dec; conv frontend stubbed (frame embeddings from input_specs)",
)
