"""llava-next-mistral-7b [vlm] — anyres tiling, vision tower stubbed.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
The vision tower is a STUB per assignment: ``input_specs()`` supplies
precomputed patch embeddings; the backbone projects + prepends them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    frontend="vision",
    frontend_seq=2880,       # anyres: base 576 + 4 tiles x 576
    frontend_dim=1024,       # CLIP-L patch embedding dim before projection
    rope_theta=1_000_000.0,
    notes="vision tower stubbed; long_500k skipped (full attention)",
)
