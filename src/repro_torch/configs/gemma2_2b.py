"""gemma2-2b [dense] — local/global alternating, logit softcap.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000  [arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256_000,
    window_pattern=("L", "G"),      # alternating local/global
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    notes="alternating local/global; softcaps; runs long_500k",
)
