"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144  [hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=10_240,
    vocab_size=262_144,
    window_pattern=("L", "L", "L", "L", "L", "G"),  # 5:1 local:global
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="5:1 local:global; runs long_500k (local layers sub-quadratic)",
)
