"""qwen3-32b [dense] — qk_norm, GQA.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="pure full attention; long_500k skipped",
)
