"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32_001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    window_pattern=("L", "L", "L", "L", "L", "L", "L", "G"),  # mostly SWA + few global
    window_size=1024,
    notes=("parallel attn+SSM heads fused per layer; meta-tokens omitted "
           "(noted in DESIGN.md); runs long_500k"),
)
