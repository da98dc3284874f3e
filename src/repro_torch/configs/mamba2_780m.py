"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
    notes=("attention-free; T-SAR applies to in/out projections, SSD "
           "recurrence stays fp (DESIGN.md §Arch-applicability); runs long_500k"),
)
