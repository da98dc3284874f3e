"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400  [arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MHA (kv=16)
    d_ff=1408,                 # fine-grained expert hidden dim
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    notes=("first layer is dense-FFN in the release; all-MoE here (noted in "
           "DESIGN.md); long_500k skipped (full attention)"),
)
