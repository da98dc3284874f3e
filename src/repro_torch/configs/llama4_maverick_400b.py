"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,                 # also shared-expert hidden dim
    vocab_size=202_048,
    n_experts=128,
    n_shared_experts=1,
    moe_top_k=1,
    d_expert=8192,
    qk_norm=True,
    rope_theta=500_000.0,
    notes=("all layers MoE in this repro (HF interleaves dense/MoE); "
           "router kept fp; long_500k skipped (full attention)"),
)
