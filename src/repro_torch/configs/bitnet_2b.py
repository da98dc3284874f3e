"""BitNet-b1.58-2B-4T — the paper's own evaluation model family (Sec. IV).

Shapes from the paper's kernel microbenchmarks (Fig. 10): K=2560, M=6912.
Not part of the assigned 10-arch pool; used by the paper-reproduction
benchmarks and examples.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bitnet-2b-4t",
    family="dense",
    n_layers=30,
    d_model=2560,
    n_heads=20,
    n_kv_heads=5,
    d_ff=6912,
    vocab_size=128_256,
    notes="paper's BitNet-b1.58-2B-4T; ternary by construction",
)
