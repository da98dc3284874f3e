"""Architecture config registry: ``--arch <id>`` resolution."""
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

from repro_torch.configs import (  # noqa: F401
    bitnet_2b,
    deepseek_coder_33b,
    deepseek_moe_16b,
    gemma2_2b,
    gemma3_4b,
    hymba_1p5b,
    llama4_maverick_400b,
    llava_next_mistral_7b,
    mamba2_780m,
    qwen3_32b,
    whisper_tiny,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        whisper_tiny, gemma3_4b, deepseek_coder_33b, qwen3_32b, gemma2_2b,
        llama4_maverick_400b, deepseek_moe_16b, mamba2_780m, hymba_1p5b,
        llava_next_mistral_7b, bitnet_2b,
    )
}

# The ten assigned pool archs (bitnet-2b-4t is the paper's own, extra).
ASSIGNED = [n for n in ARCHS if n != "bitnet-2b-4t"]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """Yield every (arch, shape) cell, honoring the skip rules:
    long_500k only for sub-quadratic archs (decode is the lowered fn)."""
    for arch in ASSIGNED:
        cfg = ARCHS[arch]
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and not cfg.sub_quadratic
            if include_skipped or not skip:
                yield cfg, shape, skip
