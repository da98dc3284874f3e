"""Device resolution: the GPU unless the caller asks for the CPU.

There is no silent fallback: asking for ``cuda`` on a machine without a
usable GPU raises instead of quietly running the plain PyTorch path.
``meta`` is accepted when the caller names it: trees built there carry
shapes and dtypes only (the dry-run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import torch

# Full-float32 matmuls everywhere: TF32 would round the attention and
# lm_head products to ~3 decimal digits and break agreement with the
# reference.  Both flags are set explicitly rather than trusting defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (``cuda``, ``cpu`` or ``meta``);
    raises if a CUDA device is requested and no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
