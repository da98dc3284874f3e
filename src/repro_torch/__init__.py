"""PyTorch + CUDA port of the T-SAR ternary serving stack.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and imports none of it.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``.

The only hand-written kernel so far is ``csrc/tsar_matmul.cu``, the Hopper
port of ``repro.kernels.tsar_matmul.tsar_matmul_packed``; it carries every
packed BitLinear projection of the serving step.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
