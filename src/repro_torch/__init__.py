"""PyTorch + CUDA port of the T-SAR ternary serving stack.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module and imports none of it.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``.

Two hand-written kernels carry the serving step's packed BitLinear
projections: ``csrc/tsar_matmul.cu`` (the Hopper port of
``repro.kernels.tsar_matmul.tsar_matmul_packed``) for 2-bit planes, and
``csrc/tsar_sparse.cu`` (port of
``repro.kernels.tsar_sparse.tsar_sparse_padded_matmul_packed``) for layers
the execution plan sends to their padded block-sparse pools.  The
layer-level path (``core.bitlinear.freeze`` / ``apply_frozen``) reaches
the other two: ``csrc/tsar_lut.cu`` (port of ``tsar_lut_gemv``) and the
compacted entry point of ``csrc/tsar_sparse.cu`` (port of
``tsar_sparse_matmul_packed``).

Training runs the reference's QAT recipe in plain PyTorch (``train/``,
``optim/``, ``data/``, ``checkpoint/``, ``runtime/``, ``launch/train.py``);
its trained weights are frozen and served through the same kernels.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
