"""Float64 attention core of the flat serving step: the hand-written Hopper
kernel.

Replaces no TPU kernel: the reference computes the flat branch of
``repro/models/layers.py::attention`` in plain JAX.  The plain version is
``repro_torch.models.layers._flat_context`` (the reference's layout: every
query against every slot's key rows under the segment mask), and
``layers.flat_context`` routes between the two.  The CUDA source is
``repro_torch/csrc/flat_attn.cu``; it is built with ``nvcc`` for ``sm_90a``
on first use and bound through ``ctypes``.

What bounds it: at a decode step the live key and value rows of each slot,
read once; on a prompt chunk the float64 FMAs.  One call is one launch: a
CTA per (run of one slot's rows, KV head) loads each K/V tile of its slot's
live prefix once, double-buffered, and the GQA group's query heads and the
run's rows share it.  Scores, the online softmax and the weighted sum are
float64 in a fixed order (no atomics, no split of a row's keys), rounded
once to the output's type: two calls on the same inputs give the same bits.

:func:`flat_attn_f64` launches the kernel on CUDA tensors and, on meta
tensors, returns the output's shape and records the call in
``kernels.tally``; any other device raises.  ``LAUNCHES`` counts the
launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import tally

# Launch counter; chip_smoke.py zeroes it before driving a path.
LAUNCHES = {"flat_attn": 0}

# Constants of the CUDA source (csrc/flat_attn.cu).
HEAD_DIMS = (32, 128, 256)       # compiled instances: served and reduced configs
MAX_GROUP = 32                   # kMaxQ: query heads per KV head at most
KV_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN = 16                      # bytes: cp.async copies 16-byte chunks

# C signature of flat_attn_f64_launch: 6 pointers (q, ck, cv, slot, pos,
# out), 9 ints (out_f64, t, h, hk, b, vtok, dh, kv_bf16, window), 2 doubles
# (softcap, sqrt(dh)), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 6), *([ctypes.c_int] * 9),
                          ctypes.c_double, ctypes.c_double, ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    return _PROTO(("flat_attn_f64_launch", _build.load("flat_attn")))


def _check(q, ck, cv, slot, pos, window: int) -> None:
    dev = q.device
    for name, t in (("ck", ck), ("cv", cv), ("slot", slot), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv), ("slot", slot), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if ck.dtype not in KV_DTYPES or cv.dtype != ck.dtype:
        raise TypeError(f"ck and cv must be one of {KV_DTYPES}, got {ck.dtype} and {cv.dtype}")
    for name, t in (("slot", slot), ("pos", pos)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if q.ndim != 4 or q.shape[0] != 1:
        raise ValueError(f"q must be (1, T, H, Dh), got {tuple(q.shape)}")
    _, t, h, dh = q.shape
    if ck.ndim != 4 or ck.shape != cv.shape or ck.shape[3] != dh:
        raise ValueError(f"ck and cv must be equal (B, Vtok, Hk, {dh}), got "
                         f"{tuple(ck.shape)} and {tuple(cv.shape)}")
    if tuple(slot.shape) != (t,) or tuple(pos.shape) != (t,):
        raise ValueError(f"slot and pos must be ({t},), got {tuple(slot.shape)} and "
                         f"{tuple(pos.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} has no kernel instance {HEAD_DIMS}")
    hk = ck.shape[2]
    if h % hk or h // hk > MAX_GROUP:
        raise ValueError(f"{h} query heads over {hk} KV heads: need a group of at most "
                         f"{MAX_GROUP}")
    if window < 0:
        raise ValueError(f"window must be 0 (none) or positive, got {window}")


def flat_attn_f64(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, slot: torch.Tensor,
                  pos: torch.Tensor, *, window: int, softcap: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """The flat step's context (1, T, Hk, G, Dh) in ``dtype`` of the T packed
    queries ``q`` (1, T, H, Dh) float32 over the updated view ``ck``, ``cv``
    (B, Vtok, Hk, Dh) float32 or bfloat16, with ``slot``, ``pos`` (T,)
    int64: row t with ``slot[t] < B`` attends over its slot's positions
    ``0..pos[t]`` (only those past ``pos[t] - window`` where ``window > 0``),
    scores scaled by 1/sqrt(Dh) and softcapped where ``softcap > 0``;
    padding rows (``slot == B``) get zeros.  Rounded once to ``dtype``: the
    kernel stores float32 when ``dtype`` is float32, else float64, which
    ``.to(dtype)`` rounds as the plain version rounds its float64 context."""
    _check(q, ck, cv, slot, pos, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flat_attn_f64 runs on CUDA (or meta) tensors, got {q.device}; "
                         "the plain version is models.layers._flat_context")
    _, t, h, dh = q.shape
    nb, vtok, hk = ck.shape[0], ck.shape[1], ck.shape[2]
    out_f64 = dtype != torch.float32
    out = torch.empty((1, t, hk, h // hk, dh),
                      dtype=torch.float64 if out_f64 else torch.float32, device=q.device)
    if q.device.type == "meta":
        # At most every query over its slot's whole row, scores and weighted
        # sum; the view read once.
        tally.record("flat_attn", t * h, dh, 2 * vtok, (q, ck, cv, out))
        return out.to(dtype)
    if t == 0:
        return out.to(dtype)
    for name, x in (("q", q), ("ck", ck), ("cv", cv)):
        if x.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be {_ALIGN}-byte aligned for the CUDA kernel")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), slot.data_ptr(),
                     pos.data_ptr(), out.data_ptr(), int(out_f64), t, h, hk, nb, vtok, dh,
                     int(ck.dtype == torch.bfloat16), window, float(softcap),
                     math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flat_attn kernel launch failed: CUDA error {err}")
    LAUNCHES["flat_attn"] += 1
    return out.to(dtype)
