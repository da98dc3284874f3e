"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (port of ``repro/optim/compression.py``).

``compress_leaf`` quantizes ``g + err`` to int8 with one absmax scale and
returns the rounding error, which the next step adds back (EF-SGD), so the
quantization error does not accumulate.  ``psum_compressed`` is the
compressed mean over the data-parallel processes.  This module runs it for
a world of one process, where it is the reference's round trip exactly:
int8 codes times the scale, rounded to bf16 as the reference's all-gather
phase sends them; the ``torch.distributed`` exchange (reduce-scatter of
int8, all-gather of bf16) comes with the multi-device slice (ROADMAP.md,
Queue 1, item 10) and raises until then.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_map

# Leaves smaller than this take a plain float32 mean (not worth compressing).
MIN_COMPRESSED = 1024


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + err) -> (int8 q, scale, new_err)."""
    target = g.to(torch.float32) + err
    scale = torch.amax(torch.abs(target)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.to(torch.float32) * scale
    return q, scale, new_err


def world_size(group=None) -> int:
    """Processes in ``group`` (1 without an initialized process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def psum_compressed(grads, err_buf, group=None) -> tuple[dict, dict]:
    """Compressed mean of ``grads`` over the processes of ``group``, and the
    new error buffers.  One process only (see the module docstring)."""
    n = world_size(group)
    if n != 1:
        raise NotImplementedError(
            f"psum_compressed over {n} processes: the torch.distributed int8 "
            "all-reduce is not ported yet (ROADMAP.md, Queue 1, item 10)")

    out_g, out_e = {}, {}
    for k, g in grads.items():
        e = err_buf[k]
        if isinstance(g, dict):
            out_g[k], out_e[k] = psum_compressed(g, e, group)
        elif g.numel() < MIN_COMPRESSED:
            out_g[k], out_e[k] = g, e
        else:
            q, scale, out_e[k] = compress_leaf(g, e)      # the mean over one process:
            g_hat = q.to(torch.float32) * scale          # its own dequantized codes
            out_g[k] = g_hat.to(torch.bfloat16).to(torch.float32).to(g.dtype)
    return out_g, out_e


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
