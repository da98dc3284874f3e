"""The meta device's kernel tally.

On a meta tensor a kernel wrapper runs its checks and its padding, returns
an empty output of the kernel's shape and dtype, and appends one
:class:`KernelCall` here: what the kernel would have been asked to do.  The
dry-run (``launch/dryrun.py``) reads it for the roofline's operations and
bytes accessed, which ``torch.utils.flop_counter`` and the dry-run's op
trace cannot see inside a hand-written kernel.  ``TALLY`` is separate from
the wrappers' ``LAUNCHES``, which count launches on the card and nothing
else.
"""
from __future__ import annotations

from typing import NamedTuple


class KernelCall(NamedTuple):
    kernel: str
    n: int
    k: int
    m: int
    ops: int        # 2 * n * k * m
    nbytes: int     # every operand read once and the output written once


TALLY: list[KernelCall] = []


def record(kernel: str, n: int, k: int, m: int, tensors: tuple) -> None:
    """One call of ``kernel`` on (n, k) x (k, m); ``tensors`` are its
    operands (as the kernel is handed them, padded) and its output."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    TALLY.append(KernelCall(kernel, n, k, m, 2 * n * k * m, nbytes))


def counts() -> dict[str, int]:
    """Calls per kernel name."""
    out: dict[str, int] = {}
    for call in TALLY:
        out[call.kernel] = out.get(call.kernel, 0) + 1
    return out


def ops() -> int:
    return sum(call.ops for call in TALLY)


def nbytes() -> int:
    return sum(call.nbytes for call in TALLY)
