"""The meta device's kernel tally.

On a meta tensor a kernel wrapper runs its checks and its padding, returns
an empty output of the kernel's shape and dtype, and appends one
:class:`KernelCall` here: what the kernel would have been asked to do.  The
dry-run (``launch/dryrun.py``) reads it for the roofline's operations, which
``torch.utils.flop_counter`` cannot see inside a hand-written kernel.
``TALLY`` is separate from the wrappers' ``LAUNCHES``, which count launches
on the card and nothing else.
"""
from __future__ import annotations

from typing import NamedTuple


class KernelCall(NamedTuple):
    kernel: str
    n: int
    k: int
    m: int
    ops: int        # 2 * n * k * m


TALLY: list[KernelCall] = []


def record(kernel: str, n: int, k: int, m: int) -> None:
    TALLY.append(KernelCall(kernel, n, k, m, 2 * n * k * m))


def counts() -> dict[str, int]:
    """Calls per kernel name."""
    out: dict[str, int] = {}
    for call in TALLY:
        out[call.kernel] = out.get(call.kernel, 0) + 1
    return out


def ops() -> int:
    return sum(call.ops for call in TALLY)
