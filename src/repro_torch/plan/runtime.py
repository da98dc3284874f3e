"""Serve-time plan activation (port of ``repro/plan/runtime.py``).

``activate(plan)`` installs a :class:`~repro_torch.plan.plan.ModelPlan` for
the duration of a ``with`` block (thread-local, re-entrant).  Model code
that has no layer names (``models.layers._packed_linear`` inside the step)
asks ``planned(k, m, n)`` and gets the LayerPlan the offline phase committed
to, or None when no plan is active.  The engine activates its plan outside
the step; inside it ``planned`` only reads, and resolves with Python dicts
alone, no tensor op.

``activate(None)`` is a no-op (keeps whatever plan is already active).
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def current():
    """The active ModelPlan, or None."""
    return getattr(_STATE, "plan", None)


@contextlib.contextmanager
def activate(plan):
    """Install ``plan`` for the dynamic extent of the block (None = no-op)."""
    if plan is None:
        yield current()
        return
    prev = current()
    _STATE.plan = plan
    try:
        yield plan
    finally:
        _STATE.plan = prev


def planned(k: int, m: int, n: int):
    """LayerPlan for a (k, m) BitLinear at step width n, or None."""
    plan = current()
    if plan is None:
        return None
    return plan.lookup_shape(k, m, n)
