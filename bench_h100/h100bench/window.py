"""The arithmetic of the measured window [t0, t1).

Every statistic is taken over all samples of the window, never as a median
of chunks: a rate over all the work and all the time, a tail over every
sample.  Percentiles interpolate linearly between order statistics
(``numpy.percentile``'s default).
"""
from __future__ import annotations

import numpy as np


def percentile(xs, q: float) -> float | None:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) if len(xs) else None


def output_tokens(tracked, t0: float, t1: float) -> int:
    """Tokens emitted in the window, by every request."""
    return sum(sum(1 for t in tr.times if t0 <= t < t1) for tr in tracked)


def itl_samples(tracked, t0: float, t1: float) -> list[float]:
    """Every gap (s) between consecutive output tokens of a request, both
    tokens in the window."""
    out = []
    for tr in tracked:
        ts = tr.times
        out += [b - a for a, b in zip(ts, ts[1:]) if t0 <= a and b < t1]
    return out


def due_in_window(tracked, t0: float, t1: float) -> list:
    return [tr for tr in tracked if t0 <= tr.due < t1]


def ttft_samples(tracked, t0: float, t1: float) -> list[float]:
    """Time to first token (s) of every request due in the window, from its
    due time, drained ones included."""
    return [tr.times[0] - tr.due for tr in due_in_window(tracked, t0, t1) if tr.times]


def queue_samples(tracked, t0: float, t1: float) -> list[float]:
    """Due time to first admission into a slot (s), every request due in
    the window that was admitted."""
    return [tr.req.t_admit - tr.due for tr in due_in_window(tracked, t0, t1)
            if tr.req.t_admit is not None]
