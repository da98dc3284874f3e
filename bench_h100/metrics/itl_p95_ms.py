"""itl_p95_ms (ms): the 95th percentile of every gap between consecutive
output tokens of a request, both tokens in the window."""
from h100bench import window


def read(run):
    p = window.percentile(window.itl_samples(run.drive.tracked, run.t0, run.t1), 95)
    return None if p is None else 1e3 * p
