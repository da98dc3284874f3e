"""step_rows_mean (rows): real (non-padding) token rows per engine
step in the window (the engine's realized_tokens / steps).  Layer:
scheduler (``serving/scheduler.py`` ``plan_flat``)."""


def read(run):
    c = run.counters
    return c["realized"] / c["steps"] if c["steps"] > 0 else None
