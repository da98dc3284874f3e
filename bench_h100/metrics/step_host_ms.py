"""step_host_ms (ms): mean wall time a step in ``engine.step()`` outside
its model call and synchronize (the engine's ``step_host_s`` counter over
its steps: admission, the scheduler's plan, the uploads, sampling, the
emit loop), the profiled slice's steps left out, as ``step_ms`` does.
The device has nothing queued for all of it.  Layer: scheduler
(``serving/engine.step``, ``serving/scheduler.py``)."""


def read(run):
    c, s = run.counters, run.slice_counters
    if "step_host_s" not in c:
        return None
    host = c["step_host_s"] - (s["step_host_s"] if s else 0.0)
    steps = c["steps"] - (s["steps"] if s else 0)
    return 1e3 * host / steps if steps > 0 else None
