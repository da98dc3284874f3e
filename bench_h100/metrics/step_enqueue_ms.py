"""step_enqueue_ms (ms): mean wall time a step from the model call's start
to the start of its synchronize (the engine's ``step_enqueue_s`` counter
over its steps), the profiled slice's steps left out, as ``step_ms``
does; ``step_ms`` less this is the wait for the device.  Layer: model
step (``serving/engine.step``)."""


def read(run):
    c, s = run.counters, run.slice_counters
    if "step_enqueue_s" not in c:
        return None
    enqueue = c["step_enqueue_s"] - (s["step_enqueue_s"] if s else 0.0)
    steps = c["steps"] - (s["steps"] if s else 0)
    return 1e3 * enqueue / steps if steps > 0 else None
