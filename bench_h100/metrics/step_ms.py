"""step_ms (ms): mean wall time of an engine step in the window, from
the engine's own counters ((prefill_s + decode_s) / steps; each step ends
in ``torch.cuda.synchronize``), the profiled slice's steps left out.
Layer: model step (``serving/engine.step`` -> ``models/transformer.flat_step``)."""


def read(run):
    c, s = run.counters, run.slice_counters
    busy = c["prefill_s"] + c["decode_s"] - (s["prefill_s"] + s["decode_s"] if s else 0.0)
    steps = c["steps"] - (s["steps"] if s else 0)
    return 1e3 * busy / steps if steps > 0 else None
