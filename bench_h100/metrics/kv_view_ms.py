"""kv_view_ms (ms): device ms a step of the kernels launched under a
``tsar.kv.*`` span (``h100bench.spans``): the cache view's gather and
scatter (``model_zoo.gather_cache_view``/``scatter_cache_view``), each
layer's write into its copy of the view (``layers._flat_write``) and the
stack of the new caches (``transformer._layers``).  Layer: model step."""
from h100bench import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    kv = sum(v for k, v in sp["device_s"].items() if k.startswith("tsar.kv."))
    return 1e3 * kv / sp["steps"]
