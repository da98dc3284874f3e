"""attn_ms (ms): device ms a step of the kernels whose innermost span at
launch is ``tsar.attn`` (``h100bench.spans``): the attention's own kernels
(RoPE, the float64 scores, softmax and weighted sum, masks), without its
projections (``tsar.proj``) or its cache writes (``tsar.kv.write``).
Layer: model step (``models/layers.attention``)."""
from h100bench import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp["device_s"].get("tsar.attn", 0.0) / sp["steps"]
