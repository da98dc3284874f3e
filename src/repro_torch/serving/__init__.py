"""Serving: paged KV cache, prefix cache, token-budget scheduler, and the
engine."""
from repro_torch.serving.engine import Request, ServingEngine, freeze_params
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix_cache import PrefixCache

__all__ = ["PagedKVCache", "PrefixCache", "Request", "ServingEngine", "freeze_params"]
