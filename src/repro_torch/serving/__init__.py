"""Serving: paged KV cache, token-budget scheduler, and the engine."""
from repro_torch.serving.engine import Request, ServingEngine, freeze_params

__all__ = ["Request", "ServingEngine", "freeze_params"]
