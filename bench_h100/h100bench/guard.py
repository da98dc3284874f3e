"""The import rule: no JAX, and nothing of the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word, so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden(names=None) -> list[str]:
    """The loaded top-level names that the rule forbids, sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
