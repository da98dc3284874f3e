"""Kernel and dataflow selection (port of ``repro/core/dataflow.py``).

:func:`select_kernel` is the argmin over the registry's selectable kernel
costs, with a strict improvement required of the sparse family;
:func:`select_dataflow` picks the paper's AP (activation-persistent) or OP
(output-persistent) order; :func:`sparse_break_even` finds the block
density below which a sparse kernel wins; :func:`layer_plan` is the
per-shape plan, a thin wrapper over ``plan.compile_plan_from_shapes``.
The cost models read the H100 constants of ``repro_torch.core.hw``; the
serving engine runs all of this once, at init, through
``repro_torch.plan.compile_plan``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hw import SMEM_BYTES
from repro_torch.plan import registry as _registry
from repro_torch.plan.registry import DEFAULT_DENSITY, SPARSE_BLOCK, SPARSE_KERNELS


@dataclass(frozen=True)
class KernelChoice:
    kernel: str          # a registry name
    dataflow: str        # 'AP' | 'OP'
    est_time_s: float
    bound: str           # 'compute' | 'memory'
    detail: dict


# The per-kernel cost models live on the registry's impls; these keep the
# reference's private names callable.

def _tsar_mxu_cost(n: int, k: int, m: int) -> tuple[float, float]:
    return _registry.get("tsar_mxu").cost(n, k, m)


def _tsar_lut_cost(n: int, k: int, m: int, c: int) -> tuple[float, float]:
    return _registry.get("tsar_lut").cost(n, k, m, c)


def _tsar_sparse_cost(n: int, k: int, m: int, block_density: float,
                      block_shape: tuple = SPARSE_BLOCK) -> tuple[float, float]:
    return _registry.get("tsar_sparse").cost(
        n, k, m, block_density=block_density, block_shape=block_shape)


def select_kernel(n: int, k: int, m: int, c: int = 4,
                  density: float = DEFAULT_DENSITY,
                  block_density: float | None = None,
                  block_shape: tuple = SPARSE_BLOCK,
                  sparse_ok: tuple | None = None) -> KernelChoice:
    """Compile-time per-layer selection: an analytic roofline argmin over
    the registry's selectable kernels.

    ``density`` is the measured nonzero-weight fraction, ``block_density``
    the measured live-block fraction at ``block_shape`` (estimated from
    ``density`` under unstructured zeros when omitted, which makes every
    block live).  ``sparse_ok`` restricts the sparse family to the formats
    the layer carries; ``None`` keeps every selectable kernel in play.  A
    sparse kernel must be strictly cheaper than the best dense one.
    """
    if block_density is None:
        block_density = _registry.estimate_block_density(density, block_shape)
    costs = _registry.candidate_costs(n, k, m, c, density=density,
                                      block_density=block_density,
                                      block_shape=block_shape)
    if sparse_ok is not None:
        costs = {kn: v for kn, v in costs.items()
                 if kn not in SPARSE_KERNELS or kn in sparse_ok}
    cands = {name: max(comp, mem) for name, (comp, mem) in costs.items()}
    dense_cands = {kn: v for kn, v in cands.items() if kn not in SPARSE_KERNELS}
    kernel = min(dense_cands, key=dense_cands.get)
    sparse_cands = {kn: v for kn, v in cands.items() if kn in SPARSE_KERNELS}
    if sparse_cands:
        best_sparse = min(sparse_cands, key=sparse_cands.get)
        if sparse_cands[best_sparse] < dense_cands[kernel]:
            kernel = best_sparse
    comp, mem = costs[kernel]
    return KernelChoice(
        kernel=kernel,
        dataflow=select_dataflow(n, k, m, c),
        est_time_s=cands[kernel],
        bound="compute" if comp >= mem else "memory",
        detail={"compute_s": comp, "memory_s": mem, "candidates": cands,
                "density": density, "block_density": block_density},
    )


def sparse_break_even(n: int, k: int, m: int, c: int = 4,
                      block_shape: tuple = SPARSE_BLOCK,
                      kernel: str = "tsar_sparse") -> float:
    """Block density below which ``kernel`` (a sparse-family member) beats
    the best dense kernel.  The sparse cost rises monotonically with block
    density and the dense costs are constant, so the crossover is unique;
    found by bisection to agree with :func:`select_kernel` exactly."""
    if kernel not in SPARSE_KERNELS:
        raise ValueError(f"{kernel!r} is not a sparse kernel: {SPARSE_KERNELS}")
    best_dense = min(
        max(*_registry.get(name).cost(n, k, m, c))
        for name in _registry.selectable_names()
        if name not in SPARSE_KERNELS)
    sp = _registry.get(kernel)

    def sparse(bd: float) -> float:
        sc, sm = sp.cost(n, k, m, c, block_density=bd, block_shape=block_shape)
        return max(sc, sm)

    if sparse(1.0) < best_dense:
        return 1.0
    if sparse(0.0) >= best_dense:
        return 0.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if sparse(mid) < best_dense:
            lo = mid
        else:
            hi = mid
    return lo


def select_dataflow(n: int, k: int, m: int, c: int = 4,
                    smem_budget: int = SMEM_BYTES) -> str:
    """AP vs OP (paper Fig. 7), the reference's heuristic against an SM's
    shared memory: AP when the activation and LUT working set fits in half
    of it and n >= 8, OP when the (n, m) accumulator does and m >= n, else
    whichever operand is larger."""
    act_bytes = n * k                       # int8 activations
    lut_bytes = n * (k / c) * (2 ** c) * 2  # bf16 shared LUTs
    out_bytes = n * m * 4                   # f32 accumulators
    if act_bytes + lut_bytes <= smem_budget * 0.5 and n >= 8:
        return "AP"
    if out_bytes <= smem_budget * 0.5 and m >= n:
        return "OP"
    return "AP" if n * k >= m else "OP"


def layer_plan(shapes: dict, c: int = 4) -> dict[str, KernelChoice]:
    """Whole-model compile-time plan: layer name -> choice, from specs
    ``(n, k, m)``, ``(n, k, m, c)`` or dicts with optional per-layer ``c``,
    ``density`` and ``block_density`` (see
    ``repro_torch.plan.compile_plan_from_shapes``, which it wraps)."""
    from repro_torch.plan.plan import compile_plan_from_shapes

    mp = compile_plan_from_shapes(shapes, c=c)
    out: dict[str, KernelChoice] = {}
    for name, by_bucket in mp.layers.items():
        ((n, lp),) = by_bucket.items()
        out[name] = KernelChoice(
            kernel=lp.kernel, dataflow=lp.dataflow, est_time_s=lp.est_time_s,
            bound=lp.bound,
            detail={"density": lp.density, "tile_sizes": lp.tile_sizes,
                    "bucket": n})
    return out
