"""BitLinear: the ternary linear layer (port of ``repro/core/bitlinear.py``).

Two modes:

* **Training (QAT)**: latent float master weights; the forward ternarizes
  them with the absmean recipe and fake-quantizes the activations to int8
  levels, with straight-through (identity) gradients
  (:func:`apply_train`).
* **Inference (frozen)**: :func:`freeze` ternarizes once and packs 2-bit
  planes, the LUT index encodings and, for a layer whose (bk, bm) blocks
  are largely dead, the compacted and padded block-sparse sidecars;
  :func:`apply_frozen` runs one registry kernel on it, chosen by name, by a
  ``LayerPlan`` or by the cost model from the layer's measured densities.
  On CUDA tensors ``tsar_mxu``, ``tsar_lut``, ``tsar_sparse`` and
  ``tsar_sparse_padded`` launch their hand-written kernels
  (``repro_torch/csrc``); on CPU tensors their plain versions run.

The reference's deprecated ``apply_frozen(kernel=, use_pallas=)`` spelling
and its ``interpret=`` switch have no meaning here and are not ported.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import lut, ternary
from repro_torch.plan import registry
from repro_torch.sparse import format as sparse_format
from repro_torch.sparse import stats as sparse_stats

# Default LUT block size: c=4 -> a 16-entry shared binary LUT.
DEFAULT_C = 4

# Emit the block-sparse sidecars at freeze time only when the measured
# live-block fraction is below this: a notch above the ~0.9 dispatch
# break-even (``dataflow.sparse_break_even``), so borderline layers keep the
# option while dense checkpoints (unstructured zeros leave every block live)
# carry no pool that no dispatch would pick.
SPARSE_SIDE_CAR_THRESHOLD = 0.95


# ---------------------------------------------------------------------------
# Straight-through estimators
# ---------------------------------------------------------------------------

class _SteTernarize(torch.autograd.Function):
    """Absmean-ternarize and rescale; identity gradient."""

    @staticmethod
    def forward(ctx, w):
        t, scale = ternary.absmean_ternarize(w)
        return t * scale[..., None, :]

    @staticmethod
    def backward(ctx, g):
        return g


class _SteActQuant(torch.autograd.Function):
    """Fake int8 absmax quantization of activations; identity gradient."""

    @staticmethod
    def forward(ctx, x):
        q, scale = ternary.quantize_activations(x)
        return q.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_ternarize(w: torch.Tensor) -> torch.Tensor:
    return _SteTernarize.apply(w)


def ste_act_quant(x: torch.Tensor) -> torch.Tensor:
    return _SteActQuant.apply(x)


# ---------------------------------------------------------------------------
# Layer init / apply
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, k: int, m: int, dtype=torch.float32) -> dict:
    """Latent master weights, fan-in scaled, on ``generator``'s device."""
    w = torch.randn((k, m), generator=generator, device=generator.device, dtype=dtype)
    return {"w": w * (1.0 / math.sqrt(k))}


class FrozenBitLinear(NamedTuple):
    """Packed inference-time parameters of one BitLinear layer."""

    packed: ternary.TernaryWeights   # 2-bit planes + per-channel scale
    idx_pos: torch.Tensor            # (ceil(K/c), M) uint8 LUT encodings
    idx_zero: torch.Tensor
    c: int
    # Block-sparse sidecars (None for a layer too dense to bother) and the
    # measured densities that drive the auto kernel choice.
    sparse: Any = None               # sparse_format.BlockSparseTernary | None
    density: float | None = None     # nonzero-weight fraction
    block_density: float | None = None   # live-block fraction
    padded: Any = None               # sparse_format.PaddedBlockSparseTernary | None

    @property
    def shape(self):
        return self.packed.shape


def freeze(params: dict, c: int = DEFAULT_C, block_shape: tuple | None = None,
           padded: bool | None = None, max_live: int | None = None,
           s_steps: int | None = None) -> FrozenBitLinear:
    """Compile-time weight encoding (the paper's offline phase), on the
    weights' device.

    Measures the density and block occupancy, and only when the live-block
    fraction is below ``SPARSE_SIDE_CAR_THRESHOLD`` emits the compacted
    ``BlockSparseTernary`` and, with ``padded=None``, its tight padded twin
    (sized to this layer's own live count unless ``max_live``/``s_steps``
    are given).  ``padded=True`` always emits a padded pool with full-grid
    defaults; ``padded=False`` never does.
    """
    t, scale = ternary.absmean_ternarize(params["w"])
    t8 = t.to(torch.int8)
    idx_pos, idx_zero = ternary.pack_indices(t8, c)
    bk, bm = block_shape or sparse_format.DEFAULT_BLOCK_SHAPE
    occ = sparse_stats.block_occupancy(t8, bk, bm)
    density = float(ternary.ternary_density(t8))
    block_density = int(torch.count_nonzero(occ)) / occ.numel()
    sparse = padded_sidecar = None
    if block_density < SPARSE_SIDE_CAR_THRESHOLD:
        sparse = sparse_format.from_ternary(t8, scale, bk=bk, bm=bm, occupancy=occ)
    if padded:
        padded_sidecar = sparse_format.pad_from_ternary(
            t8, scale, bk=bk, bm=bm, max_live=max_live, s_steps=s_steps)
    elif padded is None and sparse is not None:
        padded_sidecar = sparse_format.pad_pool(sparse, max_live=max_live,
                                                s_steps=s_steps)
    return FrozenBitLinear(
        packed=ternary.pack(t, scale), idx_pos=idx_pos, idx_zero=idx_zero, c=c,
        sparse=sparse, density=density, block_density=block_density,
        padded=padded_sidecar)


def apply_train(params: dict, x: torch.Tensor) -> torch.Tensor:
    """QAT forward: fake-quantized activations x ternarized weights."""
    w_t = ste_ternarize(params["w"])
    x_q = ste_act_quant(x)
    return x_q @ w_t.to(x_q.dtype)


def apply_eval(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward from latent weights (the exact int8 pipeline)."""
    t, scale = ternary.absmean_ternarize(params["w"])
    return lut.bitlinear_matmul_exact_int(x, t, scale).to(x.dtype)


def resolve_kernel(frozen: FrozenBitLinear, n: int, plan=None) -> str:
    """A registry kernel name for one layer at ``n`` rows.

    ``plan`` is a kernel name, a ``plan.LayerPlan``, ``'auto'`` or None
    (auto).  Auto costs the layer's measured density and block occupancy
    (stamped by :func:`freeze`).  A planned or auto sparse-family kernel on
    a layer without that format degrades to its sibling format when
    present, else ``tsar_mxu`` (the same product); an explicit sparse name
    still raises in ``lower``.
    """
    if plan is None or plan == "auto":
        from repro_torch.core.dataflow import select_kernel

        k, m = frozen.shape
        kw = {}
        if frozen.density is not None:
            kw["density"] = frozen.density
        sidecar = frozen.sparse if frozen.sparse is not None else frozen.padded
        if frozen.block_density is not None and sidecar is not None:
            kw["block_density"] = frozen.block_density
            kw["block_shape"] = sidecar.block_shape
            kw["sparse_ok"] = tuple(kn for kn in registry.SPARSE_KERNELS
                                    if registry.get(kn).supports(frozen))
        name = select_kernel(n=n, k=k, m=m, c=frozen.c, **kw).kernel
    elif isinstance(plan, str):
        name = plan
    else:                        # LayerPlan (or anything with .kernel)
        name = plan.kernel
    explicit = isinstance(plan, str) and plan != "auto"
    if name in registry.SPARSE_KERNELS and not explicit \
            and not registry.get(name).supports(frozen):
        name = next((kn for kn in registry.SPARSE_KERNELS
                     if kn != name and registry.get(kn).supports(frozen)), "tsar_mxu")
    return name


def apply_frozen(frozen: FrozenBitLinear, x: torch.Tensor, *, plan=None) -> torch.Tensor:
    """Inference forward through the kernel registry: ``x`` (..., K) ->
    (..., M) in ``x``'s dtype.

    ``plan`` is a kernel name (``registry.names()``), a ``plan.LayerPlan``
    (e.g. ``model_plan.lookup(layer, n)``), or None/'auto' to choose by cost
    from the layer's measured densities.
    """
    n = math.prod(x.shape[:-1])
    name = resolve_kernel(frozen, n, plan)
    lp = plan if plan is not None and not isinstance(plan, str) else None
    return registry.get(name).lower(frozen, x, lp=lp).to(x.dtype)


def apply(params: Any, x: torch.Tensor, *, train: bool = True, **kw) -> torch.Tensor:
    """Unified entry point: frozen layers run :func:`apply_frozen`, latent
    ones :func:`apply_train` or :func:`apply_eval`."""
    if isinstance(params, FrozenBitLinear):
        return apply_frozen(params, x, **kw)
    if train:
        return apply_train(params, x)
    return apply_eval(params, x)
