"""The kernel registry: every servable BitLinear kernel, declared once (port
of ``repro/plan/registry.py``).

Each :class:`KernelImpl` carries its ``name``, an analytic ``cost(n, k, m,
c, density, block_density)`` against the H100 constants of
``repro_torch.core.hw``, a ``supports(frozen)`` capability gate, ``tiles(n,
k, m, c)`` (the launch picks of its CUDA kernel) and ``lower(frozen, x)``,
the computation on a frozen layer.  The six implementations keep the
reference's names, ``selectable`` and ``serve_via_registry`` flags, cost
formulas and gates, so a plan compiled by either package means the same in
both.

A frozen layer is a ``core.bitlinear.FrozenBitLinear`` or a packed-param
dict (``layers.pack_linear`` output, one layer of a stacked tree); ``_leaf``
reads either.  Lowerings: ``tsar_mxu`` runs ``ops.tsar_matmul``,
``tsar_lut`` ``ops.tsar_lut_gemv``, ``tsar_sparse`` ``ops.tsar_sparse_matmul``
on the compacted sidecar and ``tsar_sparse_padded``
``ops.tsar_sparse_padded_matmul`` (hand-written CUDA kernels on a GPU, their
plain versions on the CPU); ``dense`` and ``memory_lut`` are plain PyTorch,
as the reference computes them outside any Pallas kernel.

Import-graph note: this module sits below ``repro_torch.core.dataflow`` and
the kernels, which are imported lazily inside methods.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

# The BitNet-b1.58 prior: absmean ternarization zeroes ~1/3 of the weights.
# Used when no measured density is supplied.
DEFAULT_DENSITY = 2.0 / 3.0

# Canonical block-sparse tiling default (``sparse.format.DEFAULT_BLOCK_SHAPE``).
SPARSE_BLOCK = (256, 256)

# The sparse kernel family: select_kernel requires a strict improvement over
# the best dense kernel for them, and planners restrict them to the formats
# a layer carries.
SPARSE_KERNELS = ("tsar_sparse", "tsar_sparse_padded")


def _hw():
    from repro_torch.core import hw

    return hw


def _leaf(frozen, key: str):
    """A ``FrozenBitLinear`` field or a packed-param dict leaf (None when
    absent)."""
    if isinstance(frozen, dict):
        return frozen.get(key)
    return getattr(frozen, key, None)


def has_planes(frozen) -> bool:
    if isinstance(frozen, dict):
        # Stacked plane dicts are sliced per layer before lower().
        return ("sign" in frozen and "zero" in frozen
                and getattr(frozen["sign"], "ndim", 0) == 2)
    return _leaf(frozen, "packed") is not None


def _packed_of(frozen, x):
    """The layer's TernaryWeights: a ``FrozenBitLinear`` carries it; a
    packed dict rebuilds it from the planes with the true K taken from the
    activations (planes store ceil(K/8)*8)."""
    packed = _leaf(frozen, "packed")
    if packed is not None:
        return packed
    from repro_torch.core import ternary

    return ternary.TernaryWeights(frozen["sign"], frozen["zero"], frozen["scale"],
                                  (x.shape[-1], frozen["sign"].shape[-1]))


def _c_of(frozen) -> int:
    c = _leaf(frozen, "c")
    return 4 if c is None else c


@runtime_checkable
class KernelImpl(Protocol):
    """What the planner and the runtime need from one kernel."""

    name: str
    selectable: bool  # costed by select_kernel (baselines are not)
    # Serve-path flag: when a plan names this kernel inside the serving step
    # (models.layers._packed_linear), does the step call lower() on the
    # packed-dict leaves?  False for the dense T-SAR families, which the
    # step serves from the planes; True for kernels whose lowering differs
    # (fp escape hatch, DRAM-LUT baseline, padded-pool sparse).
    serve_via_registry: bool

    def cost(self, n: int, k: int, m: int, c: int = 4,
             density: float = DEFAULT_DENSITY,
             block_density: float | None = None,
             block_shape: tuple = SPARSE_BLOCK) -> tuple[float, float]:
        """(compute_s, memory_s) roofline estimate."""
        ...

    def supports(self, frozen) -> bool:
        """Can this kernel serve this frozen layer (encodings present)?"""
        ...

    def tiles(self, n: int, k: int, m: int, c: int = 4) -> tuple[int, ...]:
        """The launch tiles its CUDA kernel picks for this shape (empty for
        plain-PyTorch lowerings and kernels not ported yet)."""
        ...

    def lower(self, frozen, x: torch.Tensor, *, lp=None) -> torch.Tensor:
        """Run the kernel on a frozen layer: x (..., K) -> (..., M) f32.
        ``lp`` (a ``LayerPlan``) carries the planned dataflow."""
        ...


class TsarMXU:
    """Decode 2-bit planes to {-1,0,+1} int8 in registers, int8 dot products
    (``csrc/tsar_matmul.cu``)."""

    name = "tsar_mxu"
    selectable = True
    serve_via_registry = False

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        hw = _hw()
        flops = 2.0 * n * k * m                      # int8 MACs
        decode_ops = k * m * 4.0                     # bitplane unpack ALU ops
        compute = flops / hw.PEAK_FLOPS_INT8 + decode_ops / (hw.PEAK_FLOPS_INT8 / 2)
        bytes_moved = (
            k * m * 0.25                             # 2-bit packed weights
            + n * k * 1.0                            # int8 activations
            + n * m * 2.0                            # bf16 outputs
            + m * 4.0                                # scales
        )
        return compute, bytes_moved / hw.HBM_BW

    def supports(self, frozen):
        return has_planes(frozen)

    def tiles(self, n, k, m, c=4):
        from repro_torch.kernels import tsar_matmul

        # (rows per CTA, k per ring stage, columns per CTA): the picks on an
        # H100's SM_COUNT SMs (a card with other SM counts launches other
        # splits; padding K and M to the kernel's 16 changes nothing).
        cfg = tsar_matmul.launch_config(n, k, m, _hw().SM_COUNT)
        return (8 * cfg.n_tiles, cfg.stage_steps * tsar_matmul._K_STEP, cfg.bm)

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.kernels import ops

        return ops.tsar_matmul(x, _packed_of(frozen, x),
                               dataflow=lp.dataflow if lp is not None else "AP")


class TsarLUT:
    """Paper-faithful shared-LUT kernel (TLUT build + TGEMV gather)."""

    name = "tsar_lut"
    selectable = True
    serve_via_registry = False

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        hw = _hw()
        blocks = k / c
        lut_build = n * blocks * (2 ** c) * 1.0      # TLUT expansion ops
        # Each gather costed as one-hot x LUT: 2^c MACs per (block, m) pair,
        # two gathers per block (pos/zero) fused into one 2^c-wide product.
        gather = 2.0 * n * blocks * m * (2 ** c) / 8.0
        compute = (lut_build + gather) / hw.PEAK_FLOPS_INT8
        bytes_moved = (
            2.0 * (k / c) * m * 1.0                  # idx_pos + idx_zero, 1B each
            + n * k * 1.0
            + n * m * 2.0
            + m * 4.0
        )
        return compute, bytes_moved / hw.HBM_BW

    def supports(self, frozen):
        return _leaf(frozen, "idx_pos") is not None

    def tiles(self, n, k, m, c=4):
        from repro_torch.kernels import tsar_lut

        # (rows per CTA, c-blocks per ring stage, columns per CTA): the picks
        # on an H100's SM_COUNT SMs.
        cfg = tsar_lut.launch_config(n, -(-k // c), m, c, _hw().SM_COUNT)
        return (cfg.rows, cfg.stage_blocks, cfg.bm)

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.kernels import ops

        idx_pos = _leaf(frozen, "idx_pos")
        if idx_pos is None:
            raise ValueError("layer was frozen without LUT indices (idx_pos)")
        return ops.tsar_lut_gemv(x, idx_pos, _leaf(frozen, "idx_zero"),
                                 _packed_of(frozen, x).scale, c=_c_of(frozen))


class TsarSparse:
    """Zero-block-skipping matmul over a compacted BlockSparseTernary pool."""

    name = "tsar_sparse"
    selectable = True
    serve_via_registry = False

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        """Work and weight bytes scale with the live-block fraction; the
        index map and per-strip gather lists are the sparsity tax, which is
        why the dense kernel wins at density ~ 1."""
        hw = _hw()
        tax = hw.sparse_issue_tax()
        if block_density is None:
            block_density = estimate_block_density(density, block_shape)
        bk, bm = block_shape
        kb, mb = max(k / bk, 1.0), max(m / bm, 1.0)
        live = block_density * kb * mb
        flops = 2.0 * n * bk * bm * live             # int8 MACs, live blocks only
        decode_ops = bk * bm * live * 4.0            # bitplane unpack, live only
        compute = tax * (
            flops / hw.PEAK_FLOPS_INT8 + decode_ops / (hw.PEAK_FLOPS_INT8 / 2))
        bytes_moved = (
            tax * live * bk * bm * 0.25              # 2-bit planes, live blocks
            + kb * mb * 4.0                          # block-index map (int32)
            + 2.0 * live * 4.0                       # kids+slots gather lists
            + n * k * 1.0                            # int8 activations
            + n * m * 2.0                            # bf16 outputs
            + m * 4.0                                # scales
        )
        return compute, bytes_moved / hw.HBM_BW

    def supports(self, frozen):
        return _leaf(frozen, "sparse") is not None

    def tiles(self, n, k, m, c=4):
        from repro_torch.kernels import tsar_sparse

        # (rows per CTA, k per ring stage, columns per CTA): the picks on an
        # H100's SM_COUNT SMs for (256, 256) blocks and the longest walk
        # the grid allows (every k-block live); the live counts are data.
        bk, bm = SPARSE_BLOCK
        cfg = tsar_sparse.launch_config(n, bk, bm, -(-m // bm), -(-k // bk), _hw().SM_COUNT)
        return (8 * cfg.n_tiles, cfg.stage_blocks * min(bk, 256), cfg.bm)

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.kernels import ops

        sparse = _leaf(frozen, "sparse")
        if sparse is None:
            raise ValueError("layer was frozen without a block-sparse sidecar")
        return ops.tsar_sparse_matmul(x, sparse)


def _padded_of(frozen, x):
    """The layer's PaddedBlockSparseTernary: a ``FrozenBitLinear`` carries
    it; a packed dict rebuilds it from the ``sp_*`` leaves with the true K/M
    from the activations and the scales (the pools store only the
    block-padded grid)."""
    padded = _leaf(frozen, "padded")
    if padded is not None:
        return padded
    from repro_torch.core import ternary
    from repro_torch.sparse import format as sparse_format

    sp = frozen["sp_sign"]
    return sparse_format.PaddedBlockSparseTernary(
        sign_pool=sp, zero_pool=frozen["sp_zero"], block_map=frozen["sp_map"],
        occupancy=None, scale=frozen["scale"], kids=frozen["sp_kids"],
        slots=frozen["sp_slots"], counts=frozen["sp_counts"],
        shape=(x.shape[-1], frozen["scale"].shape[-1]),
        block_shape=(sp.shape[-2] * ternary.PACK, sp.shape[-1]),
        max_live=sp.shape[0], s_steps=frozen["sp_kids"].shape[-1])


class TsarSparsePadded(TsarSparse):
    """Zero-skip matmul over a padded (static-shape) pool: the sparse kernel
    the serving step can plan and dispatch (``csrc/tsar_sparse.cu``)."""

    name = "tsar_sparse_padded"
    selectable = True
    serve_via_registry = True

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        """Compacted cost plus the pad-walk overhead: the static s_steps
        walk's masked steps at a calibratable fraction of a live block's
        compute.  Strictly above ``tsar_sparse`` at every density."""
        comp, mem = TsarSparse.cost(self, n, k, m, c, density=density,
                                    block_density=block_density,
                                    block_shape=block_shape)
        hw = _hw()
        if block_density is None:
            block_density = estimate_block_density(density, block_shape)
        bk, bm = block_shape
        kb, mb = max(k / bk, 1.0), max(m / bm, 1.0)
        dead = (1.0 - block_density) * kb * mb
        per_block = (2.0 * n * bk * bm / hw.PEAK_FLOPS_INT8
                     + bk * bm * 4.0 / (hw.PEAK_FLOPS_INT8 / 2))
        comp += hw.sparse_pad_step_frac() * dead * per_block
        return comp, mem

    def supports(self, frozen):
        if isinstance(frozen, dict):
            sp = frozen.get("sp_sign")
            return sp is not None and getattr(sp, "ndim", 0) == 3
        return _leaf(frozen, "padded") is not None

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.kernels import ops

        return ops.tsar_sparse_padded_matmul(x, _padded_of(frozen, x))


class MemoryLUT:
    """DRAM-resident 3^c-entry LUT gather: the bitnet.cpp-style baseline the
    paper beats; kept servable for A/B runs, never chosen by the planner.
    Plain PyTorch, as the reference computes it outside any Pallas kernel."""

    name = "memory_lut"
    selectable = False
    serve_via_registry = True

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        hw = _hw()
        blocks = k / c
        compute = 2.0 * n * blocks * m / hw.PEAK_FLOPS_INT8
        bytes_moved = (
            n * blocks * (3 ** c) * 4.0              # DRAM-resident LUT tables
            + blocks * m * 1.0                       # index stream
            + n * k * 1.0 + n * m * 2.0 + m * 4.0
        )
        return compute, bytes_moved / hw.HBM_BW

    def supports(self, frozen):
        return has_planes(frozen)

    def tiles(self, n, k, m, c=4):
        return ()

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.core import lut, ternary

        packed = _packed_of(frozen, x)
        c = _c_of(frozen)
        x32 = x.to(torch.float32)
        t = ternary.unpack(packed)
        pad = (-t.shape[0]) % c   # ragged K: zero channels x zero weights = 0
        if pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, pad))
            x32 = torch.nn.functional.pad(x32, (0, pad))
        li = lut.ternary_lut_indices(t, c)
        return lut.memory_lut_matmul(x32, li, c, packed.scale)


class Dense:
    """Dequantize to fp and run a plain matmul: the correctness oracle and
    the escape hatch a hand-edited plan can force per layer (plain
    PyTorch)."""

    name = "dense"
    selectable = False
    serve_via_registry = True

    def cost(self, n, k, m, c=4, density=DEFAULT_DENSITY, block_density=None,
             block_shape=SPARSE_BLOCK):
        hw = _hw()
        compute = 2.0 * n * k * m / hw.PEAK_FLOPS_BF16
        bytes_moved = k * m * 2.0 + n * k * 2.0 + n * m * 2.0
        return compute, bytes_moved / hw.HBM_BW

    def supports(self, frozen):
        return has_planes(frozen)

    def tiles(self, n, k, m, c=4):
        return ()

    def lower(self, frozen, x, *, lp=None):
        from repro_torch.core import ternary

        w = ternary.unpack_dequant(_packed_of(frozen, x))
        return x.to(torch.float32) @ w


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, KernelImpl] = {}


def register(impl: KernelImpl) -> KernelImpl:
    """Register a kernel implementation (later registrations override)."""
    _REGISTRY[impl.name] = impl
    return impl


def get(name: str) -> KernelImpl:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; registered: {names()}") from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def selectable_names() -> tuple[str, ...]:
    return tuple(n for n in names() if _REGISTRY[n].selectable)


def available(frozen) -> tuple[str, ...]:
    """Kernel names whose encodings are present on this frozen layer."""
    return tuple(n for n in names() if _REGISTRY[n].supports(frozen))


def estimate_block_density(density: float, block_shape: tuple = SPARSE_BLOCK) -> float:
    """Live-block fraction under unstructured zeros at this density, which
    makes essentially every block live (``1 - (1-d)^(bk*bm) ~ 1``): the
    sparse path is chosen only on measured structured sparsity."""
    bk, bm = block_shape
    return 1.0 - (1.0 - min(density, 1.0 - 1e-12)) ** (bk * bm)


def candidate_costs(n: int, k: int, m: int, c: int = 4,
                    density: float = DEFAULT_DENSITY,
                    block_density: float | None = None,
                    block_shape: tuple = SPARSE_BLOCK,
                    ) -> dict[str, tuple[float, float]]:
    """(compute_s, memory_s) per selectable kernel: the planner's input."""
    return {
        name: _REGISTRY[name].cost(n, k, m, c, density=density,
                                   block_density=block_density,
                                   block_shape=block_shape)
        for name in selectable_names()
    }


for _impl in (TsarMXU(), TsarLUT(), TsarSparse(), TsarSparsePadded(),
              MemoryLUT(), Dense()):
    register(_impl)
del _impl
