"""Block-sparse ternary weight formats (port of ``repro/sparse/format.py``).

The ternary (K, M) matrix is tiled into (bk, bm) blocks, and only the live
(any-nonzero) blocks keep their 2-bit planes, LSB-first along bk, in a pool
of slots numbered in block-raster order.  Each m-strip gets a walk of its
live k-blocks (``kids``) and their pool ``slots``, padded with 0 past
``counts[j]``.  Two formats:

* :class:`BlockSparseTernary`, compacted: the pool holds exactly
  ``max(n_live, 1)`` slots (a data-dependent size; an all-dead matrix keeps
  one slot whose ``zero_pool`` is 0xFF, so it decodes to zeros) and the
  walk is ``max(s_max, 1)`` wide.  ``core.bitlinear.freeze`` builds it;
  ``csrc/tsar_sparse.cu``'s ``tsar_sparse_matmul_packed`` walks it.
* :class:`PaddedBlockSparseTernary`: the pool padded to a static
  ``max_live`` and the walk to a static ``s_steps``, so stacked per-layer
  pools share one shape and ride a params tree along the ``L`` axis, which
  is how the serving step carries them (``sp_*`` leaves of
  ``models.layers.pack_linear``).  Pad slots have ``zero_pool`` = 0xFF.

Every pool, map and schedule is byte-equal to the reference's.  Builders
run on the tensor's own device; bounds that do not hold raise (the
reference truncates only under tracing, which the port has no use for).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ternary
from repro_torch.plan.registry import SPARSE_BLOCK as DEFAULT_BLOCK_SHAPE

DEFAULT_BK, DEFAULT_BM = DEFAULT_BLOCK_SHAPE


@dataclasses.dataclass(frozen=True)
class BlockSparseTernary:
    """Compacted block-sparse ternary weights (frozen, inference only)."""

    sign_pool: torch.Tensor     # uint8 (max(n_live, 1), bk//8, bm)
    zero_pool: torch.Tensor     # uint8 (max(n_live, 1), bk//8, bm)
    block_map: torch.Tensor     # int32 (kb, mb)  pool slot, -1 = dead block
    occupancy: torch.Tensor     # f32   (kb, mb)  nonzero fraction per block
    scale: torch.Tensor         # f32   (M,) per-output-channel dequant scale
    shape: tuple                # logical (K, M)
    block_shape: tuple          # (bk, bm)
    n_live: int                 # live blocks (pool slots used)
    kids: torch.Tensor          # int32 (mb, max(s_max, 1)) live k-block ids per strip
    slots: torch.Tensor         # int32 (mb, max(s_max, 1)) matching pool slots
    counts: torch.Tensor        # int32 (mb,) live blocks per strip
    s_max: int                  # most live blocks in any strip

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def m(self) -> int:
        return self.shape[1]

    @property
    def grid(self) -> tuple:
        bk, bm = self.block_shape
        return (-(-self.shape[0] // bk), -(-self.shape[1] // bm))

    @property
    def block_density(self) -> float:
        """Fraction of blocks that are live."""
        kb, mb = self.grid
        return self.n_live / max(kb * mb, 1)

    def nbytes(self) -> int:
        """Device bytes of the weights: the ``n_live`` used pool slots, the
        block map, the occupancy grid and the scales."""
        bk, bm = self.block_shape
        pool = 2 * self.n_live * (bk // ternary.PACK) * bm
        return int(pool + self.block_map.numel() * 4 + self.occupancy.numel() * 4
                   + self.scale.numel() * 4)


@dataclasses.dataclass(frozen=True)
class PaddedBlockSparseTernary:
    """Block-sparse ternary weights with a static-shaped (padded) pool."""

    sign_pool: torch.Tensor     # uint8 (max_live, bk//8, bm)
    zero_pool: torch.Tensor     # uint8 (max_live, bk//8, bm)  pad slots = 0xFF
    block_map: torch.Tensor     # int32 (kb, mb)  pool slot, -1 = dead block
    occupancy: torch.Tensor | None   # f32 (kb, mb) nonzero fraction per block;
    #                                  None when rebuilt from ``sp_*`` leaves
    scale: torch.Tensor         # f32   (M,) per-output-channel dequant scale
    kids: torch.Tensor          # int32 (mb, s_steps) live k-block ids per strip
    slots: torch.Tensor         # int32 (mb, s_steps) matching pool slots
    counts: torch.Tensor        # int32 (mb,) live blocks per strip
    shape: tuple                # logical (K, M)
    block_shape: tuple          # (bk, bm)
    max_live: int               # pool slots (>= any slice's live blocks)
    s_steps: int                # per-strip walk extent (>= any strip's count)

    @property
    def grid(self) -> tuple:
        bk, bm = self.block_shape
        return (-(-self.shape[0] // bk), -(-self.shape[1] // bm))

    @property
    def n_live(self) -> torch.Tensor:
        """Live blocks: data here (the static shape is ``max_live``)."""
        return torch.sum(self.counts)

    def nbytes(self) -> int:
        """Device bytes: the pools at ``max_live`` slots, the schedule, the
        block map, the occupancy grid and the scales."""
        bk, bm = self.block_shape
        kb, mb = self.grid
        pool = 2 * self.max_live * (bk // ternary.PACK) * bm
        sched = (2 * mb * self.s_steps + mb) * 4        # kids + slots + counts
        return int(pool + sched + kb * mb * 4 * 2 + self.scale.numel() * 4)


def _pack_blocks(bits: torch.Tensor) -> torch.Tensor:
    """(G, bk, bm) {0,1} -> (G, bk//8, bm) uint8, LSB-first along bk."""
    g, bk, bm = bits.shape
    b = bits.to(torch.uint8).reshape(g, bk // ternary.PACK, ternary.PACK, bm)
    shifts = torch.arange(ternary.PACK, dtype=torch.uint8,
                          device=bits.device).reshape(1, 1, -1, 1)
    return torch.sum(b << shifts, dim=2).to(torch.uint8)


def _blocks(t: torch.Tensor, bk: int, bm: int) -> torch.Tensor:
    """Ternary (K, M) -> int8 (kb*mb, bk, bm) blocks in raster order, the
    ragged edges zero-padded."""
    if t.ndim != 2:
        raise ValueError(f"expected a 2-D (K, M) matrix, got {tuple(t.shape)}")
    if bk % ternary.PACK != 0:
        raise ValueError(f"bk={bk} must be a multiple of {ternary.PACK}")
    k, m = t.shape
    kb, mb = -(-k // bk), -(-m // bm)
    t8 = torch.nn.functional.pad(t.to(torch.int8), (0, mb * bm - m, 0, kb * bk - k))
    return t8.reshape(kb, bk, mb, bm).permute(0, 2, 1, 3).reshape(kb * mb, bk, bm)


def _schedule(block_map: torch.Tensor, width: int):
    """Per-m-strip walk of a block map: ``(kids, slots, counts)`` with the
    live k-blocks of strip j first in k order, padded with (kid 0, slot 0)
    past ``counts[j]`` to ``width`` steps."""
    lv = block_map >= 0
    counts = torch.sum(lv, dim=0).to(torch.int32)
    order = torch.argsort((~lv).to(torch.int32), dim=0, stable=True)[:width]
    valid = torch.arange(width, device=block_map.device)[None, :] < counts[:, None]
    kids = torch.where(valid, order.T, 0).to(torch.int32)
    slots = torch.where(valid, torch.take_along_dim(block_map, order, dim=0).T, 0)
    return kids.contiguous(), slots.to(torch.int32).contiguous(), counts


def _decode(sign_pool, zero_pool, block_map, shape, block_shape) -> torch.Tensor:
    """A pool decoded back through its block map -> dense (K, M) int8."""
    bk, bm = block_shape
    kb, mb = block_map.shape
    slot = torch.clamp(block_map, 0, sign_pool.shape[0] - 1).long()
    sp = sign_pool[slot].permute(2, 0, 1, 3)        # (bk//8, kb, mb, bm)
    zp = zero_pool[slot].permute(2, 0, 1, 3)
    vals = ternary.decode_planes(sp, zp, bk).permute(1, 2, 0, 3)   # (kb, mb, bk, bm)
    vals = vals * (block_map >= 0)[:, :, None, None].to(torch.int8)
    return vals.permute(0, 2, 1, 3).reshape(kb * bk, mb * bm)[:shape[0], :shape[1]]


def _scale_or_ones(scale, m: int, dev) -> torch.Tensor:
    if scale is None:
        return torch.ones((m,), dtype=torch.float32, device=dev)
    return scale.to(torch.float32)


# ---------------------------------------------------------------------------
# Compacted pool
# ---------------------------------------------------------------------------

def from_ternary(t: torch.Tensor, scale: torch.Tensor | None = None,
                 bk: int = DEFAULT_BK, bm: int = DEFAULT_BM,
                 occupancy: torch.Tensor | None = None) -> BlockSparseTernary:
    """Dense ternary (K, M) -> compacted pool, on ``t``'s device.

    ``occupancy`` takes a (kb, mb) grid already measured
    (``stats.block_occupancy``), so ``bitlinear.freeze`` counts once.
    """
    flat = _blocks(t, bk, bm)
    dev = flat.device
    k, m = t.shape
    kb, mb = -(-k // bk), -(-m // bm)
    if occupancy is None:
        occ = (torch.count_nonzero(flat, dim=(1, 2)).to(torch.float32)
               / (bk * bm)).reshape(kb, mb)
    else:
        occ = torch.as_tensor(occupancy, dtype=torch.float32, device=dev)
        if tuple(occ.shape) != (kb, mb):
            raise ValueError(f"occupancy grid {tuple(occ.shape)} != block grid {(kb, mb)}")
    live = (occ > 0.0).reshape(-1)
    n_live = int(live.sum())
    block_map = torch.full((kb * mb,), -1, dtype=torch.int32, device=dev)
    block_map[live] = torch.arange(n_live, dtype=torch.int32, device=dev)
    block_map = block_map.reshape(kb, mb)
    if n_live:
        sign_pool = _pack_blocks(flat[live] < 0)
        zero_pool = _pack_blocks(flat[live] == 0)
    else:
        # One slot that decodes to an all-zero block: no pool is 0-sized.
        sign_pool = torch.zeros((1, bk // ternary.PACK, bm), dtype=torch.uint8, device=dev)
        zero_pool = torch.full_like(sign_pool, 0xFF)
    s_max = int(torch.sum(block_map >= 0, dim=0).max()) if mb else 0
    kids, slots, counts = _schedule(block_map, max(s_max, 1))
    return BlockSparseTernary(
        sign_pool=sign_pool, zero_pool=zero_pool, block_map=block_map, occupancy=occ,
        scale=_scale_or_ones(scale, m, dev), shape=(k, m), block_shape=(bk, bm),
        n_live=n_live, kids=kids, slots=slots, counts=counts, s_max=s_max)


def from_packed(tw: ternary.TernaryWeights, bk: int = DEFAULT_BK,
                bm: int = DEFAULT_BM) -> BlockSparseTernary:
    """``TernaryWeights`` (dense 2-bit planes) -> compacted pool."""
    return from_ternary(ternary.unpack(tw), tw.scale, bk=bk, bm=bm)


def to_ternary(bst: BlockSparseTernary) -> torch.Tensor:
    """Exact inverse of :func:`from_ternary` -> dense (K, M) int8."""
    return _decode(bst.sign_pool, bst.zero_pool, bst.block_map, bst.shape,
                   bst.block_shape)


def to_packed(bst: BlockSparseTernary) -> ternary.TernaryWeights:
    """Exact round-trip back to dense ``TernaryWeights``."""
    return ternary.pack(to_ternary(bst).to(torch.float32), bst.scale)


def strip_schedule(bst: BlockSparseTernary):
    """The kernel's walk ``(kids, slots, counts, s_max)``, built once at
    construction."""
    return bst.kids, bst.slots, bst.counts, bst.s_max


# ---------------------------------------------------------------------------
# Padded pool
# ---------------------------------------------------------------------------

def pad_from_ternary(t: torch.Tensor, scale: torch.Tensor | None = None,
                     bk: int = DEFAULT_BK, bm: int = DEFAULT_BM,
                     max_live: int | None = None,
                     s_steps: int | None = None) -> PaddedBlockSparseTernary:
    """Dense ternary (K, M) -> padded-pool block-sparse format, on ``t``'s
    device.

    ``max_live`` defaults to the full block grid and ``s_steps`` to
    ``K/bk``, both lossless.  Tighter bounds that do not hold raise.
    """
    flat = _blocks(t, bk, bm)
    dev = flat.device
    k, m = t.shape
    kb, mb = -(-k // bk), -(-m // bm)
    grid_n = kb * mb
    max_live = max(int(grid_n if max_live is None else max_live), 1)
    s_steps = max(min(int(kb if s_steps is None else s_steps), kb), 1)

    occ = torch.count_nonzero(flat, dim=(1, 2)).to(torch.float32) / (bk * bm)
    live = occ > 0.0
    n_live = int(live.sum())
    if n_live > max_live:
        raise ValueError(f"max_live={max_live} < {n_live} live blocks; pass a "
                         "larger pool (or None for the full grid)")
    slot = torch.cumsum(live.to(torch.int32), dim=0) - 1   # raster-order slot id
    # Live blocks take their slots; pad slots keep sign 0 / zero 0xFF, so
    # they decode to all-zero blocks.
    k8 = bk // ternary.PACK
    sign_pool = torch.zeros((max_live, k8, bm), dtype=torch.uint8, device=dev)
    zero_pool = torch.full((max_live, k8, bm), 0xFF, dtype=torch.uint8, device=dev)
    sign_pool[slot[live].long()] = _pack_blocks(flat[live] < 0)
    zero_pool[slot[live].long()] = _pack_blocks(flat[live] == 0)

    block_map = torch.where(live, slot, -1).reshape(kb, mb).to(torch.int32)
    s_max = int(torch.sum(block_map >= 0, dim=0).max()) if mb else 0
    if s_max > s_steps:
        raise ValueError(f"s_steps={s_steps} < {s_max} live blocks in the fullest "
                         "strip; pass a larger s_steps (or None for K/bk)")
    kids, slots, counts = _schedule(block_map, s_steps)
    return PaddedBlockSparseTernary(
        sign_pool=sign_pool, zero_pool=zero_pool, block_map=block_map.contiguous(),
        occupancy=occ.reshape(kb, mb), scale=_scale_or_ones(scale, m, dev),
        kids=kids, slots=slots, counts=counts, shape=(k, m), block_shape=(bk, bm),
        max_live=max_live, s_steps=s_steps)


def pad_from_packed(tw: ternary.TernaryWeights, bk: int = DEFAULT_BK,
                    bm: int = DEFAULT_BM, max_live: int | None = None,
                    s_steps: int | None = None) -> PaddedBlockSparseTernary:
    """``TernaryWeights`` (dense 2-bit planes) -> padded pool."""
    return pad_from_ternary(ternary.unpack(tw), tw.scale, bk=bk, bm=bm,
                            max_live=max_live, s_steps=s_steps)


def pad_pool(bst: BlockSparseTernary, max_live: int | None = None,
             s_steps: int | None = None) -> PaddedBlockSparseTernary:
    """Compacted -> padded; the sizes default to this matrix's own
    ``n_live``/``s_max`` (the tightest lossless pool)."""
    bk, bm = bst.block_shape
    return pad_from_ternary(
        to_ternary(bst), bst.scale, bk=bk, bm=bm,
        max_live=max(bst.n_live, 1) if max_live is None else max_live,
        s_steps=max(bst.s_max, 1) if s_steps is None else s_steps)


def compact(pbst: PaddedBlockSparseTernary) -> BlockSparseTernary:
    """Padded -> compacted (exact)."""
    bk, bm = pbst.block_shape
    return from_ternary(padded_to_ternary(pbst), pbst.scale, bk=bk, bm=bm)


def padded_to_ternary(pbst: PaddedBlockSparseTernary) -> torch.Tensor:
    """Exact inverse of :func:`pad_from_ternary` -> dense (K, M) int8,
    decoded from the pool through the block map."""
    return _decode(pbst.sign_pool, pbst.zero_pool, pbst.block_map, pbst.shape,
                   pbst.block_shape)


def padded_to_packed(pbst: PaddedBlockSparseTernary) -> ternary.TernaryWeights:
    """Exact round-trip back to dense ``TernaryWeights``."""
    return ternary.pack(padded_to_ternary(pbst).to(torch.float32), pbst.scale)


def random_block_sparse_ternary(generator: torch.Generator, shape: tuple,
                                bk: int = DEFAULT_BK, bm: int = DEFAULT_BM,
                                p_zero_block: float = 0.5,
                                p_zero: float = 1.0 / 3.0) -> torch.Tensor:
    """Random ternary int8 matrix with whole (bk, bm) blocks zeroed with
    probability ``p_zero_block`` and the usual unstructured ``p_zero`` zeros
    in the rest, on ``generator``'s device."""
    k, m = shape
    kb, mb = -(-k // bk), -(-m // bm)
    dead = torch.rand((kb, mb), generator=generator, device=generator.device) < p_zero_block
    mask = (~dead).to(torch.int8).repeat_interleave(bk, 0).repeat_interleave(bm, 1)
    t = ternary.random_ternary(generator, (kb * bk, mb * bm), p_zero)
    return (t * mask)[:k, :m]
