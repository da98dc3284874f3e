"""Padded block-sparse ternary weight format (port of the padded half of
``repro/sparse/format.py``).

The ternary (K, M) matrix is tiled into (bk, bm) blocks, and only the live
(any-nonzero) blocks keep their 2-bit planes, in a pool padded to a static
``max_live`` slots; each m-strip gets a walk of its live k-blocks padded to a
static ``s_steps``.  Every tensor's shape depends only on ``(K, M, bk, bm,
max_live, s_steps)``, so stacked per-layer pools share one shape and ride a
params tree along the ``L`` axis, which is how the serving step carries them
(``sp_*`` leaves of ``models.layers.pack_linear``).

The pools are byte-equal to the reference's: raster-order slot ids, pad
slots with ``zero_pool`` = 0xFF (they decode to 0), ``kids``/``slots`` padded
with 0 past ``counts``.  The compacted ``BlockSparseTernary`` of the
reference (data-dependent pool size) is not ported yet: the serving step
never runs it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ternary
from repro_torch.plan.registry import SPARSE_BLOCK as DEFAULT_BLOCK_SHAPE

DEFAULT_BK, DEFAULT_BM = DEFAULT_BLOCK_SHAPE


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


def pad_from_ternary(t: torch.Tensor, scale: torch.Tensor | None = None,
                     bk: int = DEFAULT_BK, bm: int = DEFAULT_BM,
                     max_live: int | None = None,
                     s_steps: int | None = None) -> PaddedBlockSparseTernary:
    """Dense ternary (K, M) -> padded-pool block-sparse format, on ``t``'s
    device.

    ``max_live`` defaults to the full block grid and ``s_steps`` to
    ``K/bk``, both lossless.  Tighter bounds that do not hold raise (the
    reference raises too on concrete inputs; only its traced path truncates).
    """
    if t.ndim != 2:
        raise ValueError(f"pad_from_ternary expects (K, M), got {tuple(t.shape)}")
    if bk % ternary.PACK != 0:
        raise ValueError(f"bk={bk} must be a multiple of {ternary.PACK}")
    t8 = t.to(torch.int8)
    dev = t8.device
    k, m = t8.shape
    if scale is None:
        scale = torch.ones((m,), dtype=torch.float32, device=dev)
    kb, mb = -(-k // bk), -(-m // bm)
    grid_n = kb * mb
    max_live = max(int(grid_n if max_live is None else max_live), 1)
    s_steps = max(min(int(kb if s_steps is None else s_steps), kb), 1)

    t8 = torch.nn.functional.pad(t8, (0, mb * bm - m, 0, kb * bk - k))
    flat = t8.reshape(kb, bk, mb, bm).permute(0, 2, 1, 3).reshape(grid_n, bk, bm)
    occ = torch.count_nonzero(flat, dim=(1, 2)).to(torch.float32) / (bk * bm)
    live_raw = occ > 0.0
    slot = torch.cumsum(live_raw.to(torch.int32), dim=0) - 1   # raster-order slot id
    n_live = int(live_raw.sum())
    if n_live > max_live:
        raise ValueError(f"max_live={max_live} < {n_live} live blocks; pass a "
                         "larger pool (or None for the full grid)")
    live = live_raw

    # Live blocks take their slots; pad slots keep sign 0 / zero 0xFF, so
    # they decode to all-zero blocks.
    k8 = bk // ternary.PACK
    sign_pool = torch.zeros((max_live, k8, bm), dtype=torch.uint8, device=dev)
    zero_pool = torch.full((max_live, k8, bm), 0xFF, dtype=torch.uint8, device=dev)
    sign_pool[slot[live].long()] = _pack_blocks(flat[live] < 0)
    zero_pool[slot[live].long()] = _pack_blocks(flat[live] == 0)

    block_map = torch.where(live, slot, -1).reshape(kb, mb).to(torch.int32)
    lv = block_map >= 0
    counts_full = torch.sum(lv, dim=0).to(torch.int32)
    s_max = int(counts_full.max()) if mb else 0
    if s_max > s_steps:
        raise ValueError(f"s_steps={s_steps} < {s_max} live blocks in the fullest "
                         "strip; pass a larger s_steps (or None for K/bk)")
    # Strip-overflow blocks (rank >= s_steps within their column) would fall
    # out of the walk; kill them in the map too, as the reference does, so
    # every consumer decodes the same matrix.
    rank = torch.cumsum(lv.to(torch.int32), dim=0) - 1
    block_map = torch.where(lv & (rank >= s_steps), -1, block_map)
    lv = block_map >= 0
    # Live k-blocks first, k order kept by the stable sort; padded with
    # (kid 0, slot 0) past counts[j].
    order = torch.argsort((~lv).to(torch.int32), dim=0, stable=True)
    kids_full = order.T
    slots_full = torch.take_along_dim(block_map, order, dim=0).T
    counts = torch.minimum(counts_full, torch.tensor(s_steps, dtype=torch.int32,
                                                     device=dev))
    valid = torch.arange(s_steps, device=dev)[None, :] < counts[:, None]
    kids = torch.where(valid, kids_full[:, :s_steps], 0).to(torch.int32)
    slots = torch.where(valid, slots_full[:, :s_steps], 0).to(torch.int32)

    return PaddedBlockSparseTernary(
        sign_pool=sign_pool, zero_pool=zero_pool,
        block_map=block_map.contiguous(), occupancy=occ.reshape(kb, mb),
        scale=scale.to(torch.float32), kids=kids.contiguous(),
        slots=slots.contiguous(), counts=counts.contiguous(),
        shape=(k, m), block_shape=(bk, bm), max_live=max_live, s_steps=s_steps)


def padded_to_ternary(pbst: PaddedBlockSparseTernary) -> torch.Tensor:
    """Exact inverse of :func:`pad_from_ternary` -> dense (K, M) int8,
    decoded from the pool through the block map."""
    bk, bm = pbst.block_shape
    kb, mb = pbst.grid
    k, m = pbst.shape
    slot = torch.clamp(pbst.block_map, 0, pbst.max_live - 1).long()
    sp = pbst.sign_pool[slot].permute(2, 0, 1, 3)      # (bk//8, kb, mb, bm)
    zp = pbst.zero_pool[slot].permute(2, 0, 1, 3)
    vals = ternary.decode_planes(sp, zp, bk).permute(1, 2, 0, 3)   # (kb, mb, bk, bm)
    vals = vals * (pbst.block_map >= 0)[:, :, None, None].to(torch.int8)
    dense = vals.permute(0, 2, 1, 3).reshape(kb * bk, mb * bm)
    return dense[:k, :m]


def padded_to_packed(pbst: PaddedBlockSparseTernary) -> ternary.TernaryWeights:
    """Exact round-trip back to dense ``TernaryWeights``."""
    return ternary.pack(padded_to_ternary(pbst).to(torch.float32), pbst.scale)
