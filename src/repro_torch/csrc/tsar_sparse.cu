// Block-sparse packed-ternary matmul for Hopper (sm_90a): two entry points
// over one kernel template.
//
// Replaces the TPU kernels of src/repro/kernels/tsar_sparse.py:
//   tsar_sparse_padded_matmul_packed (pallas_call at :223, body _kernel_2d at
//     :135), the padded pool of the serving step, with the activation skip;
//   tsar_sparse_matmul_packed (pallas_call at :122, body _kernel at :46), the
//     compacted pool of core/bitlinear, without it.
// With the weights tiled into (bk, bm) blocks and only the live ones kept in
// a pool,
//
//   y[n, j*bm + c] = (f32(sum_{s < counts[j]} sum_{r < bk}
//                          a_q[n, kids[j,s]*bk + r] * t_{slots[j,s]}[r, c])
//                     * a_scale[n]) * w_scale[j*bm + c]
//
// where t_slot = (1 - 2*sign) * (1 - zero) is decoded from the pool's two
// LSB-first uint8 planes, (bk/8, bm) bytes each.  The int32 sum skips dead
// weight blocks (strip j walks only its counts[j] live steps) and, in the
// padded entry point, activation sub-tiles that are all zero; both skips
// drop exact int32 zeros, so the result is bit-identical to tsar_matmul on
// the decoded matrix and to the plain version
// (repro_torch/kernels/tsar_sparse.py).  The two pool formats differ only
// in size (max_live slots and an s_steps walk, or max(n_live, 1) slots and a
// max(s_max, 1) walk); the kernel reads s_steps only as the row stride of
// kids/slots, so one body serves both.
//
// What bounds it: the serving step calls it at N = 4 or 20 rows, so it is
// bound by the plane bytes of the live blocks, sum_j counts[j] * 2 * bk/8 *
// bm, read once.  The design is tsar_matmul.cu's, carried over to a walk of
// live blocks whose length and addresses are data:
//
// * One launch per call.  A CTA owns 64 columns of one m-strip and up to 32
//   rows (grid x = strips x column tiles, grid y = 32-row tiles).  A strip's
//   live walk is split over the CTAs of one thread-block cluster (gridDim.z
//   = cluster size, 1..8): rank r takes the walk's steps r, r + C, r + 2C,
//   ... below counts[j], so the ranks' shares differ by one block at most.
//   The split is computed on the device from counts[j]: the host reads only
//   shapes (launch_config), never the schedule, so a call is one node of a
//   CUDA graph.  Each CTA stores each slice of its int32 partial tile into
//   the shared memory of the CTA that owns the slice; after one cluster
//   barrier each owner sums its inbox and writes f32 out.  No workspace,
//   memset, epilogue kernel or atomic; integer sums are exact in any order.
// * Live blocks staged by TMA.  The ring's unit is a chunk: at most 256 k
//   (32 plane rows) of one live block, one copy per plane (box (min(bk/8,
//   32) rows, 64 columns) at pool row slots[j,s] * bk/8, a 2-D view of the
//   pool) and one per 128-byte activation box (8 * n_tiles rows at k
//   kids[j,s] * bk), counted on the stage's mbarrier.  A stage holds
//   stage_chunks chunks; every stage of the ring is requested before the
//   first is consumed.  launch_config puts a CTA's whole share of the walk
//   in one stage where it fits (half an SM's shared memory), so the CTA
//   waits once: on this card the chunks land close together, and a wait
//   per chunk measured slower (PERF.md).  TMA fills zeros past the matrix:
//   rows past N, k past Kp and columns past bm.
// * Tensor cores.  As in tsar_matmul.cu: y^T = T^T a_q^T with
//   mma.sync.m16n8k32 s8 x s8 -> s32, the A operand decoded in registers
//   from the staged plane bytes, the B operand one 64-bit load of a staged
//   activation row per lane.  The 8 warps split a stage's (chunk, 32-k
//   step) pairs, kept as counters: the decode and the mma are most of a
//   step's instructions, and a CTA's steps are issue-bound.  The warps'
//   partial tiles are summed in warp order.
//
// The traps of a data-dependent walk, and what this kernel does about each:
//
// 1. TMA coordinates are data.  Warp 0 holds a window of its CTA's walk
//    entries (kid, slot) in shared memory, loaded with one round of global
//    reads (at the start, beside counts[j]; again only after kWindow
//    blocks), and its lanes read their coordinates from it before they
//    issue a chunk's copies: one round trip before the first copy.
// 2. No early return inside a cluster.  Every CTA runs to both cluster
//    barriers, including a rank with no step and a strip with counts[j] ==
//    0; such a CTA's partials are zero and a strip with no live block writes
//    0 * a_scale * w_scale, bit-equal to the plain version.
// 3. Plane rows past a block.  A chunk's plane box can reach past its block
//    (bk/8 not a multiple of 32, or of 4): those rows belong to the next
//    pool slot.  A lane whose plane row is past the block's rows decodes
//    zero weights instead of reading it, so activations past the block (the
//    next k-block's, fetched by the same box) meet zeros.
// 4. The activation skip (padded entry point only).  Each warp votes on the
//    activation operand of its 32-k step before it decodes and multiplies:
//    an all-zero operand adds exact int32 zeros, so the warp skips that
//    step, a finer skip than the TPU kernel's (bn, bk) tiles.  The plane
//    bytes are copied either way (every copy is requested up front); the
//    vote costs a few instructions a step.
// 5. TMA alignment.  Every box starts 16-byte aligned, at a row start and
//    at its k offset kids[j,s] * bk: the wrapper
//    (kernels/tsar_sparse.py::pad_for_tma) pads blocks whose bk or bm is
//    not a multiple of 16 (zero weights, zero activations) and copies a
//    misaligned tensor; the serving shapes (bk = bm = 256) copy nothing.
//
// Thread layout: each warp covers the CTA's 64 columns as four m16 tiles.
// Lane (g = lane / 4, q = lane % 4) owns columns 8g..8g+7: for m-tile j,
// fragment row g is column 8g + 2j and row g + 8 is column 8g + 2j + 1.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "tsar_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;              // columns per CTA
constexpr int kRedRow = kBM + 1;     // words per row of a staged partial tile
constexpr int kKStep = 32;           // k per mma
constexpr int kChunkRows = 32;       // plane rows (256 k) of a chunk at most
constexpr int kActBox = 128;         // k bytes of one activation TMA box (swizzle 128B)
constexpr int kMaxStages = 16;
constexpr int kWindow = 64;          // walk entries in warp 0's window
constexpr int kMaxSmem = 227 * 1024;

// Offsets from a 1024-byte-aligned base (the swizzled activation boxes need
// it); the allocation carries 1024 bytes of slack to reach that base.
struct Layout {
  int scales;      // kBM w_scale + 32 a_scale floats, after kMaxStages mbarriers
  int window;      // kWindow (kid, slot) pairs
  int inbox;       // the cluster peers' partials of this CTA's slice of its tile
  int ring;
  int box_rows;    // plane rows of one chunk's copy: min(bk/8, kChunkRows)
  int act_boxes;   // activation boxes per chunk: [npad rows][128 k bytes] each
  int plane;       // bytes of one plane's copy, box_rows x kBM, 128-byte rounded
  int chunk;       // act boxes, then the sign plane, then the zero plane, 1 KiB-rounded
  int stage;       // stage_chunks chunks
  int total;       // the ring, or once consumed the kWarps int32 partial tiles over it
};

__host__ __device__ inline Layout layout(int n_tiles, int bk, int stages, int stage_chunks) {
  Layout l;
  l.scales = kMaxStages * 8;
  l.window = l.scales + (kBM + 32) * 4;
  l.inbox = 1024;
  // The inbox holds csize slices of at most ceil(rows * kBM / csize)
  // elements: rows * kBM + 7 words at most (csize <= 8).
  l.ring = l.inbox + ((8 * n_tiles * kBM + 8) * 4 + 1023) / 1024 * 1024;
  l.box_rows = bk / 8 < kChunkRows ? bk / 8 : kChunkRows;
  l.act_boxes = (8 * l.box_rows + kActBox - 1) / kActBox;
  l.plane = (l.box_rows * kBM + 127) / 128 * 128;
  l.chunk = (l.act_boxes * 8 * n_tiles * kActBox + 2 * l.plane + 1023) / 1024 * 1024;
  l.stage = stage_chunks * l.chunk;
  const int ring = stages * l.stage;
  const int red = kWarps * 8 * n_tiles * kRedRow * 4;
  l.total = l.ring + (ring > red ? ring : red) + 1024;
  return l;
}

// Byte offset of activation (row r, chunk k byte o) in a chunk: 128-byte
// boxes of npad rows, 16-byte chunks XOR-swizzled by row as TMA's
// SWIZZLE_128B writes them, so a warp's B loads hit distinct banks.
__device__ __forceinline__ int act_offset(int npad, int r, int o) {
  return (o / kActBox) * npad * kActBox + r * kActBox +
         ((((o % kActBox) / 16) ^ (r % 8)) * 16) + o % 16;
}

// tsar::decode4 with the planes combined by one multiply-add: a negative
// weight is nonzero, so 0x01 + 0xFE fills its byte without a carry.
__device__ __forceinline__ int32_t decode4(uint32_t nz_nib, uint32_t neg_nib) {
  return static_cast<int32_t>(tsar::spread4(neg_nib) * 0xFEu + tsar::spread4(nz_nib));
}

template <int NT, bool kSkipZeroActs>
__global__ void __launch_bounds__(kThreads)
tsar_sparse_kernel(const __grid_constant__ CUtensorMap sign_map,  // (slots * bk/8, bm) uint8
                   const __grid_constant__ CUtensorMap zero_map,  // (slots * bk/8, bm) uint8
                   const __grid_constant__ CUtensorMap act_map,   // (N, Kp) int8
                   const int32_t* __restrict__ kids,       // (mb, s_steps)
                   const int32_t* __restrict__ slots,      // (mb, s_steps)
                   const int32_t* __restrict__ counts,     // (mb,)
                   const float* __restrict__ a_scale,      // (N,)
                   const float* __restrict__ w_scale,      // (mb * bm,)
                   float* __restrict__ out,                // (N, mb * bm)
                   int n, int bk, int bm, int mb, int s_steps, int tiles_per_strip,
                   int stages, int stage_chunks) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - tsar::smem_addr(smem_raw) % 1024) % 1024);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const Layout l = layout(NT, bk, stages, stage_chunks);
  constexpr int npad = 8 * NT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int strip = blockIdx.x / tiles_per_strip;
  const int col0 = (blockIdx.x % tiles_per_strip) * kBM;   // first column within the strip
  const int row0 = blockIdx.y * 32;
  const int mp = mb * bm;
  const int rows8 = bk / 8;
  const int parts = (rows8 + kChunkRows - 1) / kChunkRows;  // chunks per block
  const int chunk_steps = (l.box_rows + 3) / 4;              // 32-k steps per chunk
  const int32_t* kid_row = kids + (size_t)strip * s_steps;
  const int32_t* slot_row = slots + (size_t)strip * s_steps;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + l.scales);   // w_scale[strip*bm + col0 ..+kBM)
  float* s_a = s_w + kBM;                                     // a_scale[row0 ..+32)
  int2* window = reinterpret_cast<int2*>(smem + l.window);
  uint8_t* ring = smem + l.ring;

  // Warp 0's window: this rank's walk entries [base, base + kWindow), entry
  // i being step rank + i * csize.  Entries up to s_steps are read whatever
  // counts[j] says (the rows are s_steps long), so the first window's reads
  // need not wait for the count.
  int win_base = 0;
  auto load_window = [&](int base) {
    int2 v[kWindow / 32];                    // every read in flight before the first store
#pragma unroll
    for (int i = 0; i < kWindow / 32; ++i) {
      const int s = rank + (base + lane + 32 * i) * csize;
      v[i] = s < s_steps ? make_int2(kid_row[s], slot_row[s]) : make_int2(0, 0);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kWindow / 32; ++i) window[lane + 32 * i] = v[i];
    __syncwarp();
    win_base = base;
  };

  // Cluster barrier phase 1 (arrive now, wait before the first remote
  // store): every CTA of the cluster has started.
  tsar::cluster_arrive_relaxed();
  const int count = counts[strip];           // read beside the window, not after it
  if (warp == 0) load_window(0);
  const int mine = count > rank ? (count - rank + csize - 1) / csize : 0;
  const int chunks = mine * parts;
  const int n_stages = (chunks + stage_chunks - 1) / stage_chunks;
  if (tid == 0) {
    for (int b = 0; b < stages; ++b) tsar::mbar_init(bars + b, 1);
    tsar::mbar_init_fence();
  }
  __syncthreads();

  // Stage st holds chunks [st * stage_chunks, ...) of this rank's walk.  The
  // lanes of warp 0 issue the copies (lanes 0-1 the planes, 2.. the
  // activation boxes of each chunk), counted on the stage's mbarrier.
  auto fill = [&](int st) {
    uint8_t* stage = ring + (st % stages) * l.stage;
    uint64_t* bar = bars + st % stages;
    const int c0 = st * stage_chunks;
    const int here = min(stage_chunks, chunks - c0);
    const int act_bytes = l.act_boxes * npad * kActBox;
    if (lane == 0) tsar::mbar_expect_tx(bar, here * (act_bytes + 2 * l.box_rows * kBM));
    __syncwarp();
    for (int i = 0; i < here; ++i) {
      const int b = (c0 + i) / parts;        // block of this rank's walk
      const int part = (c0 + i) % parts;     // 256-k chunk of that block
      if (b >= win_base + kWindow) load_window(b);
      const int2 e = window[b - win_base];   // (kid, slot)
      uint8_t* ch = stage + i * l.chunk;
      if (lane < 2) {
        tsar::tma_load_2d(ch + act_bytes + lane * l.plane, lane ? &zero_map : &sign_map,
                          col0, e.y * rows8 + part * kChunkRows, bar);
      } else if (lane - 2 < l.act_boxes) {
        const int box = lane - 2;
        tsar::tma_load_2d(ch + box * npad * kActBox, &act_map,
                          e.x * bk + part * kChunkRows * 8 + box * kActBox, row0, bar);
      }
    }
  };
  // Every stage of the ring is requested before the first is consumed.
  if (warp == 0) {
    const int first = min(stages, n_stages);
    for (int st = 0; st < first; ++st) fill(st);
  }

  // The epilogue's scales, read while the copies are in flight.
  if (tid < kBM) {
    s_w[tid] = col0 + tid < bm ? w_scale[strip * bm + col0 + tid] : 0.f;
  } else if (tid < kBM + 32) {
    s_a[tid - kBM] = row0 + tid - kBM < n ? a_scale[row0 + tid - kBM] : 0.f;
  }

  int32_t acc[4][NT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0;

  // The fragment k order of tsar_matmul.cu: lane (g, q) feeds k 8q..8q+3 of
  // a 32-k step as fragment k 4q..4q+3 and k 8q+4..8q+7 as 16+4q.., so its
  // A registers come from the two nibbles of one plane byte (byte row q of
  // the step) and its B registers are one 64-bit load.
  for (int st = 0; st < n_stages; ++st) {
    tsar::mbar_wait(bars + st % stages, (st / stages) & 1);
    const uint8_t* stage = ring + (st % stages) * l.stage;
    const int c0 = st * stage_chunks;
    const int here = min(stage_chunks, chunks - c0);
    // This warp's (chunk i, step s) pairs of the stage, e = i * chunk_steps +
    // s = warp, warp + kWarps, ..., kept as counters (no division a step).
    int i = warp / chunk_steps;
    int s = warp % chunk_steps;
    int part = (c0 + i) % parts;             // 256-k chunk of its block
    while (i < here) {
      const uint8_t* ch = stage + i * l.chunk;
      uint2 b[NT];
      uint32_t nonzero = 0;
      const int boff = act_offset(npad, g, s * kKStep + 8 * q);
#pragma unroll
      for (int t = 0; t < NT; ++t) {         // rows 8t + g: 8 rows further
        b[t] = *reinterpret_cast<const uint2*>(ch + boff + 8 * t * kActBox);
        nonzero |= b[t].x | b[t].y;
      }
      // An all-zero activation operand adds exact zeros (trap 4).
      if (!kSkipZeroActs || __any_sync(0xffffffffu, nonzero != 0)) {
        // This lane's plane row, and the rows of the block in this chunk
        // (trap 3): past them the weights are zero.
        const int row = s * (kKStep / 8) + q;
        const uint8_t* planes = ch + l.act_boxes * npad * kActBox;
        uint2 sv = make_uint2(0u, 0u);
        uint2 zv = make_uint2(~0u, ~0u);
        if (row < rows8 - part * kChunkRows) {
          sv = *reinterpret_cast<const uint2*>(planes + row * kBM + 8 * g);
          zv = *reinterpret_cast<const uint2*>(planes + l.plane + row * kBM + 8 * g);
        }
        const uint32_t nzw[2] = {~zv.x, ~zv.y};
        const uint32_t negw[2] = {sv.x & nzw[0], sv.y & nzw[1]};
        int32_t a[4][4];
#pragma unroll
        for (int col = 0; col < 8; ++col) {  // column 8g+col: m-tile col/2, row g or g+8
          const uint32_t nz = nzw[col / 4] >> (8 * (col % 4));
          const uint32_t neg = negw[col / 4] >> (8 * (col % 4));
          a[col / 2][col % 2] = decode4(nz & 0xFu, neg & 0xFu);
          a[col / 2][2 + col % 2] = decode4((nz >> 4) & 0xFu, (neg >> 4) & 0xFu);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tsar::mma_s8_16832(acc[j][t], a[j], static_cast<int32_t>(b[t].x),
                               static_cast<int32_t>(b[t].y));
      }
      for (s += kWarps; s >= chunk_steps; s -= chunk_steps) {
        ++i;
        if (++part == parts) part = 0;
      }
    }
    if (st + stages < n_stages) {
      __syncthreads();                       // stage st % stages is consumed
      if (warp == 0) fill(st + stages);
    }
  }

  // Warp partials -> red[warp][token][col] (rows of kRedRow words, so that
  // a warp's stores spread over the banks), then summed in warp order.
  __syncthreads();                           // every warp is done with the ring
  int32_t* red = reinterpret_cast<int32_t*>(ring);
  constexpr int tile = npad * kRedRow;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      int32_t* base = red + warp * tile + (8 * t + 2 * q) * kRedRow + 8 * g + 2 * j;
      *reinterpret_cast<int2*>(base) = make_int2(acc[j][t][0], acc[j][t][2]);
      base[kRedRow] = acc[j][t][1];          // odd row: 4-byte aligned only
      base[kRedRow + 1] = acc[j][t][3];
    }
  __syncthreads();

  // The walk's split across the cluster: CTA `rank` finishes the slice
  // [rank * per, (rank + 1) * per) of the tile (element e = row * kBM +
  // col).  Every CTA, with or without live steps (trap 2), stores its warp
  // sums of each element into the owner's inbox through distributed shared
  // memory; after one cluster barrier each owner sums its inbox in rank
  // order and no CTA touches a peer again.  A cluster of one skips the inbox.
  const int rows_here = min(32, n - row0);
  const int elems = rows_here * kBM;
  const int per = (elems + csize - 1) / csize;
  auto warp_sum = [&](int e) {
    const int32_t* p = red + (e / kBM) * kRedRow + e % kBM;
    int32_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += p[w * tile];
    return v;
  };
  int32_t* inbox = reinterpret_cast<int32_t*>(smem + l.inbox);
  tsar::cluster_wait();
  if (csize > 1) {
    for (int e = tid; e < elems; e += kThreads) {
      const int p = e / per;
      cluster.map_shared_rank(inbox, p)[rank * per + e - p * per] = warp_sum(e);
    }
    tsar::cluster_arrive_release();
    tsar::cluster_wait();
  }
  const int owned = min(per, elems - rank * per);
  for (int i = tid; i < owned; i += kThreads) {
    const int e = rank * per + i;
    const int r = e / kBM;
    const int col = e % kBM;
    if (col0 + col >= bm) continue;
    int32_t v = 0;
    if (csize > 1) {
      for (int p = 0; p < csize; ++p) v += inbox[p * per + i];
    } else {
      v = warp_sum(e);
    }
    out[(size_t)(row0 + r) * mp + strip * bm + col0 + col] =
        __fmul_rn(__fmul_rn(static_cast<float>(v), s_a[r]), s_w[col]);
  }
}

template <int NT, bool kSkipZeroActs>
cudaError_t launch(const CUtensorMap& sm, const CUtensorMap& zm, const CUtensorMap& am,
                   const int32_t* kids, const int32_t* slots, const int32_t* counts,
                   const float* a_scale, const float* w_scale, float* out, int n, int bk,
                   int bm, int mb, int s_steps, int cluster, int stages, int stage_chunks,
                   int smem, cudaStream_t stream) {
  auto kernel = tsar_sparse_kernel<NT, kSkipZeroActs>;
  // The opt-in above 48 KiB of shared memory holds for one device: made
  // once per device for this instance.
  constexpr int kDevices = 64;
  static bool smem_raised[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices || !smem_raised[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < kDevices) smem_raised[dev] = true;
  }
  const int tiles_per_strip = (bm + kBM - 1) / kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mb * tiles_per_strip, (n + 31) / 32, cluster);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, sm, zm, am, kids, slots, counts, a_scale, w_scale,
                            out, n, bk, bm, mb, s_steps, tiles_per_strip, stages,
                            stage_chunks);
}

template <bool kSkipZeroActs>
int run(const void* a_q, const void* a_scale, const void* sign_pool, const void* zero_pool,
        const void* kids, const void* slots, const void* counts, const void* w_scale,
        void* out, int n, int kp, int bk, int bm, int mb, int s_steps, int pool_slots,
        int cluster, int n_tiles, int stages, int stage_chunks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || mb <= 0 || s_steps <= 0 || pool_slots <= 0 || bk <= 0 || bk % 16 ||
      kp % bk || bm <= 0 || bm % 16 || cluster < 1 || cluster > 8 ||
      n_tiles < 1 || n_tiles > 4 || 8 * n_tiles < (n < 32 ? n : 32) || stages < 1 ||
      stages > kMaxStages || stage_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n_tiles, bk, stages, stage_chunks);
  if (l.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(sign_pool) |
                         reinterpret_cast<uintptr_t>(zero_pool) |
                         reinterpret_cast<uintptr_t>(a_q);
  if (ptrs % 16) return static_cast<int>(cudaErrorInvalidValue);
  // The pools as 2-D (slots * bk/8, bm) byte matrices: a block's plane rows
  // are rows slot * bk/8 .. of it.
  CUtensorMap maps[3] = {};
  constexpr auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int pool_rows = pool_slots * (bk / 8);
  if (!(tsar::encode_2d(&maps[0], u8, 1, sign_pool, pool_rows, bm, l.box_rows, kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[1], u8, 1, zero_pool, pool_rows, bm, l.box_rows, kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[2], u8, 1, a_q, n, kp, 8 * n_tiles, kActBox,
                        CU_TENSOR_MAP_SWIZZLE_128B)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kd = static_cast<const int32_t*>(kids);
  auto* sl = static_cast<const int32_t*>(slots);
  auto* ct = static_cast<const int32_t*>(counts);
  auto* as = static_cast<const float*>(a_scale);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  cudaError_t e;
  switch (n_tiles) {
#define TSAR_CASE(NT)                                                                       \
    case NT:                                                                                \
      e = launch<NT, kSkipZeroActs>(maps[0], maps[1], maps[2], kd, sl, ct, as, wsc, o, n,  \
                                    bk, bm, mb, s_steps, cluster, stages, stage_chunks,    \
                                    l.total, stream);                                      \
      break;
    TSAR_CASE(1) TSAR_CASE(2) TSAR_CASE(3) TSAR_CASE(4)
#undef TSAR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each is one cluster launch and
// returns cudaGetLastError() (or the launch's own error); the caller raises
// when it is not cudaSuccess.  Neither allocates on the device.
//
// Preconditions, checked by the Python wrapper (which pads ragged shapes):
// kp == kb * bk with bk % 16 == 0 and bm % 16 == 0, every pointer on the
// current device, a_q and the pools 16-byte aligned (cudaErrorInvalidValue
// otherwise).  pool_slots is the pools' first dimension.  cluster (CTAs
// sharing a strip's walk, 1..8), n_tiles (8-row tiles of one 32-row CTA
// tile, 1..4), stages (1..16) and stage_chunks (chunks of <= 256 k of one
// live block per stage) come from
// kernels/tsar_sparse.py::launch_config.  The schedule comes from the
// pool's format: kids[j, s] < kb and slots[j, s] < pool_slots for s <
// counts[j] <= s_steps.
extern "C" int tsar_sparse_padded_matmul_packed(
    const void* a_q, const void* a_scale, const void* sign_pool, const void* zero_pool,
    const void* kids, const void* slots, const void* counts, const void* w_scale, void* out,
    int n, int kp, int bk, int bm, int mb, int s_steps, int pool_slots, int cluster,
    int n_tiles, int stages, int stage_chunks, void* stream_ptr) {
  return run<true>(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale, out, n,
                   kp, bk, bm, mb, s_steps, pool_slots, cluster, n_tiles, stages,
                   stage_chunks, stream_ptr);
}

extern "C" int tsar_sparse_matmul_packed(
    const void* a_q, const void* a_scale, const void* sign_pool, const void* zero_pool,
    const void* kids, const void* slots, const void* counts, const void* w_scale, void* out,
    int n, int kp, int bk, int bm, int mb, int s_steps, int pool_slots, int cluster,
    int n_tiles, int stages, int stage_chunks, void* stream_ptr) {
  return run<false>(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale, out,
                    n, kp, bk, bm, mb, s_steps, pool_slots, cluster, n_tiles, stages,
                    stage_chunks, stream_ptr);
}
