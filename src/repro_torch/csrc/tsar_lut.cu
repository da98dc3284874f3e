// Shared-LUT ternary matmul for Hopper (sm_90a): the paper's TLUT build and
// TGEMV gather.
//
// Replaces the TPU kernel src/repro/kernels/tsar_lut.py::tsar_lut_gemv
// (pallas_call at :96, body _kernel at :32).  For f32 activations a (N, K),
// K = blocks * c, and per-block weight encodings idx_pos / idx_zero (blocks,
// M) uint8 (bit i set iff w[b*c+i] is +1, resp. 0), it computes
//
//   S_b[n][p] = sum_i bit_i(p) * a[n, b*c + i]                (2^c entries)
//   y[n, m]   = (sum_b (2*S_b[n][idx_pos[b,m]] + S_b[n][idx_zero[b,m]])
//                - sum_k a[n, k]) * w_scale[m]
//
// in float32, within rtol 1e-4 / atol 2e-3 of the dense product (the
// reference's contract, tests/test_conformance.py); the plain version is
// repro_torch/core/lut.py::tsar_lut_matmul.  The TPU spells each gather as a
// one-hot matmul on its matrix unit; here it is a real table lookup.
//
// What bounds it: at N = 1 and 4 the index bytes, 2 * blocks * M (twice the
// 2-bit planes at c = 4); at N = 20 the lookups, 2 * N * blocks * M, at 32
// per SM clock at most (shuffles and shared-memory loads measured alike).
//
// The design, against the five causes that held the first kernel back (two
// warps per CTA, one 4-byte load in flight per thread, tables rebuilt
// serially per column tile, a serial per-row gather, a workspace and an
// epilogue node):
//
// * One launch per call.  The K splits of a column tile are the CTAs of one
//   thread-block cluster (gridDim.z = cluster size, 1..8).  Each CTA pushes
//   each slice of its f32 partial tile into the shared memory of the CTA that
//   owns the slice; after one cluster barrier the owner sums the partials in
//   rank order, scales and writes out.  No workspace, memset or epilogue
//   kernel, and the output is deterministic (every sum in a fixed order).
// * Bytes in flight.  A CTA copies its index tiles (stage_blocks x 128
//   columns, both arrays) and its activation rows (rt x stage_blocks*c
//   floats) into a ring of shared-memory stages with TMA, one mbarrier per
//   stage, and requests every stage before it consumes the first.  TMA needs
//   16-byte aligned rows: the wrapper pads M to 16 and blocks so that
//   blocks * c is a multiple of 4 (zero activations: any index adds 0).  TMA
//   fills zeros past the matrix (index 0 meets S[0] = 0).
// * Tables in registers, built once per warp, in parallel.  At c = 4 the 32
//   lanes of a warp hold two blocks' 16-entry tables for one row, lane
//   16*t + p holding S_{b+t}[p] (one 16-byte activation load and four FMAs);
//   c <= 5 likewise with 32 / 2^c blocks per warp, c > 5 with 2^c / 32
//   registers per lane.
// * Gathers without a per-row serial loop.  Each lane owns 4 adjacent
//   columns (one 32-bit index load per array and block) and reads S[idx] with
//   __shfl_sync from the lane that holds it: all 32 columns of a warp in one
//   instruction.  The 8 warps split the k-steps (and, above 16 rows, the rows
//   into two groups); their partials are summed in warp order.  A warp of at
//   most 4 rows interleaves their lookups.  The row sums come free:
//   S_b[2^c - 1] is the sum of block b's activations.
// * Enough lookups in flight.  One CTA's warps leave an SM's shuffle rate
//   unused (a CTA takes as long alone on its SM as beside a second one), so
//   two CTAs share an SM (at most 128 registers, half an SM's shared memory
//   each) and launch_config spreads the work over one wave of up to 2 x SMs
//   CTAs: column tiles x row tiles (rt rows each, fewer than N where that
//   shortens a CTA's work) x K splits (clusters of 1, 2, 4 or 8).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "tsar_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 128;              // columns per CTA, 4 per lane
constexpr int kMaxRows = 32;          // rows per CTA tile at most; more rows add grid rows
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round128(int x) { return (x + 127) / 128 * 128; }

// Offsets from a 128-byte-aligned base; the allocation carries 128 bytes of
// slack to reach it.
struct Layout {
  int inbox;       // the peers' partials of this CTA's slice (rt * kBM + 32 floats: >= one
                   // tile + cluster size - 1), after the mbarriers
  int ring;
  int idx_tile;    // bytes of one index tile in a stage: stage_blocks x kBM
  int stage;       // idx_pos tile, idx_zero tile, activation box [rt][stage_blocks*c]
  int total;       // the ring, or once consumed the warps' partial tiles over it
};

__host__ __device__ inline Layout layout(int c, int rt, int k_groups, int stages,
                                         int stage_blocks) {
  Layout l;
  l.inbox = kMaxStages * 8;
  l.ring = round128(l.inbox + (rt * kBM + 32) * 4);
  l.idx_tile = round128(stage_blocks * kBM);
  l.stage = 2 * l.idx_tile + round128(rt * stage_blocks * c * 4);
  const int ring = stages * l.stage;
  const int red = k_groups * rt * kBM * 4;
  l.total = l.ring + (ring > red ? ring : red) + 128;
  return l;
}

// Blocks whose tables one warp holds at once (kTables), and registers of
// table per lane (kRegs): 32 lanes hold 32 entries per register.
template <int C>
struct Tables {
  static constexpr int kEntries = 1 << C;
  static constexpr int kTables = C <= 5 ? 32 / kEntries : 1;
  static constexpr int kRegs = C <= 5 ? 1 : kEntries / 32;
};

// S[p] of the table whose register(s) `s` this warp holds (p already carries
// the table's lane offset when kRegs == 1).
template <int C>
__device__ __forceinline__ float lookup(const float (&s)[Tables<C>::kRegs], uint32_t p) {
  if constexpr (Tables<C>::kRegs == 1) {
    return __shfl_sync(0xffffffffu, s[0], static_cast<int>(p));
  } else {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < Tables<C>::kRegs; ++j) {
      const float x = __shfl_sync(0xffffffffu, s[j], static_cast<int>(p & 31u));
      v = (p >> 5) == static_cast<uint32_t>(j) ? x : v;
    }
    return v;
  }
}

template <int C, int RW>
__global__ void __launch_bounds__(kThreads, 2)
tsar_lut_kernel(const __grid_constant__ CUtensorMap pos_map,    // (blocks, Mp) uint8
                const __grid_constant__ CUtensorMap zero_map,   // (blocks, Mp) uint8
                const __grid_constant__ CUtensorMap act_map,    // (N, blocks*c) f32
                const float* __restrict__ w_scale,  // (>= m,)
                float* __restrict__ out,            // (N, m)
                int n, int blocks, int m, int rt, int row_groups, int blocks_per_split,
                int stages, int stage_blocks) {
  using T = Tables<C>;
  constexpr int kRows = RW <= 4 ? RW : 1;    // rows whose lookups a warp interleaves
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - tsar::smem_addr(smem_raw) % 128) % 128);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int k_groups = kWarps / row_groups;
  const Layout l = layout(C, rt, k_groups, stages, stage_blocks);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kg = warp % k_groups;             // this warp's share of the k-steps
  const int col0 = blockIdx.x * kBM;
  const int row0 = blockIdx.y * rt;
  const int rows_here = min(rt, n - row0);
  const int group_rows = (rt + row_groups - 1) / row_groups;
  const int r0 = (warp / k_groups) * group_rows;
  const int my_rows = max(0, min(group_rows, rows_here - r0));   // <= RW
  const int b_begin = rank * blocks_per_split;
  const int my_blocks = max(0, min(blocks_per_split, blocks - b_begin));
  const int my_steps = (my_blocks + T::kTables - 1) / T::kTables;
  const int stage_steps = stage_blocks / T::kTables;
  const int chunks = (my_blocks + stage_blocks - 1) / stage_blocks;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + l.ring;
  const int act_row = stage_blocks * C;       // floats per staged activation row

  auto fill = [&](int ch) {
    if (tid == 0) {
      uint8_t* st = ring + (ch % stages) * l.stage;
      uint64_t* bar = bars + ch % stages;
      const int b0 = b_begin + ch * stage_blocks;
      tsar::mbar_expect_tx(bar, 2 * stage_blocks * kBM + rt * act_row * 4);
      tsar::tma_load_2d(st, &pos_map, col0, b0, bar);
      tsar::tma_load_2d(st + l.idx_tile, &zero_map, col0, b0, bar);
      tsar::tma_load_2d(st + 2 * l.idx_tile, &act_map, b0 * C, row0, bar);
    }
  };
  // Cluster barrier phase 1 (arrive now, wait before the first remote
  // store): every CTA of the cluster has started.
  tsar::cluster_arrive_relaxed();
  if (tid == 0) {
    for (int b = 0; b < stages; ++b) tsar::mbar_init(bars + b, 1);
    tsar::mbar_init_fence();
  }
  __syncthreads();
  // Every stage of the ring is requested before the first is consumed.
  const int first = min(stages, chunks);
  for (int ch = 0; ch < first; ++ch) fill(ch);

  // This lane's table entries: entry e = lane % 2^c of block lane / 2^c
  // (kRegs == 1), or entries lane + 32 j of one block; bit i of e as 0 / 1.
  const int tab = T::kRegs == 1 ? lane / T::kEntries : 0;
  float bit[T::kRegs][C];
#pragma unroll
  for (int j = 0; j < T::kRegs; ++j) {
    const int e = T::kRegs == 1 ? lane % T::kEntries : lane + 32 * j;
#pragma unroll
    for (int i = 0; i < C; ++i) bit[j][i] = static_cast<float>((e >> i) & 1);
  }
  // Index bytes are masked below 2^c; table t's lane offset is OR-ed into each.
  constexpr uint32_t kIdxMask = (T::kEntries - 1) * 0x01010101u;

  float acc[RW][4];
  float tot[RW];                  // running S[2^c - 1]: the row sums of this warp's blocks
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    tot[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  for (int ch = 0; ch < chunks; ++ch) {
    tsar::mbar_wait(bars + ch % stages, (ch / stages) & 1);
    const uint8_t* st = ring + (ch % stages) * l.stage;
    const float* act = reinterpret_cast<const float*>(st + 2 * l.idx_tile);
    const int steps = min(stage_steps, my_steps - ch * stage_steps);
    for (int s = kg; s < steps; s += k_groups) {
      uint32_t pw[T::kTables], zw[T::kTables];
#pragma unroll
      for (int t = 0; t < T::kTables; ++t) {
        const int row = s * T::kTables + t;
        const uint32_t off = T::kRegs == 1 ? t * T::kEntries * 0x01010101u : 0u;
        pw[t] = (*reinterpret_cast<const uint32_t*>(st + row * kBM + 4 * lane) & kIdxMask) | off;
        zw[t] = (*reinterpret_cast<const uint32_t*>(st + l.idx_tile + row * kBM + 4 * lane) &
                 kIdxMask) | off;
      }
      // Rows in groups of kRows, independent work for the shuffles to
      // overlap; a group past the warp's last row repeats that row into
      // accumulators that are never written out.
#pragma unroll
      for (int r = 0; r < RW; r += kRows) {
        if (r >= my_rows) break;
        float sv[kRows][T::kRegs];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          // TLUT: this lane's entries of its block's table for one row.
          const int row = r0 + min(r + q, my_rows - 1);
          const float* a = act + row * act_row + (s * T::kTables + tab) * C;
          float av[C];
          if constexpr (C % 4 == 0) {
#pragma unroll
            for (int i = 0; i < C; i += 4) {
              const float4 v = *reinterpret_cast<const float4*>(a + i);
              av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < C; ++i) av[i] = a[i];
          }
#pragma unroll
          for (int j = 0; j < T::kRegs; ++j) {
            float v = bit[j][0] * av[0];
#pragma unroll
            for (int i = 1; i < C; ++i) v = __fmaf_rn(bit[j][i], av[i], v);
            sv[q][j] = v;
          }
          tot[r + q] += sv[q][T::kRegs - 1];
        }
        // TGEMV: every lane gathers its 4 columns from the warp's tables.
#pragma unroll
        for (int t = 0; t < T::kTables; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t ip = (pw[t] >> (8 * j)) & 0xFFu;
            const uint32_t iz = (zw[t] >> (8 * j)) & 0xFFu;
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
              const float sp = lookup<C>(sv[q], ip);
              const float sz = lookup<C>(sv[q], iz);
              acc[r + q][j] = __fmaf_rn(2.f, sp, acc[r + q][j]) + sz;
            }
          }
      }
    }
    if (ch + stages < chunks) {
      __syncthreads();                        // stage ch % stages is consumed
      fill(ch + stages);
    }
  }

  // Warp partials, less the warp's row sums, -> red[kg][row][col]; summed
  // in warp order below.
  __syncthreads();                            // every warp is done with the ring
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (r >= my_rows) break;
    float sum = 0.f;
    if constexpr (T::kRegs == 1) {
#pragma unroll
      for (int t = 0; t < T::kTables; ++t)
        sum += __shfl_sync(0xffffffffu, tot[r], t * T::kEntries + T::kEntries - 1);
    } else {
      sum = __shfl_sync(0xffffffffu, tot[r], 31);
    }
    *reinterpret_cast<float4*>(red + (kg * rt + r0 + r) * kBM + 4 * lane) =
        make_float4(acc[r][0] - sum, acc[r][1] - sum, acc[r][2] - sum, acc[r][3] - sum);
  }
  __syncthreads();

  // Split-K across the cluster: CTA `rank` finishes the slice
  // [rank * per, (rank + 1) * per) of the tile (element e = row * kBM + col).
  // Every CTA sums its warps' partials of each element and stores the sum
  // into the owner's inbox through distributed shared memory; after one
  // cluster barrier each owner sums its inbox in rank order and no CTA
  // touches a peer again.  A cluster of one skips the inbox.
  const int elems = rows_here * kBM;
  const int per = (elems + csize - 1) / csize;
  auto warp_sum = [&](int e) {
    float v = 0.f;
    for (int w = 0; w < k_groups; ++w) v += red[w * rt * kBM + e];
    return v;
  };
  float* inbox = reinterpret_cast<float*>(smem + l.inbox);
  tsar::cluster_wait();
  if (csize > 1) {
    for (int e = tid; e < elems; e += kThreads) {
      const int p = e / per;
      cluster.map_shared_rank(inbox, p)[rank * per + e - p * per] = warp_sum(e);
    }
    tsar::cluster_arrive_release();
    tsar::cluster_wait();
  }
  const int mine = min(per, elems - rank * per);
  for (int i = tid; i < mine; i += kThreads) {
    const int e = rank * per + i;
    const int col = col0 + e % kBM;
    if (col >= m) continue;
    float v = 0.f;
    if (csize > 1) {
      for (int p = 0; p < csize; ++p) v += inbox[p * per + i];
    } else {
      v = warp_sum(e);
    }
    out[(size_t)(row0 + e / kBM) * m + col] = v * __ldg(w_scale + col);
  }
}

template <int C, int RW>
cudaError_t launch(const CUtensorMap& pm, const CUtensorMap& zm, const CUtensorMap& am,
                   const float* w_scale, float* out, int n, int blocks, int mp, int m, int rt,
                   int row_groups, int splits, int blocks_per_split, int stages,
                   int stage_blocks, int smem, cudaStream_t stream) {
  auto kernel = tsar_lut_kernel<C, RW>;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((mp + kBM - 1) / kBM, (n + rt - 1) / rt, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, pm, zm, am, w_scale, out, n, blocks, m, rt,
                            row_groups, blocks_per_split, stages, stage_blocks);
}

}  // namespace

// Plain C entry point (bound with ctypes).  One cluster launch; returns
// cudaGetLastError() (or the launch's own error), and the caller raises when
// it is not cudaSuccess.  Allocates nothing on the device.
//
// Preconditions, checked here (cudaErrorInvalidValue otherwise) and by the
// Python wrapper (repro_torch/kernels/tsar_lut.py, which pads ragged
// shapes): 1 <= c <= 8; blocks * c a multiple of 4 and mp a multiple of 16,
// so that every TMA row is 16-byte aligned; m <= mp; a and the index arrays
// 16-byte aligned; every index byte < 2^c.  rt (rows per CTA tile, 1..32),
// rows_per_warp (1, 2, 4, 8 or 16 at c = 4; 4 or 16 otherwise), row_groups (1
// or 2), splits (the cluster size, 1..8), blocks_per_split, stages (1..8)
// and stage_blocks come from kernels/tsar_lut.py::launch_config.
extern "C" int tsar_lut_gemv(const void* a, const void* idx_pos, const void* idx_zero,
                             const void* w_scale, void* out, int n, int blocks, int mp,
                             int m, int c, int rt, int rows_per_warp, int row_groups, int splits,
                             int blocks_per_split, int stages, int stage_blocks,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (c < 1 || c > 8 || n <= 0 || blocks <= 0 || m <= 0 || mp % 16 || m > mp ||
      (blocks * c) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tables = c <= 5 ? 32 >> c : 1;
  const int granule = tables > 4 ? tables : 4;          // blocks: whole steps, 16-byte rows
  if (rt < 1 || rt > kMaxRows || rt > n || row_groups < 1 || row_groups > 2 ||
      (rt + row_groups - 1) / row_groups > rows_per_warp || splits < 1 || splits > 8 ||
      blocks_per_split < 1 || blocks_per_split % granule ||
      (splits - 1) * blocks_per_split >= blocks || splits * blocks_per_split < blocks ||
      stages < 1 || stages > kMaxStages || stage_blocks < 1 || stage_blocks % granule ||
      stage_blocks > 256 || stage_blocks * c > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = layout(c, rt, kWarps / row_groups, stages, stage_blocks).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(idx_pos) |
                         reinterpret_cast<uintptr_t>(idx_zero);
  if (ptrs % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3] = {};
  constexpr auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!(tsar::encode_2d(&maps[0], u8, 1, idx_pos, blocks, mp, stage_blocks, kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[1], u8, 1, idx_zero, blocks, mp, stage_blocks, kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, n, blocks * c, rt,
                        stage_blocks * c, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  cudaError_t e = cudaErrorInvalidValue;
#define TSAR_CASE(C, RW)                                                                      \
  if (c == C && rows_per_warp == RW)                                                          \
    e = launch<C, RW>(maps[0], maps[1], maps[2], wsc, o, n, blocks, mp, m, rt, row_groups,    \
                      splits, blocks_per_split, stages, stage_blocks, smem, stream);
  TSAR_CASE(4, 1) TSAR_CASE(4, 2) TSAR_CASE(4, 4) TSAR_CASE(4, 8) TSAR_CASE(4, 16)
  TSAR_CASE(1, 4) TSAR_CASE(1, 16) TSAR_CASE(2, 4) TSAR_CASE(2, 16)
  TSAR_CASE(3, 4) TSAR_CASE(3, 16) TSAR_CASE(5, 4) TSAR_CASE(5, 16)
  TSAR_CASE(6, 4) TSAR_CASE(6, 16) TSAR_CASE(7, 4) TSAR_CASE(7, 16)
  TSAR_CASE(8, 4) TSAR_CASE(8, 16)
#undef TSAR_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
