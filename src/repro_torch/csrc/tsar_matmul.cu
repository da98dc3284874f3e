// Packed-ternary BitLinear matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tsar_matmul.py::tsar_matmul_packed
// (pallas_call at :124, body _kernel at :41).  Computes
//
//   y[n, m] = (f32(sum_k a_q[n, k] * t[k, m]) * a_scale[n]) * w_scale[m]
//
// with t = (1 - 2*sign) * (1 - zero) decoded from two LSB-first uint8 bit
// planes of shape (K/8, M), int32 accumulation, and the epilogue multiplied
// in exactly that order, so the result is bit-identical to the plain
// PyTorch version (repro_torch/kernels/tsar_matmul.py::tsar_matmul_plain).
//
// What bounds it: the serving step calls it at N = 4 (pure decode) or 20
// (steps with prefill).  The work is 2*N*K*M int8 ops against K*M/4 plane
// bytes, at most 256 ops/byte for N <= 32, below the card's int8 ridge of
// about 590 ops/byte (1,979 TOP/s over 3.35 TB/s): the plane bytes bound it,
// and they are read exactly once.  Only the 2-bit planes cross device memory
// (the paper's central claim); no int8 weight matrix is ever written.
//
// The design, against the four causes that held the first (split-K
// __dp4a) kernel back:
//
// * One launch per call.  K is split over the CTAs of one thread-block
//   cluster (gridDim.z = cluster size, 1..8).  Each CTA stores each slice
//   of its int32 partial tile into the shared memory of the CTA that owns
//   the slice (distributed shared memory); after one cluster barrier each
//   CTA sums its slice, applies the epilogue and writes f32 out.  No
//   workspace, memset or epilogue kernel; integer sums are exact in any
//   order.  A cluster of one skips the exchange.
// * Bytes in flight.  A CTA copies its plane tiles and activation rows into
//   a ring of shared-memory stages with TMA (one copy per plane and per
//   128-byte activation box, counted on the stage's mbarrier; the hardware
//   fills zeros past the matrix), and requests every stage before it
//   consumes the first.  launch_config sizes the grid to one wave and the
//   ring to the CTA's whole k-range at the serving shapes, so the whole
//   matrix is requested at once.  TMA needs every row start 16-byte
//   aligned: the wrapper pads ragged M and K to multiples of 16 (the
//   serving shapes are, and copy nothing).
// * Tensor cores.  The product is taken transposed, y^T = T^T a_q^T, with
//   mma.sync.m16n8k32 s8 x s8 -> s32: the A operand (16 output columns x 32
//   k) is decoded in registers from the staged plane bytes, and one A
//   register (four k of one column) is exactly one nibble of one plane
//   byte, which tsar::decode4 turns into four int8 weights in the
//   fragment's byte order.  The B operand (32 k x 8 tokens) is one 64-bit
//   load of a staged activation row per lane; N is padded to whole
//   8-row n-tiles with zero rows (N = 4 -> 1, N = 20 -> 3), N > 32 runs as
//   a grid over 32-row tiles.  K past the matrix is zero in shared memory.
// * No atomics.  The 8 warps of a CTA split its k-steps; their partial
//   tiles are summed in warp order, then across the cluster as above.
//
// Thread layout: each warp covers the CTA's 64 columns as four m16 tiles.
// Lane (g = lane / 4, q = lane % 4) owns columns 8g..8g+7 of the tile: for
// m-tile j, fragment row g is column 8g + 2j and row g + 8 is column
// 8g + 2j + 1, so one 64-bit shared load per plane feeds all four m-tiles,
// and a warp's loads cover 256 contiguous bytes.

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
constexpr int kActBox = 128;         // k bytes of one activation TMA box (swizzle 128B)
constexpr int kMaxStages = 8;
constexpr int kInbox = 2048 + 1024;  // >= cluster size x slice of a 32 x kBM tile, 1 KiB-rounded
constexpr int kMaxSmem = 227 * 1024;

// Offsets from a 1024-byte-aligned base (the swizzled activation boxes need
// it); the allocation carries 1024 bytes of slack to reach that base.
struct Layout {
  int scales;        // kBM w_scale + 32 a_scale floats, after kMaxStages mbarriers
  int inbox;         // the cluster peers' partials of this CTA's slice of the tile
  int ring;
  int act_boxes;     // activation boxes per stage: [npad rows][128 k bytes] each
  int stage_plane;   // bytes of one plane in one stage: stage_steps*4 rows x kBM
  int stage;         // act boxes, then the sign plane, then the zero plane
  int total;         // the ring, or once consumed the kWarps int32 partial tiles over it
};

__host__ __device__ inline Layout layout(int n_tiles, int stages, int stage_steps) {
  Layout l;
  l.scales = kMaxStages * 8;
  l.inbox = 1024;
  l.ring = l.inbox + kInbox * 4;
  l.act_boxes = (stage_steps * kKStep + kActBox - 1) / kActBox;
  l.stage_plane = stage_steps * (kKStep / 8) * kBM;
  l.stage = (l.act_boxes * 8 * n_tiles * kActBox + 2 * l.stage_plane + 1023) / 1024 * 1024;
  const int ring = stages * l.stage;
  const int red = kWarps * 8 * n_tiles * kRedRow * 4;
  l.total = l.ring + (ring > red ? ring : red) + 1024;
  return l;
}

// Byte offset of activation (row r, stage k byte o) in a stage: 128-byte
// boxes of npad rows, 16-byte chunks XOR-swizzled by row as TMA's
// SWIZZLE_128B writes them, so a warp's B loads hit distinct banks.
__device__ __forceinline__ int act_offset(int npad, int r, int o) {
  return (o / kActBox) * npad * kActBox + r * kActBox +
         ((((o % kActBox) / 16) ^ (r % 8)) * 16) + o % 16;
}

// One TMA copy per plane and per activation box, issued by the lanes of
// warp 0 and counted on the stage's mbarrier.  TMA writes zeros outside the
// matrix (k past Kp, rows past N, columns past M): a zero plane row decodes
// to +1, and meets a zero activation.
template <int NPAD>
__device__ void fill_stage_tma(uint8_t* stage, const Layout& l, uint64_t* bar, int lane,
                               const CUtensorMap* sign_map, const CUtensorMap* zero_map,
                               const CUtensorMap* act_map, int row0, int col0, int k_step0) {
  if (lane == 0) tsar::mbar_expect_tx(bar, l.act_boxes * NPAD * kActBox + 2 * l.stage_plane);
  __syncwarp();
  uint8_t* planes = stage + l.act_boxes * NPAD * kActBox;
  if (lane < 2) {
    tsar::tma_load_2d(planes + lane * l.stage_plane, lane ? zero_map : sign_map, col0,
                      k_step0 * (kKStep / 8), bar);
  } else if (lane - 2 < l.act_boxes) {
    const int b = lane - 2;
    tsar::tma_load_2d(stage + b * NPAD * kActBox, act_map, k_step0 * kKStep + b * kActBox, row0,
                      bar);
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
tsar_matmul_kernel(const __grid_constant__ CUtensorMap sign_map,   // (Kp/8, M) uint8
                   const __grid_constant__ CUtensorMap zero_map,   // (Kp/8, M) uint8
                   const __grid_constant__ CUtensorMap act_map,    // (N, Kp) int8
                   const float* __restrict__ a_scale,   // (N,)
                   const float* __restrict__ w_scale,   // (M,)
                   float* __restrict__ out,             // (N, M)
                   int n, int kp, int m, int steps_per_split, int stages,
                   int stage_steps) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - tsar::smem_addr(smem_raw) % 1024) % 1024);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const Layout l = layout(NT, stages, stage_steps);
  constexpr int npad = 8 * NT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int col0 = blockIdx.x * kBM;
  const int row0 = blockIdx.y * 32;
  const int total_steps = (kp + kKStep - 1) / kKStep;
  const int step_begin = rank * steps_per_split;
  const int my_steps = max(0, min(steps_per_split, total_steps - step_begin));
  const int chunks = (my_steps + stage_steps - 1) / stage_steps;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + l.scales);   // w_scale[col0 ..+kBM)
  float* s_a = s_w + kBM;                                     // a_scale[row0 ..+32)
  uint8_t* ring = smem + l.ring;

  auto fill = [&](int c) {
    if (warp == 0)
      fill_stage_tma<npad>(ring + (c % stages) * l.stage, l, bars + c % stages, lane,
                           &sign_map, &zero_map, &act_map, row0, col0,
                           step_begin + c * stage_steps);
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
  for (int c = 0; c < first; ++c) fill(c);

  // The epilogue's scales, read while the copies are in flight.
  if (tid < kBM) {
    s_w[tid] = col0 + tid < m ? w_scale[col0 + tid] : 0.f;
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

  // The mma's k order is free as long as A and B agree: lane (g, q) feeds
  // k 8q..8q+3 of a 32-k step as fragment k 4q..4q+3 (registers a0/a1, b0)
  // and k 8q+4..8q+7 as 16+4q.. (a2/a3, b1).  So a lane's A registers come
  // from the low and high nibbles of one plane byte (byte row q of the
  // step), and its B registers are one 64-bit load.
  for (int c = 0; c < chunks; ++c) {
    tsar::mbar_wait(bars + c % stages, (c / stages) & 1);
    const uint8_t* st = ring + (c % stages) * l.stage;
    const uint8_t* planes = st + l.act_boxes * npad * kActBox;
    const int steps = min(stage_steps, my_steps - c * stage_steps);
    for (int s = warp; s < steps; s += kWarps) {
      const int row = s * (kKStep / 8) + q;
      const uint2 sv = *reinterpret_cast<const uint2*>(planes + row * kBM + 8 * g);
      const uint2 zv =
          *reinterpret_cast<const uint2*>(planes + l.stage_plane + row * kBM + 8 * g);
      const uint32_t nzw[2] = {~zv.x, ~zv.y};
      const uint32_t negw[2] = {sv.x & nzw[0], sv.y & nzw[1]};
      int32_t a[4][4];
#pragma unroll
      for (int col = 0; col < 8; ++col) {    // column 8g+col: m-tile col/2, row g or g+8
        const uint32_t nz = nzw[col / 4] >> (8 * (col % 4));
        const uint32_t neg = negw[col / 4] >> (8 * (col % 4));
        a[col / 2][col % 2] = tsar::decode4(nz & 0xFu, neg & 0xFu);
        a[col / 2][2 + col % 2] = tsar::decode4((nz >> 4) & 0xFu, (neg >> 4) & 0xFu);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            st + act_offset(npad, 8 * t + g, s * kKStep + 8 * q));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tsar::mma_s8_16832(acc[j][t], a[j], static_cast<int32_t>(b.x),
                             static_cast<int32_t>(b.y));
      }
    }
    if (c + stages < chunks) {
      __syncthreads();                       // stage c % stages is consumed
      fill(c + stages);
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

  // Split-K across the cluster: CTA `rank` finishes the slice
  // [rank * per, (rank + 1) * per) of the tile (element e = row * kBM + col).
  // Every CTA sums its warps' partials of each element and stores the sum
  // into the owner's inbox through distributed shared memory; after one
  // cluster barrier each owner sums its inbox in rank order (integer adds:
  // exact in any order) and no CTA touches a peer again.  A cluster of one
  // skips the inbox.
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
  const int mine = min(per, elems - rank * per);
  for (int i = tid; i < mine; i += kThreads) {
    const int e = rank * per + i;
    const int r = e / kBM;
    const int col = e % kBM;
    if (col0 + col >= m) continue;
    int32_t v = 0;
    if (csize > 1) {
      for (int p = 0; p < csize; ++p) v += inbox[p * per + i];
    } else {
      v = warp_sum(e);
    }
    out[(size_t)(row0 + r) * m + col0 + col] =
        __fmul_rn(__fmul_rn(static_cast<float>(v), s_a[r]), s_w[col]);
  }
}

template <int NT>
cudaError_t launch(const CUtensorMap& sm, const CUtensorMap& zm, const CUtensorMap& am,
                   const float* a_scale, const float* w_scale, float* out, int n, int kp,
                   int m, int splits, int steps_per_split, int stages, int stage_steps,
                   int smem, cudaStream_t stream) {
  auto kernel = tsar_matmul_kernel<NT>;
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
  cfg.gridDim = dim3((m + kBM - 1) / kBM, (n + 31) / 32, splits);
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
  return cudaLaunchKernelEx(&cfg, kernel, sm, zm, am, a_scale, w_scale, out, n, kp, m,
                            steps_per_split, stages, stage_steps);
}

}  // namespace

// Plain C entry point (bound with ctypes).  One cluster launch; returns
// cudaGetLastError() (or the launch's own error), and the caller raises when
// it is not cudaSuccess.  Allocates nothing on the device.
//
// Preconditions, checked by the Python wrapper (which pads ragged shapes):
// kp % 16 == 0 and m % 16 == 0, every pointer on the current device, a_q
// and the planes 16-byte aligned, so that every row a TMA box starts on is
// (cudaErrorInvalidValue otherwise).  splits (the cluster
// size, 1..8), n_tiles (8-row tiles of one 32-row CTA tile, 1..4), stages
// (1..8) and stage_steps (32-k steps per ring stage, 1..64) come from
// kernels/tsar_matmul.py::launch_config.
extern "C" int tsar_matmul_packed(const void* a_q, const void* a_scale, const void* sign,
                                  const void* zero, const void* w_scale, void* out, int n,
                                  int kp, int m, int splits, int n_tiles, int stages,
                                  int stage_steps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int total_steps = (kp + kKStep - 1) / kKStep;
  if (n <= 0 || kp <= 0 || m <= 0 || kp % 16 || m % 16 || splits < 1 || splits > 8 ||
      n_tiles < 1 || n_tiles > 4 || 8 * n_tiles < (n < 32 ? n : 32) || stages < 1 ||
      stages > kMaxStages || stage_steps < 1 || stage_steps > 64 || splits > total_steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (total_steps + splits - 1) / splits;
  if ((splits - 1) * per >= total_steps) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = layout(n_tiles, stages, stage_steps).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(sign) | reinterpret_cast<uintptr_t>(zero) |
                         reinterpret_cast<uintptr_t>(a_q);
  if (ptrs % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3] = {};
  constexpr auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!(tsar::encode_2d(&maps[0], u8, 1, sign, kp / 8, m, stage_steps * (kKStep / 8), kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[1], u8, 1, zero, kp / 8, m, stage_steps * (kKStep / 8), kBM,
                        CU_TENSOR_MAP_SWIZZLE_NONE) &&
        tsar::encode_2d(&maps[2], u8, 1, a_q, n, kp, 8 * n_tiles, kActBox,
                        CU_TENSOR_MAP_SWIZZLE_128B)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* as = static_cast<const float*>(a_scale);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  cudaError_t e;
  switch (n_tiles) {
#define TSAR_CASE(NT)                                                                        \
    case NT:                                                                                 \
      e = launch<NT>(maps[0], maps[1], maps[2], as, wsc, o, n, kp, m, splits, per, stages,   \
                     stage_steps, smem, stream);                                             \
      break;
    TSAR_CASE(1) TSAR_CASE(2) TSAR_CASE(3) TSAR_CASE(4)
#undef TSAR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
