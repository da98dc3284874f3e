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
// weight blocks (the strip walks only its counts[j] live steps) and, in the
// padded entry point, (BN, bk) activation tiles that are all zero; both skips
// drop exact int32 zeros, so the result is bit-identical to tsar_matmul on
// the decoded matrix and to the plain version
// (repro_torch/kernels/tsar_sparse.py).  The two pool formats differ only
// in size (max_live slots and an s_steps walk, or max(n_live, 1) slots and a
// max(s_max, 1) walk); the kernel reads s_steps only as the row stride of
// kids/slots, so one body serves both.
//
// What bounds it: the serving step calls it at N = 4 or 20 rows, so it is
// bound by the plane bytes of the live blocks, sum_j counts[j] * 2 * bk/8 *
// bm, read once.  The design:
//
// * a CTA owns one 64-column sub-tile of one m-strip and up to 32 rows, and
//   walks the strip's live steps as a data-dependent loop (no masked tail
//   steps);
// * there are only mb = 3..27 strips against 132 SMs, so the walk is split
//   across gridDim.z (CTA z takes steps z, z + Z, ...), and the partial int32
//   sums meet in a workspace through integer atomics, exact in any order;
// * per live step the activation k-slice is staged in shared memory; with
//   kSkipZeroActs, a block whose slice is all zero for the CTA's rows is
//   skipped before any pool byte is read (the activation-liveness map of the
//   padded TPU kernel, computed here from the staged tile instead of in a
//   separate pass);
// * the pool bytes are read coalesced along bm, decoded in registers with
//   the bit trick of tsar_common.cuh and consumed by __dp4a, as in
//   tsar_matmul.cu; the epilogue multiplies with __fmul_rn in the same order.
//
// wgmma, TMA and cp.async pipelining are left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "tsar_common.cuh"

namespace {

constexpr int kColsPerThread = 4;
constexpr int kColGroups = 16;                       // threads along a block's columns
constexpr int kKGroups = 16;                         // threads along K
constexpr int kThreads = kColGroups * kKGroups;      // 256
constexpr int kTileCols = kColGroups * kColsPerThread;   // 64 columns per CTA
constexpr int kKChunk = 256;                         // k values staged per pass

template <int BN, bool kSkipZeroActs>
__global__ void __launch_bounds__(kThreads)
tsar_sparse_kernel(const int8_t* __restrict__ a_q,        // (N, Kp)
                   const float* __restrict__ a_scale,     // (N,)
                   const uint8_t* __restrict__ sign_pool, // (max_live, bk/8, bm)
                   const uint8_t* __restrict__ zero_pool, // (max_live, bk/8, bm)
                   const int32_t* __restrict__ kids,      // (mb, s_steps)
                   const int32_t* __restrict__ slots,     // (mb, s_steps)
                   const int32_t* __restrict__ counts,    // (mb,)
                   const float* __restrict__ w_scale,     // (mb * bm,)
                   float* __restrict__ out,               // (N, mb * bm)
                   int32_t* __restrict__ ws,              // (N, mb * bm) when split
                   int n, int kp, int bk, int bm, int mb, int s_steps,
                   int tiles_per_strip) {
  __shared__ __align__(8) int32_t act[BN][kKChunk / 4];
  __shared__ int32_t red[BN][kTileCols];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  const int strip = blockIdx.x / tiles_per_strip;
  const int c0 = (blockIdx.x % tiles_per_strip) * kTileCols;   // first column in the block
  const int cl = c0 + cg * kColsPerThread;                     // this thread's columns
  const int n0 = blockIdx.y * BN;
  const int mp = mb * bm;
  const int rows8 = bk / 8;
  const int count = counts[strip];
  const bool split = gridDim.z > 1;
  // A split CTA past the strip's live steps adds nothing to the workspace.
  if (split && static_cast<int>(blockIdx.z) >= count) return;
  const bool col_ok = cl < bm;   // bm % 4 == 0, so cl + 3 < bm too

  for (int i = tid; i < BN * kTileCols; i += kThreads) red[i / kTileCols][i % kTileCols] = 0;

  int32_t acc[BN][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BN; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0;

  const int words_per_row = kp / 4;
  for (int s = blockIdx.z; s < count; s += gridDim.z) {
    const int kid = kids[(size_t)strip * s_steps + s];
    const size_t slot = static_cast<size_t>(slots[(size_t)strip * s_steps + s]);
    const uint8_t* sp = sign_pool + slot * rows8 * bm;
    const uint8_t* zp = zero_pool + slot * rows8 * bm;
    for (int k0 = 0; k0 < bk; k0 += kKChunk) {
      const int chunk = min(kKChunk, bk - k0);   // a multiple of 8
      const int cw = chunk / 4;
      __syncthreads();
      // Stage the (BN, chunk) activation tile; rows past N are zero.
      int nz = 0;
      for (int i = tid; i < BN * cw; i += kThreads) {
        const int r = i / cw;
        const int w = i % cw;
        const int row = n0 + r;
        int32_t v = 0;
        if (row < n)
          v = reinterpret_cast<const int32_t*>(a_q)[(size_t)row * words_per_row +
                                                    (kid * bk + k0) / 4 + w];
        act[r][w] = v;
        nz |= v;
      }
      if constexpr (kSkipZeroActs) {
        // Barrier and vote in one: an all-zero activation tile adds exact
        // int32 zeros, so its pool bytes are never read.
        if (!__syncthreads_or(nz != 0)) continue;
      } else {
        __syncthreads();
      }
      if (!col_ok) continue;
#pragma unroll 2
      for (int jr = kg; jr < chunk / 8; jr += kKGroups) {
        const size_t off = (size_t)(k0 / 8 + jr) * bm + cl;
        const uint32_t sw = __ldg(reinterpret_cast<const uint32_t*>(sp + off));
        const uint32_t zw = __ldg(reinterpret_cast<const uint32_t*>(zp + off));
        const uint32_t nzw = ~zw;
        const uint32_t negw = sw & nzw;
        int32_t w_lo[kColsPerThread], w_hi[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const uint32_t nzb = (nzw >> (8 * c)) & 0xFFu;
          const uint32_t negb = (negw >> (8 * c)) & 0xFFu;
          w_lo[c] = tsar::decode4(nzb & 0xFu, negb & 0xFu);
          w_hi[c] = tsar::decode4(nzb >> 4, negb >> 4);
        }
#pragma unroll
        for (int r = 0; r < BN; ++r) {
          const int2 a = *reinterpret_cast<const int2*>(&act[r][2 * jr]);
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            acc[r][c] = __dp4a(a.x, w_lo[c], acc[r][c]);
            acc[r][c] = __dp4a(a.y, w_hi[c], acc[r][c]);
          }
        }
      }
    }
  }

  // Combine the 16 k-groups in shared memory (integer adds: exact).
  __syncthreads();
  if (col_ok) {
#pragma unroll
    for (int r = 0; r < BN; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        atomicAdd(&red[r][cg * kColsPerThread + c], acc[r][c]);
  }
  __syncthreads();

  // A strip with counts[j] == 0 still writes 0 * scales here (or leaves its
  // zeroed workspace to the epilogue).
  for (int i = tid; i < BN * kTileCols; i += kThreads) {
    const int r = i / kTileCols;
    const int cb = c0 + i % kTileCols;
    const int row = n0 + r;
    if (row >= n || cb >= bm) continue;
    const int col = strip * bm + cb;
    const int32_t v = red[r][i % kTileCols];
    if (split) {
      atomicAdd(&ws[(size_t)row * mp + col], v);
    } else {
      out[(size_t)row * mp + col] =
          __fmul_rn(__fmul_rn(static_cast<float>(v), a_scale[row]), w_scale[col]);
    }
  }
}

template <int BN, bool kSkipZeroActs>
void launch(const int8_t* a_q, const float* a_scale, const uint8_t* sign_pool,
            const uint8_t* zero_pool, const int32_t* kids, const int32_t* slots,
            const int32_t* counts, const float* w_scale, float* out, int32_t* ws,
            int n, int kp, int bk, int bm, int mb, int s_steps, int splits,
            cudaStream_t stream) {
  const int tiles_per_strip = (bm + kTileCols - 1) / kTileCols;
  dim3 grid(mb * tiles_per_strip, (n + BN - 1) / BN, splits);
  tsar_sparse_kernel<BN, kSkipZeroActs><<<grid, kThreads, 0, stream>>>(
      a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale, out, ws,
      n, kp, bk, bm, mb, s_steps, tiles_per_strip);
}

template <bool kSkipZeroActs>
int run(const void* a_q, const void* a_scale, const void* sign_pool,
        const void* zero_pool, const void* kids, const void* slots,
        const void* counts, const void* w_scale, void* out, void* ws, int n,
        int kp, int bk, int bm, int mb, int s_steps, int bn, int splits,
        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* a = static_cast<const int8_t*>(a_q);
  auto* as = static_cast<const float*>(a_scale);
  auto* sp = static_cast<const uint8_t*>(sign_pool);
  auto* zp = static_cast<const uint8_t*>(zero_pool);
  auto* kd = static_cast<const int32_t*>(kids);
  auto* sl = static_cast<const int32_t*>(slots);
  auto* ct = static_cast<const int32_t*>(counts);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int32_t*>(ws);
  const int mp = mb * bm;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(w, 0, sizeof(int32_t) * (size_t)n * mp, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  switch (bn) {
#define TSAR_CASE(B)                                                                \
    case B:                                                                         \
      launch<B, kSkipZeroActs>(a, as, sp, zp, kd, sl, ct, wsc, o, w, n, kp, bk, bm, \
                               mb, s_steps, splits, stream);                        \
      break;
    TSAR_CASE(4) TSAR_CASE(8) TSAR_CASE(12) TSAR_CASE(16)
    TSAR_CASE(20) TSAR_CASE(24) TSAR_CASE(28) TSAR_CASE(32)
#undef TSAR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) tsar::launch_epilogue(w, as, wsc, o, n, mp, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns cudaGetLastError()
// after its launches; the caller raises when it is not cudaSuccess.
//
// Preconditions, checked by the Python wrapper: kp == kb * bk with bk % 8 ==
// 0, bm % 4 == 0, every pointer on the current device, the pools 4-byte
// aligned, and ws pointing at an int32 (n, mb * bm) buffer when splits > 1.
// The schedule comes from the pool's format: kids[j, s] < kb and
// slots[j, s] < the pool's slots for s < counts[j] <= s_steps.
extern "C" int tsar_sparse_padded_matmul_packed(
    const void* a_q, const void* a_scale, const void* sign_pool,
    const void* zero_pool, const void* kids, const void* slots,
    const void* counts, const void* w_scale, void* out, void* ws, int n, int kp,
    int bk, int bm, int mb, int s_steps, int bn, int splits, void* stream_ptr) {
  return run<true>(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale,
                   out, ws, n, kp, bk, bm, mb, s_steps, bn, splits, stream_ptr);
}

extern "C" int tsar_sparse_matmul_packed(
    const void* a_q, const void* a_scale, const void* sign_pool,
    const void* zero_pool, const void* kids, const void* slots,
    const void* counts, const void* w_scale, void* out, void* ws, int n, int kp,
    int bk, int bm, int mb, int s_steps, int bn, int splits, void* stream_ptr) {
  return run<false>(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale,
                    out, ws, n, kp, bk, bm, mb, s_steps, bn, splits, stream_ptr);
}
