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
// What bounds it: on the serving path N is 4 (pure decode) or 20 (steps
// with prefill), so the work is a skinny GEMM bound by the plane bytes,
// K*M/4, which are read exactly once.  The design keeps the 2-bit planes the
// only weight bytes that cross device memory (the paper's central claim):
//
// * each thread owns 4 adjacent output columns and reads one 32-bit word
//   (4 columns x 8 k) per plane per k-byte-row, so a warp's loads are
//   contiguous along M;
// * the CTA's k-slice of the int8 activations is staged in shared memory and
//   read back 8 k values at a time with broadcast 64-bit loads;
// * each plane byte pair is decoded in registers to 2 x 4 int8 weights and
//   consumed by __dp4a, so no int8 weight matrix is ever written;
// * 16 k-groups per CTA and a split of K across gridDim.z put enough loads in
//   flight for the skinny shapes; partial int32 sums are combined with
//   integer atomics, which are exact in any order, then one epilogue pass.
//
// wgmma, TMA and cp.async pipelining are left for a later change.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kColsPerThread = 4;
constexpr int kColGroups = 16;                       // threads along M
constexpr int kKGroups = 16;                         // threads along K
constexpr int kThreads = kColGroups * kKGroups;      // 256
constexpr int kBM = kColGroups * kColsPerThread;     // 64 columns per CTA
constexpr int kKChunk = 256;                         // k values staged per pass
constexpr int kRowsPerChunk = kKChunk / 8;           // plane byte rows per pass

// 4-bit value -> one bit in the low bit of each byte (bit i -> byte i).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// Decode one nibble of the zero/sign planes into 4 packed int8 weights in
// {-1, 0, +1}: nonzero -> 0x01, negative -> 0xFF, zero -> 0x00.
__device__ __forceinline__ int32_t decode4(uint32_t nz_nib, uint32_t neg_nib) {
  return static_cast<int32_t>(spread4(nz_nib) | (spread4(neg_nib) * 0xFEu));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
tsar_matmul_kernel(const int8_t* __restrict__ a_q,      // (N, Kp) int8
                   const float* __restrict__ a_scale,   // (N,)
                   const uint8_t* __restrict__ sign,    // (Kp/8, M)
                   const uint8_t* __restrict__ zero,    // (Kp/8, M)
                   const float* __restrict__ w_scale,   // (M,)
                   float* __restrict__ out,             // (N, M)
                   int32_t* __restrict__ ws,            // (N, M) when split
                   int n, int kp, int m, int chunks_per_split) {
  __shared__ __align__(8) int32_t act[BN][kKChunk / 4];
  __shared__ int32_t red[BN][kBM];

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int kg = tid / kColGroups;
  const int m0 = blockIdx.x * kBM + cg * kColsPerThread;
  const int n0 = blockIdx.y * BN;
  const int k8 = kp / 8;
  const int n_chunks = (kp + kKChunk - 1) / kKChunk;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  const bool col_ok = m0 < m;   // m % 4 == 0, so m0 + 3 < m too

  for (int i = tid; i < BN * kBM; i += kThreads) red[i / kBM][i % kBM] = 0;

  int32_t acc[BN][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BN; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0;

  const int words_per_row = kp / 4;
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int k0 = chunk * kKChunk;
    __syncthreads();
    // Stage the (BN, kKChunk) activation tile as 32-bit words; rows past N
    // and k past Kp are zero, so they add nothing.
    for (int i = tid; i < BN * (kKChunk / 4); i += kThreads) {
      const int r = i / (kKChunk / 4);
      const int w = i % (kKChunk / 4);
      const int row = n0 + r;
      const int word = k0 / 4 + w;
      int32_t v = 0;
      if (row < n && word < words_per_row)
        v = reinterpret_cast<const int32_t*>(a_q)[(size_t)row * words_per_row + word];
      act[r][w] = v;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 2
      for (int j = kg; j < kRowsPerChunk; j += kKGroups) {
        const int kb = k0 / 8 + j;
        if (kb >= k8) break;
        const size_t off = (size_t)kb * m + m0;
        const uint32_t sw = __ldg(reinterpret_cast<const uint32_t*>(sign + off));
        const uint32_t zw = __ldg(reinterpret_cast<const uint32_t*>(zero + off));
        const uint32_t nzw = ~zw;
        const uint32_t negw = sw & nzw;
        int32_t w_lo[kColsPerThread], w_hi[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const uint32_t nzb = (nzw >> (8 * c)) & 0xFFu;
          const uint32_t negb = (negw >> (8 * c)) & 0xFFu;
          w_lo[c] = decode4(nzb & 0xFu, negb & 0xFu);
          w_hi[c] = decode4(nzb >> 4, negb >> 4);
        }
#pragma unroll
        for (int r = 0; r < BN; ++r) {
          // k = 8j..8j+3 and 8j+4..8j+7 of row r, one 64-bit shared load.
          const int2 a = *reinterpret_cast<const int2*>(&act[r][2 * j]);
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

  const bool split = gridDim.z > 1;
  for (int i = tid; i < BN * kBM; i += kThreads) {
    const int r = i / kBM;
    const int col = blockIdx.x * kBM + i % kBM;
    const int row = n0 + r;
    if (row >= n || col >= m) continue;
    const int32_t v = red[r][i % kBM];
    if (split) {
      atomicAdd(&ws[(size_t)row * m + col], v);
    } else {
      out[(size_t)row * m + col] =
          __fmul_rn(__fmul_rn(static_cast<float>(v), a_scale[row]), w_scale[col]);
    }
  }
}

__global__ void tsar_epilogue_kernel(const int32_t* __restrict__ ws,
                                     const float* __restrict__ a_scale,
                                     const float* __restrict__ w_scale,
                                     float* __restrict__ out, int n, int m) {
  const size_t total = (size_t)n * m;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(i / m);
    const int col = static_cast<int>(i % m);
    out[i] = __fmul_rn(__fmul_rn(static_cast<float>(ws[i]), a_scale[row]),
                       w_scale[col]);
  }
}

template <int BN>
void launch(const int8_t* a_q, const float* a_scale, const uint8_t* sign,
            const uint8_t* zero, const float* w_scale, float* out, int32_t* ws,
            int n, int kp, int m, int splitk, int chunks_per_split,
            cudaStream_t stream) {
  dim3 grid((m + kBM - 1) / kBM, (n + BN - 1) / BN, splitk);
  tsar_matmul_kernel<BN><<<grid, kThreads, 0, stream>>>(
      a_q, a_scale, sign, zero, w_scale, out, ws, n, kp, m, chunks_per_split);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns cudaGetLastError() after
// the launches; the caller raises when it is not cudaSuccess.
//
// Preconditions, checked by the Python wrapper: kp % 8 == 0, m % 4 == 0,
// every pointer on the current device, the planes 4-byte aligned, and
// ws pointing at an int32 (n, m) buffer when splitk > 1.
extern "C" int tsar_matmul_packed(const void* a_q, const void* a_scale,
                                  const void* sign, const void* zero,
                                  const void* w_scale, void* out, void* ws,
                                  int n, int kp, int m, int bn, int splitk,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_chunks = (kp + kKChunk - 1) / kKChunk;
  const int per = (n_chunks + splitk - 1) / splitk;
  auto* a = static_cast<const int8_t*>(a_q);
  auto* as = static_cast<const float*>(a_scale);
  auto* s = static_cast<const uint8_t*>(sign);
  auto* z = static_cast<const uint8_t*>(zero);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int32_t*>(ws);
  if (splitk > 1) {
    cudaError_t e = cudaMemsetAsync(w, 0, sizeof(int32_t) * (size_t)n * m, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  switch (bn) {
#define TSAR_CASE(B) \
    case B: launch<B>(a, as, s, z, wsc, o, w, n, kp, m, splitk, per, stream); break;
    TSAR_CASE(4) TSAR_CASE(8) TSAR_CASE(12) TSAR_CASE(16)
    TSAR_CASE(20) TSAR_CASE(24) TSAR_CASE(28) TSAR_CASE(32)
#undef TSAR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splitk > 1) {
    const size_t total = (size_t)n * m;
    const int threads = 256;
    const int blocks = static_cast<int>(
        std::min<size_t>((total + threads - 1) / threads, 4096));
    tsar_epilogue_kernel<<<blocks, threads, 0, stream>>>(w, as, wsc, o, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
