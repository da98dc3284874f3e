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
// What bounds it: the index bytes, 2 * blocks * M (twice the 2-bit planes at
// c = 4), and at N = 20 the shared-memory lookups, 2 * N per (block,
// column).  The design:
//
// * a CTA owns 256 output columns (4 adjacent ones per thread, so a warp
//   reads 128 contiguous index bytes per array and block) and up to 32 rows;
// * per chunk of blocks the CTA stages the activations in shared memory and
//   builds S[r][b][0..2^c) there, so a warp's lookups (one block, one row)
//   hit at most 2^c words, one bank each, or broadcast: no bank conflicts at
//   c <= 5;
// * each thread keeps its (rows x 4) sums in registers and loads the next
//   block's index words while it gathers the current one's;
// * K is split over gridDim.z; each split subtracts the row sums of its own
//   k-range (the TPU kernel does so per tile) and writes an f32 workspace,
//   which an epilogue sums in split order and scales: deterministic.
//
// wgmma, TMA and cp.async pipelining are left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kColsPerThread = 4;
constexpr int kTileCols = kThreads * kColsPerThread;   // 256 columns per CTA

template <int BN>
__global__ void __launch_bounds__(kThreads)
tsar_lut_kernel(const float* __restrict__ a,           // (N, blocks*c)
                const uint8_t* __restrict__ idx_pos,   // (blocks, M)
                const uint8_t* __restrict__ idx_zero,  // (blocks, M)
                const float* __restrict__ w_scale,     // (M,)
                float* __restrict__ out,               // (N, M)
                float* __restrict__ ws,                // (splits, N, M) when split
                int n, int blocks, int m, int c, int cb, int blocks_per_split) {
  // Dynamic shared memory: lut[BN][cb][2^c], act[BN][cb*c], tot[BN].
  extern __shared__ float smem[];
  const int lut_w = 1 << c;
  float* lut = smem;
  float* act = lut + BN * cb * lut_w;
  float* tot = act + BN * cb * c;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int rows = min(BN, n - n0);
  const int col = blockIdx.x * kTileCols + tid * kColsPerThread;
  const bool col_ok = col < m;                 // m % 4 == 0, so col + 3 < m too
  const int b_begin = blockIdx.z * blocks_per_split;
  const int b_end = min(b_begin + blocks_per_split, blocks);
  const int k = blocks * c;

  if (tid < BN) tot[tid] = 0.f;

  float acc[BN][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BN; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

  for (int b0 = b_begin; b0 < b_end; b0 += cb) {
    const int nb = min(cb, b_end - b0);
    const int kw = nb * c;                     // k values in this chunk
    __syncthreads();
    // Stage the (BN, kw) activation slice; rows past N are zero.
    for (int i = tid; i < BN * kw; i += kThreads) {
      const int r = i / kw;
      const int j = i % kw;
      act[r * cb * c + j] = r < rows ? a[(size_t)(n0 + r) * k + (size_t)b0 * c + j] : 0.f;
    }
    __syncthreads();
    // TLUT: S[r][b][p] = sum_i bit_i(p) * a[r][b*c + i].
    for (int i = tid; i < BN * nb * lut_w; i += kThreads) {
      const int p = i % lut_w;
      const int b = (i / lut_w) % nb;
      const int r = i / (lut_w * nb);
      const float* ab = act + r * cb * c + b * c;
      float s = 0.f;
      for (int bit = 0; bit < c; ++bit)
        if ((p >> bit) & 1) s += ab[bit];
      lut[(r * cb + b) * lut_w + p] = s;
    }
    // Running row sums over this CTA's k-range, in k order.
    if (tid < rows) {
      float s = tot[tid];
      for (int j = 0; j < kw; ++j) s += act[tid * cb * c + j];
      tot[tid] = s;
    }
    __syncthreads();
    if (!col_ok) continue;
    // TGEMV: gather and accumulate, the next block's index words in flight.
    const size_t base = (size_t)b0 * m + col;
    uint32_t pw = __ldg(reinterpret_cast<const uint32_t*>(idx_pos + base));
    uint32_t zw = __ldg(reinterpret_cast<const uint32_t*>(idx_zero + base));
    for (int b = 0; b < nb; ++b) {
      uint32_t pw_next = 0, zw_next = 0;
      if (b + 1 < nb) {
        const size_t off = base + (size_t)(b + 1) * m;
        pw_next = __ldg(reinterpret_cast<const uint32_t*>(idx_pos + off));
        zw_next = __ldg(reinterpret_cast<const uint32_t*>(idx_zero + off));
      }
      int ip[kColsPerThread], iz[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        ip[j] = ((pw >> (8 * j)) & 0xFFu) & (lut_w - 1);
        iz[j] = ((zw >> (8 * j)) & 0xFFu) & (lut_w - 1);
      }
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        if (r < rows) {
          const float* s = lut + (r * cb + b) * lut_w;
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[r][j] += __fmaf_rn(2.f, s[ip[j]], s[iz[j]]);
        }
      }
      pw = pw_next;
      zw = zw_next;
    }
  }

  if (!col_ok) return;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int r = 0; r < BN; ++r) {
    if (r >= rows) break;
    const int row = n0 + r;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float v = acc[r][j] - tot[r];
      if (split)
        ws[((size_t)blockIdx.z * n + row) * m + col + j] = v;
      else
        out[(size_t)row * m + col + j] = v * w_scale[col + j];
    }
  }
}

// out[i] = (sum over splits, in order, of ws[z][i]) * w_scale[col].
__global__ void lut_epilogue_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ w_scale,
                                    float* __restrict__ out, int n, int m, int splits) {
  const size_t total = (size_t)n * m;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * total + i];
    out[i] = s * w_scale[i % m];
  }
}

template <int BN>
void launch(const float* a, const uint8_t* ip, const uint8_t* iz, const float* wsc,
            float* out, float* ws, int n, int blocks, int m, int c, int cb,
            int blocks_per_split, int splits, cudaStream_t stream) {
  dim3 grid((m + kTileCols - 1) / kTileCols, (n + BN - 1) / BN, splits);
  const size_t smem = sizeof(float) * ((size_t)BN * cb * (1 << c) + (size_t)BN * cb * c + BN);
  tsar_lut_kernel<BN><<<grid, kThreads, smem, stream>>>(
      a, ip, iz, wsc, out, ws, n, blocks, m, c, cb, blocks_per_split);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns cudaGetLastError() after
// the launches; the caller raises when it is not cudaSuccess.
//
// Preconditions, checked by the Python wrapper (repro_torch/kernels/
// tsar_lut.py): 1 <= c <= 8, m % 4 == 0, every pointer on the current
// device, the index arrays 4-byte aligned, every index byte < 2^c, cb chosen
// so the dynamic shared memory stays within 48 KiB, splits ==
// ceil(blocks / blocks_per_split), and ws an f32 (splits, n, m) buffer when
// splits > 1.
extern "C" int tsar_lut_gemv(const void* a, const void* idx_pos, const void* idx_zero,
                             const void* w_scale, void* out, void* ws, int n,
                             int blocks, int m, int c, int bn, int cb,
                             int blocks_per_split, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* af = static_cast<const float*>(a);
  auto* ip = static_cast<const uint8_t*>(idx_pos);
  auto* iz = static_cast<const uint8_t*>(idx_zero);
  auto* wsc = static_cast<const float*>(w_scale);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<float*>(ws);
  switch (bn) {
#define TSAR_CASE(B)                                                                 \
    case B:                                                                          \
      launch<B>(af, ip, iz, wsc, o, w, n, blocks, m, c, cb, blocks_per_split, splits, \
                stream);                                                             \
      break;
    TSAR_CASE(4) TSAR_CASE(8) TSAR_CASE(12) TSAR_CASE(16)
    TSAR_CASE(20) TSAR_CASE(24) TSAR_CASE(28) TSAR_CASE(32)
#undef TSAR_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const size_t total = (size_t)n * m;
    const int threads = 256;
    const int grid = static_cast<int>(
        (total + threads - 1) / threads < 4096 ? (total + threads - 1) / threads : 4096);
    lut_epilogue_kernel<<<grid, threads, 0, stream>>>(w, wsc, o, n, m, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
