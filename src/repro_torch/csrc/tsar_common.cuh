// Pieces shared by the packed-ternary kernels (tsar_matmul.cu,
// tsar_sparse.cu): the in-register 2-bit plane decode and the split-K
// epilogue.  Each kernel library includes this header; the build hashes it
// with the source (repro_torch/kernels/_build.py), so editing it rebuilds both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tsar {

// 4-bit value -> one bit in the low bit of each byte (bit i -> byte i).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// Decode one nibble of the zero/sign planes into 4 packed int8 weights in
// {-1, 0, +1}: nonzero -> 0x01, negative -> 0xFF, zero -> 0x00.
__device__ __forceinline__ int32_t decode4(uint32_t nz_nib, uint32_t neg_nib) {
  return static_cast<int32_t>(spread4(nz_nib) | (spread4(neg_nib) * 0xFEu));
}

// out = (f32(ws) * a_scale[row]) * w_scale[col] over an (n, m) int32
// workspace that split CTAs summed into with integer atomics.
__global__ void epilogue_kernel(const int32_t* __restrict__ ws,
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

inline void launch_epilogue(const int32_t* ws, const float* a_scale,
                            const float* w_scale, float* out, int n, int m,
                            cudaStream_t stream) {
  const size_t total = (size_t)n * m;
  const int threads = 256;
  const int blocks = static_cast<int>(
      (total + threads - 1) / threads < 4096 ? (total + threads - 1) / threads : 4096);
  epilogue_kernel<<<blocks, threads, 0, stream>>>(ws, a_scale, w_scale, out, n, m);
}

}  // namespace tsar
