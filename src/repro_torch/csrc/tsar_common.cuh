// Pieces shared by the hand-written kernels (tsar_matmul.cu, tsar_sparse.cu,
// tsar_lut.cu): the in-register 2-bit plane decode, TMA / mbarrier /
// cluster barrier / int8 mma.sync wrappers, and the host-side 2-D tensor-map
// encoder.  Each kernel library includes this header; the build hashes it
// with the source (repro_torch/kernels/_build.py), so editing it rebuilds all
// three.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier (sm_90) completing TMA copies: init with one arrival; per phase
// one arrive.expect_tx of the phase's bytes, then the copies' complete_tx.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: the box of a 2-D tensor map at (x = inner coordinate, y) into this
// CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* smem, const void* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(smem)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// Thread-block cluster barrier in two halves (every thread of every CTA).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// c += a * b on the int8 tensor cores: a is 16x32 (row), b 32x8 (col), c
// 16x8 int32, in the PTX fragment layouts of mma.m16n8k32.
__device__ __forceinline__ void mma_s8_16832(int32_t (&c)[4], const int32_t (&a)[4],
                                             int32_t b0, int32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cuTensorMapEncodeTiled, looked up in libcuda through the CUDA runtime
// (nothing to link).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D tensor map over (rows, cols) elements of `elem_bytes` each,
// row-major at `base` with a row stride of `cols` elements, copied in boxes
// of (box_rows, box_cols).  TMA fills zeros outside the matrix.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* base, int rows, int cols, int box_rows, int box_cols,
                      CUtensorMapSwizzle swizzle) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tsar
