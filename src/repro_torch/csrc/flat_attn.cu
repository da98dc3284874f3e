// Float64 attention core of the flat serving step for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes this step in plain JAX
// (repro/models/layers.py, the flat branch of attention), and the port's
// plain version is repro_torch/models/layers.py::_flat_context.  That plain
// version scores every query of a flat step against every slot's key rows
// and masks out the other slots' rows (kslot == slot): a decode step of 48
// slots at 2,048 positions writes a 48 x 20 x 98,304 float64 score tensor and
// makes five full passes over it a layer (scale, mask, softmax, weighted
// sum), and each op is a launch of its own.  This kernel is one launch a
// layer, and each query reads only its own slot's live key and value rows.
//
// What it computes, for the T packed query rows q (1, T, H, Dh) float32 over
// the updated cache view ck, cv (B, Vtok, Hk, Dh) (float32 or bfloat16), with
// G = H / Hk query heads per KV head (head h reads KV head h / G):
//
//   row t with slot[t] < B attends over view rows slot[t], positions
//   0..pos[t] (and only positions > pos[t] - window where window > 0);
//   s = q . k / sqrt(Dh), then tanh(s / cap) * cap where cap > 0;
//   ctx = sum_k softmax(s)_k v_k, stored as float32 (rounded once) or as
//   float64 (for the caller to round once to another type);
//   rows with slot[t] outside [0, B) (padding) get zeros.
//
// Scores, softmax and the weighted sum are float64 (DFMA), as in the plain
// version: see models/layers.py::attention for why.  The softmax is the
// online (running-max) form over blocks of BK keys.
//
// Determinism: every sum has one fixed order (a score's dot over d in order,
// a block's max and sum through one shuffle tree, the weighted sum over keys
// in order, blocks in order), with no atomics and no split of a row's keys
// across CTAs, so two runs give the same bits.  Key blocks start at absolute
// multiples of BK, and a block in which a row has no valid key leaves that
// row's running max, sum and accumulator exactly as they were: a row's result
// does not depend on which other rows share its CTA, so a token's context has
// the same bits in a decode step and in a prompt-carrying step.
//
// What bounds it on the card: at a decode step (one row per slot) the live
// key and value rows, read once from device memory, Vlive x Hk x Dh x 2
// elements a layer (~78 MB at 48 slots of ~317 live positions, bitnet-2b-4t:
// ~23 us at 3.35 TB/s); on a prompt chunk the float64 FMAs, 4 x rows x H x
// keys x Dh a layer, at 67 TFLOP/s.  The design:
//
// * One CTA per (tile of rows, KV head).  A tile is up to kMaxQ / G
//   consecutive rows of one slot (the flat plan packs a slot's rows
//   together), cut at multiples of that count; the G query heads of the GQA
//   group and the tile's rows share every K/V tile the CTA loads.  The grid
//   is (T, Hk): the CTA of a row that does not start a tile returns at once.
// * K and V tiles of BK rows are copied to shared memory with cp.async,
//   double-buffered, so the next block's bytes are in flight while this one
//   is scored.  Keys past the tile's last position are zero-filled.
// * Scores: a thread per (key, query group) holds its query dots in
//   registers, reads its key row 16 bytes at a time (row stride padded by
//   16 bytes: no bank conflicts) and the queries (float64 in shared memory)
//   as broadcasts.  Weighted sum: a thread per (d, query group) keeps its
//   float64 accumulators in registers, reading two probabilities per load.
// * No T x Vtok tensor exists anywhere; the kernel allocates nothing.
//   Two CTAs share an SM at Dh <= 128 (~108 KB of shared memory each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 32;     // query vectors (rows x G) per CTA
constexpr int kStages = 2;

__host__ __device__ constexpr size_t round16(size_t x) { return (x + 15) / 16 * 16; }

template <int DH>
struct Shape {
  static constexpr int BK = 4096 / DH < 32 ? 4096 / DH : 32;   // keys per block
  static constexpr int QSTR = DH + 2;        // doubles: query row stride (16-byte pad)
  static constexpr int SSTR = BK + 2;        // doubles: score row stride
  static constexpr int NG = kThreads / BK;   // score phase: query groups
  static constexpr int QPT = kMaxQ / NG;     // score phase: queries per thread
  static constexpr int NH = kThreads / DH;   // weighted sum: query groups
  static constexpr int QPV = kMaxQ / NH;     // weighted sum: queries per thread
};

template <typename KV>
struct Kv;

template <>
struct Kv<float> {
  static constexpr int E = 4;   // elements per 16 bytes
  __device__ static void load16(const float* p, double* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static double one(const float* p) { return *p; }
};

template <>
struct Kv<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load16(const __nv_bfloat16* p, double* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static double one(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

// Byte offsets of the dynamic shared memory.
template <int DH, typename KV>
struct Layout {
  using S = Shape<DH>;
  static constexpr int KSTR = DH + 16 / sizeof(KV);   // elements: K/V row stride
  static constexpr size_t q = 0;                                   // double [kMaxQ][QSTR]
  static constexpr size_t s = q + 8 * kMaxQ * S::QSTR;             // double [kMaxQ][SSTR]
  static constexpr size_t m = s + 8 * kMaxQ * S::SSTR;             // running max
  static constexpr size_t l = m + 8 * kMaxQ;                       // running sum
  static constexpr size_t a = l + 8 * kMaxQ;                       // this block's rescale
  static constexpr size_t pos = a + 8 * kMaxQ;                     // int [kMaxQ]: rows' pos
  static constexpr size_t kv = round16(pos + 4 * kMaxQ);
  static constexpr size_t tile = sizeof(KV) * S::BK * KSTR;        // one K or V stage
  static constexpr size_t total = kv + 2 * kStages * tile;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DH, typename KV>
__global__ void __launch_bounds__(kThreads, DH <= 128 ? 2 : 1)
flat_attn_f64(const float* __restrict__ q, const KV* __restrict__ ck,
              const KV* __restrict__ cv, const int64_t* __restrict__ slot,
              const int64_t* __restrict__ pos, float* __restrict__ out32,
              double* __restrict__ out64, int T, int H, int Hk, int B, int vtok, int window,
              double softcap, double sqrt_dh) {
  using S = Shape<DH>;
  using L = Layout<DH, KV>;
  constexpr int BK = S::BK;
  constexpr int E = Kv<KV>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  double* qs = reinterpret_cast<double*>(smem + L::q);
  double* ss = reinterpret_cast<double*>(smem + L::s);
  double* ms = reinterpret_cast<double*>(smem + L::m);
  double* ls = reinterpret_cast<double*>(smem + L::l);
  double* as = reinterpret_cast<double*>(smem + L::a);
  int* rpos = reinterpret_cast<int*>(smem + L::pos);
  KV* kst = reinterpret_cast<KV*>(smem + L::kv);
  KV* vst = kst + kStages * BK * L::KSTR;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hk;
  const int R = kMaxQ / G;                 // rows per tile
  const int64_t sl = slot[t0];
  if (t0 % R != 0 && slot[t0 - 1] == sl) return;    // not the first row of a tile
  int n = 1;
  while (n < R && t0 + n < T && (t0 + n) % R != 0 && slot[t0 + n] == sl) ++n;
  const int nq = n * G;

  if (sl < 0 || sl >= B) {                  // padding rows
    for (int i = tid; i < nq * DH; i += kThreads) {
      const int r = i / (G * DH);
      const size_t o = (static_cast<size_t>(t0 + r) * H + kvh * G) * DH + i % (G * DH);
      if (out64) out64[o] = 0.0; else out32[o] = 0.f;
    }
    return;
  }

  for (int i = tid; i < nq * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    qs[j * S::QSTR + d] =
        q[(static_cast<size_t>(t0 + j / G) * H + kvh * G + j % G) * DH + d];
  }
  if (tid < n) rpos[tid] = static_cast<int>(pos[t0 + tid]);
  if (tid < nq) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0;
  }
  __syncthreads();

  int hi = 0, lo = INT_MAX;
  for (int r = 0; r < n; ++r) {
    const int p = rpos[r];
    hi = max(hi, min(p, vtok - 1));
    lo = min(lo, window > 0 ? max(0, p - window + 1) : 0);
  }
  const int kb0 = lo / BK * BK;
  const int nblk = hi >= kb0 ? (hi - kb0) / BK + 1 : 0;

  const size_t row_stride = static_cast<size_t>(Hk) * DH;
  const KV* kbase = ck + (static_cast<size_t>(sl) * vtok * Hk + kvh) * DH;
  const KV* vbase = cv + (static_cast<size_t>(sl) * vtok * Hk + kvh) * DH;
  auto load = [&](int blk, int stage) {
    constexpr int CPR = DH / E;            // 16-byte chunks per row
    const int kb = kb0 + blk * BK;
    KV* kd = kst + stage * BK * L::KSTR;
    KV* vd = vst + stage * BK * L::KSTR;
    for (int c = tid; c < BK * CPR; c += kThreads) {
      const int row = c / CPR, ch = c % CPR;
      const bool ok = kb + row <= hi;
      const size_t off = (ok ? kb + row : 0) * row_stride + ch * E;
      cp_async16(kd + row * L::KSTR + ch * E, kbase + off, ok);
      cp_async16(vd + row * L::KSTR + ch * E, vbase + off, ok);
    }
    cp_async_commit();
  };

  double acc[S::QPV];
#pragma unroll
  for (int i = 0; i < S::QPV; ++i) acc[i] = 0.0;
  const int dv = tid % DH, hv = tid / DH;  // weighted-sum thread: d, query group
  const int ks = tid % BK, gs = tid / BK;  // score thread: key, query group

  if (nblk > 0) load(0, 0);
  for (int b = 0; b < nblk; ++b) {
    if (b + 1 < nblk) {
      load(b + 1, (b + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KV* kt = kst + (b & 1) * BK * L::KSTR;
    const KV* vt = vst + (b & 1) * BK * L::KSTR;
    const int key = kb0 + b * BK + ks;

    // Scores: scaled, softcapped, masked (-inf).
    if (gs < nq) {
      double sc[S::QPT];
#pragma unroll
      for (int i = 0; i < S::QPT; ++i) sc[i] = 0.0;
      const KV* kr = kt + ks * L::KSTR;
#pragma unroll 4
      for (int d = 0; d < DH; d += E) {
        double kd[E];
        Kv<KV>::load16(kr + d, kd);
#pragma unroll
        for (int i = 0; i < S::QPT; ++i) {
          const int j = gs + i * S::NG;
          if (j < nq) {
            const double* qr = qs + j * S::QSTR + d;
#pragma unroll
            for (int e = 0; e < E; ++e) sc[i] = fma(qr[e], kd[e], sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < S::QPT; ++i) {
        const int j = gs + i * S::NG;
        if (j < nq) {
          const int p = rpos[j / G];
          const bool ok = key <= p && (window <= 0 || key > p - window);
          double x = sc[i] / sqrt_dh;
          if (softcap > 0.0) x = tanh(x / softcap) * softcap;
          ss[j * S::SSTR + ks] = ok ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: a warp per query row, a lane per key.
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int j = warp; j < nq; j += kThreads / 32) {
        const double x = lane < BK ? ss[j * S::SSTR + lane] : -INFINITY;
        double mx = x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const double m_old = ms[j];
        const double m_new = fmax(m_old, mx);
        const double p = x == -INFINITY ? 0.0 : exp(x - m_new);
        if (lane < BK) ss[j * S::SSTR + lane] = p;
        double sum = p;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const double alpha = m_new == -INFINITY ? 1.0 : exp(m_old - m_new);
          ls[j] = ls[j] * alpha + sum;
          ms[j] = m_new;
          as[j] = alpha;
        }
      }
    }
    __syncthreads();

    // Weighted sum: rescale, then add this block's keys in order.
#pragma unroll
    for (int i = 0; i < S::QPV; ++i) {
      const int j = hv + i * S::NH;
      if (j < nq) acc[i] *= as[j];
    }
#pragma unroll 2
    for (int k = 0; k < BK; k += 2) {
      const double v0 = Kv<KV>::one(vt + k * L::KSTR + dv);
      const double v1 = Kv<KV>::one(vt + (k + 1) * L::KSTR + dv);
#pragma unroll
      for (int i = 0; i < S::QPV; ++i) {
        const int j = hv + i * S::NH;
        if (j < nq) {
          const double2 pp = *reinterpret_cast<const double2*>(ss + j * S::SSTR + k);
          acc[i] = fma(pp.x, v0, acc[i]);
          acc[i] = fma(pp.y, v1, acc[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < S::QPV; ++i) {
    const int j = hv + i * S::NH;
    if (j < nq) {
      const size_t o = (static_cast<size_t>(t0 + j / G) * H + kvh * G + j % G) * DH + dv;
      const double r = acc[i] / ls[j];
      if (out64) out64[o] = r; else out32[o] = static_cast<float>(r);
    }
  }
}

template <int DH, typename KV>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* slot,
                   const void* pos, void* out, bool out_f64, int t, int h, int hk, int b,
                   int vtok, int window, double softcap, double sqrt_dh, cudaStream_t stream) {
  constexpr size_t smem = Layout<DH, KV>::total;
  // Devices (bit per ordinal) whose limit is raised already; the same value
  // from any thread, so a race only repeats the call.
  static uint64_t attr_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    e = cudaFuncSetAttribute(flat_attn_f64<DH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev < 64) attr_set |= uint64_t{1} << dev;
  }
  flat_attn_f64<DH, KV><<<dim3(t, hk), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(ck), static_cast<const KV*>(cv),
      static_cast<const int64_t*>(slot), static_cast<const int64_t*>(pos),
      out_f64 ? nullptr : static_cast<float*>(out), out_f64 ? static_cast<double*>(out) : nullptr,
      t, h, hk, b, vtok, window, softcap, sqrt_dh);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes; repro_torch/kernels/flat_attn.py).
// One launch of a (t, hk) grid; returns cudaGetLastError() (or the
// attribute call's error), and the caller raises when it is not
// cudaSuccess.  Allocates nothing on the device.
//
// Preconditions, checked here (cudaErrorInvalidValue otherwise) and by the
// Python wrapper: every tensor contiguous, q float32 (1, t, h, dh), out
// (1, t, h, dh) float32 (out_f64 = 0) or float64 (1), ck and cv
// (b, vtok, hk, dh) float32 (kv_bf16 = 0) or bfloat16 (1), slot and pos
// int64 (t,), every pointer 16-byte aligned; dh in {32, 128, 256}
// (the served head dims and the reduced configs'); h a multiple of hk with
// h / hk <= 32; window 0 (none) or the sliding window; softcap 0 (none) or
// the cap; sqrt_dh = sqrt(dh).  A real row's pos must lie in [0, vtok).
extern "C" int flat_attn_f64_launch(const void* q, const void* ck, const void* cv,
                                    const void* slot, const void* pos, void* out, int out_f64,
                                    int t, int h, int hk, int b, int vtok, int dh, int kv_bf16,
                                    int window, double softcap, double sqrt_dh,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (t <= 0 || hk <= 0 || h % hk || h / hk > kMaxQ || b <= 0 || vtok <= 0 || window < 0 ||
      (kv_bf16 != 0 && kv_bf16 != 1) || (out_f64 != 0 && out_f64 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(ck) |
                         reinterpret_cast<uintptr_t>(cv) | reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
#define FLAT_ATTN_CASE(DH)                                                                  \
  if (dh == DH)                                                                             \
    e = kv_bf16 ? launch<DH, __nv_bfloat16>(q, ck, cv, slot, pos, out, out_f64, t, h, hk, b, \
                                            vtok, window, softcap, sqrt_dh, stream)        \
                : launch<DH, float>(q, ck, cv, slot, pos, out, out_f64, t, h, hk, b, vtok,  \
                                    window, softcap, sqrt_dh, stream);
  FLAT_ATTN_CASE(32) FLAT_ATTN_CASE(128) FLAT_ATTN_CASE(256)
#undef FLAT_ATTN_CASE
  return static_cast<int>(e);
}
