// Weighted column sum of N stacked client updates, for Hopper (sm_90a),
// its streaming form, and its fused form over int8-quantised updates.
//
//   fedavg_reduce:     out[t] = sum_i w[i] * x[i, t]
//                      x: (N, T) f32 or bf16, w: (N,) f32
//   fedavg_accumulate: out[t] = acc[t] + w * x[t]
//                      acc, x: (T,) f32, w: f32 scalar
//   fedavg_reduce_q8:  out[t] = sum_i w[i] * (q[i, t] * s[i, t / block])
//                      q: (N, T) int8, s: (N, T / block) f32, w: (N,) f32
//
// Replaces the Pallas TPU kernel `_fedavg_kernel` launched by
// `fedavg_reduce` in src/repro/kernels/fedavg_reduce.py. The TPU version
// tiles T by COL_TILE=1024 lanes with the whole (N, COL_TILE) tile in VMEM
// and needs T padded to a multiple of the tile; here each thread owns one
// column, so the 32 threads of a warp read 32 neighbouring elements of a
// row (one coalesced transaction per row) and the ragged tail is masked.
//
// Bound: device-memory bytes. The kernel reads N*T*sizeof(x) + 4*N bytes
// and writes 4*T, with 2*N*T flops: far below the card's
// operations-per-byte balance. The design does the minimum for that: every
// input byte is read exactly once, the sum stays in an f32 register, and
// the client loop runs in a fixed order with no atomics, so the result is
// deterministic from run to run. 16-byte vector loads are left for later.
//
// fedavg_accumulate replaces `_accum_kernel` (launched by `fedavg_accumulate`
// in the same file): the fleet-scale hub folds one weighted update into a
// running sum per arrival. The TPU version pads T to COL_TILE; here nothing
// is padded. It is bound by bytes (read acc and x, write out: 12 bytes and
// 2 flops per element; 10.4 MB at the Small tier's T, a 3.1 us bound).
// Each thread moves 16 bytes of each input per step (float4), in
// 128-thread blocks, at most kAccBlocksPerSm of them per SM, striding over
// the vector; on the H100 that ran faster than several float4s per thread
// in fewer blocks (PERF.md). The T % 4 tail is done by the first
// threads of the same launch, and a view that is not 16-byte aligned
// (acc, x or out) takes the same loop on single floats. The arithmetic is
// written as two rounded operations, __fadd_rn(acc, __fmul_rn(w, x)), so
// nvcc cannot contract it into an FMA: that is the order the plain PyTorch
// version (a multiply, then an add) rounds in, so the two agree bit for
// bit.
//
// fedavg_reduce_q8 replaces `_fedavg_q8_kernel` (launched by
// `fedavg_reduce_q8` in the same file): the fused form over qsgd-packed
// updates, out[t] = sum_i w[i] * (q[i, t] * s[i, t / block]), with int8 q
// (N, T), f32 scales (N, T / block) and any block that divides T. The TPU
// version tiles T by COL_TILE and needs T padded to it; here, as above,
// one thread owns one column, the tail is masked, and the dequantised f32
// copies are never written anywhere: each product lives in a register. Each
// product is rounded as the reference rounds it, x = q * s and then x * w,
// and the sum is taken with __fadd_rn in a fixed client order (no FMA
// contraction, no atomics: deterministic). Bound: device-memory bytes, N*T
// int8 plus 4*N*T/block of scales read and 4*T written, a quarter of the
// f32 reduction's traffic; the scale loads of neighbouring threads hit the
// same word, so they are served from L1.
//
// Plain C interface (bound from Python with ctypes): every entry point
// launches on the given stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fedavg_reduce_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ out, int64_t n, int64_t t) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= t) return;  // ragged tail: no padding to a tile multiple
  float acc = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    acc += w[i] * to_f32(x[i * t + col]);
  }
  out[col] = acc;
}

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t n, int64_t t,
           void* stream) {
  const int64_t blocks = (t + kThreads - 1) / kThreads;
  fedavg_reduce_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), n, t);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kAccThreads = 128;
constexpr int kAccBlocksPerSm = 16;  // 2,048 threads: a full SM

__device__ __forceinline__ float axpy(float a, float x, float w) {
  return __fadd_rn(a, __fmul_rn(w, x));
}

__device__ __forceinline__ float4 axpy(float4 a, float4 x, float w) {
  return make_float4(axpy(a.x, x.x, w), axpy(a.y, x.y, w),
                     axpy(a.z, x.z, w), axpy(a.w, x.w, w));
}

// out[i] = acc[i] + w * x[i] for i < n, over elements of type V (float4 or
// float), grid-strided; each input is read once, so the loads and the
// store are marked streaming (evict first).
template <typename V>
__device__ __forceinline__ void accumulate_span(const V* __restrict__ acc,
                                                const V* __restrict__ x,
                                                float w, V* __restrict__ out,
                                                int64_t n, int64_t first,
                                                int64_t stride) {
  for (int64_t i = first; i < n; i += stride) {
    __stcs(out + i, axpy(__ldcs(acc + i), __ldcs(x + i), w));
  }
}

__global__ void __launch_bounds__(kAccThreads)
    fedavg_accumulate_kernel(const float* __restrict__ acc,
                             const float* __restrict__ x, float w,
                             float* __restrict__ out, int64_t t, int vec) {
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kAccThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kAccThreads;
  if (!vec) {  // a misaligned view: the same loop on single floats
    accumulate_span(acc, x, w, out, t, first, stride);
    return;
  }
  const int64_t n4 = t / 4;
  accumulate_span(reinterpret_cast<const float4*>(acc),
                  reinterpret_cast<const float4*>(x), w,
                  reinterpret_cast<float4*>(out), n4, first, stride);
  const int64_t j = 4 * n4 + first;  // the ragged tail: T % 4 elements
  if (j < t) out[j] = axpy(acc[j], x[j], w);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

__global__ void __launch_bounds__(kThreads)
    fedavg_reduce_q8_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ s,
                            const float* __restrict__ w,
                            float* __restrict__ out, int64_t n, int64_t t,
                            int64_t block) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= t) return;  // ragged tail: no padding to a tile multiple
  const int64_t n_scales = t / block;
  const int64_t sb = col / block;
  float acc = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const float x = __fmul_rn(static_cast<float>(q[i * t + col]),
                              s[i * n_scales + sb]);
    acc = __fadd_rn(acc, __fmul_rn(x, w[i]));
  }
  out[col] = acc;
}

}  // namespace

extern "C" int fedavg_reduce_f32(const void* x, const void* w, void* out,
                                 int64_t n, int64_t t, void* stream) {
  return launch<float>(x, w, out, n, t, stream);
}

extern "C" int fedavg_reduce_bf16(const void* x, const void* w, void* out,
                                  int64_t n, int64_t t, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, n, t, stream);
}

extern "C" int fedavg_accumulate_f32(const void* acc, const void* x, float w,
                                     void* out, int64_t t, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(acc) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = (addr % sizeof(float4)) == 0;
  const int64_t items = vec ? t / 4 : t;
  int64_t blocks = (items + kAccThreads - 1) / kAccThreads;
  const int64_t cap = int64_t{sm_count()} * kAccBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // T < 4: the tail threads of one block
  fedavg_accumulate_kernel<<<static_cast<unsigned int>(blocks), kAccThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(x), w,
      static_cast<float*>(out), t, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fedavg_reduce_q8(const void* q, const void* s, const void* w,
                                void* out, int64_t n, int64_t t, int64_t block,
                                void* stream) {
  const int64_t blocks = (t + kThreads - 1) / kThreads;
  fedavg_reduce_q8_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(out), n, t, block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
