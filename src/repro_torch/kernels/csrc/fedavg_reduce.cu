// Weighted column sum of N stacked client updates, for Hopper (sm_90a),
// and its streaming form.
//
//   fedavg_reduce:     out[t] = sum_i w[i] * x[i, t]
//                      x: (N, T) f32 or bf16, w: (N,) f32
//   fedavg_accumulate: out[t] = acc[t] + w * x[t]
//                      acc, x: (T,) f32, w: f32 scalar
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
// running sum per arrival. The TPU version pads T to COL_TILE; here one
// thread owns one element, the tail is masked and nothing is padded. It is
// bound by bytes (read acc and x, write out: 12 bytes and 2 flops per
// element). The arithmetic is written as two rounded operations,
// __fadd_rn(acc, __fmul_rn(w, x)), so nvcc cannot contract it into an FMA:
// that is the order the plain PyTorch version (a multiply, then an add)
// rounds in, so the two agree bit for bit.
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

__global__ void __launch_bounds__(kThreads)
    fedavg_accumulate_kernel(const float* __restrict__ acc,
                             const float* __restrict__ x, float w,
                             float* __restrict__ out, int64_t t) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= t) return;  // ragged tail: no padding to a tile multiple
  out[i] = __fadd_rn(acc[i], __fmul_rn(w, x[i]));
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
  const int64_t blocks = (t + kThreads - 1) / kThreads;
  fedavg_accumulate_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(x), w,
      static_cast<float*>(out), t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
