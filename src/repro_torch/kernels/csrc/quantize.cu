// Blockwise symmetric int8 quantisation and its inverse, for Hopper (sm_90a).
//
//   quantize_blocks:   x (rows, block) f32 or bf16
//                      -> q (rows, block) int8, scale (rows,) f32
//       scale[r] = max_j |x[r, j]| / 127
//       q[r, j]  = clamp(rint(x[r, j] * (1 / scale[r])), -127, 127)
//       (an all-zero row gives scale 0 and q 0)
//   dequantize_blocks: q (rows, block) int8, scale (rows,) f32
//                      -> x (rows, block) f32 or bf16, q * scale[row]
//
// Replaces the Pallas TPU kernels `_quantize_kernel` (launched by
// `quantize_blocks`) and `_dequantize_kernel` (launched by
// `dequantize_blocks`) in src/repro/kernels/quantize.py. The TPU version
// holds a (ROW_TILE=8, block) tile in VMEM with the block on the lane axis
// and takes the row max in one in-tile reduction. Here one warp owns one
// row: its 32 lanes stride the row (any block size, neighbouring lanes on
// neighbouring addresses), the |x| max is a butterfly of __shfl_xor_sync,
// and every lane then holds the row's scale, so no shared memory and no
// second pass over a scales array is needed. Dequantize is one thread per
// element.
//
// Bit-exactness with the reference (int8 and scales): the arithmetic is
// written as the reference writes it. `amax / 127.0f` is a true IEEE
// division and the reciprocal is taken first, then multiplied; `rintf`
// rounds half to even like jnp.round; bf16 input is widened to f32 before
// anything else. The build keeps --use_fast_math off: it would make the
// division approximate and flush denormal scales to zero.
//
// Bound: device-memory bytes. Quantize reads 4 (or 2) bytes and writes 1
// per element plus 4 per row, with a handful of operations per element;
// dequantize the reverse. Each input byte is read once from device memory
// (quantize reads its row twice, the second time from L1), so the design
// stays at one pass. 16-byte vector loads are left for later.
//
// Plain C interface (bound from Python with ctypes): every entry point
// launches on the given stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int64_t rows, int64_t block) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * block;
  float amax = 0.0f;
  for (int64_t j = lane; j < block; j += kWarp) {
    amax = fmaxf(amax, fabsf(to_f32(xr[j])));
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = __fdiv_rn(amax, 127.0f);
  const float inv = s > 0.0f ? __fdiv_rn(1.0f, s) : 0.0f;
  int8_t* qr = q + row * block;
  for (int64_t j = lane; j < block; j += kWarp) {
    const float v = rintf(__fmul_rn(to_f32(xr[j]), inv));
    qr[j] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int64_t n, int64_t block) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  store(out + i, __fmul_rn(static_cast<float>(q[i]), scale[i / block]));
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, int64_t rows,
                    int64_t block, void* stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), rows, block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequantize(const void* q, const void* scale, void* out,
                      int64_t rows, int64_t block, void* stream) {
  const int64_t n = rows * block;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  dequantize_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<T*>(out), n, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quantize_blocks_f32(const void* x, void* q, void* scale,
                                   int64_t rows, int64_t block,
                                   void* stream) {
  return launch_quantize<float>(x, q, scale, rows, block, stream);
}

extern "C" int quantize_blocks_bf16(const void* x, void* q, void* scale,
                                    int64_t rows, int64_t block,
                                    void* stream) {
  return launch_quantize<__nv_bfloat16>(x, q, scale, rows, block, stream);
}

extern "C" int dequantize_blocks_f32(const void* q, const void* scale,
                                     void* out, int64_t rows, int64_t block,
                                     void* stream) {
  return launch_dequantize<float>(q, scale, out, rows, block, stream);
}

extern "C" int dequantize_blocks_bf16(const void* q, const void* scale,
                                      void* out, int64_t rows, int64_t block,
                                      void* stream) {
  return launch_dequantize<__nv_bfloat16>(q, scale, out, rows, block, stream);
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
