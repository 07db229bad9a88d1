// Weighted sum of N client updates, for Hopper (sm_90a), its streaming
// form, and its fused form over int8-quantised updates.
//
//   fedavg_reduce:     out[t] = sum_i w[i] * x[i, t]
//                      x: N client trees of L leaves (f32 or bf16), read in
//                      place through a table of N * L pointers, or (N, T)
//                      rows; w: (N,) f32
//   fedavg_accumulate: out[t] = acc[t] + w * x[t]
//                      acc, x: (T,) f32, w: f32 scalar
//   fedavg_reduce_q8:  out[t] = sum_i w[i] * (q[i, t] * s[i, t / block])
//                      q: (N, T) int8, s: (N, T / block) f32, w: (N,) f32
//
// Subnormals and rounding (the rule of kernels/quantize.py, which the plain
// versions follow too): XLA flushes subnormal f32 values when it runs the
// reference on the CPU, and the TPU has none. Every multiply and add here
// is one PTX instruction with the .ftz modifier, mul.rn.ftz.f32 and
// add.rn.ftz.f32: a subnormal input reads as a zero of its sign, and a
// result whose value rounded to 24 bits (exponent unbounded) lies below
// FLT_MIN becomes one. That is the tininess rule of the x86 flush XLA runs
// under, measured equal on the H100 (PERF.md); a compare-and-select after
// an IEEE product differs from it for products within 2^-25 below
// FLT_MIN. The clients are summed in their order, one rounded multiply and
// one rounded add each (never an FMA), so each kernel agrees with its plain
// version bit for bit. The modifier is per instruction: the build has no
// -ftz, which would change every library's arithmetic.
//
// fedavg_reduce replaces the Pallas TPU kernel `_fedavg_kernel` launched by
// `fedavg_reduce` in src/repro/kernels/fedavg_reduce.py. The TPU version
// takes one (N, T) matrix, padded to its COL_TILE of 1024 lanes, with the
// whole (N, COL_TILE) tile in VMEM; the server first flattens every
// client's tree and stacks the flat vectors. Here the kernel reads each
// client's leaves where they lie: the host builds, once per tree structure,
// a table of tiles of at most kTile = 1024 elements that never cross a
// leaf (3 words each: the tile's offset in the output, its first element in
// the leaf, and leaf | bf16 << 31 | count), and per call a table of the
// N * L leaf pointers, leaf by leaf. One block of 256 threads takes one
// tile. Each leaf's output slot starts on 16 bytes (the host pads slots to
// 4 floats; only views of the leaves leave the wrapper), so every tile's
// output is 16-byte aligned. The (N, T) form is the same kernel with no
// tables: one leaf of T elements, client i's row at x + i * T.
//
// Bound: device-memory bytes. The kernel reads N * T * sizeof(x) and
// writes 4 * T bytes (plus the tables, ~12 B per leaf and client per call),
// with a few operations per byte. The design moves each byte once and keeps
// many loads in flight: the block first puts its N pointers and weights in
// shared memory, then each thread issues the loads of kChunk = 8 clients
// before any add: 4 elements of each in one 16-byte (f32) or 8-byte (bf16)
// streaming load (__ldcs: every byte is read once) when all N pointers of
// the tile are aligned to that width, else the same arithmetic on single
// elements, each thread taking elements tid, tid + 256, ... (coalesced).
// Registers are capped so that 4 blocks share an SM (kMinBlocks) with a
// chunk's loads held in registers and nothing spilled.
// A leaf need not be aligned: trees decoded by the codecs are views of one
// flat vector at arbitrary offsets. At T = 868,123 the rows of an (N, T)
// matrix after the first are not 16-byte aligned (T % 4 = 3), so that form
// takes the single-element path there.
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
// (acc, x or out) takes the same loop on single floats.
//
// fedavg_reduce_q8 replaces `_fedavg_q8_kernel` (launched by
// `fedavg_reduce_q8` in the same file): the fused form over qsgd-packed
// updates, with int8 q (N, T), f32 scales (N, T / block) and any block
// that divides T. The TPU version tiles T by COL_TILE and needs T padded
// to it; here the dequantised f32 copies are never written anywhere: each
// product lives in a register, x = q * s, then x * w, then the flushed sum.
// Bound: device-memory bytes, N*T int8 plus 4*N*T/block of scales read and
// 4*T written, a quarter of the f32 reduction's traffic. Two paths, chosen
// by the launcher from (block, T, q) alone (fedavg_q8_fast_path):
//
// * fast: block % 4 == 0, T % 4 == 0 and q 4-byte aligned (so every row
//   is). Each thread takes 4 int8 of a row in one 32-bit streaming load,
//   for kQ8Chunk clients before any add, and the one scale those 4 share
//   in a register; it writes its 4 floats as one float4. The grid is capped
//   at kQ8BlocksPerSm blocks per SM and strides over T. 16 int8 per
//   thread in one 16-byte load leave T / 16 threads, too few to hide the
//   loads' latency: that first design ran slower than one column per
//   thread (PERF.md).
// * general: any other block or pointer. One thread per column, each
//   element and its scale loaded on their own.
//
// Plain C interface (bound from Python with ctypes): every entry point
// launches on the given stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // elements of a tile a thread sums
constexpr int kTile = kThreads * kPerThread;   // elements of a leaf per block
constexpr int kChunk = 8;                      // clients whose loads fly together
constexpr int kMinBlocks = 4;                  // blocks per SM the registers allow
constexpr int kMaxClients = 4096;              // 12 bytes of shared memory each

// a * b and a + b, each rounded on its own, with XLA's flush (see above).
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One client's term added to a running sum: the order and rounding of the
// plain versions.
__device__ __forceinline__ float step(float acc, float w, float x) {
  return add_ftz(acc, mul_ftz(w, x));
}

// An element type's single load and its 4-element vector load.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Vec = float4;  // 16 bytes
  static __device__ __forceinline__ float load(const void* p, int64_t e) {
    return __ldcs(static_cast<const float*>(p) + e);
  }
  static __device__ __forceinline__ void widen(const Vec& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Elem<__nv_bfloat16> {
  using Vec = uint2;  // 8 bytes: 4 bf16, element 2k in the low half
  static __device__ __forceinline__ float load(const void* p, int64_t e) {
    const uint32_t bits = __ldcs(static_cast<const unsigned short*>(p) + e);
    return __uint_as_float(bits << 16);
  }
  static __device__ __forceinline__ void widen(const Vec& v, float* f) {
    f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// Where a block's tile and the clients' data lie. With a tile table, tile b
// is tiles[3b .. 3b + 2] and client i's leaf l starts at ptrs[l * n + i].
// Without one (the (N, T) form) tile b is elements [b * kTile, ..) of the
// one leaf, and client i's row starts at base + i * t elements.
struct Source {
  const int64_t* tiles;
  const int64_t* ptrs;
  const char* base;
  int64_t t;
  int bf16;
};

// One tile: count elements of every client, starting at the pointers in
// `sp`, summed into o[0 .. count).
template <typename T>
__device__ __forceinline__ void reduce_tile(const char* const* sp,
                                            const float* sw, int n, int count,
                                            bool vec, float* __restrict__ o) {
  using V = typename Elem<T>::Vec;
  float acc[kPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int tid = threadIdx.x;
  if (vec) {
    const int full = count / kPerThread;  // whole vectors in the tile
    if (tid < full) {
      for (int i0 = 0; i0 < n; i0 += kChunk) {
        V v[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (i0 + k < n) v[k] = __ldcs(reinterpret_cast<const V*>(sp[i0 + k]) + tid);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (i0 + k < n) {
            float x[kPerThread];
            Elem<T>::widen(v[k], x);
#pragma unroll
            for (int e = 0; e < kPerThread; ++e) acc[e] = step(acc[e], sw[i0 + k], x[e]);
          }
        }
      }
      reinterpret_cast<float4*>(o)[tid] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    // the count % 4 tail: one element each for the first threads
    const int e = full * kPerThread + tid;
    if (e < count) {
      float a = 0.0f;
      for (int i = 0; i < n; ++i) a = step(a, sw[i], Elem<T>::load(sp[i], e));
      o[e] = a;
    }
    return;
  }
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    float x[kChunk][kPerThread];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        const int idx = tid + e * kThreads;
        x[k][e] = (i0 + k < n && idx < count) ? Elem<T>::load(sp[i0 + k], idx) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (i0 + k < n) {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) acc[e] = step(acc[e], sw[i0 + k], x[k][e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < count) o[idx] = acc[e];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fedavg_reduce_kernel(Source src, const float* __restrict__ w,
                         float* __restrict__ out, int n) {
  extern __shared__ int64_t smem[];  // n client pointers, then n weights
  const char** sp = reinterpret_cast<const char**>(smem);
  float* sw = reinterpret_cast<float*>(smem + n);
  int64_t out_off, start;
  int64_t leaf = 0;
  int count, bf16;
  if (src.tiles != nullptr) {
    const int64_t* d = src.tiles + 3 * static_cast<int64_t>(blockIdx.x);
    out_off = d[0];
    start = d[1];
    leaf = d[2] >> 32;
    bf16 = static_cast<int>((d[2] >> 31) & 1);
    count = static_cast<int>(d[2] & 0x7fffffff);
  } else {
    start = static_cast<int64_t>(blockIdx.x) * kTile;
    out_off = start;
    bf16 = src.bf16;
    count = src.t - start < kTile ? static_cast<int>(src.t - start) : kTile;
  }
  const int esize = bf16 ? 2 : 4;
  int misaligned = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const char* p = src.ptrs != nullptr
                        ? reinterpret_cast<const char*>(src.ptrs[leaf * n + i])
                        : src.base + static_cast<int64_t>(i) * src.t * esize;
    p += start * esize;
    sp[i] = p;
    sw[i] = w[i];
    misaligned |= static_cast<int>(reinterpret_cast<uintptr_t>(p) %
                                   (kPerThread * esize));
  }
  float* o = out + out_off;
  if (threadIdx.x == 0) {
    misaligned |= static_cast<int>(reinterpret_cast<uintptr_t>(o) % sizeof(float4));
  }
  const bool vec = __syncthreads_or(misaligned) == 0;
  if (bf16) {
    reduce_tile<__nv_bfloat16>(sp, sw, n, count, vec, o);
  } else {
    reduce_tile<float>(sp, sw, n, count, vec, o);
  }
}

int launch_reduce(const Source& src, int64_t n_tiles, const void* w, void* out,
                  int64_t n, void* stream) {
  if (n < 1 || n > kMaxClients || n_tiles < 1 || n_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * (sizeof(int64_t) + sizeof(float));
  fedavg_reduce_kernel<<<static_cast<unsigned int>(n_tiles), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const void* x, int bf16, const void* w, void* out, int64_t n,
                int64_t t, void* stream) {
  const Source src{nullptr, nullptr, static_cast<const char*>(x), t, bf16};
  return launch_reduce(src, (t + kTile - 1) / kTile, w, out, n, stream);
}

constexpr int kAccThreads = 128;
constexpr int kAccBlocksPerSm = 16;  // 2,048 threads: a full SM

__device__ __forceinline__ float axpy(float a, float x, float w) {
  return step(a, w, x);
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

// x = q * s, then its weighted term: the plain version's rounding.
__device__ __forceinline__ float q8_step(float acc, float w, float q, float s) {
  return step(acc, w, mul_ftz(q, s));
}

constexpr int kQ8Vec = 4;         // int8 of a row per thread: one 32-bit load,
                                  // one float4 store
constexpr int kQ8Chunk = 4;       // clients whose loads fly together
constexpr int kQ8BlocksPerSm = 16;

__global__ void __launch_bounds__(kThreads)
    fedavg_reduce_q8_fast(const int8_t* __restrict__ q,
                          const float* __restrict__ s,
                          const float* __restrict__ w,
                          float* __restrict__ out, int n, int64_t t,
                          int64_t block) {
  const int64_t n_vec = t / kQ8Vec;
  const int64_t n_scales = t / block;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n_vec; j += stride) {
    const int64_t sb = j * kQ8Vec / block;  // the 4 share one scale
    float acc[kQ8Vec];
#pragma unroll
    for (int e = 0; e < kQ8Vec; ++e) acc[e] = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kQ8Chunk) {
      uint32_t v[kQ8Chunk];
      float sc[kQ8Chunk];
#pragma unroll
      for (int k = 0; k < kQ8Chunk; ++k) {
        if (i0 + k < n) {
          const int64_t i = i0 + k;
          v[k] = __ldcs(reinterpret_cast<const unsigned int*>(q + i * t) + j);
          sc[k] = __ldg(s + i * n_scales + sb);
        }
      }
#pragma unroll
      for (int k = 0; k < kQ8Chunk; ++k) {
        if (i0 + k < n) {
          const float wk = __ldg(w + i0 + k);
#pragma unroll
          for (int e = 0; e < kQ8Vec; ++e) {
            const int8_t b = static_cast<int8_t>((v[k] >> (8 * e)) & 0xffu);
            acc[e] = q8_step(acc[e], wk, static_cast<float>(b), sc[k]);
          }
        }
      }
    }
    reinterpret_cast<float4*>(out)[j] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    fedavg_reduce_q8_general(const int8_t* __restrict__ q,
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
    acc = q8_step(acc, w[i], static_cast<float>(q[i * t + col]),
                  s[i * n_scales + sb]);
  }
  out[col] = acc;
}

bool q8_fast(int64_t block, int64_t t, const void* q) {
  return block % kQ8Vec == 0 && t % kQ8Vec == 0 &&
         reinterpret_cast<uintptr_t>(q) % sizeof(uint32_t) == 0;
}

}  // namespace

// The (N, T) form: rows of one matrix, any T.
extern "C" int fedavg_reduce_f32(const void* x, const void* w, void* out,
                                 int64_t n, int64_t t, void* stream) {
  return launch_rows(x, 0, w, out, n, t, stream);
}

extern "C" int fedavg_reduce_bf16(const void* x, const void* w, void* out,
                                  int64_t n, int64_t t, void* stream) {
  return launch_rows(x, 1, w, out, n, t, stream);
}

// The tree form: `tiles` (3 words per tile, built once per tree structure)
// and `ptrs` (n pointers per leaf, leaf by leaf) lie on the card.
extern "C" int fedavg_reduce_leaves(const void* tiles, int64_t n_tiles,
                                    const void* ptrs, const void* w, void* out,
                                    int64_t n, void* stream) {
  const Source src{static_cast<const int64_t*>(tiles),
                   static_cast<const int64_t*>(ptrs), nullptr, 0, 0};
  return launch_reduce(src, n_tiles, w, out, n, stream);
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
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(s);
  const auto* ww = static_cast<const float*>(w);
  auto* oo = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (q8_fast(block, t, q)) {
    int64_t blocks = (t / kQ8Vec + kThreads - 1) / kThreads;
    const int64_t cap = int64_t{sm_count()} * kQ8BlocksPerSm;
    if (blocks > cap) blocks = cap;
    fedavg_reduce_q8_fast<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            st>>>(qq, ss, ww, oo, static_cast<int>(n), t,
                                  block);
  } else {
    const int64_t blocks = (t + kThreads - 1) / kThreads;
    fedavg_reduce_q8_general<<<static_cast<unsigned int>(blocks), kThreads, 0,
                               st>>>(qq, ss, ww, oo, n, t, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 when a fedavg_reduce_q8 call with this block, T and q takes the fast
// path (the launcher's own rule), else 0.
extern "C" int fedavg_q8_fast_path(int64_t block, int64_t t, const void* q) {
  return q8_fast(block, t, q) ? 1 : 0;
}

extern "C" const char* fedavg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
