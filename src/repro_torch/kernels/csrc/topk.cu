// Batched magnitude top-k, for Hopper (sm_90a).
//
//   topk_rows: x (B, T) f32 or bf16, k in [1, T]
//              -> idx (B, k) int32, vals (B, k) f32
//       per row, the k entries of largest |x|, ordered by |x| descending,
//       ties to the lower index (jax.lax.top_k's rule); vals are x[idx]
//       widened to f32, sign and bits included (-0.0 stays -0.0).
//
// Replaces the Pallas TPU kernel `_topk_kernel` launched by `topk_rows` in
// src/repro/kernels/topk.py. That kernel runs k rounds of a full-row argmax
// (O(k * T)): at the Medium tier's row (T = 4,375,723, k = 218,786) that is
// ~1e12 compare-selects per update. This file computes the same function
// in a few passes over the row instead:
//
//   key      u = bits(float(x)) & 0x7fffffff. For finite values it orders
//            like |x| and makes -0.0 tie with +0.0, as jnp.abs does.
//   select   4 radix passes over 8-bit digits of u, high digit first,
//            find the k-th largest key tau per row and `need`, the number
//            of entries equal to tau that belong to the top k. Each pass is
//            a histogram of the entries still matching the chosen prefix
//            (one block per 4,096-element chunk of the row, a shared
//            histogram with warp-aggregated atomics, added into a global
//            per-row histogram), then a one-block kernel that scans the 256
//            bins and picks the digit.
//   compact  every u > tau is kept, and of the u == tau the first `need`
//            in index order: per-chunk counts, an exclusive scan over the
//            chunks, then each chunk writes its survivors in index order
//            (ballots give each entry its rank). This is where the tie
//            rule is kept: the survivors sit in index order.
//   order    a stable LSD radix sort of the k survivors on ~u (4 passes of
//            8 bits) orders them by |x| descending and, being stable, keeps
//            equal keys in index order. One block of 1,024 threads per row:
//            each warp owns a contiguous segment, counts digits into its own
//            column of a shared (digit, warp) table, one block scan turns
//            the table into stable offsets, and each warp scatters its
//            segment in order (__match_any_sync ranks equal digits).
//            The last step gathers vals = x[idx].
//
// Bound: device-memory bytes. The function must read the row once and
// write 8 bytes per kept entry; at the Medium shape that is 19.25 MB, a
// 5.7 us bound at 3.35 TB/s. This design reads the row 6 times (4 select
// passes, count, scatter) and runs the order step on one SM per row, so it
// sits far above the bound: on the H100 the order step is ~95 % of the
// call at the Medium shape, and spreading it over many blocks is the next
// step (PERF.md). It is the simple first version that keeps the tie rule
// exact. The kernels allocate nothing: the wrapper passes one scratch
// buffer of topk_rows_scratch_words() 32-bit words.
//
// Plain C interface (bound from Python with ctypes): the entry point
// launches on the given stream and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // chunk kernels and the digit picker
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int64_t kChunk = int64_t{kThreads} * kItems;  // row entries per block
constexpr int kRadix = 256;
constexpr int kDigitBits = 8;
constexpr int kPasses = 4;
constexpr int kScanThreads = 1024;
constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kPerThread = kRadix * kSortWarps / kSortThreads;  // 8
constexpr unsigned kFull = 0xffffffffu;

// Per row: the key prefix chosen so far, its mask, and how many entries
// matching the prefix still belong to the top k.
struct RowState {
  uint32_t prefix;
  uint32_t mask;
  uint32_t k_rem;
  uint32_t pad;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ uint32_t key_at(const T* xr, int64_t i) {
  return __float_as_uint(widen(xr[i])) & 0x7fffffffu;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// One select pass: histogram of digit (u >> shift) & 0xff over the entries
// of this block's chunk whose key matches the row's prefix.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const T* __restrict__ x, int64_t t,
                const RowState* __restrict__ state, uint32_t* __restrict__ hist,
                int shift) {
  __shared__ uint32_t sh[kRadix];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kRadix; i += kThreads) sh[i] = 0;
  __syncthreads();
  const RowState st = state[row];
  const T* xr = x + row * t;
  const int64_t begin = blockIdx.x * kChunk;
  const int64_t end = min64(begin + kChunk, t);
  for (int64_t base = begin; base < end; base += kThreads) {  // block-uniform
    const int64_t i = base + threadIdx.x;
    bool live = false;
    uint32_t digit = 0;
    if (i < end) {
      const uint32_t u = key_at(xr, i);
      live = (u & st.mask) == st.prefix;
      digit = (u >> shift) & (kRadix - 1);
    }
    const unsigned live_mask = __ballot_sync(kFull, live);
    if (live) {  // one shared add per distinct digit in the warp
      const unsigned peers = __match_any_sync(live_mask, digit);
      if (lane == __ffs(peers) - 1) atomicAdd(&sh[digit], __popc(peers));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRadix; i += kThreads) {
    if (sh[i]) atomicAdd(&hist[row * kRadix + i], sh[i]);
  }
}

// Pick this pass's digit: the bin, scanning from the largest digit down,
// where the running count first reaches k_rem. Zeroes the histogram for
// the next pass.
__global__ void __launch_bounds__(kRadix)
    pick_digit_kernel(uint32_t* __restrict__ hist, RowState* __restrict__ state,
                      int shift, uint32_t k, int first) {
  __shared__ uint32_t incl[kRadix];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  RowState st = state[row];  // read by every thread before any write below
  const uint32_t k_rem = first ? k : st.k_rem;
  uint32_t* h = hist + row * kRadix;
  const int digit = kRadix - 1 - tid;  // thread 0 holds the largest digit
  const uint32_t c = h[digit];
  incl[tid] = c;
  __syncthreads();
  for (int off = 1; off < kRadix; off <<= 1) {
    const uint32_t add = tid >= off ? incl[tid - off] : 0u;
    __syncthreads();
    incl[tid] += add;
    __syncthreads();
  }
  h[digit] = 0;
  const uint32_t before = incl[tid] - c;  // matching entries in larger digits
  if (before < k_rem && incl[tid] >= k_rem) {  // exactly one thread
    st.prefix |= static_cast<uint32_t>(digit) << shift;
    st.mask |= static_cast<uint32_t>(kRadix - 1) << shift;
    st.k_rem = k_rem - before;
    state[row] = st;
  }
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Per chunk: how many keys are above tau, and how many equal it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const T* __restrict__ x, int64_t t,
                 const RowState* __restrict__ state, int* __restrict__ counts,
                 int64_t nb) {
  __shared__ int red_gt[kWarps];
  __shared__ int red_eq[kWarps];
  const int row = blockIdx.y;
  const uint32_t tau = state[row].prefix;
  const T* xr = x + row * t;
  const int64_t begin = blockIdx.x * kChunk;
  const int64_t end = min64(begin + kChunk, t);
  int gt = 0, eq = 0;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const uint32_t u = key_at(xr, i);
    gt += u > tau;
    eq += u == tau;
  }
  gt = block_sum(gt, red_gt);
  eq = block_sum(eq, red_eq);
  if (threadIdx.x == 0) {
    int* c = counts + 2 * (row * nb + blockIdx.x);
    c[0] = gt;
    c[1] = eq;
  }
}

// Exclusive scan, in place, of each row's (gt, eq) chunk counts.
__global__ void __launch_bounds__(kScanThreads)
    scan_counts_kernel(int* __restrict__ counts, int64_t nb) {
  __shared__ int s_gt[kScanThreads];
  __shared__ int s_eq[kScanThreads];
  const int tid = threadIdx.x;
  int* c = counts + 2 * blockIdx.x * nb;
  int carry_gt = 0, carry_eq = 0;
  for (int64_t base = 0; base < nb; base += kScanThreads) {
    const int64_t i = base + tid;
    const int g = i < nb ? c[2 * i] : 0;
    const int e = i < nb ? c[2 * i + 1] : 0;
    s_gt[tid] = g;
    s_eq[tid] = e;
    __syncthreads();
    for (int off = 1; off < kScanThreads; off <<= 1) {
      const int ag = tid >= off ? s_gt[tid - off] : 0;
      const int ae = tid >= off ? s_eq[tid - off] : 0;
      __syncthreads();
      s_gt[tid] += ag;
      s_eq[tid] += ae;
      __syncthreads();
    }
    if (i < nb) {
      c[2 * i] = carry_gt + s_gt[tid] - g;
      c[2 * i + 1] = carry_eq + s_eq[tid] - e;
    }
    carry_gt += s_gt[kScanThreads - 1];
    carry_eq += s_eq[kScanThreads - 1];
    __syncthreads();  // before the next tile overwrites the scan arrays
  }
}

// Write each chunk's survivors in index order. An entry's slot is the
// number of survivors before it: the keys above tau before it, plus the
// keys equal to tau before it, capped at `need`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const T* __restrict__ x, int64_t t,
                   const RowState* __restrict__ state,
                   const int* __restrict__ bases, int64_t nb, int64_t k,
                   uint32_t* __restrict__ keys_out, int* __restrict__ idx_out) {
  __shared__ int warp_gt[kWarps];
  __shared__ int warp_eq[kWarps];
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const RowState st = state[row];
  const uint32_t tau = st.prefix;
  const int need = static_cast<int>(st.k_rem);
  const T* xr = x + row * t;
  uint32_t* ko = keys_out + row * k;
  int* io = idx_out + row * k;
  const int* b = bases + 2 * (row * nb + blockIdx.x);
  int run_gt = b[0], run_eq = b[1];
  const int64_t begin = blockIdx.x * kChunk;
  const int64_t end = min64(begin + kChunk, t);
  for (int64_t base = begin; base < end; base += kThreads) {  // block-uniform
    const int64_t i = base + threadIdx.x;
    const bool in = i < end;
    const uint32_t u = in ? key_at(xr, i) : 0u;
    const bool gt = in && u > tau;
    const bool eq = in && u == tau;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    if (lane == 0) {
      warp_gt[warp] = __popc(bg);
      warp_eq[warp] = __popc(be);
    }
    __syncthreads();
    int pg = 0, pe = 0, tg = 0, te = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int a = warp_gt[w], c = warp_eq[w];
      if (w < warp) {
        pg += a;
        pe += c;
      }
      tg += a;
      te += c;
    }
    const int gt_before = run_gt + pg + __popc(bg & lanemask_lt(lane));
    const int eq_before = run_eq + pe + __popc(be & lanemask_lt(lane));
    int slot = -1;
    if (gt) {
      slot = gt_before + min(eq_before, need);
    } else if (eq && eq_before < need) {
      slot = gt_before + eq_before;
    }
    if (slot >= 0) {
      ko[slot] = u;
      io[slot] = static_cast<int>(i);
    }
    run_gt += tg;
    run_eq += te;
    __syncthreads();  // before the warp totals are overwritten
  }
}

// Stable LSD radix sort of one row's k survivors on ~key (so |x|
// descending; equal keys keep their index order), then the gather of the
// signed values. Ping-pongs between (keys_a, idx_a) and (keys_b, idx_b);
// after an even number of passes the result is back in a.
template <typename T>
__global__ void __launch_bounds__(kSortThreads)
    order_kernel(const T* __restrict__ x, int64_t t, int64_t k,
                 uint32_t* __restrict__ keys_a, int* __restrict__ idx_a,
                 uint32_t* __restrict__ keys_b, int* __restrict__ idx_b,
                 int* __restrict__ out_idx, float* __restrict__ out_vals) {
  // offs[d * kSortWarps + w]: digit-major, so one scan gives stable offsets
  __shared__ uint32_t offs[kRadix * kSortWarps];
  __shared__ uint32_t part[kSortThreads];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t seg = (k + kSortWarps - 1) / kSortWarps;
  const int64_t s0 = min64(warp * seg, k);
  const int64_t s1 = min64(s0 + seg, k);
  uint32_t* ka = keys_a + row * k;
  uint32_t* kb = keys_b + row * k;
  int* ia = idx_a + row * k;
  int* ib = idx_b + row * k;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = pass * kDigitBits;
    const uint32_t* kin = (pass & 1) ? kb : ka;
    const int* iin = (pass & 1) ? ib : ia;
    uint32_t* kout = (pass & 1) ? ka : kb;
    int* iout = (pass & 1) ? ia : ib;
    for (int i = tid; i < kRadix * kSortWarps; i += kSortThreads) offs[i] = 0;
    __syncthreads();
    // 1. each warp counts the digits of its own segment into its column
    for (int64_t base = s0; base < s1; base += 32) {  // warp-uniform
      const int64_t i = base + lane;
      const bool live = i < s1;
      const unsigned lm = __ballot_sync(kFull, live);
      if (live) {
        const uint32_t d = (~kin[i] >> shift) & (kRadix - 1);
        const unsigned peers = __match_any_sync(lm, d);
        if (lane == __ffs(peers) - 1) offs[d * kSortWarps + warp] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // 2. exclusive scan of the table in (digit, warp) order
    uint32_t v[kPerThread];
    uint32_t sum = 0;
    for (int j = 0; j < kPerThread; ++j) {
      v[j] = offs[tid * kPerThread + j];
      sum += v[j];
    }
    part[tid] = sum;
    __syncthreads();
    for (int off = 1; off < kSortThreads; off <<= 1) {
      const uint32_t add = tid >= off ? part[tid - off] : 0u;
      __syncthreads();
      part[tid] += add;
      __syncthreads();
    }
    uint32_t run = part[tid] - sum;
    for (int j = 0; j < kPerThread; ++j) {
      offs[tid * kPerThread + j] = run;
      run += v[j];
    }
    __syncthreads();
    // 3. each warp scatters its segment in order: stable
    for (int64_t base = s0; base < s1; base += 32) {  // warp-uniform
      const int64_t i = base + lane;
      const bool live = i < s1;
      const unsigned lm = __ballot_sync(kFull, live);
      if (live) {
        const uint32_t key = kin[i];
        const int id = iin[i];
        const uint32_t d = (~key >> shift) & (kRadix - 1);
        const unsigned peers = __match_any_sync(lm, d);
        const uint32_t slot = offs[d * kSortWarps + warp] +
                              __popc(peers & lanemask_lt(lane));
        kout[slot] = key;
        iout[slot] = id;
        __syncwarp(lm);
        if (lane == __ffs(peers) - 1) offs[d * kSortWarps + warp] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();  // the pass's output is complete before the next reads it
  }
  const T* xr = x + row * t;
  for (int64_t j = tid; j < k; j += kSortThreads) {
    const int id = ia[j];
    out_idx[row * k + j] = id;
    out_vals[row * k + j] = widen(xr[id]);
  }
}

struct Scratch {
  RowState* state;
  uint32_t* hist;
  int* counts;
  uint32_t* keys_a;
  int* idx_a;
  uint32_t* keys_b;
  int* idx_b;
};

int64_t chunks(int64_t t) { return (t + kChunk - 1) / kChunk; }

int64_t scratch_words(int64_t b, int64_t t, int64_t k) {
  return b * 4 + b * kRadix + 2 * b * chunks(t) + 4 * b * k;
}

Scratch carve(void* scratch, int64_t b, int64_t t, int64_t k) {
  uint32_t* w = static_cast<uint32_t*>(scratch);
  Scratch s;
  s.state = reinterpret_cast<RowState*>(w);
  w += b * 4;
  s.hist = w;
  w += b * kRadix;
  s.counts = reinterpret_cast<int*>(w);
  w += 2 * b * chunks(t);
  s.keys_a = w;
  w += b * k;
  s.idx_a = reinterpret_cast<int*>(w);
  w += b * k;
  s.keys_b = w;
  w += b * k;
  s.idx_b = reinterpret_cast<int*>(w);
  return s;
}

template <typename T>
int launch(const void* xv, void* out_idx, void* out_vals, void* scratch,
           int64_t b, int64_t t, int64_t k, void* stream_v) {
  const T* x = static_cast<const T*>(xv);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const int64_t nb = chunks(t);
  Scratch s = carve(scratch, b, t, k);
  // the state and the histograms start at zero; nothing else needs it
  cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * (b * 4 + b * kRadix), stream);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(b));
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = (kPasses - 1 - pass) * kDigitBits;  // high digit first
    hist_kernel<T><<<grid, kThreads, 0, stream>>>(x, t, s.state, s.hist, shift);
    pick_digit_kernel<<<static_cast<unsigned>(b), kRadix, 0, stream>>>(
        s.hist, s.state, shift, static_cast<uint32_t>(k), pass == 0);
  }
  count_kernel<T><<<grid, kThreads, 0, stream>>>(x, t, s.state, s.counts, nb);
  scan_counts_kernel<<<static_cast<unsigned>(b), kScanThreads, 0, stream>>>(
      s.counts, nb);
  compact_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, t, s.state, s.counts, nb, k, s.keys_a, s.idx_a);
  order_kernel<T><<<static_cast<unsigned>(b), kSortThreads, 0, stream>>>(
      x, t, k, s.keys_a, s.idx_a, s.keys_b, s.idx_b,
      static_cast<int*>(out_idx), static_cast<float*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t topk_rows_scratch_words(int64_t b, int64_t t, int64_t k) {
  return scratch_words(b, t, k);
}

extern "C" int topk_rows_f32(const void* x, void* idx, void* vals,
                             void* scratch, int64_t b, int64_t t, int64_t k,
                             void* stream) {
  return launch<float>(x, idx, vals, scratch, b, t, k, stream);
}

extern "C" int topk_rows_bf16(const void* x, void* idx, void* vals,
                              void* scratch, int64_t b, int64_t t, int64_t k,
                              void* stream) {
  return launch<__nv_bfloat16>(x, idx, vals, scratch, b, t, k, stream);
}

extern "C" const char* topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
