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
//   select   3 radix passes over 11-, 10- and 10-bit digits of u, high
//            digit first, find the k-th largest key tau per row and `need`,
//            the number of entries equal to tau that belong to the top k.
//            Each pass is a histogram of the entries still matching the
//            chosen prefix (one block per 4,096-element chunk of the row, a
//            shared histogram, added into a global per-row histogram); the
//            row's last block to finish scans the bins and picks the digit,
//            so a pass is one launch.
//   compact  every u > tau is kept, and of the u == tau the first `need`
//            in index order: per-chunk counts (the row's last block to
//            finish scans them over the chunks), then each chunk writes
//            its survivors in index order (ballots give each entry its
//            rank). This is where the tie rule is kept: the survivors sit
//            in index order.
//   order    a stable LSD radix sort of the k survivors on top - u (top
//            is the largest survivor key; 8-bit digits, low digit first)
//            orders them by |x| descending and, being stable, keeps equal
//            keys in index order. Only the bytes that top - tau spans get a
//            pass (at least one). One kernel
//            counts the digits of every pass; then each pass is one
//            launch over many tiles per row, in the one-sweep form: each
//            tile ranks its survivors stably (8 ballots per 32 entries
//            find the lanes that share a digit; per-warp counters are laid
//            out so that different digits sit in different banks), learns
//            from a decoupled look-back how many entries of each digit the
//            tiles before it hold, and scatters the (key, idx) pairs. The
//            last pass writes idx and the gathered vals = x[idx] instead.
//
// Bound: device-memory bytes. The function must read the row once and
// write 8 bytes per kept entry; at the Medium shape that is 19.25 MB, a
// 5.7 us bound at 3.35 TB/s. This design reads the row 5 times (3 select
// passes, count, compaction), so the select step sits well above the bound.
// The sort reads and writes 8 bytes per survivor per pass, from L2 at
// these sizes (1.75 MB of pairs at the Medium shape), in 5 launches (a
// pass that the key range does not need returns at once). The
// kernels allocate nothing: the wrapper passes one scratch buffer of
// topk_rows_scratch_words() 32-bit words.
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
constexpr int kSelectRadix = 2048;  // bins of the widest (11-bit) select digit
// sort: at most 4 passes of 8-bit digits
constexpr int kRadix = 256;
constexpr int kDigitBits = 8;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoKey = 0xffffffffu;  // past the row's end (keys are 31-bit)

// Per row: the key prefix chosen so far, its mask, and how many entries
// matching the prefix still belong to the top k; after the select, prefix
// is the k-th largest key tau. top is the largest key, set by the
// compaction.
struct RowState {
  uint32_t prefix;
  uint32_t mask;
  uint32_t k_rem;
  uint32_t top;
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

// Pick this pass's digit, in the last block of the row to finish its
// histogram: the bin, scanning from the largest digit down, where the
// running count first reaches k_rem. Thread i holds the kPer bins from
// hi = 2^kBits - 1 - i * kPer down (thread 0 the largest). Zeroes the
// histogram and the row's block counter for the next pass.
template <int kBits>
__device__ void pick_digit(uint32_t* __restrict__ h, RowState* __restrict__ state,
                           uint32_t* __restrict__ done, RowState st, int shift,
                           uint32_t k, int first) {
  constexpr int kBins = 1 << kBits;
  constexpr int kPer = kBins / kThreads;
  __shared__ uint32_t warp_tot[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t k_rem = first ? k : st.k_rem;
  const int hi = kBins - 1 - tid * kPer;  // this thread's largest digit
  uint32_t c[kPer];
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(h + hi - j);  // other blocks' adds are in L2
    sum += c[j];
  }
  uint32_t incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_tot[w];
#pragma unroll
  for (int j = 0; j < kPer; ++j) h[hi - j] = 0;
  if (tid == 0) *done = 0;
  uint32_t before = incl - sum;  // matching entries in larger digits
  if (before < k_rem && incl >= k_rem) {  // exactly one thread
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (before + c[j] >= k_rem) {
        st.prefix |= static_cast<uint32_t>(hi - j) << shift;
        st.mask |= static_cast<uint32_t>(kBins - 1) << shift;
        st.k_rem = k_rem - before;
        *state = st;
        break;
      }
      before += c[j];
    }
  }
}

// True in every thread of the block that is the last of its row to get
// here; the blocks' global writes before it are then visible to it.
__device__ __forceinline__ bool last_block_of_row(uint32_t* done) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// One select pass: histogram of the kBits-bit digit (u >> shift) over the
// entries of this block's chunk whose key matches the row's prefix; the
// row's last block then picks the digit. Each thread loads its kItems keys
// before it counts any, so the loads are in flight together, and adds each
// live one to the shared histogram with its own atomic (no aggregation of
// equal digits in the warp: 10- and 11-bit digits spread a warp's entries
// over many bins).
template <typename T, int kBits>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const T* __restrict__ x, int64_t t, RowState* __restrict__ state,
                uint32_t* __restrict__ hist, uint32_t* __restrict__ done,
                int shift, uint32_t k, int first) {
  constexpr int kBins = 1 << kBits;
  __shared__ uint32_t sh[kBins];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const RowState st = state[row];
  const T* xr = x + row * t;
  const int64_t begin = blockIdx.x * kChunk;
  const int64_t end = min64(begin + kChunk, t);
  uint32_t u[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = begin + j * kThreads + threadIdx.x;
    u[j] = i < end ? key_at(xr, i) : kNoKey;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool live = u[j] != kNoKey && (u[j] & st.mask) == st.prefix;
    const uint32_t digit = (u[j] >> shift) & (kBins - 1);
    if (live) atomicAdd(&sh[digit], 1u);
  }
  __syncthreads();
  uint32_t* hr = hist + row * kSelectRadix;
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    if (sh[i]) atomicAdd(hr + i, sh[i]);
  }
  if (last_block_of_row(done + row)) {
    pick_digit<kBits>(hr, state + row, done + row, st, shift, k, first);
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

// Exclusive scan, in place, of a row's (gt, eq) chunk counts, by the
// kThreads threads of one block: each thread sums a contiguous segment,
// one block scan, then each rewrites its segment.
__device__ void scan_chunk_counts(int* __restrict__ c, int64_t nb) {
  __shared__ int warp_gt[kWarps];
  __shared__ int warp_eq[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t per = (nb + kThreads - 1) / kThreads;
  const int64_t s0 = min64(tid * per, nb);
  const int64_t s1 = min64(s0 + per, nb);
  int gt = 0, eq = 0;
  for (int64_t i = s0; i < s1; ++i) {
    gt += __ldcg(c + 2 * i);
    eq += __ldcg(c + 2 * i + 1);
  }
  int ig = gt, ie = eq;  // inclusive over the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int vg = __shfl_up_sync(kFull, ig, off);
    const int ve = __shfl_up_sync(kFull, ie, off);
    if (lane >= off) {
      ig += vg;
      ie += ve;
    }
  }
  if (lane == 31) {
    warp_gt[warp] = ig;
    warp_eq[warp] = ie;
  }
  __syncthreads();
  int run_gt = ig - gt, run_eq = ie - eq;
  for (int w = 0; w < warp; ++w) {
    run_gt += warp_gt[w];
    run_eq += warp_eq[w];
  }
  for (int64_t i = s0; i < s1; ++i) {
    const int g = __ldcg(c + 2 * i), e = __ldcg(c + 2 * i + 1);
    c[2 * i] = run_gt;
    c[2 * i + 1] = run_eq;
    run_gt += g;
    run_eq += e;
  }
}

// Per chunk: how many keys are above tau, and how many equal it; the row's
// last block then scans the chunk counts into exclusive bases.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const T* __restrict__ x, int64_t t,
                 const RowState* __restrict__ state, int* __restrict__ counts,
                 uint32_t* __restrict__ done, int64_t nb) {
  __shared__ int red_gt[kWarps];
  __shared__ int red_eq[kWarps];
  const int row = blockIdx.y;
  const uint32_t tau = state[row].prefix;
  const T* xr = x + row * t;
  const int64_t begin = blockIdx.x * kChunk;
  const int64_t end = min64(begin + kChunk, t);
  uint32_t u[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = begin + j * kThreads + threadIdx.x;
    u[j] = i < end ? key_at(xr, i) : kNoKey;
  }
  int gt = 0, eq = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    gt += u[j] != kNoKey && u[j] > tau;
    eq += u[j] == tau;
  }
  gt = block_sum(gt, red_gt);
  eq = block_sum(eq, red_eq);
  if (threadIdx.x == 0) {
    int* c = counts + 2 * (row * nb + blockIdx.x);
    c[0] = gt;
    c[1] = eq;
  }
  if (last_block_of_row(done + row)) {
    scan_chunk_counts(counts + 2 * row * nb, nb);
    if (threadIdx.x == 0) done[row] = 0;
  }
}

// Write each chunk's survivors in index order. An entry's slot is the
// number of survivors before it: the keys above tau before it, plus the
// keys equal to tau before it, capped at `need`. Warp w owns entries
// [w * 32 * kItems, (w + 1) * 32 * kItems) of the chunk and holds their
// keys in registers: one pass of ballots counts them, one block scan over
// the warps gives each warp its bases, and a second pass writes them. The
// largest key kept goes into the row's state.top.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const T* __restrict__ x, int64_t t,
                   RowState* __restrict__ state,
                   const int* __restrict__ bases, int64_t nb, int64_t k,
                   uint2* __restrict__ pairs_out) {
  __shared__ int warp_gt[kWarps];
  __shared__ int warp_eq[kWarps];
  __shared__ uint32_t warp_top[kWarps];
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const RowState st = state[row];
  const uint32_t tau = st.prefix;
  const int need = static_cast<int>(st.k_rem);
  const T* xr = x + row * t;
  uint2* po = pairs_out + row * k;
  uint32_t top = 0;  // the largest key this thread keeps
  const int64_t seg = blockIdx.x * kChunk + int64_t{warp} * 32 * kItems;
  const int64_t end = min64(blockIdx.x * kChunk + kChunk, t);
  uint32_t u[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t i = seg + s * 32 + lane;
    u[s] = i < end ? key_at(xr, i) : kNoKey;
  }
  int n_gt = 0, n_eq = 0;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    n_gt += __popc(__ballot_sync(kFull, u[s] != kNoKey && u[s] > tau));
    n_eq += __popc(__ballot_sync(kFull, u[s] == tau));
  }
  if (lane == 0) {
    warp_gt[warp] = n_gt;
    warp_eq[warp] = n_eq;
  }
  __syncthreads();
  const int* b = bases + 2 * (row * nb + blockIdx.x);
  int run_gt = b[0], run_eq = b[1];
  for (int w = 0; w < warp; ++w) {
    run_gt += warp_gt[w];
    run_eq += warp_eq[w];
  }
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const bool gt = u[s] != kNoKey && u[s] > tau;
    const bool eq = u[s] == tau;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    const int gt_before = run_gt + __popc(bg & lanemask_lt(lane));
    const int eq_before = run_eq + __popc(be & lanemask_lt(lane));
    int slot = -1;
    if (gt) {
      slot = gt_before + min(eq_before, need);
    } else if (eq && eq_before < need) {
      slot = gt_before + eq_before;
    }
    if (slot >= 0) {
      po[slot] = make_uint2(u[s], static_cast<uint32_t>(seg + s * 32 + lane));
      top = max(top, u[s]);
    }
    run_gt += __popc(bg);
    run_eq += __popc(be);
  }
  top = __reduce_max_sync(kFull, top);
  if (lane == 0) warp_top[warp] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) top = max(top, warp_top[w]);
    if (top > tau) atomicMax(&state[row].top, top);
  }
}

// ---- order: a stable LSD radix sort of each row's survivors ----
//
// On top - u, so that |x| comes out descending. Many blocks per row (grid
// (sort tiles, B)), one launch per 8-bit digit, low digit first (a digit
// above the row's key range returns at once), after one launch that counts
// every pass's digits:
//   sort_hist  the row's 4 digit histograms (one per pass), from which each
//              tile derives where each digit's run starts in the output;
//   onesweep   each tile ranks its survivors stably (warp by warp, in
//              index order), learns how many entries of each digit the
//              tiles before it hold by a decoupled look-back, and scatters
//              each (key, idx) pair to its slot; the last pass writes idx
//              and vals = x[idx] instead.
// Tiles take their position in the row from a ticket (an atomic counter),
// so a tile only ever waits on tiles that already run. Each tile publishes,
// per digit, its own count (an aggregate) at once and the count of the
// tiles up to it (an inclusive prefix) when it knows it; a successor sums
// aggregates backwards until it meets an inclusive prefix. Each published
// word holds a tag naming the pass and the kind in its high half and the
// count in its low half, so it is written and read in one 64-bit access
// and one zeroed array serves all 4 passes.
// A warp finds the lanes that share its digit with 8 ballots (one per
// digit bit). Per-warp digit counters are laid out warp-major,
// cnt[warp * 256 + digit], so the lanes of a warp that hold different
// digits mostly hit different banks, and thread d of the block owns digit
// d when the counters are scanned across warps.

constexpr int kSortThreadsPerBlock = kRadix;  // thread d owns digit d
constexpr int kSortWarpsPerBlock = kSortThreadsPerBlock / 32;
constexpr int kSortItems = 8;  // survivors per lane per tile
constexpr int64_t kSortTile = int64_t{kSortThreadsPerBlock} * kSortItems;
constexpr int kHistItems = 4;  // survivors per lane in sort_hist
constexpr int64_t kHistTile = int64_t{kSortThreadsPerBlock} * kHistItems;
constexpr int64_t kSpinLimit = int64_t{1} << 26;  // ~seconds: a lost tile

// The sort orders survivors by top - u ascending (u descending): every
// survivor has tau <= u <= top, so only the bytes that top - tau spans
// need a pass (at least one, which also writes the output).
__device__ __forceinline__ uint32_t sort_base(const RowState& st) {
  return max(st.top, st.prefix);  // top stays 0 if every survivor is tau
}

__device__ __forceinline__ int sort_passes(const RowState& st) {
  const int bits = 32 - __clz(sort_base(st) - st.prefix);
  return max(1, (bits + kDigitBits - 1) / kDigitBits);
}

__device__ __forceinline__ uint32_t sort_digit(uint32_t base, uint32_t key,
                                               int shift) {
  return ((base - key) >> shift) & (kRadix - 1);
}

// The lanes of `live` whose digit equals this lane's: one ballot per digit
// bit (every lane of the warp calls it).
__device__ __forceinline__ unsigned digit_peers(uint32_t d, unsigned live) {
  unsigned peers = live;
#pragma unroll
  for (int bit = 0; bit < kDigitBits; ++bit) {
    const unsigned set = __ballot_sync(kFull, (d >> bit) & 1u);
    peers &= ((d >> bit) & 1u) ? set : ~set;
  }
  return peers;
}

int64_t sort_tiles(int64_t k) { return (k + kSortTile - 1) / kSortTile; }

// Per block of kHistTile survivors: the digit counts of all 4 passes (one
// shared atomic per entry and pass), added into the row's histograms
// hist[row][pass][digit].
__global__ void __launch_bounds__(kSortThreadsPerBlock)
    sort_hist_kernel(const uint2* __restrict__ pairs, int64_t k,
                     const RowState* __restrict__ state,
                     uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[kPasses][kRadix];
  const int row = blockIdx.y;
  const uint32_t base = sort_base(state[row]);
  for (int p = 0; p < kPasses; ++p) sh[p][threadIdx.x] = 0;
  __syncthreads();
  const uint2* pr = pairs + row * k;
  const int64_t begin = blockIdx.x * kHistTile;
  uint32_t key[kHistItems];
#pragma unroll
  for (int j = 0; j < kHistItems; ++j) {
    const int64_t i = begin + j * kSortThreadsPerBlock + threadIdx.x;
    key[j] = i < k ? pr[i].x : kNoKey;
  }
#pragma unroll
  for (int j = 0; j < kHistItems; ++j) {
    if (key[j] == kNoKey) continue;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      atomicAdd(&sh[p][sort_digit(base, key[j], p * kDigitBits)], 1u);
    }
  }
  __syncthreads();
  for (int p = 0; p < kPasses; ++p) {
    const uint32_t c = sh[p][threadIdx.x];
    if (c) atomicAdd(&hist[(row * kPasses + p) * kRadix + threadIdx.x], c);
  }
}

__device__ __forceinline__ void publish(unsigned long long* slot, uint32_t tag,
                                        uint32_t count) {
  *reinterpret_cast<volatile unsigned long long*>(slot) =
      (static_cast<unsigned long long>(tag) << 32) | count;
}

// One pass for one tile: rank each survivor stably and scatter it. Warp w
// owns entries [w * 32 * kSortItems, (w + 1) * 32 * kSortItems) of the
// tile and walks them 32 at a time, so (warp, step, lane) is index order.
template <typename T>
__global__ void __launch_bounds__(kSortThreadsPerBlock)
    sort_onesweep_kernel(const uint2* __restrict__ pairs_in, int64_t k,
                         const RowState* __restrict__ state,
                         const uint32_t* __restrict__ hist,
                         uint32_t* __restrict__ tickets,
                         unsigned long long* __restrict__ status, int pass,
                         uint2* __restrict__ pairs_out, const T* __restrict__ x,
                         int64_t t, int* __restrict__ out_idx,
                         float* __restrict__ out_vals) {
  __shared__ uint32_t cnt[kSortWarpsPerBlock * kRadix];  // [warp][digit]
  __shared__ uint32_t warp_tot[kSortWarpsPerBlock];
  __shared__ uint32_t tile_s;
  const int row = blockIdx.y;
  const int64_t tiles = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = threadIdx.x;  // the digit this thread owns below
  const int shift = pass * kDigitBits;
  const RowState rs = state[row];
  const int passes = sort_passes(rs);
  if (pass >= passes) return;  // this row's keys span fewer bytes
  const uint32_t base = sort_base(rs);
  if (threadIdx.x == 0) tile_s = atomicAdd(tickets + row, 1u);
  for (int w = 0; w < kSortWarpsPerBlock; ++w) cnt[w * kRadix + d] = 0;
  __syncthreads();
  const int64_t tile = tile_s;
  const uint2* pr = pairs_in + row * k;
  const int64_t seg = tile * kSortTile + int64_t{warp} * 32 * kSortItems;
  uint2 item[kSortItems];
  uint32_t local[kSortItems];  // rank among this warp's equal digits
  uint32_t* wc = cnt + warp * kRadix;
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    const int64_t i = seg + s * 32 + lane;
    item[s] = i < k ? pr[i] : make_uint2(0u, 0u);
  }
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    const bool live = seg + s * 32 + lane < k;
    const unsigned lm = __ballot_sync(kFull, live);
    const uint32_t dig = sort_digit(base, item[s].x, shift);
    const unsigned peers = digit_peers(dig, lm);
    const uint32_t prior = live ? wc[dig] : 0u;
    local[s] = prior + __popc(peers & lanemask_lt(lane));
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) wc[dig] = prior + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: this tile's count of digit d, published at once
  uint32_t own = 0;
  for (int w = 0; w < kSortWarpsPerBlock; ++w) own += cnt[w * kRadix + d];
  const uint32_t tag_agg = 2u * pass + 1u, tag_incl = 2u * pass + 2u;
  unsigned long long* st = status + row * tiles * kRadix;
  publish(st + tile * kRadix + d, tile == 0 ? tag_incl : tag_agg, own);
  // where digit d starts in the row: the exclusive scan of the histogram
  const uint32_t h = hist[(row * kPasses + pass) * kRadix + d];
  uint32_t incl = h;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  // the look-back: digit d's entries in the tiles before this one
  uint32_t before = 0;
  int64_t spins = 0;
  for (int64_t j = tile - 1; j >= 0;) {
    const unsigned long long v =
        *reinterpret_cast<volatile unsigned long long*>(st + j * kRadix + d);
    const uint32_t tag = static_cast<uint32_t>(v >> 32);
    if (tag == tag_incl) {
      before += static_cast<uint32_t>(v);
      break;
    }
    if (tag == tag_agg) {
      before += static_cast<uint32_t>(v);
      --j;
      continue;
    }
    if (++spins > kSpinLimit) __trap();  // a tile that never published
    __nanosleep(32);
  }
  if (tile > 0) publish(st + tile * kRadix + d, tag_incl, before + own);
  __syncthreads();  // warp_tot complete
  uint32_t run = incl - h + before;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int w = 0; w < kSortWarpsPerBlock; ++w) {
    const uint32_t c = cnt[w * kRadix + d];
    cnt[w * kRadix + d] = run;
    run += c;
  }
  __syncthreads();
  const bool last = pass == passes - 1;
  const T* xr = x + row * t;
#pragma unroll
  for (int s = 0; s < kSortItems; ++s) {
    if (seg + s * 32 + lane >= k) continue;
    const int64_t slot = wc[sort_digit(base, item[s].x, shift)] + local[s];
    if (last) {
      const uint32_t id = item[s].y;
      out_idx[row * k + slot] = static_cast<int>(id);
      out_vals[row * k + slot] = widen(xr[id]);
    } else {
      pairs_out[row * k + slot] = item[s];
    }
  }
}

struct Scratch {
  RowState* state;
  uint32_t* hist;
  uint32_t* done_hist;   // per row: blocks done with this select pass
  uint32_t* done_count;  // per row: blocks done counting
  uint32_t* sort_hist;   // per row and sort pass: digit counts
  uint32_t* tickets;     // per row and sort pass: tiles started
  unsigned long long* status;  // per row, tile and digit: look-back words
  int* counts;
  uint2* pairs_a;
  uint2* pairs_b;
};

int64_t chunks(int64_t t) { return (t + kChunk - 1) / kChunk; }

// The words the launch zeroes, at the front of the scratch: the state, the
// histograms, the counters and the look-back words.
int64_t zeroed_words(int64_t b, int64_t k) {
  return b * (4 + kSelectRadix + 2 + kPasses * kRadix + kPasses) +
         2 * b * sort_tiles(k) * kRadix;
}

// In 32-bit words; every part starts on an even word, so the 64-bit
// look-back words and the (key, idx) pairs are 8-byte aligned.
int64_t scratch_words(int64_t b, int64_t t, int64_t k) {
  return zeroed_words(b, k) + 2 * b * chunks(t) + 4 * b * k;
}

Scratch carve(void* scratch, int64_t b, int64_t t, int64_t k) {
  uint32_t* w = static_cast<uint32_t*>(scratch);
  Scratch s;
  s.state = reinterpret_cast<RowState*>(w);
  w += b * 4;
  s.hist = w;
  w += b * kSelectRadix;
  s.done_hist = w;
  w += b;
  s.done_count = w;
  w += b;
  s.sort_hist = w;
  w += b * kPasses * kRadix;
  s.tickets = w;
  w += b * kPasses;
  s.status = reinterpret_cast<unsigned long long*>(w);
  w += 2 * b * sort_tiles(k) * kRadix;
  s.counts = reinterpret_cast<int*>(w);
  w += 2 * b * chunks(t);
  s.pairs_a = reinterpret_cast<uint2*>(w);
  w += 2 * b * k;
  s.pairs_b = reinterpret_cast<uint2*>(w);
  return s;
}

template <typename T>
int launch(const void* xv, void* out_idx, void* out_vals, void* scratch,
           int64_t b, int64_t t, int64_t k, void* stream_v) {
  const T* x = static_cast<const T*>(xv);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const int64_t nb = chunks(t);
  Scratch s = carve(scratch, b, t, k);
  // the state, the histograms and the counters start at zero; nothing
  // else needs it
  cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * zeroed_words(b, k), stream);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(b));
  // the select: 11-, 10- and 10-bit digits, high first, cover the 31 key
  // bits
  hist_kernel<T, 11><<<grid, kThreads, 0, stream>>>(
      x, t, s.state, s.hist, s.done_hist, 20, static_cast<uint32_t>(k), 1);
  hist_kernel<T, 10><<<grid, kThreads, 0, stream>>>(
      x, t, s.state, s.hist, s.done_hist, 10, static_cast<uint32_t>(k), 0);
  hist_kernel<T, 10><<<grid, kThreads, 0, stream>>>(
      x, t, s.state, s.hist, s.done_hist, 0, static_cast<uint32_t>(k), 0);
  count_kernel<T><<<grid, kThreads, 0, stream>>>(x, t, s.state, s.counts,
                                                 s.done_count, nb);
  compact_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, t, s.state, s.counts, nb, k, s.pairs_a);
  const dim3 hist_grid(static_cast<unsigned>((k + kHistTile - 1) / kHistTile),
                       static_cast<unsigned>(b));
  sort_hist_kernel<<<hist_grid, kSortThreadsPerBlock, 0, stream>>>(
      s.pairs_a, k, s.state, s.sort_hist);
  const dim3 sort_grid(static_cast<unsigned>(sort_tiles(k)),
                       static_cast<unsigned>(b));
  for (int pass = 0; pass < kPasses; ++pass) {  // low digit first
    const uint2* in = (pass & 1) ? s.pairs_b : s.pairs_a;
    uint2* out = (pass & 1) ? s.pairs_a : s.pairs_b;
    sort_onesweep_kernel<T><<<sort_grid, kSortThreadsPerBlock, 0, stream>>>(
        in, k, s.state, s.sort_hist, s.tickets + pass * b, s.status, pass,
        out, x, t,
        static_cast<int*>(out_idx), static_cast<float*>(out_vals));
  }
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
