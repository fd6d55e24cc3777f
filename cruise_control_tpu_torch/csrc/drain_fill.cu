// KP: the replica bulk drain's fill -- everything of one drain round after
// its lexsort, in seven launches over the whole card.
//
// Replaces cruise_control_tpu/analyzer/goals.py:_replica_bulk_drain
// (:486-631) from the sort on: in plain torch about 80 launches a round,
// among them three 16-block scans over the P x R replicas of 16 launches
// a level (utils/ordered.py:scan_sum), a segment sum (KB) and a tree sum.
//
// Over the n = P x R replica slots in the lexsort's order (broker first,
// so each broker's slots are one run), as the reference computes them:
//  1. the sorted broker, weight (0 where not a candidate) and must flags;
//  2. _segment_cum_before as its composite, scan_sum(w) - w - offset[b]
//     with offset = scan_sum(per_broker) - per_broker and per_broker KB's
//     in-order sum of a broker's run (a direct segmented scan would round
//     differently);
//  3. take = candidate & (before < quota[b] | must), then the first taken
//     slot of each partition only, the global rank (an exact integer
//     scan), rank < N;
//  4. tree_sum of the taken weights (XLA's windows of 32), the batch's
//     per-unit maximum load per resource, the intake budgets capped by
//     every capacity's headroom (_capacity_budget_cap, its FMAs) and, for
//     util goals, by the replica-count ceiling;
//  5. the deficit-first fill: a stable argsort of -deficit, scan_sum of the
//     sorted budgets, scan_sum(tw) - tw / 2, searchsorted (left);
//  6. the scatter of (p, r, dst, ok) into N slots (the rest zero).
//
// The scan levels, cum_at and the runs' in-order sums are drain.cuh's,
// which KAA (leadership_drain.cu) shares; KZ (drain_order.cu) gives KP its
// order.
//
// Bound on the card: bytes at the scale cell (the slots' planes read a
// few times, ~40 bytes a slot); at the main path's 40,192 slots the
// launches, each a few memory round trips, and the longest broker run's
// in-order sum. The launch boundaries are the only barriers (no fence, no
// cluster). Gathers run a thread a slot over the whole card (a block per
// chunk would draw on a few SMs' bandwidth only), every load issued before
// the stores; chunks are 4,096 = 16^3 slots, so both scan16s' lower three
// levels stay inside a block and only the chunks' totals cross blocks:
//  L1 gather (a thread a slot): the sorted slots, their place in the sort
//     (inverse order), and where each broker's run starts (the slot that
//     starts a run writes it for its broker and every absent one before
//     it). The outputs and counters zeroed;
//  L2 keys: a block a chunk for the chunk's levels of the first scan16 (a
//     thread sums a 16-block in order, 16 threads the level-1 blocks, one
//     thread the chunk's 16 level-2 values); a warp a broker for its run's
//     in-order sum (KB's order; drain.cuh:run_sum: the run copied
//     ahead through a ring in shared memory, one dependent add a slot);
//     blocks of 64 brokers x 2,048 keys counting each broker's rank in the
//     stable argsort of -deficit (integer atomics);
//  L3 one block: scan16 of the per-broker sums and of the chunk totals;
//  L4 take (a thread a slot): its cumulative shed from the chunk-local
//     levels and the scanned totals, take, and the first taken slot of its
//     partition (kept unless a sibling replica earlier in the order is
//     taken too: recomputed, not read); kept counts a chunk (atomics);
//  L5 rank (a block a chunk): the global rank (the kept counts before the
//     chunk, then in order), rank < N, the taken weights, the chunk's
//     per-unit maxima, the second scan16's chunk-local levels, and the
//     tree_sum's first level: the chunk's 128 windows of 32 start 0-15
//     slots before it (the padding split front and back), whose taken
//     weights it recomputes from the kept counts;
//  L6 one block: the tree's upper levels, the budgets, the argsort from
//     the ranks, scan16 of the sorted budgets and of the chunk totals;
//  L7 scatter (a thread a slot): the midpoint, searchsorted over the
//     cumulative budgets (staged in shared memory), the outputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "drain.cuh"
#include "ordered.cuh"

namespace {

using drain::chunk_scan;
using drain::kChunk;
using drain::kStage;
using drain::pad;
using drain::staged_scan16;

constexpr int kChunkThreads = 1024;        // four slots a thread
constexpr int kSlotThreads = 256;          // the launches of a thread a slot
constexpr int kSmallThreads = 256;         // the one-block launches
constexpr int kKeysThreads = 256;          // the keys launch's blocks
constexpr int kRankRows = 64;              // brokers a rank block ranks
constexpr int kRankTile = 2048;            // keys a rank block compares
constexpr int kRing = 8;                   // a broker warp's chunks in flight
constexpr int kStageBudgets = 4096;        // cumulative budgets in shared
constexpr uint8_t kCand = 1, kMust = 2, kKept = 4, kTake = 8;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

struct DrainArgs {
  const int64_t* order;         // [n] the lexsort's order of the slots
  const int64_t* rb;            // [n] flat replica brokers
  const float* w;               // [n] flat drain weights
  const uint8_t* cand;          // [n]
  const uint8_t* must;          // [n] offline & cand
  const float* quota;           // [B1]
  const float* deficit;         // [B1]
  const float* values;          // [B1]
  const float* up;              // [B1]
  const uint8_t* alive;         // [B1]
  const uint8_t* dest;          // [B1]
  const uint8_t* bvalid;        // [B1]
  const float* capacity;        // [B1, 4]
  const float* util;            // [B1, 4]
  const int32_t* cnt;           // [B1] replica counts
  const float* leader_load;     // [P, 4]
  const float* follower_load;   // [P, 4]
  float thr[4];                 // capacity thresholds
  const float* cap;             // [B1] or null: the upper bound is cap x cap_thr
  float cap_thr;
  int32_t count_goal;
  float rbt;                    // replica balance threshold
  int64_t* p_out;               // [N]
  int64_t* r_out;
  int64_t* dst_out;
  uint8_t* ok_out;
  // scratch (n slots, nch = ceil(n / 4096) chunks)
  int32_t* sb;                  // [n] sorted brokers
  float* sw;                    // [n] sorted weights
  uint8_t* flags;               // [n]
  int32_t* inv;                 // [n] a slot's place in the order
  int32_t* grank;               // [n] a taken slot's global rank
  float* loc0;                  // [n] a scan16's level 0 in its 16-blocks
  float* loc1;                  // [ceil(n / 16)] level 1 in its 16-blocks
  float* loc2;                  // [ceil(n / 256)] level 2
  float* t3;                    // [nch] the chunks' totals
  float* out3;                  // [nch] their scan16
  int32_t* kept;                // [nch] kept slots a chunk
  float* pmax;                  // [nch, 4] per-unit maxima a chunk
  float* wsum;                  // [ceil(n / 32)] tree_sum's first level
  int32_t* run_start;           // [B1 + 1] first slot of broker >= b
  float* per_key;               // [B1]
  float* oscan;                 // [B1]
  int32_t* rank;                // [B1] rank in the argsort of -deficit
  int64_t* perm;                // [B1] the argsort
  float* budget;                // [B1]
  float* cum_budget;            // [B1]
  float* scr;                   // cc_drain_fill_scratch(n, B1) floats
  int64_t n, P, R, B1, N;
};

namespace {

// KP's scan levels (drain.cuh)
__device__ __forceinline__ drain::Levels levels(const DrainArgs& a) {
  return drain::Levels{a.loc0, a.loc1, a.loc2, a.t3, a.out3};
}

// The sum of v over the block, returned to every thread (``s_red`` holds
// a word a warp).
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    total += s_red[w];
  }
  return total;
}

// The exclusive prefix of v over the block's threads in order (``s_red``
// holds a word a warp).
__device__ __forceinline__ int block_exclusive(int v, int* s_red) {
  const int lane = threadIdx.x & 31;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_red[threadIdx.x >> 5] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < static_cast<int>(threadIdx.x >> 5); ++w) {
    before += s_red[w];
  }
  return before + incl - v;
}

// Whether slot i is taken before the first-per-partition rule.
__device__ bool take_at(const DrainArgs& a, int64_t i) {
  // loaded whether or not a candidate: two memory round trips, not four
  const uint8_t f = a.flags[i];
  const int32_t b = a.sb[i];
  const float sw = a.sw[i], cum = drain::cum_at(levels(a), i);
  const float offset = __fsub_rn(a.oscan[b], a.per_key[b]);
  const float before = __fsub_rn(__fsub_rn(cum, sw), offset);
  return (f & kCand) && (before < a.quota[b] || (f & kMust));
}

__global__ void __launch_bounds__(kSlotThreads) drain_gather_kernel(
    const DrainArgs a, int64_t nch) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = i; s < a.N; s += stride) {
    a.p_out[s] = 0;
    a.r_out[s] = 0;
    a.dst_out[s] = 0;
    a.ok_out[s] = 0;
  }
  for (int64_t b = i; b < a.B1; b += stride) a.rank[b] = 0;
  for (int64_t k = i; k < nch; k += stride) a.kept[k] = 0;
  if (i >= a.n) return;
  // every load first, then the stores
  const int64_t o = a.order[i];
  const int64_t o_prev = i == 0 ? o : a.order[i - 1];
  const int32_t b = static_cast<int32_t>(a.rb[o]);
  const int64_t prev = i == 0 ? -1 : a.rb[o_prev];
  const bool cnd = a.cand[o] != 0;
  const float w = a.w[o];
  const bool must = a.must[o] != 0;
  a.sb[i] = b;
  a.sw[i] = cnd ? w : 0.0f;
  a.flags[i] = (cnd ? kCand : 0) | (must ? kMust : 0);
  a.inv[o] = static_cast<int32_t>(i);
  // a run starts here: this broker's and every absent one's before it
  if (prev < b) {
    const int64_t hi = b < a.B1 ? b : a.B1;
    for (int64_t q = prev + 1 > 0 ? prev + 1 : 0; q <= hi; ++q) {
      a.run_start[q] = static_cast<int32_t>(i);
    }
  }
  if (i == a.n - 1) {
    for (int64_t q = (b + 1 > 0 ? b + 1 : 0); q <= a.B1; ++q) {
      a.run_start[q] = static_cast<int32_t>(a.n);
    }
  }
}

__global__ void __launch_bounds__(kKeysThreads) drain_keys_kernel(
    const DrainArgs a, int64_t nch, int64_t broker_blocks) {
  __shared__ float s_x[kChunk + kChunk / 16];
  __shared__ float s_t1[kChunk / 16];
  __shared__ float s_t2[16];
  __shared__ __align__(16) float s_ring[kKeysThreads / 32][kRing][32];
  __shared__ int s_n[kKeysThreads / 32][kRing];
  if (blockIdx.x < nch) {
    // ---- the chunk's levels of the first scan16 (of the weights)
    const int64_t c = blockIdx.x;
    const int m = drain::chunk_slots(a.n, c);
    constexpr int kPer = kChunk / kKeysThreads;
    float v[kPer];                             // every load, then the stores
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = threadIdx.x + u * kKeysThreads;
      v[u] = a.sw[c * kChunk + (k < m ? k : m - 1)];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = threadIdx.x + u * kKeysThreads;
      if (k < m) s_x[pad(k)] = v[u];
    }
    __syncthreads();
    chunk_scan(levels(a), c, m, s_x, s_t1, s_t2);
    return;
  }
  if (blockIdx.x < nch + broker_blocks) {
    // ---- each broker's run summed in order (KB): a warp a broker
    const int warp = threadIdx.x >> 5;
    const int64_t b = (blockIdx.x - nch) * (kKeysThreads / 32) + warp;
    if (b >= a.B1) return;
    const float acc = drain::run_sum<kRing>(
        a.sw, a.run_start[b], a.run_start[b + 1], s_ring[warp][0],
        s_n[warp]);
    if ((threadIdx.x & 31) == 0) a.per_key[b] = acc;
    return;
  }
  // ---- ranks in the stable argsort of -deficit: a block compares 64
  // brokers with 2,048 keys, each broker's a quarter by one thread (the
  // lower index first among ties, -0.0 equal to +0.0, as
  // torch.sort(stable=True) compares)
  __shared__ float s_key[kRankTile];
  constexpr int kSplit = kKeysThreads / kRankRows;
  const int64_t j_tiles = (a.B1 + kRankTile - 1) / kRankTile;
  const int64_t blk = blockIdx.x - nch - broker_blocks;
  const int64_t i = (blk / j_tiles) * kRankRows + threadIdx.x % kRankRows;
  const int64_t j0 = (blk % j_tiles) * kRankTile;
  const int nj = static_cast<int>(a.B1 - j0 < kRankTile ? a.B1 - j0
                                                        : kRankTile);
  for (int k = threadIdx.x; k < nj; k += blockDim.x) {
    s_key[k] = -a.deficit[j0 + k];
  }
  __syncthreads();
  if (i >= a.B1) return;
  const float key = -a.deficit[i];
  const int part = threadIdx.x / kRankRows;
  const int k_hi = (part + 1) * (kRankTile / kSplit) < nj
                       ? (part + 1) * (kRankTile / kSplit) : nj;
  int r = 0;
  for (int k = part * (kRankTile / kSplit); k < k_hi; ++k) {
    const float kj = s_key[k];
    r += (kj < key) || (kj == key && j0 + k < i);
  }
  if (r > 0) atomicAdd(a.rank + i, r);
}

__global__ void __launch_bounds__(kSmallThreads) drain_scans_kernel(
    const DrainArgs a, int64_t nch) {
  __shared__ float s_in[kStage], s_out[kStage], s_scr[kStage / 15 + 16];
  staged_scan16(a.per_key, a.oscan, a.B1, a.scr, s_in, s_out, s_scr);
  if (nch > 1) {
    staged_scan16(a.t3, a.out3, nch, a.scr + ordered::scan_scratch(a.B1),
                  s_in, s_out, s_scr);
  }
}

__global__ void __launch_bounds__(kSlotThreads) drain_take_kernel(
    const DrainArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  bool keep = i < a.n && take_at(a, i);
  if (keep) {
    // the first taken slot of its partition: no sibling replica earlier
    // in the order is taken
    const int64_t o = a.order[i];
    const int64_t p = o / a.R, r = o % a.R;
    for (int64_t s = 0; s < a.R && keep; ++s) {
      const int64_t j = a.inv[p * a.R + s];
      keep = !(s != r && j < i && take_at(a, j));
    }
    if (keep) a.flags[i] = a.flags[i] | kKept;
  }
  // a block's slots lie in one chunk (256 divides 4,096)
  const int count = __syncthreads_count(keep);
  if (threadIdx.x == 0 && count > 0) {
    atomicAdd(a.kept + (static_cast<int64_t>(blockIdx.x) * blockDim.x)
                           / kChunk,
              count);
  }
}

__global__ void __launch_bounds__(kChunkThreads) drain_rank_kernel(
    const DrainArgs a, int64_t w0, int front) {
  __shared__ float s_x[kChunk + kChunk / 16];
  __shared__ float s_pre[16];                 // the slots before the chunk
  __shared__ float s_t1[kChunk / 16];
  __shared__ float s_t2[16];
  __shared__ int64_t s_red[kChunkThreads / 32];
  __shared__ int s_scan[kChunkThreads / 32];
  __shared__ float s_max[kChunkThreads / 32][4];
  constexpr int kPer = kChunk / kChunkThreads;
  const int t = threadIdx.x;
  const int64_t c = blockIdx.x;
  const int64_t i0 = c * kChunk;
  const int m = drain::chunk_slots(a.n, c);
  // the kept slots before the chunk
  int64_t before = 0;
  for (int64_t k = t; k < c; k += blockDim.x) before += a.kept[k];
  const int64_t base = block_sum(before, s_red);
  // the thread's four consecutive slots, loaded together
  uint8_t f[kPer];
  float sw[kPer];
  int64_t o[kPer];
  int mine = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int k = kPer * t + u;
    const int64_t i = i0 + (k < m ? k : m - 1);      // every load in range
    f[u] = k < m ? a.flags[i] : 0;
    sw[u] = a.sw[i];
    o[u] = a.order[i];
    mine += (f[u] & kKept) ? 1 : 0;
  }
  int64_t g = base + block_exclusive(mine, s_scan);
  float pm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int k = kPer * t + u;
    if (k >= m) continue;
    const int64_t i = i0 + k;
    bool take = false;
    if (f[u] & kKept) {
      take = g < a.N;
      if (take) {
        a.grank[i] = static_cast<int32_t>(g);
        a.flags[i] = f[u] | kTake;
      }
      ++g;
    }
    s_x[pad(k)] = take ? sw[u] : 0.0f;
    // a slot not taken gives 0.0; only a taken one divides (a correctly
    // rounded division is a few dozen instructions)
    float ratio[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (take) {
      const float4 ld = reinterpret_cast<const float4*>(
          o[u] % a.R == 0 ? a.leader_load : a.follower_load)[o[u] / a.R];
      const float den = sw[u] < 1e-9f ? 1e-9f : sw[u];
      ratio[0] = __fdiv_rn(ld.x, den);
      ratio[1] = __fdiv_rn(ld.y, den);
      ratio[2] = __fdiv_rn(ld.z, den);
      ratio[3] = __fdiv_rn(ld.w, den);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) pm[q] = fmaxf(pm[q], ratio[q]);
  }
  if (t == 0 && c > 0) {
    // tree_sum's first window of the chunk starts ``front`` slots before
    // it: their taken weights from the kept counts (a slot's rank is the
    // chunk's base less the kept slots from it to the chunk)
    int64_t g2 = base;
    for (int q = 1; q <= front; ++q) {
      const int64_t i = i0 - q;
      const bool kept = (a.flags[i] & kKept) != 0;
      g2 -= kept ? 1 : 0;
      s_pre[16 - q] = kept && g2 < a.N ? a.sw[i] : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v = pm[q];
    for (int d = 16; d > 0; d >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(kFull, v, d));
    }
    if ((t & 31) == 0) s_max[t >> 5][q] = v;
  }
  __syncthreads();
  if (t < 4) {
    float v = -INFINITY;
    for (int w = 0; w < kChunkThreads / 32; ++w) v = fmaxf(v, s_max[w][t]);
    a.pmax[c * 4 + t] = v;
  }
  // tree_sum's first level: windows 128c .. 128c + 127 of 32 slots;
  // window 128c + t starts at the chunk's slot 32t - front, so only the
  // first reaches back before the chunk (padding slots are skipped, not
  // added)
  if (a.n > 32) {
    const int64_t k = c * (kChunk / 32) + t;
    if (t < kChunk / 32 && k < w0) {
      const int first = 32 * t - front;           // chunk-local slot
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int q = first + j;
        const int qc = q < 0 ? 0 : (q < m ? q : m - 1);
        v[j] = s_x[pad(qc)];
      }
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j < front) v[j] = s_pre[16 - front + j];
        }
      }
      const int lo = (c == 0 && t == 0) ? front : 0;   // slots before 0
      const int hi = m - first < 32 ? m - first : 32;  // slots past n
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j >= lo && j < hi) acc = __fadd_rn(acc, v[j]);
      }
      a.wsum[k] = acc;
    }
  } else {
    for (int k = t; k < m; k += blockDim.x) a.wsum[k] = s_x[pad(k)];
  }
  __syncthreads();
  chunk_scan(levels(a), c, m, s_x, s_t1, s_t2);
}

__global__ void __launch_bounds__(kSmallThreads) drain_budget_kernel(
    const DrainArgs a, int64_t nch, int64_t m1) {
  __shared__ int64_t s_red[kSmallThreads / 32];
  __shared__ float s_tree[kStage];
  __shared__ float s_bud[kStage], s_cum[kStage], s_scr[kStage / 15 + 16];
  __shared__ int32_t s_perm[kStage];
  const ordered::Block blk{};
  float* scr = a.scr;
  // 4. the taken weights' tree sum, from its first level (the upper
  // levels in shared memory where they fit)
  const float tsum = ordered::tree_sum(
      blk, [&](int64_t k) { return a.wsum[k]; }, m1,
      ordered::tree_scratch(m1) <= kStage ? s_tree : scr);
  __syncthreads();
  scr += ordered::tree_scratch(m1) + 1;
  int64_t kept = 0;
  for (int64_t k = threadIdx.x; k < nch; k += blockDim.x) kept += a.kept[k];
  const int64_t total = block_sum(kept, s_red);
  const int64_t n_kept = total < a.N ? total : a.N;
  const float total_w = tsum < 1e-9f ? 1e-9f : tsum;
  const float n_take = n_kept < 1 ? 1.0f : static_cast<float>(n_kept);
  // the chunks' per-unit maxima: a thread's chunks, then the block's
  float umax[4];
  {
    __shared__ float s_max[kSmallThreads / 32][4];
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int64_t k = threadIdx.x; k < nch; k += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(a.pmax)[k];
      m[0] = fmaxf(m[0], v.x);
      m[1] = fmaxf(m[1], v.y);
      m[2] = fmaxf(m[2], v.z);
      m[3] = fmaxf(m[3], v.w);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int o = 16; o > 0; o >>= 1) {
        m[q] = fmaxf(m[q], __shfl_xor_sync(kFull, m[q], o));
      }
      if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5][q] = m[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = -INFINITY;
      for (int w = 0; w < kSmallThreads / 32; ++w) v = fmaxf(v, s_max[w][q]);
      umax[q] = v < 1e-9f ? 1e-9f : v;
    }
  }
  int64_t alive = 0;
  for (int64_t b0 = 0; b0 < a.B1; b0 += blockDim.x) {
    const int64_t b = b0 + threadIdx.x;
    alive += __syncthreads_count(b < a.B1 && a.alive[b] != 0);
  }
  const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
  float cnt_up = 0.0f, mean_w = 0.0f;
  if (!a.count_goal) {
    const float cnt_total = ordered::tree_sum(
        blk,
        [&](int64_t b) {
          return a.bvalid[b] ? static_cast<float>(a.cnt[b]) : 0.0f;
        },
        a.B1, ordered::tree_scratch(a.B1) <= kStage ? s_tree : scr);
    __syncthreads();
    const float cnt_avg = __fdiv_rn(cnt_total, n_alive);
    cnt_up = fmaxf(__fmul_rn(cnt_avg, a.rbt), ceilf(cnt_avg));
    mean_w = __fdiv_rn(total_w, n_take);
  }
  scr += ordered::tree_scratch(a.B1) + 1;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    const float v = a.values[b];
    const float um = a.cap != nullptr
        ? __fmaf_rn(a.cap[b], a.cap_thr, -v)
        : __fsub_rn(a.up[b], v);
    float bud = (a.alive[b] && a.dest[b] && a.bvalid[b])
                    ? ordered::clamp0(um) : 0.0f;
    // _capacity_budget_cap
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float head = __fmaf_rn(a.thr[q], a.capacity[b * 4 + q],
                                   -a.util[b * 4 + q]);
      const float units = __fdiv_rn(ordered::clamp0(head), umax[q]);
      bud = fminf(bud, __fmul_rn(0.9f, units));
    }
    bud = ordered::clamp0(bud);
    if (!a.count_goal) {
      const float room = ordered::clamp0(
          __fsub_rn(cnt_up, static_cast<float>(a.cnt[b])));
      bud = fminf(bud, __fmul_rn(room, mean_w));
    }
    const float budget = ordered::clamp0(bud);
    const int32_t r = a.rank[b];
    a.perm[r] = b;
    if (a.B1 <= kStage) {
      s_bud[b] = budget;
      s_perm[r] = static_cast<int32_t>(b);
    } else {
      a.budget[b] = budget;
    }
  }
  __syncthreads();
  // 5. deficit-first receivers and their cumulative budgets
  if (a.B1 <= kStage) {
    ordered::scan16(blk, [&](int64_t j) { return s_bud[s_perm[j]]; }, s_cum,
                    a.B1, s_scr);
    for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
      a.cum_budget[b] = s_cum[b];
    }
  } else {
    ordered::scan16(blk, [&](int64_t j) { return a.budget[a.perm[j]]; },
                    a.cum_budget, a.B1, scr);
  }
  scr += ordered::scan_scratch(a.B1) + 1;
  __syncthreads();
  if (nch > 1) {
    staged_scan16(a.t3, a.out3, nch, scr, s_bud, s_cum, s_scr);
  }
}

__global__ void __launch_bounds__(kSlotThreads) drain_scatter_kernel(
    const DrainArgs a) {
  __shared__ float s_cum[kStageBudgets];
  const bool staged = a.B1 <= kStageBudgets;
  if (staged) {
    for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
      s_cum[b] = a.cum_budget[b];
    }
    __syncthreads();
  }
  const float* cum = staged ? s_cum : a.cum_budget;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= a.n || !(a.flags[i] & kTake)) return;
  const float tw = a.sw[i];
  const float target = __fsub_rn(drain::cum_at(levels(a), i),
                                 __fmul_rn(0.5f, tw));
  const int64_t pos = ordered::lower_bound(cum, a.B1, target);
  if (pos < a.B1 && target < cum[a.B1 - 1]) {
    const int64_t s = a.grank[i];
    const int64_t o = a.order[i];
    a.p_out[s] = o / a.R;
    a.r_out[s] = o % a.R;
    a.dst_out[s] = a.perm[pos];
    a.ok_out[s] = 1;
  }
}

}  // namespace

// Floats of KP's one-block scratch at n slots and B1 brokers.
extern "C" int64_t cc_drain_fill_scratch(int64_t n, int64_t b1) {
  const int64_t nch = (n + kChunk - 1) / kChunk;
  const int64_t w0 = (n + 31) / 32;
  const int64_t m1 = n > 32 ? w0 : n;
  const int64_t scans = ordered::scan_scratch(b1) + ordered::scan_scratch(nch)
                        + 2;
  const int64_t budget = ordered::tree_scratch(m1) + ordered::tree_scratch(b1)
                         + ordered::scan_scratch(b1)
                         + ordered::scan_scratch(nch) + 4;
  return scans > budget ? scans : budget;
}

// KP's seven launches on ``stream``; returns cudaGetLastError().
extern "C" int cc_drain_fill(const DrainArgs* args, void* stream) {
  const DrainArgs& a = *args;
  if (a.n <= 0 || a.B1 <= 0 || a.R <= 0 || a.n >= (int64_t{1} << 31)
      || a.B1 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nch = (a.n + kChunk - 1) / kChunk;
  const unsigned slot_blocks = static_cast<unsigned>(
      (a.n + kSlotThreads - 1) / kSlotThreads);
  const int64_t w0 = (a.n + 31) / 32;
  const int front = static_cast<int>((w0 * 32 - a.n) / 2);
  const int64_t broker_blocks = (a.B1 + kKeysThreads / 32 - 1)
                                / (kKeysThreads / 32);
  const int64_t rank_blocks = ((a.B1 + kRankRows - 1) / kRankRows)
                              * ((a.B1 + kRankTile - 1) / kRankTile);
  int err;
  drain_gather_kernel<<<slot_blocks, kSlotThreads, 0, s>>>(a, nch);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_keys_kernel<<<static_cast<unsigned>(nch + broker_blocks
                                            + rank_blocks),
                      kKeysThreads, 0, s>>>(a, nch, broker_blocks);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_scans_kernel<<<1, kSmallThreads, 0, s>>>(a, nch);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_take_kernel<<<slot_blocks, kSlotThreads, 0, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_rank_kernel<<<static_cast<unsigned>(nch), kChunkThreads, 0, s>>>(
      a, w0, front);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_budget_kernel<<<1, kSmallThreads, 0, s>>>(a, nch,
                                                  a.n > 32 ? w0 : a.n);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  drain_scatter_kernel<<<slot_blocks, kSlotThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(DrainArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_drain_args_size() { return sizeof(DrainArgs); }
