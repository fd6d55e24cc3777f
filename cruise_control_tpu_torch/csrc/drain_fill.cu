// KP: the replica bulk drain's fill — everything of one drain round after
// its lexsort, in one launch.
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
//     slot of each partition only (scatter_reduce amin: an int32 atomicMin
//     per taken slot), the global rank (an exact integer scan), rank < N;
//  4. tree_sum of the taken weights (XLA's windows of 32), the batch's
//     per-unit maximum load per resource, the intake budgets capped by
//     every capacity's headroom (_capacity_budget_cap, its FMAs) and, for
//     util goals, by the replica-count ceiling;
//  5. the deficit-first fill: a stable argsort of -deficit, scan_sum of the
//     sorted budgets, scan_sum(tw) - tw / 2, searchsorted (left);
//  6. the scatter of (p, r, dst, ok) into N slots (the rest zero).
//
// The launch is one cluster of 8 blocks of 1,024 threads: every phase is a
// loop over the cluster's threads, phases separated by the cluster's
// barrier (fenced: the phases exchange through global scratch), the
// broker-sized step 4-5 done by block 0 alone. Bound on the card: bytes
// at the scale cell (the slots' planes read a few times); at the main
// path's 40,192 slots the ~30 barriers of the scans dominate.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr uint8_t kCand = 1, kMust = 2, kTake = 4;
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
  // scratch
  int32_t* sb;                  // [n]
  float* sw;                    // [n]
  uint8_t* flags;               // [n]
  float* cum;                   // [n]
  float* tw;                    // [n]
  int64_t* grank;               // [n]
  int32_t* first_pos;           // [P]
  int64_t* perm;                // [B1]
  int64_t* counts;              // [kCluster * kThreads + kCluster]
  float* fs;                    // drain_scratch(n, B1) floats
  int64_t n, P, R, B1, N;
};

namespace {

// First index of the non-decreasing a[0..n) with a[i] >= v.
__device__ __forceinline__ int64_t lower_bound_int(const int32_t* a,
                                                   int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int64_t warp_incl_scan(int64_t v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
drain_fill_kernel(const DrainArgs a) {
  const ordered::Cluster g{};
  const int64_t n = a.n, B1 = a.B1, R = a.R;
  const int64_t tid = g.rank(), nthreads = g.size();
  // float scratch
  float* per_key = a.fs;                          // [B1]
  float* oscan = per_key + B1;                    // [B1]
  float* budget = oscan + B1;                     // [B1]
  float* cum_budget = budget + B1;                // [B1]
  float* pum = cum_budget + B1;                   // [kCluster * 4]
  float* scan_scr = pum + kCluster * 4;           // scan_scratch(n)
  float* tree_scr = scan_scr + ordered::scan_scratch(n);   // tree(n)
  float* btree_scr = tree_scr + ordered::tree_scratch(n);  // tree(B1)
  float* bscan_scr = btree_scr + ordered::tree_scratch(B1) + 1;

  // 1. the sorted slots; the first-taken table and the outputs cleared
  for (int64_t i = tid; i < n; i += nthreads) {
    const int64_t o = a.order[i];
    a.sb[i] = static_cast<int32_t>(a.rb[o]);
    const bool c = a.cand[o] != 0;
    a.sw[i] = c ? a.w[o] : 0.0f;
    a.flags[i] = (c ? kCand : 0) | (a.must[o] ? kMust : 0);
  }
  for (int64_t p = tid; p < a.P; p += nthreads) {
    a.first_pos[p] = static_cast<int32_t>(n);
  }
  for (int64_t s = tid; s < a.N; s += nthreads) {
    a.p_out[s] = 0;
    a.r_out[s] = 0;
    a.dst_out[s] = 0;
    a.ok_out[s] = 0;
  }
  g.sync();

  // 2. each broker's run summed in order (KB), scan_sum of the weights,
  // scan_sum of the per-broker sums
  for (int64_t b = tid; b < B1; b += nthreads) {
    const int64_t lo = lower_bound_int(a.sb, n, static_cast<int32_t>(b));
    const int64_t hi = lower_bound_int(a.sb, n, static_cast<int32_t>(b + 1));
    float acc = 0.0f;
    for (int64_t i = lo; i < hi; ++i) acc = __fadd_rn(acc, a.sw[i]);
    per_key[b] = acc;
  }
  ordered::scan16(g, [&](int64_t i) { return a.sw[i]; }, a.cum, n, scan_scr);
  ordered::scan16(g, [&](int64_t b) { return per_key[b]; }, oscan, B1,
                  scan_scr);

  // 3. take, and the first taken slot of each partition
  for (int64_t i = tid; i < n; i += nthreads) {
    const int64_t b = a.sb[i];
    const float offset = __fsub_rn(oscan[b], per_key[b]);
    const float before = __fsub_rn(__fsub_rn(a.cum[i], a.sw[i]), offset);
    const uint8_t f = a.flags[i];
    const bool take = (f & kCand) && (before < a.quota[b] || (f & kMust));
    if (take) {
      a.flags[i] = f | kTake;
      atomicMin(a.first_pos + a.order[i] / R, static_cast<int32_t>(i));
    }
  }
  g.sync();

  // the global rank of the kept slots: each thread counts a contiguous
  // chunk, an exclusive scan over the threads, then the chunk in order
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  const int64_t c_lo = tid * chunk < n ? tid * chunk : n;
  const int64_t c_hi = c_lo + chunk < n ? c_lo + chunk : n;
  int64_t mine = 0;
  for (int64_t i = c_lo; i < c_hi; ++i) {
    uint8_t f = a.flags[i];
    if ((f & kTake) && a.first_pos[a.order[i] / R] != i) {
      f &= ~kTake;
      a.flags[i] = f;
    }
    mine += (f & kTake) ? 1 : 0;
  }
  __shared__ int64_t s_warp[kWarps];
  const int64_t incl = warp_incl_scan(mine);
  if ((threadIdx.x & 31) == 31) s_warp[threadIdx.x >> 5] = incl;
  __syncthreads();
  int64_t before_warp = 0, block_total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < static_cast<int>(threadIdx.x >> 5)) before_warp += s_warp[w];
    block_total += s_warp[w];
  }
  int64_t* block_totals = a.counts;
  if (threadIdx.x == 0) block_totals[blockIdx.x] = block_total;
  g.sync();
  int64_t base = before_warp + incl - mine, total = 0;
  for (int c = 0; c < kCluster; ++c) {
    if (c < static_cast<int>(blockIdx.x)) base += block_totals[c];
    total += block_totals[c];
  }
  const int64_t n_kept = total < a.N ? total : a.N;
  // rank < N; the taken weights; the batch's per-unit maximum loads
  float pmax[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = c_lo; i < c_hi; ++i) {
    uint8_t f = a.flags[i];
    if (f & kTake) {
      a.grank[i] = base++;
      if (a.grank[i] >= a.N) {
        f &= ~kTake;
        a.flags[i] = f;
      }
    }
    const bool take = (f & kTake) != 0;
    const float sw = a.sw[i];
    a.tw[i] = take ? sw : 0.0f;
    const int64_t o = a.order[i];
    const float* load = (o % R == 0 ? a.leader_load : a.follower_load)
                        + (o / R) * 4;
    const float den = sw < 1e-9f ? 1e-9f : sw;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pmax[c] = fmaxf(pmax[c], take ? __fdiv_rn(load[c], den) : 0.0f);
    }
  }
  __shared__ float s_max[kWarps][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = warp_max(pmax[c]);
    if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5][c] = m;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_max[w][threadIdx.x]);
    pum[blockIdx.x * 4 + threadIdx.x] = m;
  }
  g.sync();

  // 4. the taken weights' tree sum (every thread gets it)
  const float tsum = ordered::tree_sum(g, [&](int64_t i) { return a.tw[i]; },
                                       n, tree_scr);
  const float total_w = tsum < 1e-9f ? 1e-9f : tsum;
  const float n_take = n_kept < 1 ? 1.0f : static_cast<float>(n_kept);

  if (blockIdx.x == 0) {
    const ordered::Block blk{};
    float umax[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float m = -INFINITY;
      for (int k = 0; k < kCluster; ++k) m = fmaxf(m, pum[k * 4 + c]);
      umax[c] = m < 1e-9f ? 1e-9f : m;
    }
    int64_t alive = 0;
    for (int64_t b0 = 0; b0 < B1; b0 += blockDim.x) {
      const int64_t b = b0 + threadIdx.x;
      alive += __syncthreads_count(b < B1 && a.alive[b] != 0);
    }
    const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
    float cnt_up = 0.0f, mean_w = 0.0f;
    if (!a.count_goal) {
      const float cnt_total = ordered::tree_sum(
          blk,
          [&](int64_t b) {
            return a.bvalid[b] ? static_cast<float>(a.cnt[b]) : 0.0f;
          },
          B1, btree_scr);
      const float cnt_avg = __fdiv_rn(cnt_total, n_alive);
      cnt_up = fmaxf(__fmul_rn(cnt_avg, a.rbt), ceilf(cnt_avg));
      mean_w = __fdiv_rn(total_w, n_take);
    }
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      const float v = a.values[b];
      const float um = a.cap != nullptr
          ? __fmaf_rn(a.cap[b], a.cap_thr, -v)
          : __fsub_rn(a.up[b], v);
      float bud = (a.alive[b] && a.dest[b] && a.bvalid[b])
                      ? ordered::clamp0(um) : 0.0f;
      // _capacity_budget_cap
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float head = __fmaf_rn(a.thr[c], a.capacity[b * 4 + c],
                                     -a.util[b * 4 + c]);
        const float units = __fdiv_rn(ordered::clamp0(head), umax[c]);
        bud = fminf(bud, __fmul_rn(0.9f, units));
      }
      bud = ordered::clamp0(bud);
      if (!a.count_goal) {
        const float room = ordered::clamp0(
            __fsub_rn(cnt_up, static_cast<float>(a.cnt[b])));
        bud = fminf(bud, __fmul_rn(room, mean_w));
      }
      budget[b] = ordered::clamp0(bud);
    }
    __syncthreads();
    // 5. deficit-first receivers and their cumulative budgets
    ordered::rank_sort(blk, [&](int64_t b) { return -a.deficit[b]; }, B1,
                       a.perm);
    ordered::scan16(blk, [&](int64_t j) { return budget[a.perm[j]]; },
                    cum_budget, B1, bscan_scr);
  }
  g.sync();

  // the midpoint of each slot's cumulative taken weight, matched against
  // the cumulative budgets; 6. the scatter
  ordered::scan16(g, [&](int64_t i) { return a.tw[i]; }, a.cum, n, scan_scr);
  const float last = cum_budget[B1 - 1];
  for (int64_t i = tid; i < n; i += nthreads) {
    if (!(a.flags[i] & kTake)) continue;
    const float target = __fsub_rn(a.cum[i], __fmul_rn(0.5f, a.tw[i]));
    const int64_t pos = ordered::lower_bound(cum_budget, B1, target);
    if (pos < B1 && target < last) {
      const int64_t s = a.grank[i];
      const int64_t o = a.order[i];
      a.p_out[s] = o / R;
      a.r_out[s] = o % R;
      a.dst_out[s] = a.perm[pos];
      a.ok_out[s] = 1;
    }
  }
}

}  // namespace

// Floats of scratch KP needs at n slots and B1 brokers.
extern "C" int64_t cc_drain_fill_scratch(int64_t n, int64_t b1) {
  return 4 * b1 + kCluster * 4 + ordered::scan_scratch(n)
         + ordered::tree_scratch(n) + ordered::tree_scratch(b1) + 1
         + ordered::scan_scratch(b1) + 1;
}

// Int64 words of KP's count scratch.
extern "C" int64_t cc_drain_fill_counts() {
  return kCluster * kThreads + kCluster;
}

extern "C" int cc_drain_fill(const DrainArgs* args, void* stream) {
  if (args->n <= 0 || args->B1 <= 0 || args->n >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  drain_fill_kernel<<<kCluster, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(DrainArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_drain_args_size() { return sizeof(DrainArgs); }
