// KAA: a leadership drain round whole -- the shed quota and intake budgets,
// each partition's best follower and tie-break noise, the two quota passes
// (shed per source broker, intake per destination broker) and the batch's
// slots, in fourteen launches after a memset. KT (candidates.cu) builds the
// candidates from its (p, r, ok).
//
// Replaces cruise_control_tpu/analyzer/goals.py:_leadership_bulk_drain
// (:633-729) up to make_leadership_candidates: in plain torch (the twin,
// kernels.leadership_drain_plain) about 120 launches, among them two
// lexsorts of two stable torch.sorts each and two _segment_cum_before of a
// 16-block scan_sum (16 launches a level) and a segment sum each.
//
// Over the P partitions, as the reference computes them:
//  - quota (drain.cuh:shed_quota, one block): the metric, its bounds, the
//    excess and deficit, the shed quota a broker and the intake budget
//    (alive, a leader destination, valid: the upper bound less the metric);
//  - a partition's source src (slot 0's broker), w = max(weight, 0) (the
//    goal's weight: 1 a partition, or its leader's NW_IN load), can =
//    leadership-movable & valid & src alive & quota[src] > 0 & w > 0; each
//    follower slot's score (the budget of its broker where the slot may
//    take the leadership, else -inf), the first slot of the highest score
//    (jnp.argmax: -0.0 equal to +0.0, a NaN the highest), a destination
//    only where that maximum is finite; the noise 1 + 0.01 u (KA's draw,
//    csrc/threefry.cuh, bit for bit _random.affine), sort_w = can ? w x
//    noise : -1;
//  - pass 1: the partitions sorted by (src, -sort_w, index) (drain.cuh's
//    segmented sort, key sort_image(-sort_w) | p), each one's cumulative
//    weight of the earlier ones of its source (_segment_cum_before's
//    float order: drain.cuh's scans, as KP computes it), take1 = can &
//    before < quota[src];
//  - the batch's per-unit maximum load per resource (max over take1 of
//    max(leader - follower load, 0) / max(w, 1e-9), a NaN kept, as
//    torch.amax keeps it) and the budgets capped by every resource's
//    headroom (_capacity_budget_cap: the headroom one FMA; torch.minimum
//    keeps a NaN);
//  - pass 2: sorted by (destination, -sort_w2, index), sort_w2 = take1 ? w
//    x noise : -1, the cumulative weight before, t2 = take1 & before <
//    capped budget[dst];
//  - the rank of each t2 in the pass-2 order (an integer scan), ok = t2 &
//    rank < N, (p, its slot, ok) into slot rank of the batch (rows not ok
//    park in a discarded slot: they are never written).
//
// The launches: L1 the quota (block 0), the partitions a source and the
// outputs zeroed (the other blocks); L2 one block: the sources' runs; L3 a
// thread a partition: its fields, its pass-1 key into its source's run,
// its destination counted; L4-L5 the pass-1 sort (a block a run, a
// thread a row of a run past 4,096; L4's last block places the
// destinations' runs); L6 the scan levels a chunk and each run's in-order
// sum (a warp a run); L7 one block: their scans; L8 a thread a sorted
// row: take1, the per-unit maxima a block, the pass-2 key into its
// destination's run; L9-L13 pass 2 the same (L9's last block caps the
// budgets); L14 the rank and the scatter. What bounds it: the launches,
// each a few dependent round trips, and the longest run's sort and sum.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounds.cuh"
#include "drain.cuh"
#include "ordered.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrepBlocks = 64;            // blocks counting the sources
constexpr int kRing = 8;                   // a run warp's chunks in flight
constexpr int kScanThreads = 256;

}  // namespace

struct LeadArgs {
  // the goal's row and the broker planes it reads (KY's)
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const float* cap;            // [B1, 4]
  const uint8_t* bvalid;       // [B1]
  const uint8_t* balive;       // [B1]
  const ViolRow* rows;         // [1] on the card: the goal's interval row
  const uint8_t* ldest;        // [B1] leader destinations allowed
  // the partitions
  const int64_t* rb;           // [P, R]
  const uint8_t* off;          // [P, R]
  const uint8_t* lmov;         // [P] leadership movable
  const uint8_t* pvalid;       // [P]
  const float* leader_load;    // [P, 4]
  const float* follower_load;  // [P, 4]
  const int64_t* key;          // the round's root key, int64[2]
  float thr[4];                // capacity thresholds
  // outputs (zeroed here)
  int64_t* p_out;              // [N]
  int64_t* r_out;              // [N]
  uint8_t* ok_out;             // [N]
  // scratch
  float* planes;               // [8, B1]: values, up, excess, deficit,
                               // pool, quota, budget, capped budget
  float* scratch;              // cc_leadership_drain_scratch(P, B1) floats
  int32_t* counts;             // [4, B1] by source: rows, placed; by
                               // destination: rows, placed (zeroed by the
                               // launcher)
  int32_t* start;              // [2, B1 + 1] the runs of each pass
  int32_t* chunk_first;        // [2, B1 + 1]
  uint64_t* keys;              // [P] a pass's keys grouped by broker
  uint64_t* runs;              // [P] the sorted chunks of longer runs
  int64_t* order;              // [2, P] each pass's order
  float* sw;                   // [P] a pass's sorted weights
  uint8_t* can;                // [P]
  uint8_t* take;               // [P] take1
  uint8_t* t2;                 // [P] t2 in the pass-2 order
  int32_t* dstb;               // [P]
  int32_t* rsel;               // [P]
  float* wv;                   // [P] max(weight, 0)
  float* wn;                   // [P] w x noise
  float* loc0;                 // [P] the scan levels (drain::Levels)
  float* loc1;                 // [ceil(P / 16)]
  float* loc2;                 // [ceil(P / 256)]
  float* t3;                   // [ceil(P / 4096)]
  float* out3;                 // [ceil(P / 4096)]
  float* per_key;              // [B1] a run's in-order sum
  float* oscan;                // [B1] their scan16
  float* pmax;                 // [ceil(P / 256), 4] per-unit maxima a block
  int32_t* kept;               // [ceil(P / 256)] t2 a block
  int64_t P, R, B1, N;
  int32_t weight;              // the drain weight: -1 every partition
                               // weighs 1, else the leader's load column
};

namespace {

__device__ __forceinline__ drain::Levels levels(const LeadArgs& a) {
  return drain::Levels{a.loc0, a.loc1, a.loc2, a.t3, a.out3};
}

__device__ __forceinline__ int32_t clamp_broker(const LeadArgs& a,
                                                int64_t b) {
  return static_cast<int32_t>(ordered::clamp_index(b, a.B1));
}

// torch.maximum / torch.amax of two floats: a NaN wins
__device__ __forceinline__ float max_nan(float x, float y) {
  return isnan(x) ? x : (isnan(y) ? y : (x < y ? y : x));
}

// torch.minimum of two floats: a NaN wins
__device__ __forceinline__ float min_nan(float x, float y) {
  return isnan(x) ? x : (isnan(y) ? y : (y < x ? y : x));
}

__global__ void __launch_bounds__(kThreads) lead_prep_kernel(
    const LeadArgs a) {
  __shared__ long long red[kThreads / 32];
  if (blockIdx.x == 0) {
    const ViolRow row = a.rows[0];
    const int64_t B1 = a.B1;
    const bounds::Brokers br{a.util, a.cnt, a.lead, a.pot, a.lni, a.cap,
                             a.bvalid, a.balive};
    const drain::QuotaOut o{a.planes, a.planes + B1, a.planes + 2 * B1,
                            a.planes + 3 * B1, a.planes + 4 * B1,
                            a.planes + 5 * B1, a.planes + 6 * B1};
    drain::shed_quota(row, br, B1, a.ldest, o, a.scratch, red);
    return;
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x - 1) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x - 1) * blockDim.x;
  for (int64_t s = tid; s < a.N; s += stride) {
    a.p_out[s] = 0;
    a.r_out[s] = 0;
    a.ok_out[s] = 0;
  }
  // the partitions a source (the warps stay converged for the atomics)
  for (int64_t base = static_cast<int64_t>(blockIdx.x - 1) * blockDim.x;
       base < a.P; base += stride) {
    const int64_t p = base + threadIdx.x;
    drain::claim(a.counts, p < a.P ? clamp_broker(a, a.rb[p * a.R]) : -1);
  }
}

__global__ void __launch_bounds__(1024) lead_starts_kernel(
    const LeadArgs a) {
  drain::segment_starts(a.counts, a.B1, a.start, a.chunk_first);
}

__global__ void __launch_bounds__(kThreads) lead_keys_kernel(
    const LeadArgs a, const DrawPath path) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t B1 = a.B1;
  int32_t src = -1, dst = -1;
  uint64_t key = 0;
  if (p < a.P) {
    const float* quota = a.planes + 5 * B1;
    const float* budget = a.planes + 6 * B1;
    src = clamp_broker(a, a.rb[p * a.R]);
    const float w = ordered::clamp0(
        a.weight < 0 ? 1.0f : a.leader_load[p * 4 + a.weight]);
    bool can = a.lmov[p] != 0 && a.pvalid[p] != 0 && a.balive[src] != 0
               && quota[src] > 0.0f && w > 0.0f;
    // the follower slot of the highest score, the first among equals
    float best = 0.0f;
    int r_sel = 0;
    for (int64_t r = 0; r < a.R; ++r) {
      const int32_t fb = clamp_broker(a, a.rb[p * a.R + r]);
      const bool ok = r != 0 && fb < B1 - 1 && a.balive[fb] != 0
                      && a.ldest[fb] != 0 && a.off[p * a.R + r] == 0;
      const float d = ok ? budget[fb] : -INFINITY;
      if (r == 0) {
        best = d;
      } else if (!isnan(best) && (isnan(d) || d > best)) {
        best = d;
        r_sel = static_cast<int>(r);
      }
    }
    can = can && isfinite(best);
    dst = clamp_broker(a, a.rb[p * a.R + r_sel]);
    uint32_t k0, k1;
    threefry::derive(a.key, path, k0, k1);
    const float noise = threefry::affine(
        threefry::bits_at(k0, k1, static_cast<uint64_t>(p)), 0.01f, 1.0f);
    const float wn = __fmul_rn(w, noise);
    const float sort_w = can ? wn : -1.0f;
    a.can[p] = can;
    a.dstb[p] = dst;
    a.rsel[p] = r_sel;
    a.wv[p] = w;
    a.wn[p] = wn;
    key = (static_cast<uint64_t>(drain::sort_image(-sort_w)) << 32)
          | static_cast<uint64_t>(p);
  }
  const int32_t place = drain::claim(a.counts + B1, src);
  if (p < a.P) a.keys[a.start[src] + place] = key;
  drain::claim(a.counts + 2 * B1, dst);
}

// A pass's sort (``pass`` 0 or 1): a block a chunk of a run; the order and
// the sorted weights (w where the pass's row is in play, else 0) where a
// run is one chunk. The last block: the destinations' runs (pass 0) or the
// capped budgets (pass 1).
__global__ void __launch_bounds__(drain::kSortThreads) lead_chunk_kernel(
    const LeadArgs a, int pass) {
  __shared__ uint64_t s[drain::kSortTile];
  const int64_t B1 = a.B1;
  if (blockIdx.x == gridDim.x - 1) {
    if (pass == 0) {
      drain::segment_starts(a.counts + 2 * B1, B1, a.start + B1 + 1,
                            a.chunk_first + B1 + 1);
      return;
    }
    // _capacity_budget_cap: the batch's per-unit maxima, then every
    // broker's budget
    __shared__ float s_max[drain::kSortThreads / 32][4];
    const int64_t blocks = (a.P + kThreads - 1) / kThreads;
    float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int64_t k = threadIdx.x; k < blocks; k += blockDim.x) {
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q] = max_nan(m[q], a.pmax[k * 4 + q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int o = 16; o > 0; o >>= 1) {
        m[q] = max_nan(m[q], __shfl_xor_sync(drain::kFull, m[q], o));
      }
      if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5][q] = m[q];
    }
    __syncthreads();
    float umax[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = -INFINITY;
      for (int w = 0; w < drain::kSortThreads / 32; ++w) {
        v = max_nan(v, s_max[w][q]);
      }
      // torch.clamp(min=1e-9) keeps a NaN
      umax[q] = v < 1e-9f ? 1e-9f : v;
    }
    const float* budget = a.planes + 6 * B1;
    float* capped = a.planes + 7 * B1;
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      float bud = budget[b];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float head = __fmaf_rn(a.thr[q], a.cap[b * 4 + q],
                                     -a.util[b * 4 + q]);
        const float units = __fdiv_rn(ordered::clamp0(head), umax[q]);
        bud = min_nan(bud, __fmul_rn(0.9f, units));
      }
      capped[b] = ordered::clamp0(bud);
    }
    return;
  }
  const int32_t* start = a.start + pass * (B1 + 1);
  const int32_t* chunk_first = a.chunk_first + pass * (B1 + 1);
  int64_t* order = a.order + pass * a.P;
  float* sw = a.sw;
  const uint8_t* in_play = pass == 0 ? a.can : a.take;
  const float* wv = a.wv;
  drain::sort_chunk(blockIdx.x, a.keys, a.runs, start, chunk_first, B1, s,
                    [=](int64_t at, uint64_t k) {
                      const int64_t p = static_cast<int64_t>(k & 0xffffffffu);
                      order[at] = p;
                      sw[at] = in_play[p] ? wv[p] : 0.0f;
                    });
}

__global__ void __launch_bounds__(kThreads) lead_merge_kernel(
    const LeadArgs a, int pass) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (q >= a.P) return;
  int64_t* order = a.order + pass * a.P;
  float* sw = a.sw;
  const uint8_t* in_play = pass == 0 ? a.can : a.take;
  const float* wv = a.wv;
  drain::merge_runs(q, a.runs, a.start + pass * (a.B1 + 1), a.B1,
                    [=](int64_t at, uint64_t k) {
                      const int64_t p = static_cast<int64_t>(k & 0xffffffffu);
                      order[at] = p;
                      sw[at] = in_play[p] ? wv[p] : 0.0f;
                    });
}

// scan16's levels of the sorted weights a chunk, and each run's in-order
// sum (a warp a run).
__global__ void __launch_bounds__(kThreads) lead_levels_kernel(
    const LeadArgs a, int pass, int64_t nch) {
  __shared__ float s_x[drain::kChunk + drain::kChunk / 16];
  __shared__ float s_t1[drain::kChunk / 16];
  __shared__ float s_t2[16];
  __shared__ __align__(16) float s_ring[kThreads / 32][kRing][32];
  __shared__ int s_n[kThreads / 32][kRing];
  if (blockIdx.x < nch) {
    const int64_t c = blockIdx.x;
    const int m = drain::chunk_slots(a.P, c);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      s_x[drain::pad(k)] = a.sw[c * drain::kChunk + k];
    }
    __syncthreads();
    drain::chunk_scan(levels(a), c, m, s_x, s_t1, s_t2);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int64_t b = (blockIdx.x - nch) * (kThreads / 32) + warp;
  if (b >= a.B1) return;
  const int32_t* start = a.start + pass * (a.B1 + 1);
  const float acc = drain::run_sum<kRing>(a.sw, start[b], start[b + 1],
                                          s_ring[warp][0], s_n[warp]);
  if ((threadIdx.x & 31) == 0) a.per_key[b] = acc;
}

__global__ void __launch_bounds__(kScanThreads) lead_scans_kernel(
    const LeadArgs a, int64_t nch) {
  __shared__ float s_in[drain::kStage], s_out[drain::kStage];
  __shared__ float s_scr[drain::kStage / 15 + 16];
  float* scr = a.scratch + ordered::tree_scratch(a.B1) + 1;
  drain::staged_scan16(a.per_key, a.oscan, a.B1, scr, s_in, s_out, s_scr);
  if (nch > 1) {
    drain::staged_scan16(a.t3, a.out3, nch,
                         scr + ordered::scan_scratch(a.B1) + 1, s_in, s_out,
                         s_scr);
  }
}

// Sorted row i's cumulative weight of the earlier rows of its run
// (_segment_cum_before), its run's broker b.
__device__ __forceinline__ float before_at(const LeadArgs& a, int64_t i,
                                           int32_t b) {
  const float sw = a.sw[i], cum = drain::cum_at(levels(a), i);
  const float offset = __fsub_rn(a.oscan[b], a.per_key[b]);
  return __fsub_rn(__fsub_rn(cum, sw), offset);
}

__global__ void __launch_bounds__(kThreads) lead_take1_kernel(
    const LeadArgs a) {
  __shared__ float s_max[kThreads / 32][4];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const int64_t B1 = a.B1;
  float ratio[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int32_t dst = -1;
  uint64_t key = 0;
  if (i < a.P) {
    const int64_t p = a.order[i];
    const int32_t b = clamp_broker(a, a.rb[p * a.R]);
    const bool t1 = a.can[p] != 0 && before_at(a, i, b) < a.planes[5 * B1 + b];
    a.take[p] = t1;
    const float w = a.wv[p];
    if (t1) {
      // torch.clamp(min=1e-9) keeps a NaN
      const float den = w < 1e-9f ? 1e-9f : w;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = ordered::clamp0(__fsub_rn(
            a.leader_load[p * 4 + q], a.follower_load[p * 4 + q]));
        ratio[q] = __fdiv_rn(d, den);
      }
    }
    dst = a.dstb[p];
    const float sort_w = t1 ? a.wn[p] : -1.0f;
    key = (static_cast<uint64_t>(drain::sort_image(-sort_w)) << 32)
          | static_cast<uint64_t>(p);
  }
  const int32_t place = drain::claim(a.counts + 3 * B1, dst);
  if (i < a.P) a.keys[a.start[B1 + 1 + dst] + place] = key;
  // the block's per-unit maxima (a row not taken gives 0.0)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v = ratio[q];
    for (int o = 16; o > 0; o >>= 1) {
      v = max_nan(v, __shfl_xor_sync(drain::kFull, v, o));
    }
    if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float v = s_max[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) {
      v = max_nan(v, s_max[w][threadIdx.x]);
    }
    a.pmax[blockIdx.x * 4 + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads) lead_take2_kernel(
    const LeadArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  bool t2 = false;
  if (i < a.P) {
    const int64_t p = a.order[a.P + i];
    const int32_t b = a.dstb[p];
    t2 = a.take[p] != 0 && before_at(a, i, b) < a.planes[7 * a.B1 + b];
    a.t2[i] = t2;
  }
  const int count = __syncthreads_count(t2);
  if (threadIdx.x == 0) a.kept[blockIdx.x] = count;
}

__global__ void __launch_bounds__(kThreads) lead_scatter_kernel(
    const LeadArgs a) {
  __shared__ int64_t s_warp[33];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  // the rows kept before the block, then the block's own before this one
  int64_t before = 0;
  for (int64_t k = threadIdx.x; k < blockIdx.x; k += blockDim.x) {
    before += a.kept[k];
  }
  int64_t base;
  drain::block_exclusive(before, s_warp, base);
  const bool t2 = i < a.P && a.t2[i] != 0;
  int64_t total;
  const int64_t g = base + drain::block_exclusive(t2 ? 1 : 0, s_warp, total);
  if (t2 && g < a.N) {
    const int64_t p = a.order[a.P + i];
    a.p_out[g] = p;
    a.r_out[g] = a.rsel[p];
    a.ok_out[g] = 1;
  }
}

}  // namespace

// Floats of KAA's scratch at P partitions and B1 brokers.
extern "C" int64_t cc_leadership_drain_scratch(int64_t P, int64_t b1) {
  const int64_t nch = (P + drain::kChunk - 1) / drain::kChunk;
  return ordered::tree_scratch(b1) + ordered::scan_scratch(b1)
         + ordered::scan_scratch(nch) + 3;
}

// KAA's memset and fourteen launches on ``stream``; returns
// cudaGetLastError().
extern "C" int cc_leadership_drain(const LeadArgs* args, DrawPath path,
                                   void* stream) {
  const LeadArgs& a = *args;
  if (a.P <= 0 || a.B1 <= 0 || a.R <= 0 || a.N < 0
      || a.P >= (int64_t{1} << 31) || a.B1 >= (int64_t{1} << 30)
      || a.rows == nullptr || path.n < 0 || path.n > threefry::kMaxPath
      || a.weight > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.counts, 0, 4 * a.B1 * sizeof(int32_t),
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (a.P + kThreads - 1) / kThreads;
  const int64_t count_blocks = blocks < kPrepBlocks ? blocks : kPrepBlocks;
  const int64_t nch = (a.P + drain::kChunk - 1) / drain::kChunk;
  const int64_t run_blocks = (a.B1 + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned sort_blocks = static_cast<unsigned>(
      a.B1 + (a.P + drain::kSortTile - 1) / drain::kSortTile + 1);
  const unsigned grid = static_cast<unsigned>(blocks);
  int err;
#define CC_LAUNCHED()                                          \
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err
  lead_prep_kernel<<<static_cast<unsigned>(1 + count_blocks), kThreads, 0,
                     s>>>(a);
  CC_LAUNCHED();
  lead_starts_kernel<<<1, 1024, 0, s>>>(a);
  CC_LAUNCHED();
  lead_keys_kernel<<<grid, kThreads, 0, s>>>(a, path);
  CC_LAUNCHED();
  for (int pass = 0; pass < 2; ++pass) {
    lead_chunk_kernel<<<sort_blocks, drain::kSortThreads, 0, s>>>(a, pass);
    CC_LAUNCHED();
    lead_merge_kernel<<<grid, kThreads, 0, s>>>(a, pass);
    CC_LAUNCHED();
    lead_levels_kernel<<<static_cast<unsigned>(nch + run_blocks), kThreads,
                         0, s>>>(a, pass, nch);
    CC_LAUNCHED();
    lead_scans_kernel<<<1, kScanThreads, 0, s>>>(a, nch);
    CC_LAUNCHED();
    if (pass == 0) {
      lead_take1_kernel<<<grid, kThreads, 0, s>>>(a);
    } else {
      lead_take2_kernel<<<grid, kThreads, 0, s>>>(a);
    }
    CC_LAUNCHED();
  }
  lead_scatter_kernel<<<grid, kThreads, 0, s>>>(a);
#undef CC_LAUNCHED
  return static_cast<int>(cudaGetLastError());
}

// sizeof(LeadArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_lead_args_size() { return sizeof(LeadArgs); }
