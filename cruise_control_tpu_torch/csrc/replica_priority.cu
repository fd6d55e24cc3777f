// KR: the noised [P, R] source priorities of every candidate generator of
// the goal catalog but the interval goals' flow moves (KO), which top_k
// then reads.
//
// Replaces the priority halves of the reference's generators
// (cruise_control_tpu/analyzer/goals.py): _top_replica_dest_grid's source
// transform (:96-195) over RackAwareGoal's duplicate racks,
// RackAwareDistributionGoal's (and KafkaAssignerEvenRackAwareGoal's)
// racks over ceil(rf / alive racks), BrokerSetAwareGoal's mismatch and
// MinTopicLeadersPerBrokerGoal's fallback; _top_leadership's transform
// over an interval goal's gain, MinTopicLeadersPerBrokerGoal (and its
// inactive all -inf form) and PreferredLeaderElectionGoal;
// IntervalGoal._swap_candidates' heavy and light planes (:732-940); and
// TopicReplicaDistributionGoal's move priority and its swap's heavy plane
// (:1221-1324). In plain torch each was 15-40 launches a call.
//
// One row kind a form (kernels.PRIORITY_KINDS), each a map over the card,
// a thread a slot: the kind's base, its transform and the tie-break noise,
// drawn in the same launch from the key path (KA's threefry, threefry.cuh)
// and added after its where (no contraction), or contracted where the
// reference's program contracts (_tier_plus_norm01, 0.99 - q * 0.99). The
// ranges a form needs over a plane come from a pass ahead of its map:
// over a [B1] plane (an interval goal's excess and deficit, the alive
// racks' bit set, any deficit) each block reduces it itself before its
// slots; over the [P, R] slots (the topic goal's _unit01) a launch ahead
// folds each block's min and max into integer atomics on an
// order-preserving encoding (exact in any order), after a launch of the
// topics' bounds (a warp a topic, as KN's topic_bounds_kernel). An
// interval swap's q reads the context's weight range (KO's first launch),
// not a reduction a call.
//
// Bound on the card: bytes -- the [P, R] placement, masks and loads read
// and the planes written once; at the main path's shapes (40,192 slots)
// a launch's floor. A slot's loads go first, the noise's key is derived
// once a block by its first warp while they are in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr float kTierExcess = 4.0f;    // goals.py:_TIER_EXCESS
constexpr float kTierOffline = 8.0f;   // _TIER_OFFLINE
constexpr float kTiny = 1e-12f;        // _unit01's smallest span
constexpr int kNwOut = 2, kDisk = 3;   // core/resources.py

// kernels.PRIORITY_KINDS
enum Kind : int32_t {
  kRackAware = 0, kRackSpread = 1, kBrokerSet = 2, kTopicLeadersMove = 3,
  kIntervalLeadership = 4, kTopicLeaders = 5, kNoLeadership = 6,
  kPreferredLeader = 7, kIntervalSwap = 8, kTopic = 9, kKinds = 10
};
// IntervalGoal._replica_weight forms: 0-3 a util column, else:
enum Weight : int32_t { kWeightPotential = 4, kWeightSmallDisk = 5 };

}  // namespace

struct PrioArgs {
  const int64_t* rb;            // [P, R]
  const int64_t* pos;           // [P, R] preferred positions
  const uint8_t* movable;       // [P, R]
  const uint8_t* off;           // [P, R]
  const uint8_t* lead_movable;  // [P]
  const int32_t* topic;         // [P] partition topics (-1: padding)
  const int32_t* rack;          // [B1]
  const int32_t* bset;          // [B1] broker sets
  const uint8_t* alive;         // [B1]
  const uint8_t* bvalid;        // [B1]
  const uint8_t* raw_dest;      // [B1]
  const int32_t* cells;         // [T, B1] topic (leader) counts
  const uint8_t* interested;    // [T] MinTopicLeaders' topics
  const int32_t* topic_set;     // [n_sets] BrokerSetAware's sets a topic
  const float* leader_load;     // [P, 4], 16-byte aligned
  const float* follower_load;   // [P, 4]
  const float* range;           // [6, 2] the context's weight range
  const float* values;          // [B1] an interval goal's planes
  const float* lo;
  const float* up;
  const float* excess;
  const float* deficit;
  const int64_t* key;           // int64[2] root of the noise's key paths
  float* prio;                  // [planes, P, R]
  float* bounds;                // [2, T] the topics' (lower, upper)
  uint32_t* scratch;            // [4] the topic planes' ranges
  int64_t P, R, B1, T, n_sets;
  // each broker plane's element step (values[b * values_step], ...): 0 for
  // a scalar bound broadcast to every broker, 4 for a column of util
  int64_t values_step, lo_step, up_step, excess_step, deficit_step;
  int32_t kind, weight, leader_scoped, min_count, planes;
  float noise_scale, gap_c, gap_lo, gap_hi;
  DrawPath path[2];
};

namespace {

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// goals.py:_tier_plus_norm01
__device__ __forceinline__ float tier_plus(float tier, float q, bool fin) {
  return fin ? __fmaf_rn(q, 0.99f, tier) : tier;
}

// The order-preserving unsigned image of a float (-0.0 taken as +0.0).
__device__ __forceinline__ uint32_t order_bits(float x) {
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

// _unit01's span of a range: max - min, at least kTiny.
__device__ __forceinline__ float span_of(float lo, float hi) {
  const float d = __fsub_rn(hi, lo);
  return d < kTiny ? kTiny : d;
}

// _unit01's q of x in a range.
__device__ __forceinline__ float unit(float x, float lo, float span) {
  return __fdiv_rn(__fsub_rn(x, lo), span);
}

// _norm01 of x in a range: q * 0.99 where finite, else 0.
__device__ __forceinline__ float norm01(float x, float lo, float span) {
  return finite(x) ? __fmul_rn(unit(x, lo, span), 0.99f) : 0.0f;
}

// _jax_index: a negative index counts from the end, then clamped.
__device__ __forceinline__ int64_t jax_index(int64_t i, int64_t n) {
  return ordered::clamp_index(i < 0 ? i + n : i, n);
}

// scale * uniform of counter c under (k0, k1): _noise's draw.
__device__ __forceinline__ float noise(uint32_t k0, uint32_t k1, uint64_t c,
                                       float scale) {
  return threefry::affine(threefry::bits_at(k0, k1, c), scale, 0.0f);
}

// prio + where(isfinite(prio), noise, 0)
__device__ __forceinline__ float with_noise(float prio, uint32_t k0,
                                            uint32_t k1, uint64_t c,
                                            float scale) {
  return __fadd_rn(prio, finite(prio) ? noise(k0, k1, c, scale) : 0.0f);
}

// Block-wide min (lo) and max (hi) of each of n values a thread, in s
// (blockDim / 32 * 2n floats); every thread gets the results.
template <int kN>
__device__ void block_range(float (&lo)[kN], float (&hi)[kN], float* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[j] = fminf(lo[j], __shfl_xor_sync(0xffffffffu, lo[j], o));
      hi[j] = fmaxf(hi[j], __shfl_xor_sync(0xffffffffu, hi[j], o));
    }
    if (lane == 0) {
      s[(2 * j) * warps + warp] = lo[j];
      s[(2 * j + 1) * warps + warp] = hi[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    lo[j] = s[(2 * j) * warps];
    hi[j] = s[(2 * j + 1) * warps];
    for (int w = 1; w < warps; ++w) {
      lo[j] = fminf(lo[j], s[(2 * j) * warps + w]);
      hi[j] = fmaxf(hi[j], s[(2 * j + 1) * warps + w]);
    }
  }
  __syncthreads();
}

// A topic slot's cells: src_excess (a dead broker's whole cell counts)
// and src_over (no dead-broker rule) of TopicReplicaDistributionGoal.
__device__ __forceinline__ void topic_cells(const PrioArgs& a, int64_t i,
                                            float& excess, float& over) {
  const int64_t p = i / a.R;
  const int64_t t = jax_index(a.topic[p], a.T);
  const int64_t b = a.rb[i];
  const float cnt = static_cast<float>(a.cells[t * a.B1 + b]);
  over = ordered::clamp0(__fsub_rn(cnt, a.bounds[a.T + t]));
  excess = a.alive[b] ? over : cnt;
}

// ---------------------------------------------------------------------------
// The topic goal's launches ahead of its map
// ---------------------------------------------------------------------------

// TopicReplicaDistributionGoal._bounds (KN's topic_bounds_kernel, one gap
// slot): a warp a topic sums its cells over the valid brokers (an integer
// sum, exact in any order), then avg = total / max(alive, 1), gap =
// clamp(avg * (threshold - 1), min, max), (max(avg - gap, 0), avg + gap).
__global__ void __launch_bounds__(kThreads) topic_limits_kernel(
    const PrioArgs a) {
  __shared__ int s_alive[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int alive = 0;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    alive += a.alive[b] != 0;
  }
  alive = __reduce_add_sync(0xffffffffu, alive);
  if (lane == 0) s_alive[warp] = alive;
  __syncthreads();
  alive = 0;
  for (int k = 0; k < warps; ++k) alive += s_alive[k];
  const float n = static_cast<float>(alive < 1 ? 1 : alive);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * warps + warp; t < a.T;
       t += static_cast<int64_t>(gridDim.x) * warps) {
    long long total = 0;
    for (int64_t b = lane; b < a.B1; b += 32) {
      total += a.bvalid[b] ? a.cells[t * a.B1 + b] : 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    if (lane == 0) {
      const float avg = __fdiv_rn(static_cast<float>(total), n);
      float gap = __fmul_rn(avg, a.gap_c);
      gap = fminf(fmaxf(gap, a.gap_lo), a.gap_hi);
      a.bounds[t] = ordered::clamp0(__fsub_rn(avg, gap));
      a.bounds[a.T + t] = __fadd_rn(avg, gap);
    }
  }
}

// The min and max of src_excess (and of src_over for the heavy plane) over
// every slot, padding rows included: each block's into atomicMin on the
// order bits (maxes complemented) of a scratch the entry set to all ones.
__global__ void __launch_bounds__(kThreads) topic_range_kernel(
    const PrioArgs a) {
  __shared__ float s_red[kThreads / 32 * 4];
  const int64_t n = a.P * a.R;
  float lo[2] = {INFINITY, INFINITY}, hi[2] = {-INFINITY, -INFINITY};
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float excess, over;
    topic_cells(a, i, excess, over);
    lo[0] = fminf(lo[0], excess);
    hi[0] = fmaxf(hi[0], excess);
    lo[1] = fminf(lo[1], over);
    hi[1] = fmaxf(hi[1], over);
  }
  block_range<2>(lo, hi, s_red);
  if (threadIdx.x < 2 * a.planes) {
    const int j = threadIdx.x >> 1;
    const bool is_max = threadIdx.x & 1;
    const uint32_t e = order_bits(is_max ? hi[j] : lo[j]);
    atomicMin(a.scratch + threadIdx.x, is_max ? ~e : e);
  }
}

// ---------------------------------------------------------------------------
// The map
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
replica_priority_kernel(const PrioArgs a) {
  extern __shared__ uint32_t s_racks[];          // the alive racks' bit set
  __shared__ uint32_t s_key[4];
  __shared__ float s_red[kThreads / 32 * 4];
  __shared__ int s_nracks;
  const int64_t n = a.P * a.R;
  const int64_t R = a.R, B = a.B1 - 1, B1 = a.B1;
  const int32_t kind = a.kind;
  if (threadIdx.x < 32) {
    uint32_t k0, k1;
    threefry::derive(a.key, a.path[0], k0, k1);
    uint32_t j0 = 0, j1 = 0;
    if (a.planes > 1) threefry::derive(a.key, a.path[1], j0, j1);
    if (threadIdx.x == 0) {
      s_key[0] = k0;
      s_key[1] = k1;
      s_key[2] = j0;
      s_key[3] = j1;
    }
  }
  // the [B1] planes' ranges, any deficit and the alive racks, block by
  // block
  float lo[2] = {INFINITY, INFINITY}, hi[2] = {-INFINITY, -INFINITY};
  bool deficit = false;
  const int64_t rack_words = kind == kRackSpread ? (B1 + 31) / 32 : 0;
  for (int64_t k = threadIdx.x; k < rack_words; k += blockDim.x) {
    s_racks[k] = 0u;
  }
  if (kind == kRackSpread) __syncthreads();
  if (kind == kIntervalLeadership || kind == kIntervalSwap
      || kind == kRackSpread) {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      if (kind == kRackSpread) {
        const int32_t rk = a.rack[b];
        if (a.alive[b] && rk >= 0) {
          const int64_t k = rk < B1 ? rk : B1 - 1;
          atomicOr(&s_racks[k >> 5], 1u << (k & 31));
        }
        continue;
      }
      const float d = a.deficit[b * a.deficit_step];
      deficit |= d > 0.0f;
      if (kind == kIntervalLeadership) {
        const float x = a.excess[b * a.excess_step];
        if (finite(x)) {
          lo[0] = fminf(lo[0], x);
          hi[0] = fmaxf(hi[0], x);
        }
        if (finite(d)) {
          lo[1] = fminf(lo[1], d);
          hi[1] = fmaxf(hi[1], d);
        }
      }
    }
  }
  if (kind == kIntervalLeadership) block_range<2>(lo, hi, s_red);
  if (kind == kTopic) {
    const uint32_t* s = a.scratch;
    lo[0] = from_order_bits(__ldcg(s));
    hi[0] = from_order_bits(~__ldcg(s + 1));
    lo[1] = from_order_bits(__ldcg(s + 2));
    hi[1] = from_order_bits(~__ldcg(s + 3));
  }
  if (kind == kIntervalSwap) {
    lo[0] = a.range[2 * a.weight];
    hi[0] = a.range[2 * a.weight + 1];
  }
  const bool any_deficit = __syncthreads_or(deficit);
  if (kind == kRackSpread && threadIdx.x < 32) {
    int c = 0;
    for (int64_t k = threadIdx.x; k < rack_words; k += 32) {
      c += __popc(s_racks[k]);
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (threadIdx.x == 0) s_nracks = c < 1 ? 1 : c;
  }
  __syncthreads();
  const uint32_t k0 = s_key[0], k1 = s_key[1], j0 = s_key[2], j1 = s_key[3];
  const float span0 = span_of(lo[0], hi[0]), span1 = span_of(lo[1], hi[1]);
  const float scale = a.noise_scale;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / R, r = i - p * R;
    const int64_t* row = a.rb + p * R;
    const int64_t b = row[r];
    float base = -INFINITY;
    switch (kind) {
      case kRackAware: {               // RackAwareGoal._dup_mask
        bool dup = false;
        const int32_t mine = a.rack[b];
        for (int64_t j = 0; j < r; ++j) {
          const int64_t bj = row[j];
          dup |= b < B && bj < B && a.rack[bj] == mine;
        }
        base = dup ? 1.0f : -INFINITY;
        break;
      }
      case kRackSpread: {              // racks over ceil(rf / alive racks)
        const int32_t mine = a.rack[b];
        int64_t rf = 0, same = 0;
        for (int64_t j = 0; j < R; ++j) {
          const int64_t bj = row[j];
          rf += bj < B;
          same += bj < B && a.rack[bj] == mine;
        }
        const int64_t limit = static_cast<int64_t>(ceilf(__fdiv_rn(
            static_cast<float>(rf), static_cast<float>(s_nracks))));
        base = b < B && same > limit ? 1.0f : -INFINITY;
        break;
      }
      case kBrokerSet: {               // BrokerSetAwareGoal._mismatch
        if (a.topic_set != nullptr) {
          const int32_t want =
              a.topic_set[jax_index(a.topic[p], a.n_sets)];
          const int32_t have = a.bset[b];
          base = b < B && want >= 0 && have >= 0 && have != want
                     ? 1.0f : -INFINITY;
        }
        break;
      }
      case kTopicLeadersMove:
      case kTopicLeaders: {            // MinTopicLeadersPerBrokerGoal
        const int64_t t = jax_index(a.topic[p], a.T);
        const bool surplus = a.cells[t * B1 + row[0]] > a.min_count;
        const bool gain = kind == kTopicLeadersMove
                              ? r == 0
                              : a.interested[t] && a.alive[b]
                                    && a.cells[t * B1 + b] < a.min_count;
        base = gain && surplus ? 1.0f : -INFINITY;
        break;
      }
      case kIntervalLeadership: {      // _norm01(excess)[src] + ...[dst]
        const int64_t sb = row[0];
        const float xs = a.excess[sb * a.excess_step];
        const float xd = a.deficit[b * a.deficit_step];
        base = xs > 0.0f || xd > 0.0f
                   ? __fadd_rn(norm01(xs, lo[0], span0),
                               norm01(xd, lo[1], span1))
                   : -INFINITY;
        break;
      }
      case kPreferredLeader:
        base = a.pos[i] == 0 && a.pos[p * R] != 0 ? 1.0f : -INFINITY;
        break;
      default:
        break;
    }
    if (kind <= kTopicLeadersMove) {   // the grid's source transform
      float rp = a.movable[i] ? base : -INFINITY;
      if (a.off[i]) {
        const float c = finite(rp) ? rp : 0.0f;
        rp = __fadd_rn(kTierOffline, fminf(fmaxf(c, 0.0f), 1.0f));
      }
      a.prio[i] = with_noise(rp, k0, k1, i, scale);
    } else if (kind <= kPreferredLeader) {  // the leadership transform
      const float pr = r > 0 && a.lead_movable[p] ? base : -INFINITY;
      a.prio[i] = with_noise(pr, k0, k1, i, scale);
    } else if (kind == kIntervalSwap) {  // IntervalGoal._swap_candidates
      const float* load = r == 0 ? a.leader_load : a.follower_load;
      const float w = a.weight == kWeightPotential
                          ? a.leader_load[p * 4 + kNwOut]
                          : a.weight == kWeightSmallDisk
                                ? -load[p * 4 + kDisk]
                                : load[p * 4 + a.weight];
      const bool fin = finite(w);
      const float q = unit(w, lo[0], span0);
      const bool swappable = a.movable[i] && !a.off[i] && a.raw_dest[b];
      const float vb = a.values[b * a.values_step];
      const float lob = a.lo[b * a.lo_step], upb = a.up[b * a.up_step];
      const float mid = finite(lob) ? __fmul_rn(__fadd_rn(lob, upb), 0.5f)
                                    : __fmul_rn(upb, 0.5f);
      bool hmask = swappable && (a.excess[b * a.excess_step] > 0.0f
                                 || (any_deficit && vb > mid));
      bool lmask = swappable && vb < mid;
      if (a.leader_scoped) {
        hmask = hmask && r == 0;
        lmask = lmask && r != 0;
      }
      const float hprio = hmask ? tier_plus(kTierExcess, q, fin) : -INFINITY;
      const float light = fin ? __fmaf_rn(-q, 0.99f, 0.99f) : 0.99f;
      const float tier = a.deficit[b * a.deficit_step] > 0.0f ? kTierExcess
                                                              : 0.0f;
      const float lprio = lmask ? __fadd_rn(tier, light) : -INFINITY;
      a.prio[i] = with_noise(hprio, k0, k1, i, scale);
      a.prio[n + i] = with_noise(lprio, j0, j1, i, scale);
    } else {                           // TopicReplicaDistributionGoal
      float excess, over;
      topic_cells(a, i, excess, over);
      float prio = excess > 0.0f
                       ? tier_plus(kTierExcess, unit(excess, lo[0], span0),
                                   finite(excess))
                       : -INFINITY;
      if (!a.movable[i]) prio = -INFINITY;
      if (a.off[i]) prio = kTierOffline;
      a.prio[i] = with_noise(prio, k0, k1, i, scale);
      if (a.planes > 1) {
        const bool swappable = a.movable[i] && !a.off[i] && a.raw_dest[b];
        const float hprio =
            swappable && over > 0.0f
                ? tier_plus(kTierExcess, unit(over, lo[1], span1),
                            finite(over))
                : -INFINITY;
        a.prio[n + i] = with_noise(hprio, j0, j1, i, scale);
      }
    }
  }
}

}  // namespace

extern "C" int cc_replica_priority(const PrioArgs* args, void* stream) {
  const PrioArgs a = *args;
  if (a.kind < 0 || a.kind >= kKinds || a.R < 1 || a.B1 < 1
      || a.planes < 1 || a.planes > 2
      || (a.planes == 2 && a.kind != kIntervalSwap && a.kind != kTopic)
      || a.path[0].n < 0 || a.path[0].n > threefry::kMaxPath
      || a.path[1].n < 0 || a.path[1].n > threefry::kMaxPath
      || (a.kind == kTopic && (a.T < 1 || a.scratch == nullptr))
      || ((a.kind == kTopicLeaders || a.kind == kTopicLeadersMove)
          && a.T < 1)
      || (a.kind == kIntervalSwap && (a.weight < 0 || a.weight > 5))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = a.P * a.R;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (a.kind == kTopic) {
    cudaError_t e = cudaMemsetAsync(a.scratch, 0xff, 4 * sizeof(uint32_t),
                                    s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t tb = (a.T + kThreads / 32 - 1) / (kThreads / 32);
    topic_limits_kernel<<<static_cast<unsigned>(
                              tb < kMaxBlocks ? tb : kMaxBlocks),
                          kThreads, 0, s>>>(a);
    topic_range_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  }
  const size_t shared = a.kind == kRackSpread
                            ? static_cast<size_t>((a.B1 + 31) / 32) * 4 : 0;
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        replica_priority_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replica_priority_kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                            s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument struct, which the host's ctypes struct must equal
extern "C" int64_t cc_prio_args_size() { return sizeof(PrioArgs); }
