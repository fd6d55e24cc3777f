// KO: the flow-matched move candidates of an interval goal's proposal, in
// two launches around the top-k of the replica priorities (which stays
// one sort, as lax.top_k stays one op in the reference).
//
// Replaces cruise_control_tpu/analyzer/goals.py:_flow_candidates
// (:790-873), which every fine iteration of a replica goal's pass runs.
// In plain torch it is about 40 launches a call.
//
// - flow_priority: the [P, R] replica priorities — _unit01's min and max
//   over the replica weights, the tier FMAs (q * 0.99 + tier, one
//   rounding), the excess / assist / leader-slot / movable / offline
//   masks, and the tie-break noise drawn in the same launch (KA's
//   threefry, threefry.cuh) and added after its where (no contraction).
//   The min and max must be known before any priority: the launch is one
//   cluster of 8 blocks of 1,024 threads, each block reducing its part,
//   one cluster barrier, then every thread writes its elements.
// - flow_match: the destination side in one block of 1,024 threads — the
//   headroom (to the midpoint, or the ceiling), the destination priority
//   with its noise, a stable argsort of the brokers (rank sort: the lower
//   index first among ties), scan_sum of the headroom in XLA's 16-block
//   order, each candidate's midpoint cumulative load, searchsorted (left),
//   the round-robin fallback of mandatory moves, and the re-route of a
//   candidate whose matched broker already hosts its partition: the first
//   legal broker in priority order, which is _legal_dest_argmax's first
//   maximum.
//
// Bound on the card: bytes at the scale cell (the [P, R] planes read and
// the priorities written once); a launch's floor at the main path's
// 20,096 x 2. flow_match is a chain of block barriers over B1 brokers and
// K candidates, far below either bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"
#include "threefry.cuh"

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kTierAssist = 0.0f;    // goals.py:_TIER_ASSIST
constexpr float kTierExcess = 4.0f;    // _TIER_EXCESS
constexpr float kTierOffline = 8.0f;   // _TIER_OFFLINE
constexpr int kNwIn = 1, kNwOut = 2, kDisk = 3;  // core/resources.py
constexpr unsigned kFull = 0xffffffffu;

// IntervalGoal._replica_weight forms: 0-3 a util column, else:
enum Weight : int32_t { kWeightPotential = 4, kWeightSmallDisk = 5 };
// IntervalGoal._replica_metric_load forms: 0-3 a util column, else:
enum Load : int32_t {
  kLoadCount = 4, kLoadLeaders = 5, kLoadPotential = 6, kLoadLeaderNwIn = 7
};

}  // namespace

struct PriorityArgs {
  const int64_t* rb;            // [P, R]
  const uint8_t* movable;       // [P, R]
  const uint8_t* off;           // [P, R]
  const float* leader_load;     // [P, 4]
  const float* follower_load;   // [P, 4]
  const float* values;          // [B1]
  const float* lo;              // [B1]
  const float* up;              // [B1]
  const float* excess;          // [B1]
  const float* deficit;         // [B1]
  const int64_t* key;           // int64[2] root of the noise's key path
  float* prio;                  // [P, R]
  float* scratch;               // [2 * kCluster]
  int64_t P, R, B1;
  int32_t weight;
  int32_t leader_scoped;
  float noise_scale;
};

struct MatchArgs {
  const float* values;          // [B1]
  const float* lo;
  const float* up;
  const float* deficit;
  const uint8_t* dest;          // [B1]
  const float* cap;             // [B1] where the upper bound is cap * thr
  float thr;
  int32_t upper_only;
  int32_t load;
  const int64_t* key;           // int64[2] root of the noise's key path
  float noise_scale;
  const int64_t* idx;           // [K] top-k flat replica indices
  const float* vals;            // [K] their priorities
  const int64_t* rb;            // [P, R]
  const uint8_t* off;           // [P, R]
  const float* leader_load;     // [P, 4]
  const float* follower_load;   // [P, 4]
  int64_t* p_out;               // [K]
  int64_t* r_out;
  int64_t* dst_out;
  uint8_t* valid_out;
  float* scratch;               // match_scratch(B1, K) floats
  int64_t* order;               // [B1]
  int64_t P, R, B1, K;
};

namespace {

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// goals.py:_tier_plus_norm01
__device__ __forceinline__ float tier_plus(float tier, float q, bool fin) {
  return fin ? __fmaf_rn(q, 0.99f, tier) : tier;
}

// The midpoint of [lo, up] (up / 2 without a lower bound).
__device__ __forceinline__ float midpoint(float lo, float up) {
  return finite(lo) ? __fmul_rn(__fadd_rn(lo, up), 0.5f)
                    : __fmul_rn(up, 0.5f);
}

__device__ __forceinline__ float replica_weight(const PriorityArgs& a,
                                                int64_t p, int64_t r) {
  const float* load = r == 0 ? a.leader_load : a.follower_load;
  if (a.weight == kWeightPotential) return a.leader_load[p * 4 + kNwOut];
  if (a.weight == kWeightSmallDisk) return -load[p * 4 + kDisk];
  return load[p * 4 + a.weight];
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// (min, max) over the block of each thread's (lo, hi), to every thread.
__device__ void block_min_max(float& lo, float& hi) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  lo = warp_min(lo);
  hi = warp_max(hi);
  const int warp = threadIdx.x >> 5;
  __syncthreads();                      // earlier readers of s_lo are done
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = INFINITY;
  hi = -INFINITY;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
flow_priority_kernel(const PriorityArgs a, const DrawPath path) {
  const ordered::Cluster g{};
  const int64_t n = a.P * a.R;
  // _unit01's min and max over the finite weights
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t i = g.rank(); i < n; i += g.size()) {
    const float w = replica_weight(a, i / a.R, i % a.R);
    if (finite(w)) {
      lo = fminf(lo, w);
      hi = fmaxf(hi, w);
    }
  }
  block_min_max(lo, hi);
  if (threadIdx.x == 0) {
    a.scratch[2 * blockIdx.x] = lo;
    a.scratch[2 * blockIdx.x + 1] = hi;
  }
  bool any_deficit = false;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    any_deficit |= a.deficit[b] > 0.0f;
  }
  any_deficit = __syncthreads_or(any_deficit);
  uint32_t k0, k1;
  threefry::derive(a.key, path, k0, k1);
  g.sync();
  float xmin = INFINITY, xmax = -INFINITY;
  for (int c = 0; c < kCluster; ++c) {
    xmin = fminf(xmin, a.scratch[2 * c]);
    xmax = fmaxf(xmax, a.scratch[2 * c + 1]);
  }
  const float diff = __fsub_rn(xmax, xmin);
  const float span = diff < 1e-12f ? 1e-12f : diff;
  for (int64_t i = g.rank(); i < n; i += g.size()) {
    const int64_t p = i / a.R, r = i % a.R;
    const float w = replica_weight(a, p, r);
    const bool fin = finite(w);
    const float q = __fdiv_rn(__fsub_rn(w, xmin), span);
    const int64_t b = ordered::clamp_index(a.rb[i], a.B1);
    const bool assist = any_deficit
                        && a.values[b] > midpoint(a.lo[b], a.up[b]);
    float prio = a.excess[b] > 0.0f ? tier_plus(kTierExcess, q, fin)
                 : (assist ? tier_plus(kTierAssist, q, fin) : -INFINITY);
    if (a.leader_scoped && r != 0) prio = -INFINITY;
    if (!a.movable[i]) prio = -INFINITY;
    if (a.off[i]) prio = tier_plus(kTierOffline, q, fin);
    const float noise = threefry::affine(
        threefry::bits_at(k0, k1, static_cast<uint64_t>(i)), a.noise_scale,
        0.0f);
    a.prio[i] = __fadd_rn(prio, finite(prio) ? noise : 0.0f);
  }
}

// IntervalGoal._replica_metric_load of replica (p, r).
__device__ __forceinline__ float metric_load(const MatchArgs& a, int64_t p,
                                             int64_t r) {
  switch (a.load) {
    case kLoadCount: return 1.0f;
    case kLoadLeaders: return r == 0 ? 1.0f : 0.0f;
    case kLoadPotential: return a.leader_load[p * 4 + kNwOut];
    case kLoadLeaderNwIn: return r == 0 ? a.leader_load[p * 4 + kNwIn] : 0.0f;
    default:
      return (r == 0 ? a.leader_load : a.follower_load)[p * 4 + a.load];
  }
}

__device__ __forceinline__ bool hosts(const MatchArgs& a, int64_t p,
                                      int64_t b) {
  for (int64_t s = 0; s < a.R; ++s) {
    if (a.rb[p * a.R + s] == b) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads, 1)
flow_match_kernel(const MatchArgs a, const DrawPath path) {
  const ordered::Block g{};
  const int64_t B1 = a.B1, K = a.K;
  float* head = a.scratch;              // [B1] headroom
  float* cum_head = head + B1;          // [B1]
  float* dprio = cum_head + B1;         // [B1]
  float* load = dprio + B1;             // [K]
  float* cum_load = load + K;           // [K]
  float* scan = cum_load + K;           // scan scratch
  // the ceiling and the headroom to the midpoint
  bool any_mid = false;
  int64_t allowed = 0;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    const bool ok = a.dest[b] != 0;
    const float v = a.values[b];
    const float um = a.cap != nullptr
                         ? __fmaf_rn(a.cap[b], a.thr, -v)
                         : __fsub_rn(a.up[b], v);
    const float ceiling = ok ? ordered::clamp0(um) : 0.0f;
    const float to_mid = ok ? ordered::clamp0(__fsub_rn(
                                  midpoint(a.lo[b], a.up[b]), v)) : 0.0f;
    any_mid |= to_mid > 0.0f;
    head[b] = ceiling;
    cum_head[b] = to_mid;
  }
  for (int64_t base = 0; base < B1; base += blockDim.x) {
    const int64_t b = base + threadIdx.x;
    allowed += __syncthreads_count(b < B1 && a.dest[b] != 0);
  }
  any_mid = __syncthreads_or(any_mid);
  // the headroom, then _norm01 of it over the allowed brokers
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    const float h = (a.upper_only || !any_mid) ? head[b] : cum_head[b];
    head[b] = h;
    if (a.dest[b] && finite(h)) {
      lo = fminf(lo, h);
      hi = fmaxf(hi, h);
    }
  }
  block_min_max(lo, hi);
  const float diff = __fsub_rn(hi, lo);
  const float span = diff < 1e-12f ? 1e-12f : diff;
  uint32_t k0, k1;
  threefry::derive(a.key, path, k0, k1);
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    float d = -INFINITY;
    if (a.dest[b]) {
      const float h = head[b];
      const float norm = finite(h)
          ? __fmul_rn(__fdiv_rn(__fsub_rn(h, lo), span), 0.99f) : 0.0f;
      d = __fadd_rn(a.deficit[b] > 0.0f ? kTierExcess : 0.0f, norm);
    }
    const float noise = threefry::affine(
        threefry::bits_at(k0, k1, static_cast<uint64_t>(b)), a.noise_scale,
        0.0f);
    dprio[b] = __fadd_rn(d, finite(d) ? noise : 0.0f);
  }
  // the candidates' loads (top-k rows: flat index -> (p, r))
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    const int64_t i = a.idx[k];
    const int64_t p = i / a.R, r = i % a.R;
    load[k] = finite(a.vals[k]) ? metric_load(a, p, r) : 0.0f;
  }
  __syncthreads();
  // brokers by descending priority (ascending -dprio), stable
  ordered::rank_sort(g, [&](int64_t b) { return -dprio[b]; }, B1, a.order);
  ordered::scan16(g, [&](int64_t j) { return head[a.order[j]]; }, cum_head,
                  B1, scan);
  ordered::scan16(g, [&](int64_t k) { return load[k]; }, cum_load, K, scan);
  const int64_t n_ok = allowed < 1 ? 1 : allowed;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    const int64_t i = a.idx[k];
    const int64_t p = i / a.R, r = i % a.R;
    const bool sel = finite(a.vals[k]);
    const float target = __fsub_rn(cum_load[k], __fmul_rn(0.5f, load[k]));
    const int64_t slot = ordered::lower_bound(cum_head, B1, target);
    const bool covered = slot < B1;
    int64_t dst = covered ? a.order[slot] : a.order[k % n_ok];
    const bool must = a.off[i] != 0 && sel;
    if (hosts(a, p, dst)) {
      // _legal_dest_argmax: the first legal broker in priority order
      for (int64_t j = 0; j < B1; ++j) {
        const int64_t b = a.order[j];
        if (!finite(dprio[b])) break;
        if (a.dest[b] && !hosts(a, p, b)) {
          dst = b;
          break;
        }
      }
    }
    a.p_out[k] = p;
    a.r_out[k] = r;
    a.dst_out[k] = dst;
    a.valid_out[k] = sel && (covered || must) && a.dest[dst] != 0;
  }
}

}  // namespace

// Floats of scratch flow_match needs at B1 brokers and K candidates.
extern "C" int64_t cc_flow_match_scratch(int64_t b1, int64_t k) {
  const int64_t sb = ordered::scan_scratch(b1);
  const int64_t sk = ordered::scan_scratch(k);
  return 3 * b1 + 2 * k + (sb > sk ? sb : sk) + 1;
}

extern "C" int cc_flow_priority(const PriorityArgs* args, DrawPath path,
                                void* stream) {
  if (path.n < 0 || path.n > threefry::kMaxPath) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flow_priority_kernel<<<kCluster, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*args, path);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_flow_match(const MatchArgs* args, DrawPath path,
                             void* stream) {
  if (path.n < 0 || path.n > threefry::kMaxPath) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flow_match_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args, path);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(PriorityArgs) and sizeof(MatchArgs), which the host's ctypes
// structs must equal
extern "C" int64_t cc_priority_args_size() { return sizeof(PriorityArgs); }
extern "C" int64_t cc_match_args_size() { return sizeof(MatchArgs); }
