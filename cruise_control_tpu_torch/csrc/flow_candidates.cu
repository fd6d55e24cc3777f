// KO: the flow-matched move candidates of an interval goal's proposal, in
// two launches around the top-k of the replica priorities (which stays
// one sort, as lax.top_k stays one op in the reference), and the replica
// weights' range, which a search context computes once.
//
// Replaces cruise_control_tpu/analyzer/goals.py:_flow_candidates
// (:790-873), which every fine iteration of a replica goal's pass runs.
// In plain torch it is about 40 launches a call.
//
// - weight_range: _unit01's min and max of the finite replica weights
//   (IntervalGoal._replica_weight, goals.py:942-958) for each of its six
//   forms -- the four util columns, potential NW_OUT and the count goals'
//   -disk. The weights read only the context's loads, so the table is
//   built once a context (state.py:build_context), not once a call. One
//   launch over the card: a thread a partition row, each block's min and
//   max into integer atomics on an order-preserving encoding (exact in
//   any order; -0.0 counted as +0.0, which changes no priority), the last
//   block to finish decoding the table.
// - flow_priority: the [P, R] replica priorities -- the tier FMAs (q *
//   0.99 + tier, one rounding) with q from the context's table, the
//   excess / assist / leader-slot / movable / offline masks, and the
//   tie-break noise drawn in the same launch (KA's threefry, threefry.cuh)
//   and added after its where (no contraction). One map over the card: a
//   thread two slots, every load issued before any select; each block
//   reduces the deficit's any() itself, and one warp derives the noise's
//   key while the loads are in flight.
// - flow_match: the destination side in one block -- the headroom (to the
//   midpoint, or the ceiling), the destination priority with its noise, a
//   stable argsort of the brokers (distinct (key, index) pairs, so the
//   lower index comes first among ties and -0.0 equals +0.0: ranks
//   counted by a few lanes a key up to 256 brokers, else a merge sort of
//   32-key runs sorted in a warp's registers), scan_sum in XLA's 16-block
//   order of the candidates' loads and of the headroom in that order (a
//   16-block's prefixes by shuffles, the two scans sharing their
//   barriers), each candidate's midpoint cumulative load, searchsorted
//   (left), the round-robin fallback of mandatory moves, and the re-route
//   of a candidate whose matched broker already hosts its partition: the
//   first legal broker in priority order, which is _legal_dest_argmax's
//   first maximum. Every per-broker and per-candidate array is staged once
//   into shared memory, and every later phase reads only shared memory
//   and registers; where they do not fit (B1 in the tens of thousands),
//   the same code runs over a global workspace (the kShared template
//   flag). Each warp derives the noise's key while its first loads are in
//   flight.
//
// Bound on the card: bytes (the [P, R] planes read and the priorities
// written once); at the main path's shapes a launch's floor. What these
// small launches cost instead is latency: dependent round trips, block
// barriers, and code the compiler serializes -- a load under a branch
// (an add skipped for an element out of range) issues only when its
// branch is reached, one round trip an element. So loads go first and
// unconditionally, a bound broadcast to every broker is read in place
// (a stride of 0) rather than copied, and a loop a thread runs once is
// not unrolled.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"
#include "threefry.cuh"

namespace {

constexpr int kRangeThreads = 256;
constexpr int kPrioThreads = 256;
constexpr int kPrioSlots = 2;          // slots a thread of flow_priority
constexpr int kMatchMaxThreads = 1024;
constexpr int kForms = 6;
// dynamic shared memory flow_match may take (the card's 227 KB less its
// static arrays)
constexpr int64_t kMatchShared = 227 * 1024 - 2048;
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

struct RangeArgs {
  const float* leader_load;     // [L, P, 4], 16-byte aligned
  const float* follower_load;   // [L, P, 4], 16-byte aligned
  float* out;                   // [L, 6, 2] (min, max) a weight form
  uint32_t* scratch;            // [L * 12 + 1] (cc_weight_range_scratch)
  int64_t L, P, R;
};

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
  const float* range;           // [6, 2] the context's weight range
  const int64_t* key;           // int64[2] root of the noise's key path
  float* prio;                  // [P, R]
  int64_t P, R, B1;
  // each broker plane's element step (values[b * values_step], ...): 0 for
  // a scalar bound broadcast to every broker, 4 for a column of util
  int64_t values_step, lo_step, up_step, excess_step, deficit_step;
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
  uint8_t* work;                // the workspace where shared memory is short
  int64_t P, R, B1, K;
  // each broker plane's element step, as in PriorityArgs
  int64_t values_step, lo_step, up_step, deficit_step, cap_step;
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

// The order-preserving unsigned image of a float (-0.0 taken as +0.0,
// every NaN as the one positive NaN above +inf, as torch.sort orders).
__device__ __forceinline__ uint32_t order_bits(float x) {
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;
  if (x != x) b = 0x7fffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// threefry2x32 of (x0, x1) under (k0, k1), not inlined: the key's
// derivation and the noise share one copy of the hash's ~100 instructions,
// which a launch that runs each once would otherwise fetch twice.
__device__ __noinline__ uint2 hash_pair(uint32_t k0, uint32_t k1, uint32_t x0,
                                        uint32_t x1) {
  threefry::hash(k0, k1, x0, x1);
  return make_uint2(x0, x1);
}

// threefry.cuh:derive through hash_pair.
__device__ __forceinline__ void derive_key(const int64_t* __restrict__ key,
                                           const DrawPath& path, uint32_t& k0,
                                           uint32_t& k1) {
  uint32_t w[threefry::kMaxPath];
#pragma unroll
  for (int32_t j = 0; j < threefry::kMaxPath; ++j) {
    w[j] = j < path.n && path.ptrs[j] != nullptr
               ? static_cast<uint32_t>(*path.ptrs[j]) : path.words[j];
  }
  k0 = static_cast<uint32_t>(key[0]);
  k1 = static_cast<uint32_t>(key[1]);
#pragma unroll
  for (int32_t j = 0; j < threefry::kMaxPath; ++j) {
    if (j < path.n) {
      const uint2 k = hash_pair(k0, k1, 0u, w[j]);
      k0 = k.x;
      k1 = k.y;
    }
  }
}

// threefry.cuh:bits_at through hash_pair.
__device__ __forceinline__ uint32_t noise_bits(uint32_t k0, uint32_t k1,
                                               uint64_t c) {
  const uint2 x = hash_pair(k0, k1, static_cast<uint32_t>(c >> 32),
                            static_cast<uint32_t>(c));
  return x.x ^ x.y;
}

// ---------------------------------------------------------------------------
// weight_range
// ---------------------------------------------------------------------------

// Folds weight w into (lo, hi): finite weights only, -0.0 as +0.0.
__device__ __forceinline__ void fold_range(float w, float& lo, float& hi) {
  if (w == 0.0f) w = 0.0f;
  if (finite(w)) {
    lo = fminf(lo, w);
    hi = fmaxf(hi, w);
  }
}

__global__ void __launch_bounds__(kRangeThreads)
weight_range_kernel(const RangeArgs a) {
  __shared__ float s_part[kRangeThreads / 32][2 * kForms];
  __shared__ bool s_last;
  const int64_t l = blockIdx.y;
  const float4* __restrict__ lead =
      reinterpret_cast<const float4*>(a.leader_load) + l * a.P;
  const float4* __restrict__ foll =
      reinterpret_cast<const float4*>(a.follower_load) + l * a.P;
  float lo[kForms], hi[kForms];
#pragma unroll
  for (int f = 0; f < kForms; ++f) {
    lo[f] = INFINITY;
    hi[f] = -INFINITY;
  }
  // slot 0 reads the leader's loads, slots 1..R-1 the follower's (with R
  // 1 the follower's column is the leader's again, which changes nothing)
  const bool slots = a.R > 0;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       slots && p < a.P; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 ld = lead[p];
    const float4 fl = a.R > 1 ? foll[p] : ld;
    fold_range(ld.x, lo[0], hi[0]);
    fold_range(fl.x, lo[0], hi[0]);
    fold_range(ld.y, lo[1], hi[1]);
    fold_range(fl.y, lo[1], hi[1]);
    fold_range(ld.z, lo[2], hi[2]);
    fold_range(fl.z, lo[2], hi[2]);
    fold_range(ld.w, lo[3], hi[3]);
    fold_range(fl.w, lo[3], hi[3]);
    fold_range(ld.z, lo[kWeightPotential], hi[kWeightPotential]);
    fold_range(-ld.w, lo[kWeightSmallDisk], hi[kWeightSmallDisk]);
    fold_range(-fl.w, lo[kWeightSmallDisk], hi[kWeightSmallDisk]);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int f = 0; f < kForms; ++f) {
    lo[f] = warp_min(lo[f]);
    hi[f] = warp_max(hi[f]);
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < kForms; ++f) {
      s_part[warp][f] = lo[f];
      s_part[warp][kForms + f] = hi[f];
    }
  }
  __syncthreads();
  // mins as their order bits, maxes as the complement of theirs: every
  // word of the scratch takes atomicMin from 0xffffffff
  const int64_t n_words = a.L * kForms;
  if (threadIdx.x < 2 * kForms) {
    const int f = threadIdx.x % kForms;
    const bool is_max = threadIdx.x >= kForms;
    float v = s_part[0][threadIdx.x];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      v = is_max ? fmaxf(v, s_part[w][threadIdx.x])
                 : fminf(v, s_part[w][threadIdx.x]);
    }
    const uint32_t e = order_bits(v);
    atomicMin(a.scratch + (is_max ? n_words : 0) + l * kForms + f,
              is_max ? ~e : e);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the counter starts at 0xffffffff with the rest: the last block
    // draws total - 2
    const uint32_t total = gridDim.x * gridDim.y;
    const uint32_t ticket = atomicAdd(a.scratch + 2 * n_words, 1u);
    s_last = ticket + 1u == total - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int64_t i = threadIdx.x; i < n_words; i += blockDim.x) {
    a.out[2 * i] = from_order_bits(__ldcg(a.scratch + i));
    a.out[2 * i + 1] = from_order_bits(~__ldcg(a.scratch + n_words + i));
  }
}

// ---------------------------------------------------------------------------
// flow_priority
// ---------------------------------------------------------------------------

// What a slot's priority reads, loaded before any of it is used.
struct Slot {
  int64_t b;
  float w, values, lo, up, excess;
  uint8_t movable, off;
};

// R: the replica slots of a row (1-4 compiled in, 0 read from the launch).
template <int kR>
__global__ void __launch_bounds__(kPrioThreads)
flow_priority_kernel(const PriorityArgs a, const DrawPath path) {
  __shared__ uint32_t s_key[2];
  const uint32_t R = kR > 0 ? kR : static_cast<uint32_t>(a.R);
  const uint32_t n = static_cast<uint32_t>(a.P) * R;
  const int64_t* __restrict__ rb = a.rb;
  const float* __restrict__ leader = a.leader_load;
  const float* __restrict__ follower = a.follower_load;
  const uint32_t base = blockIdx.x * (blockDim.x * kPrioSlots) + threadIdx.x;
  Slot s[kPrioSlots];
  // first round: the slots' brokers, masks and weights
#pragma unroll
  for (int j = 0; j < kPrioSlots; ++j) {
    uint32_t i = base + j * blockDim.x;
    i = i < n ? i : n - 1;
    const uint32_t p = i / R, r = i - p * R;
    const float* load = r == 0 ? leader : follower;
    s[j].b = rb[i];
    s[j].movable = a.movable[i];
    s[j].off = a.off[i];
    s[j].w = a.weight == kWeightPotential ? leader[p * 4 + kNwOut]
             : a.weight == kWeightSmallDisk ? -load[p * 4 + kDisk]
                                            : load[p * 4 + a.weight];
  }
  const float xmin = a.range[2 * a.weight];
  const float xmax = a.range[2 * a.weight + 1];
  bool deficit = false;
  for (int64_t b0 = threadIdx.x; b0 < a.B1; b0 += 4 * blockDim.x) {
    float d[4];                         // four loads in flight a step
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t b = b0 + u * blockDim.x;
      d[u] = a.deficit[(b < a.B1 ? b : a.B1 - 1) * a.deficit_step];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      deficit |= b0 + u * blockDim.x < a.B1 && d[u] > 0.0f;
    }
  }
  // second round: the brokers' planes
#pragma unroll
  for (int j = 0; j < kPrioSlots; ++j) {
    const int64_t b = ordered::clamp_index(s[j].b, a.B1);
    s[j].values = a.values[b * a.values_step];
    s[j].lo = a.lo[b * a.lo_step];
    s[j].up = a.up[b * a.up_step];
    s[j].excess = a.excess[b * a.excess_step];
  }
  if (threadIdx.x < 32) {
    uint32_t k0, k1;
    derive_key(a.key, path, k0, k1);
    if (threadIdx.x == 0) {
      s_key[0] = k0;
      s_key[1] = k1;
    }
  }
  const bool any_deficit = __syncthreads_or(deficit);
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  const float diff = __fsub_rn(xmax, xmin);
  const float span = diff < 1e-12f ? 1e-12f : diff;
#pragma unroll
  for (int j = 0; j < kPrioSlots; ++j) {
    const uint32_t i = base + j * blockDim.x;
    if (i >= n) break;
    const uint32_t r = i - (i / R) * R;
    const bool fin = finite(s[j].w);
    const float q = __fdiv_rn(__fsub_rn(s[j].w, xmin), span);
    const bool assist = any_deficit
                        && s[j].values > midpoint(s[j].lo, s[j].up);
    float prio = s[j].excess > 0.0f ? tier_plus(kTierExcess, q, fin)
                 : (assist ? tier_plus(kTierAssist, q, fin) : -INFINITY);
    if (a.leader_scoped && r != 0) prio = -INFINITY;
    if (!s[j].movable) prio = -INFINITY;
    if (s[j].off) prio = tier_plus(kTierOffline, q, fin);
    const float noise = threefry::affine(noise_bits(k0, k1, i),
                                         a.noise_scale, 0.0f);
    a.prio[i] = __fadd_rn(prio, finite(prio) ? noise : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// flow_match
// ---------------------------------------------------------------------------

// Where each of flow_match's arrays lies in its workspace (bytes from its
// start): shared memory, or the global workspace past kMatchShared.
struct MatchLayout {
  int64_t keys, tmp, head, cum_head, dprio, scan, scan2, load, cum_load,
      rows, flags, cflags, bytes;
  int32_t n2;                   // the sort's width: B1 up to a power of 2
};

__host__ __device__ inline int64_t align16(int64_t x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline MatchLayout match_layout(int64_t B1, int64_t K,
                                                    int64_t R) {
  MatchLayout m{};
  int32_t n2 = 1;
  while (n2 < B1) n2 <<= 1;
  m.n2 = n2;
  const int64_t sb = ordered::scan_scratch(B1), sk = ordered::scan_scratch(K);
  int64_t at = 0;
  m.keys = at;     at = align16(at + 8 * n2);
  m.tmp = at;      at = align16(at + 8 * n2);
  m.head = at;     at = align16(at + 4 * B1);
  m.cum_head = at; at = align16(at + 4 * B1);
  m.dprio = at;    at = align16(at + 4 * B1);
  m.scan = at;     at = align16(at + 4 * ((sb > sk ? sb : sk) + 2));
  m.scan2 = at;    at = align16(at + 4 * ((sb > sk ? sb : sk) + 2));
  m.load = at;     at = align16(at + 4 * K);
  m.cum_load = at; at = align16(at + 4 * K);
  m.rows = at;     at = align16(at + 4 * K * R);
  m.flags = at;    at = align16(at + B1);
  m.cflags = at;   at = align16(at + K);
  m.bytes = at;
  return m;
}

// Threads of flow_match's block: B1 and K up to a power of two, 64-1,024.
__host__ __device__ inline int match_threads(int64_t B1, int64_t K) {
  int t = 64;
  while (t < kMatchMaxThreads && (t < B1 || t < K)) t <<= 1;
  return t;
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

// Ascending sort of the distinct keys[0, n2) (n2 a power of two) by the
// block, through tmp[0, n2); returns the buffer that holds the result.
// Runs of 32 are sorted by one warp each in registers (a bitonic network
// over shuffles, no barrier), then merged in pairs, a barrier a round: an
// element's place in the merged run is its index in its own run plus the
// count of its partner run's keys below it (a binary search). The keys
// must be complete (a block barrier) before.
__device__ uint64_t* merge_sort(uint64_t* keys, uint64_t* tmp, int n2) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
#pragma unroll 1
  for (int base = tid & ~31; base < n2; base += nt) {
    const int i = base + lane;
    uint64_t x = i < n2 ? keys[i] : ~0ull;
    for (int k = 2; k <= 32; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const uint64_t y = __shfl_xor_sync(kFull, x, j);
        const bool ascending = (lane & k) == 0, lower = (lane & j) == 0;
        x = (lower == ascending) ? (x < y ? x : y) : (x < y ? y : x);
      }
    }
    if (i < n2) keys[i] = x;
  }
  __syncthreads();
  uint64_t* src = keys;
  uint64_t* dst = tmp;
  for (int shift = 5; (1 << shift) < n2; ++shift) {
    const int L = 1 << shift;
#pragma unroll 1
    for (int p = tid; p < n2; p += nt) {
      const uint64_t x = src[p];
      const int q = p >> shift;
      const uint64_t* partner = src + ((q ^ 1) << shift);
      int lo = 0, hi = L;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (partner[mid] < x) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      dst[((q & ~1) << shift) + (p & (L - 1)) + lo] = x;
    }
    __syncthreads();
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// The widest scan whose upper levels one warp walks: three levels of 16.
// Up to it the two scans share three barriers; ordered::scan16(Block),
// which takes any length, took flow_match from 0.00890 to 0.00961 ms at
// B1 105, K 512 and from 0.01855 to 0.01977 at B1 1,001, K 1,024 (NVIDIA
// H100 80GB HBM3, 700.00 W).
constexpr int kScanLevels3 = 16 * 16 * 16;

// scan16 (ordered.cuh) of x(0..n) in three steps, each ended by the
// caller's block barrier, so two scans share their barriers:
//  1. scan_level0: every thread its elements (i = tid + c * nt), each
//     half-warp one block of 16: a lane gathers its block's values by
//     shuffles and adds those up to its own in order from 0.0 (an element
//     past n adds +0.0, which changes nothing: a sum from +0.0 is never
//     -0.0), the prefix into out, the block's total into t;
//  2. scan_upper: one warp, the levels above in t (at most 256 and 16
//     values), in the same order;
//  3. scan_carry: each block past the first adds the scanned total before
//     it.
// For n up to kScanLevels3; ``t`` holds ordered::scan_scratch(n) + 2
// floats.
template <class In>
__device__ void scan_level0(In x, float* out, int n, float* t) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int base = lane & 16, me = lane & 15;
#pragma unroll 1
  for (int c = 0; c * nt < n; ++c) {          // the same on every lane
    const int i = c * nt + tid;
    const float v = x(i < n ? i : n - 1);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float w = __shfl_sync(kFull, v, base + j);
      acc = __fadd_rn(acc, j <= me && i - me + j < n ? w : 0.0f);
    }
    if (i < n) out[i] = acc;
    if (me == 15 && i - 15 < n) t[i >> 4] = acc;
  }
}

// One level of 16-blocks of v[0, m) in place by a warp: prefix sums from
// 0.0, each block's total into tot.
__device__ void scan_level_warp(float* v, int m, float* tot) {
  const int lane = threadIdx.x & 31;
  for (int blk = lane; blk * 16 < m; blk += 32) {
    const int lo = blk * 16;
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = v[lo + j < m ? lo + j : m - 1];
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc = __fadd_rn(acc, lo + j < m ? x[j] : 0.0f);
      if (lo + j < m) v[lo + j] = acc;
    }
    tot[blk] = acc;
  }
  __syncwarp();
}

__device__ void scan_upper(int n, float* t) {
  const int lane = threadIdx.x & 31;
  const int n1 = (n + 15) / 16;
  if (n1 <= 1) return;
  const int n2 = (n1 + 15) / 16;
  float* t2 = t + n1;
  scan_level_warp(t, n1, t2);
  if (n2 > 1) {
    scan_level_warp(t2, n2, t2 + n2);
    for (int i = 16 + lane; i < n1; i += 32) {
      t[i] = __fadd_rn(t[i], t2[i / 16 - 1]);
    }
    __syncwarp();
  }
}

__device__ void scan_carry(float* out, int n, const float* t) {
#pragma unroll 1
  for (int i = 16 + threadIdx.x; i < n; i += blockDim.x) {
    out[i] = __fadd_rn(out[i], t[i / 16 - 1]);
  }
}

// The rank sort's widest input: below it each key's rank is counted, a
// few lanes a key; above it the merge sort. At B1 105, K 512 the merge
// sort took flow_match from 0.00890 to 0.00916 ms (NVIDIA H100 80GB HBM3,
// 700.00 W); at B1 1,001 counting would be a million comparisons.
constexpr int kRankSortMax = 256;

// out[r] = the key of rank r among the distinct keys[0, n): each key's
// count of smaller keys split over s lanes (as many as the block has
// threads for, up to 32), then summed by shuffles. The keys must be
// complete (a block barrier) before; ends with a block barrier.
__device__ void rank_sort(const uint64_t* keys, uint64_t* out, int n) {
  const int nt = blockDim.x, lane = threadIdx.x & 31;
  int s = 1;
  while (s < 32 && 2 * s * n <= nt) s <<= 1;
#pragma unroll 1
  for (int g0 = threadIdx.x & ~31; g0 < n * s; g0 += nt) {
    const int g = g0 + lane;                  // the same trips on each lane
    const int i = g / s < n ? g / s : n - 1, q = g % s;
    const uint64_t x = keys[i];
    int r = 0;
#pragma unroll 8
    for (int j = q; j < n; j += s) r += keys[j] < x;
    for (int o = 1; o < s; o <<= 1) r += __shfl_xor_sync(kFull, r, o);
    if (q == 0 && g < n * s) out[r] = x;
  }
  __syncthreads();
}

// A broker's planes, loaded before they are used.
struct BrokerIn {
  float values, lo, up, deficit, cap;
  uint8_t dest;
};

__device__ __forceinline__ BrokerIn load_broker(const MatchArgs& a, int b) {
  BrokerIn in;
  in.values = a.values[b * a.values_step];
  in.lo = a.lo[b * a.lo_step];
  in.up = a.up[b * a.up_step];
  in.deficit = a.deficit[b * a.deficit_step];
  in.cap = a.cap != nullptr ? a.cap[b * a.cap_step] : 0.0f;
  in.dest = a.dest[b];
  return in;
}

template <bool kShared>
__global__ void __launch_bounds__(kMatchMaxThreads, 1)
flow_match_kernel(const MatchArgs a, const DrawPath path) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_red[kMatchMaxThreads / 32][4];
  __shared__ int s_cnt[kMatchMaxThreads / 32];
  const int B1 = static_cast<int>(a.B1), K = static_cast<int>(a.K);
  const int R = static_cast<int>(a.R);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const MatchLayout m = match_layout(B1, K, R);
  unsigned char* ws = kShared ? s_dyn : a.work;
  uint64_t* keys = reinterpret_cast<uint64_t*>(ws + m.keys);
  uint64_t* tmp = reinterpret_cast<uint64_t*>(ws + m.tmp);
  float* head = reinterpret_cast<float*>(ws + m.head);
  float* cum_head = reinterpret_cast<float*>(ws + m.cum_head);
  float* dprio = reinterpret_cast<float*>(ws + m.dprio);
  float* scan = reinterpret_cast<float*>(ws + m.scan);
  float* scan2 = reinterpret_cast<float*>(ws + m.scan2);
  float* load = reinterpret_cast<float*>(ws + m.load);
  float* cum_load = reinterpret_cast<float*>(ws + m.cum_load);
  int32_t* rows = reinterpret_cast<int32_t*>(ws + m.rows);
  uint8_t* flags = ws + m.flags;             // 1 dest, 2 deficit > 0
  uint8_t* cflags = ws + m.cflags;           // 1 selected, 2 mandatory

  // --- stage: the thread's first candidate row and first broker's planes
  // in flight while each warp derives the noise's key; then the brokers'
  // headrooms and noise and the candidates' rows into the workspace
  const int64_t idx0 = tid < K ? a.idx[tid] : 0;
  const float val0 = tid < K ? a.vals[tid] : 0.0f;
  const BrokerIn in0 = load_broker(a, tid < B1 ? tid : B1 - 1);
  uint32_t k0, k1;
  derive_key(a.key, path, k0, k1);
  bool any_mid = false;
  int allowed = 0;
  float c_lo = INFINITY, c_hi = -INFINITY;     // the ceilings' range
  float m_lo = INFINITY, m_hi = -INFINITY;     // the midpoint headrooms'
#pragma unroll 1
  for (int b = tid; b < B1; b += nt) {
    const BrokerIn in = b == tid ? in0 : load_broker(a, b);
    const bool ok = in.dest != 0;
    const float um = a.cap != nullptr ? __fmaf_rn(in.cap, a.thr, -in.values)
                                      : __fsub_rn(in.up, in.values);
    const float ceiling = ok ? ordered::clamp0(um) : 0.0f;
    const float to_mid = ok ? ordered::clamp0(__fsub_rn(
                                  midpoint(in.lo, in.up), in.values)) : 0.0f;
    any_mid |= to_mid > 0.0f;
    allowed += ok;
    if (ok && finite(ceiling)) {
      c_lo = fminf(c_lo, ceiling);
      c_hi = fmaxf(c_hi, ceiling);
    }
    if (ok && finite(to_mid)) {
      m_lo = fminf(m_lo, to_mid);
      m_hi = fmaxf(m_hi, to_mid);
    }
    head[b] = ceiling;
    cum_head[b] = to_mid;
    flags[b] = ok | ((in.deficit > 0.0f) << 1);
    // the destination priority's noise, until its priority replaces it
    dprio[b] = threefry::affine(noise_bits(k0, k1, static_cast<uint64_t>(b)),
                                a.noise_scale, 0.0f);
  }
#pragma unroll 1
  for (int k = tid; k < K; k += nt) {
    const int64_t i = k == tid ? idx0 : a.idx[k];
    const float val = k == tid ? val0 : a.vals[k];
    const int64_t p = i / R, r = i - p * R;
    const float ld = metric_load(a, p, r);
    const uint8_t off = a.off[i];
    int32_t row[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < R) row[s] = static_cast<int32_t>(a.rb[p * R + s]);
    }
    for (int s = 4; s < R; ++s) {
      rows[k * R + s] = static_cast<int32_t>(a.rb[p * R + s]);
    }
    const bool sel = finite(val);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < R) rows[k * R + s] = row[s];
    }
    load[k] = sel ? ld : 0.0f;
    cflags[k] = sel | ((off != 0 && sel) << 1);
    a.p_out[k] = p;
    a.r_out[k] = r;
  }
  // --- the block's any(), count, min and max: one barrier
  any_mid = __any_sync(kFull, any_mid);
  allowed = __reduce_add_sync(kFull, allowed);
  c_lo = warp_min(c_lo);
  c_hi = warp_max(c_hi);
  m_lo = warp_min(m_lo);
  m_hi = warp_max(m_hi);
  if (lane == 0) {
    s_red[warp][0] = c_lo;
    s_red[warp][1] = c_hi;
    s_red[warp][2] = m_lo;
    s_red[warp][3] = m_hi;
    s_cnt[warp] = allowed | (any_mid ? 1 << 30 : 0);
  }
  __syncthreads();
  any_mid = false;
  allowed = 0;
  c_lo = m_lo = INFINITY;
  c_hi = m_hi = -INFINITY;
  for (int w = 0; w < (nt >> 5); ++w) {
    c_lo = fminf(c_lo, s_red[w][0]);
    c_hi = fmaxf(c_hi, s_red[w][1]);
    m_lo = fminf(m_lo, s_red[w][2]);
    m_hi = fmaxf(m_hi, s_red[w][3]);
    any_mid |= (s_cnt[w] >> 30) != 0;
    allowed += s_cnt[w] & ((1 << 30) - 1);
  }
  // the headroom: the ceiling for capacity-style goals or where no
  // destination is below its midpoint, else the room to the midpoint;
  // then _norm01 of it over the allowed brokers
  const bool ceil_form = a.upper_only || !any_mid;
  const float h_lo = ceil_form ? c_lo : m_lo;
  const float h_hi = ceil_form ? c_hi : m_hi;
  const float diff = __fsub_rn(h_hi, h_lo);
  const float span = diff < 1e-12f ? 1e-12f : diff;
  const bool by_rank = B1 <= kRankSortMax;
#pragma unroll 1
  for (int b = tid; b < (by_rank ? B1 : m.n2); b += nt) {
    if (b >= B1) {
      // padding after every broker, each key distinct
      keys[b] = (0xffffffffull << 32) | static_cast<uint32_t>(b);
      continue;
    }
    const float h = ceil_form ? head[b] : cum_head[b];
    const uint8_t f = flags[b];
    float d = -INFINITY;
    if (f & 1) {
      const float norm = finite(h)
          ? __fmul_rn(__fdiv_rn(__fsub_rn(h, h_lo), span), 0.99f) : 0.0f;
      d = __fadd_rn((f & 2) ? kTierExcess : 0.0f, norm);
    }
    const float dp = __fadd_rn(d, finite(d) ? dprio[b] : 0.0f);
    head[b] = h;
    dprio[b] = dp;
    // brokers by descending priority (ascending -dprio), stable
    keys[b] = (static_cast<uint64_t>(order_bits(-dp)) << 32)
              | static_cast<uint32_t>(b);
  }
  __syncthreads();
  // --- the brokers' order, then the scans of the candidates' midpoint
  // loads and of the headroom in that order, sharing their barriers
  const uint64_t* sorted = by_rank ? (rank_sort(keys, tmp, B1), tmp)
                                   : merge_sort(keys, tmp, m.n2);
  auto order = [&](int j) { return static_cast<int>(sorted[j]); };
  auto load_at = [&](int k) { return load[k]; };
  auto head_at = [&](int j) { return head[order(j)]; };
  if (K <= kScanLevels3 && B1 <= kScanLevels3) {
    scan_level0(load_at, cum_load, K, scan2);
    scan_level0(head_at, cum_head, B1, scan);
    __syncthreads();
    if (warp == 0) scan_upper(K, scan2);
    if (warp == 1) scan_upper(B1, scan);
    __syncthreads();
    scan_carry(cum_load, K, scan2);
    scan_carry(cum_head, B1, scan);
  } else {
    ordered::scan16(ordered::Block{}, load_at, cum_load, K, scan2);
    ordered::scan16(ordered::Block{}, head_at, cum_head, B1, scan);
  }
  __syncthreads();
  // --- a thread a candidate: its slot, fallback and re-route
  const int n_ok = allowed < 1 ? 1 : allowed;
#pragma unroll 1
  for (int k = tid; k < K; k += nt) {
    const int32_t* row = rows + k * R;
    auto hosts = [&](int b) {
      bool h = false;
      for (int s = 0; s < R; ++s) h |= row[s] == b;
      return h;
    };
    const uint8_t cf = cflags[k];
    const float target = __fsub_rn(cum_load[k], __fmul_rn(0.5f, load[k]));
    const int slot = static_cast<int>(ordered::lower_bound(cum_head, B1,
                                                           target));
    const bool covered = slot < B1;
    int dst = order(covered ? slot : k % n_ok);
    if (hosts(dst)) {
      // _legal_dest_argmax: the first legal broker in priority order
#pragma unroll 1
      for (int j = 0; j < B1; ++j) {
        const int b = order(j);
        if (!finite(dprio[b])) break;
        if ((flags[b] & 1) && !hosts(b)) {
          dst = b;
          break;
        }
      }
    }
    a.dst_out[k] = dst;
    a.valid_out[k] = (cf & 1) && (covered || (cf & 2)) && (flags[dst] & 1);
  }
}

}  // namespace

// Words of scratch weight_range needs for L contexts.
extern "C" int64_t cc_weight_range_scratch(int64_t L) {
  return 2 * L * kForms + 1;
}

extern "C" int cc_weight_range(const RangeArgs* args, void* stream) {
  const RangeArgs a = *args;
  if (a.L < 1 || a.L > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      a.scratch, 0xff, cc_weight_range_scratch(a.L) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // enough blocks to fill the card, at least one a context
  int64_t bx = (a.P + kRangeThreads - 1) / kRangeThreads;
  const int64_t cap = (132 * 8 + a.L - 1) / a.L;
  bx = bx < cap ? bx : cap;
  bx = bx < 1 ? 1 : bx;
  weight_range_kernel<<<dim3(static_cast<unsigned>(bx),
                             static_cast<unsigned>(a.L)),
                        kRangeThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_flow_priority(const PriorityArgs* args, DrawPath path,
                                void* stream) {
  const PriorityArgs a = *args;
  if (path.n < 0 || path.n > threefry::kMaxPath || a.R < 0
      || a.P * a.R >= (int64_t{1} << 31) || a.weight < 0
      || a.weight >= kForms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = a.P * a.R;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>(
      (n + kPrioThreads * kPrioSlots - 1) / (kPrioThreads * kPrioSlots));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.R) {
    case 1: flow_priority_kernel<1><<<blocks, kPrioThreads, 0, s>>>(a, path);
            break;
    case 2: flow_priority_kernel<2><<<blocks, kPrioThreads, 0, s>>>(a, path);
            break;
    case 3: flow_priority_kernel<3><<<blocks, kPrioThreads, 0, s>>>(a, path);
            break;
    case 4: flow_priority_kernel<4><<<blocks, kPrioThreads, 0, s>>>(a, path);
            break;
    default:
      flow_priority_kernel<0><<<blocks, kPrioThreads, 0, s>>>(a, path);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of global workspace flow_match needs at B1 brokers, K candidates
// and R slots: 0 where its arrays fit in shared memory.
extern "C" int64_t cc_flow_match_workspace(int64_t b1, int64_t k, int64_t r) {
  const int64_t bytes = match_layout(b1, k, r).bytes;
  return bytes <= kMatchShared ? 0 : bytes;
}

extern "C" int cc_flow_match(const MatchArgs* args, DrawPath path,
                             void* stream) {
  const MatchArgs a = *args;
  if (path.n < 0 || path.n > threefry::kMaxPath || a.B1 < 1 || a.R < 1
      || a.B1 >= (int64_t{1} << 30) || a.K * a.R >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.K == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = match_threads(a.B1, a.K);
  const int64_t bytes = match_layout(a.B1, a.K, a.R).bytes;
  if (bytes > kMatchShared) {
    if (a.work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    flow_match_kernel<false><<<1, threads, 0, s>>>(a, path);
  } else {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flow_match_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    flow_match_kernel<true><<<1, threads, bytes, s>>>(a, path);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument structs, which the host's ctypes structs must
// equal
extern "C" int64_t cc_range_args_size() { return sizeof(RangeArgs); }
extern "C" int64_t cc_priority_args_size() { return sizeof(PriorityArgs); }
extern "C" int64_t cc_match_args_size() { return sizeof(MatchArgs); }
