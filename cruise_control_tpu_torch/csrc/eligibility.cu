// KN: a goal pass's candidate eligibility in one launch — base legality,
// the acceptance of every earlier goal of the interval family, the pass
// goal's residual delta and the verdict (delta < -eps) | must.
//
// Replaces cruise_control_tpu/analyzer/state.py:base_legality (:362-413)
// with the chain's acceptance and the goal's delta
// (analyzer/engine.py:eligibility, :124-128; goals.py:IntervalGoal.delta /
// accepts, :365-405; CapacityGoal.accepts, :983), which the pass evaluates
// in every drain round, proposal and apply round. In plain torch that is
// about 45 launches of legality, 12 an earlier goal and 20 for the delta
// and its bounds.
//
// The goals reach the kernel as a table (GoalTable, built once a chain
// position on the host): a row a goal of the IntervalGoal family with its
// metric, bounds form and acceptance form. Every block recomputes the
// bounds of the average-form rows itself — a warp a row sums the metric
// over the valid brokers in XLA's tree order (ordered.cuh:tree_sum),
// divides by the alive count and scales by t (integer goals widened to
// ceil / floor) — so no grid-wide sync is needed: 16 goals x 1,001
// brokers is little work. The capacity form's bound is cap * thr, one
// rounded product, read at the candidate's brokers; the constant form is
// max_replicas. Goals outside the family hand in their acceptance as a
// mask and, as the pass goal, their delta as an array.
//
// Then one thread a candidate. Bound on the card: bytes (the candidates'
// fields read once, a few gathers of the state a candidate) — well below
// a launch's floor at the main path's shapes.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int64_t kMove = 0;   // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;   // MOVE_LEADERSHIP
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGoals = 48;

enum Metric : int32_t {        // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };
enum Accepts : int32_t { kInterval = 0, kHardCap = 1 };

}  // namespace

// One goal: its metric, bounds form (average: [avg * lower, avg * t],
// capacity: cap[:, cap_col] * t, constant: t), and acceptance form
// (interval: IntervalGoal.accepts; hard cap: CapacityGoal.accepts).
struct GoalRow {
  int32_t metric;
  int32_t form;
  int32_t upper_only;
  int32_t integer;
  int32_t accepts;
  int32_t cap_col;
  float t;
  float lower;
};

// A chain position: rows[0] is the pass goal where has_pass (its delta),
// every other row an earlier goal (its acceptance).
struct GoalTable {
  GoalRow rows[kMaxGoals];
  int32_t n;
  int32_t has_pass;
  float neg_eps;               // -epsilon as float32
};

struct EligArgs {
  const int64_t* rb;           // [P, R]
  const uint8_t* off;          // [P, R]
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const uint8_t* movable;      // [P, R]
  const uint8_t* dest;         // [B1]
  const uint8_t* lead_dest;    // [B1]
  const uint8_t* lead_movable; // [P]
  const uint8_t* bvalid;       // [B1]
  const uint8_t* balive;       // [B1]
  const float* cap;            // [B1, 4]
  const int64_t* p;            // candidates [N]
  const int64_t* r;
  const int64_t* p2;
  const int64_t* r2;
  const int64_t* src;
  const int64_t* dst;
  const int64_t* kind;
  const uint8_t* valid;
  const uint8_t* must;
  const float* d_util_src;     // [N, 4]
  const float* d_util_dst;     // [N, 4]
  const int32_t* d_cnt;
  const int32_t* d_lead;
  const float* d_pot;
  const float* d_lni;
  const uint8_t* extra_ok;     // [N] or null: outside goals' acceptance
  const float* extra_delta;    // [N] or null: an outside pass goal's delta
  uint8_t* elig;               // [N]
  float* delta;                // [N]
  int64_t P, R, B1, N;
};

namespace {

__device__ __forceinline__ float metric_value(const EligArgs& a, int32_t m,
                                              int64_t b) {
  switch (m) {
    case kCount: return static_cast<float>(a.cnt[b]);
    case kLeaders: return static_cast<float>(a.lead[b]);
    case kPotential: return a.pot[b];
    case kLeaderNwIn: return a.lni[b];
    default: return a.util[b * 4 + m];
  }
}

// (d_src, d_dst) of candidate i (state.py:metric_deltas).
__device__ __forceinline__ void metric_deltas(const EligArgs& a, int32_t m,
                                              int64_t i, float& ds,
                                              float& dd) {
  switch (m) {
    case kCount: dd = static_cast<float>(a.d_cnt[i]); ds = -dd; return;
    case kLeaders: dd = static_cast<float>(a.d_lead[i]); ds = -dd; return;
    case kPotential: dd = a.d_pot[i]; ds = -dd; return;
    case kLeaderNwIn: dd = a.d_lni[i]; ds = -dd; return;
    default: ds = a.d_util_src[i * 4 + m]; dd = a.d_util_dst[i * 4 + m];
  }
}

// IntervalGoal._penalty of a gathered value (no contraction).
__device__ __forceinline__ float penalty(float v, float lo, float up,
                                         bool alive, bool upper_only) {
  const float over = ordered::clamp0(__fsub_rn(v, up));
  const float under = upper_only ? 0.0f : ordered::clamp0(__fsub_rn(lo, v));
  return alive ? __fadd_rn(over, under) : 0.0f;
}

__device__ __forceinline__ bool base_legality(const EligArgs& a, int64_t i) {
  const int64_t R = a.R;
  const int64_t p = ordered::clamp_index(a.p[i], a.P);
  const int64_t r = ordered::clamp_index(a.r[i], R);
  const int64_t p2 = ordered::clamp_index(a.p2[i], a.P);
  const int64_t r2 = ordered::clamp_index(a.r2[i], R);
  const int64_t src = a.src[i], dst = a.dst[i];
  const int64_t dst_c = ordered::clamp_index(dst, a.B1);
  const int64_t src_c = ordered::clamp_index(src, a.B1);
  const int64_t* row = a.rb + p * R;
  const int64_t* row2 = a.rb + p2 * R;
  bool hosts_dst = false, hosts_src2 = false;
  for (int64_t s = 0; s < R; ++s) {
    hosts_dst |= row[s] == dst;
    hosts_src2 |= row2[s] == src;
  }
  const int64_t slot_broker = row[r];
  const bool movable = a.movable[p * R + r] || a.off[p * R + r];
  const bool lead_dest_dst = a.lead_dest[dst_c] != 0;
  const bool dest_dst = a.dest[dst_c] != 0;
  const int64_t k = a.kind[i];
  bool ok;
  if (k == kMove) {
    ok = movable && slot_broker == src && dest_dst && !hosts_dst
         && dst != src && (r != 0 || lead_dest_dst);
  } else if (k == kLead) {
    ok = r > 0 && a.lead_movable[p] && row[0] == src && slot_broker == dst
         && lead_dest_dst && !a.off[p * R + r];
  } else {
    const bool movable2 = a.movable[p2 * R + r2] || a.off[p2 * R + r2];
    ok = movable && movable2 && p != p2 && slot_broker == src
         && row2[r2] == dst && src != dst && dest_dst && a.dest[src_c]
         && !hosts_dst && !hosts_src2 && (r != 0 || lead_dest_dst)
         && (r2 != 0 || a.lead_dest[src_c]);
  }
  return a.valid[i] && ok;
}

__global__ void __launch_bounds__(kThreads) eligibility_kernel(
    const EligArgs a, const GoalTable t, int64_t scratch_floats) {
  extern __shared__ float s_scratch[];
  __shared__ float s_lo[kMaxGoals];
  __shared__ float s_up[kMaxGoals];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the alive count (clamped at 1) and each average row's bounds
  int64_t alive = 0;
  for (int64_t base = 0; base < a.B1; base += blockDim.x) {
    const int64_t b = base + threadIdx.x;
    alive += __syncthreads_count(b < a.B1 && a.balive[b] != 0);
  }
  const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
  float* scratch = s_scratch + warp * scratch_floats;
  for (int g = warp; g < t.n; g += kWarps) {
    const GoalRow row = t.rows[g];
    if (row.form != kAverage) continue;
    const float total = ordered::tree_sum(
        ordered::Warp{},
        [&](int64_t b) {
          return a.bvalid[b] ? metric_value(a, row.metric, b) : 0.0f;
        },
        a.B1, scratch);
    if (lane == 0) {
      const float avg = __fdiv_rn(total, n_alive);
      float up = __fmul_rn(avg, row.t);
      float lo = row.upper_only ? -INFINITY : __fmul_rn(avg, row.lower);
      if (row.integer) {
        up = fmaxf(up, ceilf(avg));
        if (!row.upper_only) lo = fminf(lo, floorf(avg));
      }
      s_lo[g] = lo;
      s_up[g] = up;
    }
    __syncwarp();
  }
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= a.N) return;
  const int64_t src = ordered::clamp_index(a.src[i], a.B1);
  const int64_t dst = ordered::clamp_index(a.dst[i], a.B1);
  bool ok = base_legality(a, i);
  if (a.extra_ok != nullptr) ok = ok && a.extra_ok[i];
  float delta = a.extra_delta != nullptr ? a.extra_delta[i] : 0.0f;
  for (int g = 0; g < t.n; ++g) {
    const GoalRow row = t.rows[g];
    float lo_s, lo_d, up_s, up_d;
    if (row.form == kAverage) {
      lo_s = lo_d = s_lo[g];
      up_s = up_d = s_up[g];
    } else {
      lo_s = lo_d = -INFINITY;
      up_s = row.form == kCapacity
                 ? __fmul_rn(a.cap[src * 4 + row.cap_col], row.t) : row.t;
      up_d = row.form == kCapacity
                 ? __fmul_rn(a.cap[dst * 4 + row.cap_col], row.t) : row.t;
    }
    const float v_s = metric_value(a, row.metric, src);
    const float v_d = metric_value(a, row.metric, dst);
    float d_s, d_d;
    metric_deltas(a, row.metric, i, d_s, d_d);
    const float src_after = __fadd_rn(v_s, d_s);
    const float dst_after = __fadd_rn(v_d, d_d);
    if (g == 0 && t.has_pass) {
      // the pass goal's residual delta (IntervalGoal.delta)
      const bool uo = row.upper_only != 0;
      const bool al_s = a.balive[src] != 0, al_d = a.balive[dst] != 0;
      const float before = __fadd_rn(penalty(v_s, lo_s, up_s, al_s, uo),
                                     penalty(v_d, lo_d, up_d, al_d, uo));
      const float after = __fadd_rn(
          penalty(src_after, lo_s, up_s, al_s, uo),
          penalty(dst_after, lo_d, up_d, al_d, uo));
      delta = __fsub_rn(after, before);
      continue;
    }
    bool acc;
    if (row.accepts == kHardCap) {
      acc = (d_d <= 0.0f || dst_after <= up_d)
            && (d_s <= 0.0f || src_after <= up_s);
    } else {
      acc = d_d <= 0.0f || dst_after <= up_d || dst_after <= src_after;
      if (!row.upper_only) {
        acc = acc && (d_s >= 0.0f || src_after >= lo_s
                      || src_after >= dst_after);
      }
    }
    ok = ok && acc;
  }
  a.elig[i] = ok && (delta < t.neg_eps || a.must[i] != 0);
  a.delta[i] = delta;
}

}  // namespace

// Floats of shared scratch a warp of KN needs at B1 brokers.
extern "C" int64_t cc_eligibility_scratch(int64_t b1) {
  return ordered::tree_scratch(b1) + 1;
}

// KN's launch on ``stream``; returns cudaGetLastError().
extern "C" int cc_candidate_eligibility(const EligArgs* args,
                                        const GoalTable* table,
                                        void* stream) {
  const EligArgs a = *args;
  if (table->n < 0 || table->n > kMaxGoals) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.N == 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_warp = cc_eligibility_scratch(a.B1);
  const size_t shared = static_cast<size_t>(per_warp) * kWarps
                        * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eligibility_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (a.N + kThreads - 1) / kThreads;
  eligibility_kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(a, *table,
                                                            per_warp);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(EligArgs) and sizeof(GoalTable), which the host's ctypes structs
// must equal
extern "C" int64_t cc_elig_args_size() { return sizeof(EligArgs); }
extern "C" int64_t cc_goal_table_size() { return sizeof(GoalTable); }
