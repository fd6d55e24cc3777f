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
// metric, bounds form and acceptance form. Goals outside the family hand
// in their acceptance as a mask and, as the pass goal, their delta as an
// array.
//
// What bounds it on the card is latency, not bytes: a candidate's verdict
// is a few gathers of the state, and a goal loop that gathered the
// brokers' values from global memory paid one round trip a goal. So each
// block first stages into shared memory the per-broker planes the table
// reads -- the metric columns its rows name, each capacity row's cap * t
// (one rounded product, as the reference's bound), and the broker masks --
// while every thread's candidate fields are already in flight; the
// average rows' bounds are then summed from shared memory (a warp a row,
// XLA's tree order, ordered.cuh:tree_sum), and a candidate's second round
// of loads (its partitions' rows and masks) overlaps those sums. The goal
// loop touches only registers and shared memory. Where the planes do not
// fit in shared memory (B1 in the tens of thousands) the same code reads
// them from global memory (the kShared template flag). A block is 128
// threads wide up to 256 brokers and 256 above (``block_threads``).

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int64_t kMove = 0;   // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;   // MOVE_LEADERSHIP
constexpr int kMaxThreads = 256;
constexpr int kMaxGoals = 48;
constexpr int kMetrics = 8;
// dynamic shared memory a block may take (the card's 227 KB less the
// static arrays)
constexpr int64_t kMaxShared = 227 * 1024 - 1024;

enum Metric : int32_t {        // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };
enum Accepts : int32_t { kInterval = 0, kHardCap = 1 };
// a broker's masks, one byte in shared memory
enum BrokerBit : uint8_t {
  kAlive = 1, kDest = 2, kLeadDest = 4, kValid = 8
};

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
  const float* d_util_src;     // [N, 4], 16-byte aligned
  const float* d_util_dst;     // [N, 4], 16-byte aligned
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

// Which planes a block stages (from the table, on the host): plane
// metric_slot[m] holds metric m (-1: not read), plane cap_slot[g] the
// capacity row g's cap * t (-1: not a capacity row); cap_row lists the
// n_cap capacity rows.
struct Layout {
  int32_t metric_slot[kMetrics];
  int32_t cap_slot[kMaxGoals];
  int32_t cap_row[kMaxGoals];
  int32_t n_cap;
  int32_t n_planes;
  int32_t tree_floats;         // tree_sum scratch a warp
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

// IntervalGoal._penalty of a gathered value (no contraction).
__device__ __forceinline__ float penalty(float v, float lo, float up,
                                         bool alive, bool upper_only) {
  const float over = ordered::clamp0(__fsub_rn(v, up));
  const float under = upper_only ? 0.0f : ordered::clamp0(__fsub_rn(lo, v));
  return alive ? __fadd_rn(over, under) : 0.0f;
}

// A candidate's own fields: the first round of loads.
struct Cand {
  int64_t p, r, p2, r2, src, dst, kind;
  float4 du_s, du_d;
  int32_t d_cnt, d_lead;
  float d_pot, d_lni, extra_delta;
  uint8_t valid, must, extra_ok;       // raw: compared after they arrive
};

__device__ __forceinline__ Cand load_cand(const EligArgs& a, int64_t i) {
  Cand c;
  c.p = a.p[i];
  c.r = a.r[i];
  c.p2 = a.p2[i];
  c.r2 = a.r2[i];
  c.src = a.src[i];
  c.dst = a.dst[i];
  c.kind = a.kind[i];
  c.valid = a.valid[i];
  c.must = a.must[i];
  c.du_s = reinterpret_cast<const float4*>(a.d_util_src)[i];
  c.du_d = reinterpret_cast<const float4*>(a.d_util_dst)[i];
  c.d_cnt = a.d_cnt[i];
  c.d_lead = a.d_lead[i];
  c.d_pot = a.d_pot[i];
  c.d_lni = a.d_lni[i];
  c.extra_ok = a.extra_ok != nullptr ? a.extra_ok[i] : 1;
  c.extra_delta = a.extra_delta != nullptr ? a.extra_delta[i] : 0.0f;
  return c;
}

// (d_src, d_dst) of the candidate's metric m (state.py:metric_deltas),
// selected from registers.
__device__ __forceinline__ void metric_deltas(const Cand& c, int32_t m,
                                              float& ds, float& dd) {
  switch (m) {
    case kCount: dd = static_cast<float>(c.d_cnt); ds = -dd; return;
    case kLeaders: dd = static_cast<float>(c.d_lead); ds = -dd; return;
    case kPotential: dd = c.d_pot; ds = -dd; return;
    case kLeaderNwIn: dd = c.d_lni; ds = -dd; return;
    case 0: ds = c.du_s.x; dd = c.du_d.x; return;
    case 1: ds = c.du_s.y; dd = c.du_d.y; return;
    case 2: ds = c.du_s.z; dd = c.du_d.z; return;
    default: ds = c.du_s.w; dd = c.du_d.w;
  }
}

// A candidate's partition rows and masks: the second round of loads
// (kR slots compiled in, or R from the launch where kR is 0).
template <int kR>
struct Rows {
  static constexpr int kSlots = kR > 0 ? kR : 1;
  int64_t row[kSlots], row2[kSlots];
  int64_t slot, slot2, head;           // row[r], row2[r2], row[0]
  uint8_t mov, off, mov2, off2, lead_movable;   // raw, as loaded
};

template <int kR>
__device__ __forceinline__ void load_rows(const EligArgs& a, const Cand& c,
                                          Rows<kR>& w, int64_t& p,
                                          int64_t& r, int64_t& p2,
                                          int64_t& r2) {
  const int64_t R = kR > 0 ? kR : a.R;
  p = ordered::clamp_index(c.p, a.P);
  r = ordered::clamp_index(c.r, R);
  p2 = ordered::clamp_index(c.p2, a.P);
  r2 = ordered::clamp_index(c.r2, R);
  if (kR > 0) {
#pragma unroll
    for (int s = 0; s < Rows<kR>::kSlots; ++s) {
      w.row[s] = a.rb[p * R + s];
      w.row2[s] = a.rb[p2 * R + s];
    }
  }
  w.slot = a.rb[p * R + r];
  w.slot2 = a.rb[p2 * R + r2];
  w.head = a.rb[p * R];
  w.mov = a.movable[p * R + r];
  w.off = a.off[p * R + r];
  w.mov2 = a.movable[p2 * R + r2];
  w.off2 = a.off[p2 * R + r2];
  w.lead_movable = a.lead_movable[p];
}

template <int kR, class Flags>
__device__ __forceinline__ bool base_legality(const EligArgs& a,
                                              const Cand& c,
                                              const Rows<kR>& w, int64_t p,
                                              int64_t r, int64_t p2,
                                              int64_t r2, Flags flag) {
  const int64_t src = c.src, dst = c.dst;
  const int64_t dst_c = ordered::clamp_index(dst, a.B1);
  const int64_t src_c = ordered::clamp_index(src, a.B1);
  bool hosts_dst = false, hosts_src2 = false;
  if (kR > 0) {
#pragma unroll
    for (int s = 0; s < Rows<kR>::kSlots; ++s) {
      hosts_dst |= w.row[s] == dst;
      hosts_src2 |= w.row2[s] == src;
    }
  } else {
    for (int64_t s = 0; s < a.R; ++s) {
      hosts_dst |= a.rb[p * a.R + s] == dst;
      hosts_src2 |= a.rb[p2 * a.R + s] == src;
    }
  }
  const uint8_t fd = flag(dst_c), fs = flag(src_c);
  const bool lead_dest_dst = (fd & kLeadDest) != 0;
  const bool dest_dst = (fd & kDest) != 0;
  const bool movable = w.mov || w.off, movable2 = w.mov2 || w.off2;
  bool ok;
  if (c.kind == kMove) {
    ok = movable && w.slot == src && dest_dst && !hosts_dst
         && dst != src && (r != 0 || lead_dest_dst);
  } else if (c.kind == kLead) {
    ok = r > 0 && w.lead_movable && w.head == src && w.slot == dst
         && lead_dest_dst && !w.off;
  } else {
    ok = movable && movable2 && p != p2 && w.slot == src
         && w.slot2 == dst && src != dst && dest_dst && (fs & kDest)
         && !hosts_dst && !hosts_src2 && (r != 0 || lead_dest_dst)
         && (r2 != 0 || (fs & kLeadDest));
  }
  return c.valid != 0 && ok;
}

// The sum of get(i) over i in [start, start + 32) within [0, m), in order
// from 0.0: one window of ordered.cuh:tree_sum. An element outside adds
// +0.0, which changes nothing (a sum from +0.0 is never -0.0), so every
// load is unconditional and issues ahead of its add: a skipped add became
// a branch around each element's loads, one round trip an element.
template <class Get>
__device__ __forceinline__ float window_sum(Get get, int start, int m) {
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < ordered::kWindow; ++j) {
    const int i = start + j;
    const bool in = i >= 0 && i < m;
    const float v = get(in ? i : 0);
    acc = __fadd_rn(acc, in ? v : 0.0f);
  }
  return acc;
}

// ordered.cuh:tree_sum of x(0..n) by one warp, returned to every lane;
// ``scratch`` holds ordered::tree_scratch(n) floats.
template <class In>
__device__ float warp_tree_sum(In x, int n, float* scratch) {
  constexpr int kW = ordered::kWindow;
  const int lane = threadIdx.x & 31;
  if (n <= kW) return window_sum(x, 0, n);
  int w = (n + kW - 1) / kW;
  for (int k = lane; k < w; k += 32) {
    scratch[k] = window_sum(x, k * kW - (w * kW - n) / 2, n);
  }
  __syncwarp();
  const float* src = scratch;
  float* dst = scratch + w;
  auto from_src = [&](int i) { return src[i]; };
  for (int m = w; m > kW; m = w) {
    w = (m + kW - 1) / kW;
    for (int k = lane; k < w; k += 32) {
      dst[k] = window_sum(from_src, k * kW - (w * kW - m) / 2, m);
    }
    __syncwarp();
    src = dst;
    dst += w;
  }
  return window_sum(from_src, 0, w);
}

template <bool kShared, int kR>
__global__ void __launch_bounds__(kMaxThreads) eligibility_kernel(
    const EligArgs a, const __grid_constant__ GoalTable t,
    const __grid_constant__ Layout lay) {
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ float s_lo[kMaxGoals];
  __shared__ float s_up[kMaxGoals];
  __shared__ int s_alive[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t B1 = a.B1;
  // shared memory: the tree scratch of each warp, then (kShared) the
  // planes and the masks
  float* scratch = s_dyn + warp * lay.tree_floats;
  float* planes = s_dyn + warps * lay.tree_floats;
  uint8_t* masks = reinterpret_cast<uint8_t*>(planes + lay.n_planes * B1);

  // the candidate's own fields, in flight while the block stages
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const Cand c = load_cand(a, i < a.N ? i : a.N - 1);

  auto mask_of = [&](int64_t b) -> uint8_t {
    return (a.balive[b] ? kAlive : 0) | (a.dest[b] ? kDest : 0)
           | (a.lead_dest[b] ? kLeadDest : 0) | (a.bvalid[b] ? kValid : 0);
  };
  int alive = 0;
  if (kShared) {
#pragma unroll 1
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      const uint8_t f = mask_of(b);
      float v[kMetrics];
#pragma unroll
      for (int m = 0; m < kMetrics; ++m) {
        if (lay.metric_slot[m] >= 0) v[m] = metric_value(a, m, b);
      }
      float cv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (lay.n_cap > 0) {
#pragma unroll
        for (int col = 0; col < 4; ++col) cv[col] = a.cap[b * 4 + col];
      }
      masks[b] = f;
      alive += f & kAlive;
#pragma unroll
      for (int m = 0; m < kMetrics; ++m) {
        if (lay.metric_slot[m] >= 0) planes[lay.metric_slot[m] * B1 + b] = v[m];
      }
      for (int k = 0; k < lay.n_cap; ++k) {
        const int g = lay.cap_row[k];
        planes[lay.cap_slot[g] * B1 + b] = __fmul_rn(cv[t.rows[g].cap_col],
                                                     t.rows[g].t);
      }
    }
  } else {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      alive += a.balive[b] != 0;
    }
  }
  alive = __reduce_add_sync(0xffffffffu, alive);
  if (lane == 0) s_alive[warp] = alive;
  __syncthreads();

  auto flag = [&](int64_t b) -> uint8_t {
    return kShared ? masks[b] : mask_of(b);
  };
  auto cap_t = [&](int g, int64_t b) -> float {
    return kShared ? planes[lay.cap_slot[g] * B1 + b]
                   : __fmul_rn(a.cap[b * 4 + t.rows[g].cap_col],
                               t.rows[g].t);
  };

  // the second round of loads, in flight during the average rows' sums
  Rows<kR> w;
  int64_t p, r, p2, r2;
  load_rows<kR>(a, c, w, p, r, p2, r2);

  // the alive count (clamped at 1) and each average row's bounds
  alive = 0;
  for (int k = 0; k < warps; ++k) alive += s_alive[k];
  const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
#pragma unroll 1
  for (int g = warp; g < t.n; g += warps) {
    const GoalRow row = t.rows[g];
    if (row.form != kAverage) continue;
    float total;
    if (kShared) {
      // both loads of an element issued unconditionally, then selected
      const float* plane = planes + lay.metric_slot[row.metric] * B1;
      total = warp_tree_sum(
          [&](int b) {
            const float v = plane[b];
            return (masks[b] & kValid) ? v : 0.0f;
          },
          static_cast<int>(B1), scratch);
    } else {
      total = warp_tree_sum(
          [&](int b) {
            return a.bvalid[b] ? metric_value(a, row.metric, b) : 0.0f;
          },
          static_cast<int>(B1), scratch);
    }
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

  if (i >= a.N) return;
  const int64_t src = ordered::clamp_index(c.src, B1);
  const int64_t dst = ordered::clamp_index(c.dst, B1);
  bool ok = base_legality<kR>(a, c, w, p, r, p2, r2, flag)
            && c.extra_ok != 0;
  float delta = c.extra_delta;
  const bool al_s = (flag(src) & kAlive) != 0;
  const bool al_d = (flag(dst) & kAlive) != 0;
#pragma unroll 1
  for (int g = 0; g < t.n; ++g) {
    const GoalRow row = t.rows[g];
    float lo_s, lo_d, up_s, up_d;
    if (row.form == kAverage) {
      lo_s = lo_d = s_lo[g];
      up_s = up_d = s_up[g];
    } else {
      lo_s = lo_d = -INFINITY;
      up_s = row.form == kCapacity ? cap_t(g, src) : row.t;
      up_d = row.form == kCapacity ? cap_t(g, dst) : row.t;
    }
    const float* plane = planes + lay.metric_slot[row.metric] * B1;
    const float v_s = kShared ? plane[src] : metric_value(a, row.metric, src);
    const float v_d = kShared ? plane[dst] : metric_value(a, row.metric, dst);
    float d_s, d_d;
    metric_deltas(c, row.metric, d_s, d_d);
    const float src_after = __fadd_rn(v_s, d_s);
    const float dst_after = __fadd_rn(v_d, d_d);
    if (g == 0 && t.has_pass) {
      // the pass goal's residual delta (IntervalGoal.delta)
      const bool uo = row.upper_only != 0;
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
  a.elig[i] = ok && (delta < t.neg_eps || c.must != 0);
  a.delta[i] = delta;
}

template <bool kShared>
cudaError_t launch(const EligArgs& a, const GoalTable& t, const Layout& lay,
                   int threads, size_t shared, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((a.N + threads - 1)
                                                / threads);
  switch (a.R) {
#define CC_ELIG_CASE(R)                                                     \
    case R: {                                                               \
      auto k = eligibility_kernel<kShared, R>;                              \
      if (shared > 48 * 1024) {                                             \
        const cudaError_t e = cudaFuncSetAttribute(                         \
            k, cudaFuncAttributeMaxDynamicSharedMemorySize,                 \
            static_cast<int>(shared));                                      \
        if (e != cudaSuccess) return e;                                     \
      }                                                                     \
      k<<<blocks, threads, shared, s>>>(a, t, lay);                         \
      break;                                                                \
    }
    CC_ELIG_CASE(1)
    CC_ELIG_CASE(2)
    CC_ELIG_CASE(3)
    CC_ELIG_CASE(4)
    default: {
      auto k = eligibility_kernel<kShared, 0>;
      if (shared > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(shared));
        if (e != cudaSuccess) return e;
      }
      k<<<blocks, threads, shared, s>>>(a, t, lay);
    }
#undef CC_ELIG_CASE
  }
  return cudaGetLastError();
}

}  // namespace

// Floats of shared tree_sum scratch a warp of KN needs at B1 brokers.
extern "C" int64_t cc_eligibility_scratch(int64_t b1) {
  return ordered::tree_scratch(b1) + 1;
}

// KN's plane layout for ``t`` (false where a row is malformed) and the
// shared memory it needs at B1 brokers in blocks of ``threads``: the
// per-warp tree scratch alone (``tree``), or with the staged planes and
// masks (``staged``).
static bool plan_layout(const GoalTable& t, int64_t b1, int threads,
                        Layout& lay, int64_t& tree, int64_t& staged) {
  lay = Layout{};
  for (int m = 0; m < kMetrics; ++m) lay.metric_slot[m] = -1;
  int n = 0;
  for (int g = 0; g < t.n; ++g) {
    const int m = t.rows[g].metric;
    if (m < 0 || m >= kMetrics || t.rows[g].cap_col < 0
        || t.rows[g].cap_col > 3) {
      return false;
    }
    if (lay.metric_slot[m] < 0) lay.metric_slot[m] = n++;
  }
  for (int g = 0; g < t.n; ++g) {
    lay.cap_slot[g] = -1;
    if (t.rows[g].form == kCapacity) {
      lay.cap_slot[g] = n++;
      lay.cap_row[lay.n_cap++] = g;
    }
  }
  lay.n_planes = n;
  lay.tree_floats = static_cast<int32_t>(cc_eligibility_scratch(b1));
  tree = static_cast<int64_t>(threads / 32) * lay.tree_floats
         * static_cast<int64_t>(sizeof(float));
  staged = tree + n * b1 * static_cast<int64_t>(sizeof(float)) + b1;
  return true;
}

// KN's block at B1 brokers. Each block stages and sums the brokers'
// planes once, so more brokers want fewer, wider blocks: at N 1,024 the
// card gave 32 threads 0.011158 ms, 64 0.007132, 128 0.005310 and 256
// 0.006015 at B1 105, but 256 0.009422 against 128's 0.010586 at B1
// 1,001 (NVIDIA H100 80GB HBM3, 700.00 W).
static int block_threads(int64_t b1) { return b1 <= 256 ? 128 : 256; }

// KN's launch on ``stream``; returns cudaGetLastError().
extern "C" int cc_candidate_eligibility(const EligArgs* args,
                                        const GoalTable* table,
                                        void* stream) {
  const EligArgs a = *args;
  const GoalTable& t = *table;
  if (t.n < 0 || t.n > kMaxGoals) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = block_threads(a.B1);
  if (a.N == 0) return static_cast<int>(cudaGetLastError());
  Layout lay;
  int64_t tree, staged;
  if (!plan_layout(t, a.B1, threads, lay, tree, staged)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged <= kMaxShared) {
    return static_cast<int>(launch<true>(a, t, lay, threads,
                                         static_cast<size_t>(staged), s));
  }
  if (tree > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  lay.n_planes = 0;
  lay.n_cap = 0;
  return static_cast<int>(launch<false>(a, t, lay, threads,
                                        static_cast<size_t>(tree), s));
}

// Whether KN stages its planes in shared memory for ``table`` at B1
// brokers (1), or reads them from global memory (0).
extern "C" int cc_eligibility_staged(const GoalTable* table, int64_t b1) {
  Layout lay;
  int64_t tree, staged;
  return plan_layout(*table, b1, block_threads(b1), lay, tree, staged)
         && staged <= kMaxShared;
}

// sizeof(EligArgs) and sizeof(GoalTable), which the host's ctypes structs
// must equal
extern "C" int64_t cc_elig_args_size() { return sizeof(EligArgs); }
extern "C" int64_t cc_goal_table_size() { return sizeof(GoalTable); }
