// KN: a goal pass's candidate eligibility -- base legality, the
// acceptance of every earlier goal of the chain, the pass goal's residual
// delta and the verdict (delta < -eps) | must.
//
// Replaces cruise_control_tpu/analyzer/state.py:base_legality (:362-413)
// with the chain's acceptance and the goal's delta
// (analyzer/engine.py:eligibility, :124-128; goals.py:IntervalGoal.delta /
// accepts, :365-405; CapacityGoal.accepts, :983; and the goals outside
// the interval family: RackAwareGoal :1158/:1169,
// RackAwareDistributionGoal :1750/:1756, TopicReplicaDistributionGoal
// :1343/:1359, MinTopicLeadersPerBrokerGoal :1520/:1538,
// BrokerSetAwareGoal :1647/:1666, PreferredLeaderElectionGoal :1822),
// which the pass evaluates in every drain round, proposal and apply
// round. In plain torch that is about 45 launches of legality, 12 an
// earlier goal and 20 for the delta and its bounds.
//
// The goals reach the kernel as a table (GoalRow, built once a chain
// position on the host): rows[0] the pass goal (its delta), every other
// row an earlier goal (its acceptance), one row kind a goal form: the
// interval family's (a metric, a bounds form, an acceptance form), and
// one kind for each goal outside it -- rack counts over the candidate's
// partition rows, the topic cells of topic_counts / topic_leader_counts
// (a topic of -1 wraps to the last row, as a JAX gather reads it), the
// broker sets, the preferred positions. A goal that accepts every
// candidate (an inactive one, PreferredLeaderElection) has no row as an
// earlier goal. A launch holds kMaxGoals rows; a longer table is read in
// chunks of kMaxGoals, one launch each, a chunk after the first carrying
// the verdict and delta of the one before through ``elig`` and ``delta``
// (the default chain's 16 goals are one launch). The chunks, and the
// topic rows' several gap slots (kMaxTopicSlots), exist only so that any
// goal list the API accepts runs on the card: no chain the repo builds
// passes 16 goals, and a chain bound from one BalancingConstraint has one
// topic gap.
//
// What bounds it on the card is latency, not bytes: a candidate's verdict
// is a few gathers of the state, and a goal loop that gathered the
// brokers' values from global memory paid one round trip a goal. So each
// block first stages into shared memory the per-broker planes the table
// reads -- the metric columns its rows name, each capacity row's cap * t
// (one rounded product, as the reference's bound), the racks and broker
// sets where a row reads them, and the broker masks -- while every
// thread's candidate fields are already in flight; the average rows'
// bounds are then summed from shared memory (a warp a row, XLA's tree
// order, ordered.cuh:tree_sum), and a candidate's second round of loads
// (its partitions' rows, masks and topics) overlaps those sums. Where the
// planes do not fit in shared memory (B1 in the tens of thousands) the
// same code reads them from global memory (the kShared template flag). A
// block is 128 threads wide up to 256 brokers and 256 above
// (``block_threads``). The count of alive racks (RackAwareDistribution's
// limit) is a bit set in shared memory that the staging loop fills as it
// reads the alive mask, at no extra pass. The topic rows' bounds sum a
// [T, B1] table, which every block would repeat, so they are one launch
// of their own ahead of KN (topic_bounds_kernel, a warp a topic); a
// candidate then reads its four cells and its topics' bounds, never the
// whole table, so topic_counts is not staged at any T x B1.
//
// In an apply round the caller hands in ``bounds``: block 0 writes each
// average row's (lower, upper) there, and the topic bounds stay in
// ``tbounds``, for KQ (round_guards.cu), whose guards read the same bounds
// at the same state.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounds.cuh"
#include "ordered.cuh"

namespace {

constexpr int64_t kMove = 0;   // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;   // MOVE_LEADERSHIP
constexpr int64_t kSwap = 2;   // MOVE_SWAP
constexpr int kMaxThreads = 256;
constexpr int kMaxGoals = 48;  // rows a launch holds (kernels.MAX_GOAL_ROWS)
constexpr int kMaxTopicSlots = 8;
constexpr int kMetrics = 8;
// dynamic shared memory a block may take (the card's 227 KB less the
// static arrays)
constexpr int64_t kMaxShared = 227 * 1024 - 1024;

enum Metric : int32_t {        // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };
// A row's goal form (kernels.ROW_KINDS): the interval family's two
// acceptance forms, then one a goal outside it.
enum Kind : int32_t {
  kInterval = 0,        // IntervalGoal.accepts / delta
  kHardCap = 1,         // CapacityGoal.accepts, IntervalGoal.delta
  kRackAware = 2,       // RackAwareGoal
  kRackSpread = 3,      // RackAwareDistributionGoal (KafkaAssignerEvenRackAware)
  kTopicReplica = 4,    // TopicReplicaDistributionGoal
  kTopicLeaders = 5,    // MinTopicLeadersPerBrokerGoal, topics configured
  kBrokerSet = 6,       // BrokerSetAwareGoal, a topic set bound
  kPreferredLeader = 7, // PreferredLeaderElectionGoal
  kNothing = 8          // an inactive goal: accepts all, delta 0
};
// a broker's masks, one byte in shared memory
enum BrokerBit : uint8_t {
  kAlive = 1, kDest = 2, kLeadDest = 4, kValid = 8
};

}  // namespace

// One goal: its kind; for the interval family its metric, bounds form
// (average: [avg * lower, avg * t], capacity: cap[:, cap_col] * t,
// constant: t) and acceptance (kind interval: IntervalGoal.accepts; hard
// cap: CapacityGoal.accepts); for the others what the kind reads.
struct GoalRow {
  int32_t kind;
  int32_t metric;
  int32_t form;
  int32_t upper_only;
  int32_t integer;
  int32_t cap_col;
  // topic leaders: min_count; broker set: the topic sets' length; topic
  // replica: its slot of the launch's topic bounds
  int32_t param;
  float t;                     // topic replica: threshold - 1.0
  float lower;                 // topic replica: the minimum gap
  float hi;                    // topic replica: the maximum gap
  // topic leaders: uint8 interested[T]; broker set: int32 topic_set[param]
  const void* aux;
};

// A launch's chunk of a chain position's rows: with ``first`` rows[0] is
// the pass goal (its delta) and base legality is checked; otherwise the
// chunk before left the verdict so far in elig and the delta in delta.
// ``last`` writes the verdict (delta < -eps) | must. ``start``: the
// chunk's first row among the chain position's rows.
struct GoalTable {
  GoalRow rows[kMaxGoals];
  int32_t n;
  int32_t start;
  int32_t first;
  int32_t last;
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
  const int64_t* pos;          // [P, R]
  const int32_t* rack;         // [B1]
  const int32_t* bset;         // [B1]
  const int32_t* ptopic;       // [P]
  const int32_t* tc;           // [T, B1] or null
  const int32_t* tlc;          // [T, B1] or null
  float* tbounds;              // [slots, 2, T]: each topic row's (lower, upper)
  uint8_t* elig;               // [N]
  float* delta;                // [N]
  // [rows, 2] or null: each average row's (lower, upper), for KQ
  // (round_guards.cu), which reads them in the same round
  float* bounds;
  int64_t P, R, B1, N, T;
};

// Which planes a block stages (from the table, on the host): plane
// metric_slot[m] holds metric m (-1: not read), plane cap_slot[g] the
// capacity row g's cap * t (-1: not a capacity row); cap_row lists the
// n_cap capacity rows; rack_plane and set_plane hold the racks and broker
// sets (int32, -1: not read). rack_words: words of the alive racks' bit
// set (0: no rack-spread row); topics: a row reads the candidates'
// topics.
struct Layout {
  int32_t metric_slot[kMetrics];
  int32_t cap_slot[kMaxGoals];
  int32_t cap_row[kMaxGoals];
  int32_t n_cap;
  int32_t n_planes;
  int32_t tree_floats;         // tree_sum scratch a warp
  int32_t rack_plane;
  int32_t set_plane;
  int32_t rack_words;
  int32_t topics;
};

// The topic rows' gap constants, by slot (topic_bounds_kernel).
struct TopicGaps {
  float c[kMaxTopicSlots];     // threshold - 1.0
  float lo[kMaxTopicSlots];
  float hi[kMaxTopicSlots];
  int32_t n;
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
  float d_pot, d_lni;
  uint8_t valid, must;                 // raw: compared after they arrive
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
  int32_t topic, topic2;               // raw partition_topic[p], [p2]
  uint8_t mov, off, mov2, off2, lead_movable;   // raw, as loaded
};

template <int kR>
__device__ __forceinline__ void load_rows(const EligArgs& a, const Cand& c,
                                          bool topics, Rows<kR>& w,
                                          int64_t& p, int64_t& r,
                                          int64_t& p2, int64_t& r2) {
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
  w.topic = topics ? a.ptopic[p] : 0;
  w.topic2 = topics ? a.ptopic[p2] : 0;
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

// The row a JAX gather reads for index i along an axis of n: a negative
// index counts from the end, then the index is clamped (goals._jax_index).
__device__ __forceinline__ int64_t jax_index(int64_t i, int64_t n) {
  return ordered::clamp_index(i < 0 ? i + n : i, n);
}

// What the rows outside the interval family read of a candidate: its
// partition rows (slot(s), slot2(s)), the brokers and racks, the alive
// racks' count.
template <class Slot, class Slot2, class RackOf, class SetOf>
struct Reach {
  const EligArgs& a;
  const Cand& c;
  Slot slot;
  Slot2 slot2;
  RackOf rack;
  SetOf bset;
  int64_t R, p, r, r2, src, dst, mine, mine2;
  int32_t topic, topic2;
  bool al_s, al_d;
  int n_racks;
};

// (before, after) same-rack pairs of replica (·, r) of a row when it moves
// to ``nw`` (RackAwareGoal._dup_change): the other valid slots on the
// replica's rack and on nw's.
template <class SlotF, class RackOf>
__device__ __forceinline__ void dup_change(SlotF slot, int64_t R, int64_t r,
                                           int64_t mine, int64_t nw,
                                           int64_t B, RackOf rack,
                                           int& before, int& after) {
  const int32_t my = rack(mine), nr = rack(nw);
  before = after = 0;
  for (int64_t s = 0; s < R; ++s) {
    const int64_t b = slot(s);
    if (s != r && b < B) {
      const int32_t rk = rack(b);
      before += rk == my;
      after += rk == nr;
    }
  }
}

// A row's excess over the per-rack limit with slot ``sub`` holding
// ``sub_b`` (-1: none): RackAwareDistributionGoal._row_penalty, each rack
// group's count on its first valid slot.
template <class SlotF, class RackOf>
__device__ __forceinline__ int64_t rack_excess(SlotF slot, int64_t R,
                                               int64_t sub, int64_t sub_b,
                                               int64_t B, RackOf rack,
                                               int64_t limit) {
  int64_t pen = 0;
  for (int64_t s = 0; s < R; ++s) {
    const int64_t bs = s == sub ? sub_b : slot(s);
    if (bs >= B) continue;
    const int32_t rs = rack(bs);
    int64_t n = 0;
    bool first = true;
    for (int64_t j = 0; j < R; ++j) {
      const int64_t bj = j == sub ? sub_b : slot(j);
      if (bj < B && rack(bj) == rs) {
        ++n;
        first = first && j >= s;
      }
    }
    if (first) pen += n > limit ? n - limit : 0;
  }
  return pen;
}

// ceil(rf / alive racks) of a row: its valid slots over the count, in
// float32 (RackAwareDistributionGoal._limit).
template <class SlotF>
__device__ __forceinline__ int64_t rack_limit(SlotF slot, int64_t R,
                                              int64_t B, int n_racks) {
  int64_t rf = 0;
  for (int64_t s = 0; s < R; ++s) rf += slot(s) < B;
  return static_cast<int64_t>(ceilf(__fdiv_rn(static_cast<float>(rf),
                                              static_cast<float>(n_racks))));
}

// TopicReplicaDistributionGoal._penalty of a count against (lo, up).
__device__ __forceinline__ float topic_penalty(int32_t count, float lo,
                                               float up, bool alive) {
  const float v = static_cast<float>(count);
  const float over = ordered::clamp0(__fsub_rn(v, up));
  const float under = ordered::clamp0(__fsub_rn(lo, v));
  return alive ? __fadd_rn(over, under) : 0.0f;
}

// A row of a goal outside the interval family: its delta where ``pass``
// (the pass goal), else its acceptance; the port's goals.py methods of
// the same name, read gather by gather.
template <class Re>
__device__ bool outside_row(const GoalRow& row, const Re& x, int64_t B1,
                            int64_t T, bool pass, float& delta) {
  const EligArgs& a = x.a;
  const Cand& c = x.c;
  const int64_t B = B1 - 1;              // num_brokers_padded
  const bool is_move = c.kind == kMove, is_swap = c.kind == kSwap;
  const bool is_lead = c.kind == kLead;
  switch (row.kind) {
    case kRackAware: {
      int b1, a1, b2, a2;
      dup_change(x.slot, x.R, x.r, x.mine, x.dst, B, x.rack, b1, a1);
      dup_change(x.slot2, x.R, x.r2, x.mine2, x.src, B, x.rack, b2, a2);
      if (pass) {
        const float d1 = static_cast<float>(a1 - b1);
        const float d2 = static_cast<float>(a2 - b2);
        delta = is_move ? d1 : (is_swap ? __fadd_rn(d1, d2) : 0.0f);
        return true;
      }
      return is_move ? a1 == 0 : (is_swap ? a1 == 0 && a2 == 0 : true);
    }
    case kRackSpread: {
      const int64_t lim1 = rack_limit(x.slot, x.R, B, x.n_racks);
      const int64_t lim2 = rack_limit(x.slot2, x.R, B, x.n_racks);
      const float d1 = static_cast<float>(
          rack_excess(x.slot, x.R, x.r, x.dst, B, x.rack, lim1)
          - rack_excess(x.slot, x.R, -1, 0, B, x.rack, lim1));
      const float d2 = static_cast<float>(
          rack_excess(x.slot2, x.R, x.r2, x.src, B, x.rack, lim2)
          - rack_excess(x.slot2, x.R, -1, 0, B, x.rack, lim2));
      if (pass) {
        delta = is_move ? d1 : (is_swap ? __fadd_rn(d1, d2) : 0.0f);
        return true;
      }
      return is_move ? d1 <= 0.0f
                     : (is_swap ? d1 <= 0.0f && d2 <= 0.0f : true);
    }
    case kTopicReplica: {
      const int64_t t1 = jax_index(x.topic, T), t2 = jax_index(x.topic2, T);
      const int32_t m1 = is_move || is_swap, m2 = is_swap;
      const bool same_t = x.topic == x.topic2;
      const int32_t m2_t1 = same_t ? m2 : 0, m2_t2 = same_t ? 0 : m2;
      const int32_t d_src_t1 = m2_t1 - m1, d_dst_t1 = m1 - m2_t1;
      const int32_t* tc = a.tc;
      const int32_t c1s = tc[t1 * B1 + x.src], c1d = tc[t1 * B1 + x.dst];
      const int32_t c2d = tc[t2 * B1 + x.dst], c2s = tc[t2 * B1 + x.src];
      const float* tb = a.tbounds + static_cast<int64_t>(row.param) * 2 * T;
      const float up1 = tb[T + t1], up2 = tb[T + t2];
      if (!pass) {
        const int32_t dst_after = c1d + d_dst_t1;
        const bool ok1 = d_dst_t1 <= 0
                         || static_cast<float>(dst_after) <= up1
                         || dst_after <= c1s + d_src_t1;
        const int32_t src_after = c2s + m2_t2;
        const bool ok2 = m2_t2 <= 0
                         || static_cast<float>(src_after) <= up2
                         || src_after <= c2d - m2_t2;
        return ok1 && ok2;
      }
      const float lo1 = tb[t1], lo2 = tb[t2];
      auto pen = [&](int32_t cell, float lo, float up, bool alive,
                     int32_t d) {
        return __fsub_rn(topic_penalty(cell + d, lo, up, alive),
                         topic_penalty(cell, lo, up, alive));
      };
      delta = __fadd_rn(
          __fadd_rn(__fadd_rn(pen(c1s, lo1, up1, x.al_s, d_src_t1),
                              pen(c1d, lo1, up1, x.al_d, d_dst_t1)),
                    pen(c2d, lo2, up2, x.al_d, -m2_t2)),
          pen(c2s, lo2, up2, x.al_s, m2_t2));
      return true;
    }
    case kTopicLeaders: {
      const int64_t t1 = jax_index(x.topic, T), t2 = jax_index(x.topic2, T);
      const uint8_t* interested = static_cast<const uint8_t*>(row.aux);
      const int32_t d1 = is_lead || ((is_move || is_swap) && x.r == 0);
      const int32_t d2 = is_swap && x.r2 == 0;
      const int32_t* tlc = a.tlc;
      const int32_t m = row.param;
      const bool i1 = interested[t1] != 0, i2 = interested[t2] != 0;
      const int32_t c1s = tlc[t1 * B1 + x.src];
      const int32_t c2d = tlc[t2 * B1 + x.dst];
      if (!pass) {
        const bool ok1 = !(i1 && x.al_s) || -d1 >= 0 || c1s - d1 >= m;
        const bool ok2 = !(i2 && x.al_d) || -d2 >= 0 || c2d - d2 >= m;
        return ok1 && ok2;
      }
      const int32_t c1d = tlc[t1 * B1 + x.dst];
      const int32_t c2s = tlc[t2 * B1 + x.src];
      auto pen = [&](int32_t cell, bool active, int32_t d) -> int32_t {
        const int32_t before = m - cell > 0 ? m - cell : 0;
        const int32_t after = m - (cell + d) > 0 ? m - (cell + d) : 0;
        return active ? after - before : 0;
      };
      delta = static_cast<float>(
          pen(c1s, x.al_s && i1, -d1) + pen(c1d, x.al_d && i1, d1)
          + pen(c2d, x.al_d && i2, -d2) + pen(c2s, x.al_s && i2, d2));
      return true;
    }
    case kBrokerSet: {
      const int32_t* sets = static_cast<const int32_t*>(row.aux);
      const int32_t want1 = sets[jax_index(x.topic, row.param)];
      const int32_t want2 = sets[jax_index(x.topic2, row.param)];
      auto outside = [&](int32_t want, int64_t b) {
        const int32_t have = x.bset(b);
        return want >= 0 && have >= 0 && have != want;
      };
      const bool lo1 = outside(want1, x.dst), lo2 = outside(want2, x.src);
      if (!pass) {
        return is_move ? !lo1 : (is_swap ? !lo1 && !lo2 : true);
      }
      const bool mis1 = x.mine < B && outside(want1, x.mine);
      const bool mis2 = x.mine2 < B && outside(want2, x.mine2);
      const float d1 = __fsub_rn(lo1 ? 1.0f : 0.0f, mis1 ? 1.0f : 0.0f);
      const float d2 = __fsub_rn(lo2 ? 1.0f : 0.0f, mis2 ? 1.0f : 0.0f);
      delta = is_move ? d1 : (is_swap ? __fadd_rn(d1, d2) : 0.0f);
      return true;
    }
    case kPreferredLeader: {
      if (pass) {
        const int64_t pr = a.pos[x.p * x.R + x.r], p0 = a.pos[x.p * x.R];
        delta = !is_lead ? 0.0f
                         : (pr == 0 && p0 != 0 ? -1.0f
                                               : (p0 == 0 ? 1.0f : 0.0f));
      }
      return true;
    }
    default:                             // kNothing
      if (pass) delta = 0.0f;
      return true;
  }
}

template <bool kShared, int kR>
__global__ void __launch_bounds__(kMaxThreads) eligibility_kernel(
    const EligArgs a, const __grid_constant__ GoalTable t,
    const __grid_constant__ Layout lay) {
  extern __shared__ __align__(16) float s_dyn[];
  __shared__ float s_lo[kMaxGoals];
  __shared__ float s_up[kMaxGoals];
  __shared__ int s_alive[kMaxThreads / 32];
  __shared__ int s_racks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t B1 = a.B1;
  // shared memory: the tree scratch of each warp, the alive racks' bit
  // set, then (kShared) the planes and the masks
  float* scratch = s_dyn + warp * lay.tree_floats;
  uint32_t* rack_bits = reinterpret_cast<uint32_t*>(
      s_dyn + warps * lay.tree_floats);
  float* planes = s_dyn + warps * lay.tree_floats + lay.rack_words;
  int32_t* iplanes = reinterpret_cast<int32_t*>(planes);
  uint8_t* masks = reinterpret_cast<uint8_t*>(planes + lay.n_planes * B1);

  // the candidate's own fields, in flight while the block stages
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  const Cand c = load_cand(a, i < a.N ? i : a.N - 1);

  if (lay.rack_words > 0) {
    for (int k = threadIdx.x; k < lay.rack_words; k += blockDim.x) {
      rack_bits[k] = 0u;
    }
    __syncthreads();
  }
  // an alive broker's rack in the bit set (ids clamped into [0, B1), a
  // negative rack not counted: goals._count_distinct)
  auto mark_rack = [&](int64_t b, bool alive_b) {
    if (lay.rack_words > 0 && alive_b) {
      const int32_t rk = a.rack[b];
      if (rk >= 0) {
        const int64_t k = rk < B1 ? rk : B1 - 1;
        atomicOr(&rack_bits[k >> 5], 1u << (k & 31));
      }
    }
  };
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
      const int32_t rk = lay.rack_plane >= 0 ? a.rack[b] : 0;
      const int32_t st = lay.set_plane >= 0 ? a.bset[b] : 0;
      masks[b] = f;
      alive += f & kAlive;
#pragma unroll
      for (int m = 0; m < kMetrics; ++m) {
        if (lay.metric_slot[m] >= 0) planes[lay.metric_slot[m] * B1 + b] = v[m];
      }
      for (int k = 0; k < lay.n_cap; ++k) {
        const int g = lay.cap_row[k];
        planes[lay.cap_slot[g] * B1 + b] =
            bounds::capacity(cv[t.rows[g].cap_col], t.rows[g].t);
      }
      if (lay.rack_plane >= 0) iplanes[lay.rack_plane * B1 + b] = rk;
      if (lay.set_plane >= 0) iplanes[lay.set_plane * B1 + b] = st;
      mark_rack(b, (f & kAlive) != 0);
    }
  } else {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      const bool al = a.balive[b] != 0;
      alive += al;
      mark_rack(b, al);
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
                   : bounds::capacity(a.cap[b * 4 + t.rows[g].cap_col],
                                      t.rows[g].t);
  };

  // the second round of loads, in flight during the average rows' sums
  Rows<kR> w;
  int64_t p, r, p2, r2;
  load_rows<kR>(a, c, lay.topics != 0, w, p, r, p2, r2);

  // the alive count (clamped at 1) and each average row's bounds
  alive = 0;
  for (int k = 0; k < warps; ++k) alive += s_alive[k];
  const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
#pragma unroll 1
  for (int g = warp; g < t.n; g += warps) {
    const GoalRow row = t.rows[g];
    if (row.kind > kHardCap || row.form != kAverage) continue;
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
      bounds::average(total, n_alive, row.t, row.lower, row.upper_only != 0,
                      row.integer != 0, s_lo[g], s_up[g]);
    }
    __syncwarp();
  }
  // the count of alive racks (clamped at 1), by the last warp
  if (lay.rack_words > 0 && warp == warps - 1) {
    int n = 0;
    for (int k = lane; k < lay.rack_words; k += 32) n += __popc(rack_bits[k]);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) s_racks = n < 1 ? 1 : n;
  }
  __syncthreads();
  if (a.bounds != nullptr && blockIdx.x == 0) {
    for (int g = threadIdx.x; g < t.n; g += blockDim.x) {
      if (t.rows[g].kind <= kHardCap && t.rows[g].form == kAverage) {
        a.bounds[2 * (t.start + g)] = s_lo[g];
        a.bounds[2 * (t.start + g) + 1] = s_up[g];
      }
    }
  }

  if (i >= a.N) return;
  const int64_t src = ordered::clamp_index(c.src, B1);
  const int64_t dst = ordered::clamp_index(c.dst, B1);
  bool ok;
  float delta = 0.0f;
  if (t.first) {
    ok = base_legality<kR>(a, c, w, p, r, p2, r2, flag);
  } else {
    ok = a.elig[i] != 0;
    delta = a.delta[i];
  }
  const bool al_s = (flag(src) & kAlive) != 0;
  const bool al_d = (flag(dst) & kAlive) != 0;
  const int64_t R = kR > 0 ? kR : a.R;
  auto slot = [&](int64_t s) -> int64_t {
    if (kR > 0) return w.row[s];
    return a.rb[p * R + s];
  };
  auto slot2 = [&](int64_t s) -> int64_t {
    if (kR > 0) return w.row2[s];
    return a.rb[p2 * R + s];
  };
  auto rack_of = [&](int64_t b) -> int32_t {
    b = ordered::clamp_index(b, B1);
    return kShared && lay.rack_plane >= 0 ? iplanes[lay.rack_plane * B1 + b]
                                          : a.rack[b];
  };
  auto set_of = [&](int64_t b) -> int32_t {
    b = ordered::clamp_index(b, B1);
    return kShared && lay.set_plane >= 0 ? iplanes[lay.set_plane * B1 + b]
                                         : a.bset[b];
  };
  const Reach<decltype(slot), decltype(slot2), decltype(rack_of),
              decltype(set_of)>
      reach{a, c, slot, slot2, rack_of, set_of, R, p, r, r2, src, dst,
            w.slot, w.slot2, w.topic, w.topic2, al_s, al_d,
            lay.rack_words > 0 ? s_racks : 1};
#pragma unroll 1
  for (int g = 0; g < t.n; ++g) {
    const GoalRow row = t.rows[g];
    const bool pass = t.first && g == 0;
    if (row.kind > kHardCap) {
      const bool acc = outside_row(row, reach, B1, a.T, pass, delta);
      ok = ok && (pass || acc);
      continue;
    }
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
    if (pass) {
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
    if (row.kind == kHardCap) {
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
  a.elig[i] = t.last ? ok && (delta < t.neg_eps || c.must != 0) : ok;
  a.delta[i] = delta;
}

// Each topic row's bounds of the launch (TopicReplicaDistributionGoal.
// _bounds): a warp a topic sums its cells over the valid brokers (an
// integer sum, exact in any order), then avg = total / max(alive, 1) and
// each slot's gap clamp(avg * (threshold - 1), min, max) in float32;
// out[slot] holds (lower[T], upper[T]).
__global__ void __launch_bounds__(kMaxThreads) topic_bounds_kernel(
    const int32_t* tc, const uint8_t* bvalid, const uint8_t* balive,
    int64_t T, int64_t B1, const TopicGaps gaps, float* out) {
  __shared__ int s_alive[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int alive = 0;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    alive += balive[b] != 0;
  }
  alive = __reduce_add_sync(0xffffffffu, alive);
  if (lane == 0) s_alive[warp] = alive;
  __syncthreads();
  alive = 0;
  for (int k = 0; k < warps; ++k) alive += s_alive[k];
  const float n = static_cast<float>(alive < 1 ? 1 : alive);
  for (int64_t tp = static_cast<int64_t>(blockIdx.x) * warps + warp; tp < T;
       tp += static_cast<int64_t>(gridDim.x) * warps) {
    long long total = 0;
    for (int64_t b = lane; b < B1; b += 32) {
      total += bvalid[b] ? tc[tp * B1 + b] : 0;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, d);
    }
    if (lane < gaps.n) {
      bounds::topic(total, n, gaps.c[lane], gaps.lo[lane], gaps.hi[lane],
                    out[(2 * lane) * T + tp], out[(2 * lane + 1) * T + tp]);
    }
  }
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

// KN's plane layout for a chunk ``t`` (false where a row is malformed)
// and the shared memory it needs at B1 brokers in blocks of ``threads``:
// the per-warp tree scratch and the rack bit set alone (``tree``), or
// with the staged planes and masks (``staged``).
static bool plan_layout(const GoalTable& t, int64_t b1, int threads,
                        Layout& lay, int64_t& tree, int64_t& staged) {
  lay = Layout{};
  for (int m = 0; m < kMetrics; ++m) lay.metric_slot[m] = -1;
  lay.rack_plane = lay.set_plane = -1;
  int n = 0;
  bool racks = false, spread = false, sets = false;
  for (int g = 0; g < t.n; ++g) {
    const GoalRow& row = t.rows[g];
    if (row.kind < kInterval || row.kind > kNothing) return false;
    if (row.kind > kHardCap) {
      racks |= row.kind == kRackAware || row.kind == kRackSpread;
      spread |= row.kind == kRackSpread;
      sets |= row.kind == kBrokerSet;
      lay.topics |= row.kind == kTopicReplica || row.kind == kTopicLeaders
                    || row.kind == kBrokerSet;
      continue;
    }
    const int m = row.metric;
    if (m < 0 || m >= kMetrics || row.cap_col < 0 || row.cap_col > 3) {
      return false;
    }
    if (lay.metric_slot[m] < 0) lay.metric_slot[m] = n++;
  }
  for (int g = 0; g < t.n; ++g) {
    lay.cap_slot[g] = -1;
    if (t.rows[g].kind <= kHardCap && t.rows[g].form == kCapacity) {
      lay.cap_slot[g] = n++;
      lay.cap_row[lay.n_cap++] = g;
    }
  }
  if (racks) lay.rack_plane = n++;
  if (sets) lay.set_plane = n++;
  lay.n_planes = n;
  lay.rack_words = spread ? static_cast<int32_t>((b1 + 31) / 32) : 0;
  lay.tree_floats = static_cast<int32_t>(cc_eligibility_scratch(b1));
  tree = (static_cast<int64_t>(threads / 32) * lay.tree_floats
          + lay.rack_words) * static_cast<int64_t>(sizeof(float));
  staged = tree + n * b1 * static_cast<int64_t>(sizeof(float)) + b1;
  return true;
}

// KN's block at B1 brokers. Each block stages and sums the brokers'
// planes once, so more brokers want fewer, wider blocks: at N 1,024 the
// card gave 32 threads 0.011158 ms, 64 0.007132, 128 0.005310 and 256
// 0.006015 at B1 105, but 256 0.009422 against 128's 0.010586 at B1
// 1,001 (NVIDIA H100 80GB HBM3, 700.00 W).
static int block_threads(int64_t b1) { return b1 <= 256 ? 128 : 256; }

// Chunk ``k`` of the ``n`` rows: its table (``first`` where k is 0,
// ``last`` where it ends the rows).
static GoalTable chunk(const GoalRow* rows, int32_t n, int32_t k,
                       float neg_eps) {
  GoalTable t{};
  const int32_t start = k * kMaxGoals;
  t.n = n - start < kMaxGoals ? n - start : kMaxGoals;
  t.start = start;
  for (int g = 0; g < t.n; ++g) t.rows[g] = rows[start + g];
  t.first = k == 0;
  t.last = start + t.n == n;
  t.neg_eps = neg_eps;
  return t;
}

// KN's launches on ``stream`` for the ``n`` rows (rows[0] the pass goal):
// the topic rows' bounds where the rows have one, then a launch per chunk
// of kMaxGoals rows; returns cudaGetLastError().
extern "C" int cc_candidate_eligibility(const EligArgs* args,
                                        const GoalRow* rows, int32_t n,
                                        float neg_eps, void* stream) {
  const EligArgs a = *args;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_threads(a.B1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TopicGaps gaps{};
  for (int g = 0; g < n; ++g) {
    // a topic row reads its table, T >= 1 rows of it
    if ((rows[g].kind == kTopicLeaders && (a.tlc == nullptr || a.T < 1))
        || (rows[g].kind == kTopicReplica && a.T < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rows[g].kind != kTopicReplica) continue;
    const int k = rows[g].param;
    if (k < 0 || k >= kMaxTopicSlots || a.tc == nullptr
        || a.tbounds == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    gaps.c[k] = rows[g].t;
    gaps.lo[k] = rows[g].lower;
    gaps.hi[k] = rows[g].hi;
    gaps.n = gaps.n > k + 1 ? gaps.n : k + 1;
  }
  if (a.N == 0) return static_cast<int>(cudaGetLastError());
  if (gaps.n > 0) {
    const int64_t per = kMaxThreads / 32;
    const int64_t want = (a.T + per - 1) / per;
    const unsigned blocks = static_cast<unsigned>(want < 264 ? want : 264);
    topic_bounds_kernel<<<blocks, kMaxThreads, 0, s>>>(
        a.tc, a.bvalid, a.balive, a.T, a.B1, gaps, a.tbounds);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int32_t k = 0; k * kMaxGoals < n; ++k) {
    const GoalTable t = chunk(rows, n, k, neg_eps);
    Layout lay;
    int64_t tree, staged;
    if (!plan_layout(t, a.B1, threads, lay, tree, staged)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e;
    if (staged <= kMaxShared) {
      e = launch<true>(a, t, lay, threads, static_cast<size_t>(staged), s);
    } else {
      if (tree > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
      lay.n_planes = 0;
      lay.n_cap = 0;
      lay.rack_plane = lay.set_plane = -1;
      e = launch<false>(a, t, lay, threads, static_cast<size_t>(tree), s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether every launch of KN stages its planes in shared memory for the
// ``n`` rows at B1 brokers (1), or one reads them from global memory (0).
extern "C" int cc_eligibility_staged(const GoalRow* rows, int32_t n,
                                     int64_t b1) {
  for (int32_t k = 0; k * kMaxGoals < n; ++k) {
    const GoalTable t = chunk(rows, n, k, 0.0f);
    Layout lay;
    int64_t tree, staged;
    if (!plan_layout(t, b1, block_threads(b1), lay, tree, staged)
        || staged > kMaxShared) {
      return 0;
    }
  }
  return 1;
}

// sizeof(EligArgs) and sizeof(GoalRow), which the host's ctypes structs
// must equal
extern "C" int64_t cc_elig_args_size() { return sizeof(EligArgs); }
extern "C" int64_t cc_goal_row_size() { return sizeof(GoalRow); }
