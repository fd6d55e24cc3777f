// KQ: one apply round's guards and masks, between KN (eligibility) and KM
// (apply): for the M candidates of the round, with elig = pending & KN's
// verdict,
//   blocked[i] = any_j conflict_earlier[i, j] & elig[j]
//   ok[i]      = AND over the chain's guard goals of the goal's collective
//                guard over the earlier eligible candidates (j < i,
//                elig[j]), the pass goal's or'ed with must[i]
//   do[i]      = elig[i] & !blocked[i] & ok[i]
//   pending'   = pending & !do;  more = any(pending') & any(do)
//
// Replaces the body of cruise_control_tpu/analyzer/engine.py's apply round
// (:154-180) with every guard it calls: IntervalGoal.collective_guard
// (goals.py:406, two-sided and upper_only), CapacityGoal's (:994, also
// ReplicaCapacityGoal's), TopicReplicaDistributionGoal's (:1373),
// MinTopicLeadersPerBrokerGoal's (:1552), the engine's default for a goal
// without one (serialize shared brokers, engine.py:167-169) and the
// partition-local goals' (all ones: no row). In the port those were KC
// (net_flow.cu) or KK (cell_flow.cu) and about ten eager operations a goal
// a round, and the masks around them.
//
// The goals reach the kernel as a table (GuardRow, built once a chain
// position on the host and uploaded once a device): one row a guard goal
// with a kind. Its flows do not depend on the goal: an interval or
// capacity row reads the six one-sided partial sums of its metric, which
// are computed once a distinct metric of the table (a "slot"), and every
// topic row reads the same topic-cell sums. The rows' bounds are what KN
// computed at the same state in the same round: an average row's (lower,
// upper) and the topic rows' bounds come from the buffers KN wrote
// (eligibility.cu), a capacity row's is cap[b, col] * t (one rounded
// product), a constant row's t.
//
// Order and exactness. Each float partial sum adds its terms in ascending
// j, a skipped term being +-0.0 (a sum from +0.0 never becomes -0.0, so
// skipping changes no bit), the pairs added last, then (values + net) + d
// and the comparisons: KC's order and the eager epilogue's roundings
// (kernels.net_broker_flow_ascending), no contraction. The topic cells'
// terms are small integers, exact in any order (integer sums here).
//
// What bounds it: latency. The bytes are the [M, M] conflict mask and a
// few M-vectors (~0.1 us at M 512); a row's verdict is a walk over its
// earlier candidates, and in a dense round (every candidate on a few hot
// brokers) the last rows match 600-1,100 times. So each candidate row is
// one warp; the block's eight rows share the candidate columns staged in
// shared memory in chunks of kChunk (ids, each slot's two deltas, the
// topic fields; a column's read-only loads all issued before its
// stores), and a warp reads its conflict row in one vector load a lane a
// chunk, issued before the staging barrier. Matches are found 32 columns
// at a time by ballots (dst == dst, src == dst, src == src, dst == src),
// and lane 4 s + q adds slot s's terms of match kind q in ascending
// column order: the 4 x 8 sums run side by side, so a table of eight
// metrics costs a match what one does. A window where some lane has more
// than kDense matches is walked column by column, the others four
// matches a step with their loads in flight together (a missing term
// adds +0.0, which changes no bit of a sum from +0.0). The table's rows
// and their average bounds sit in shared memory and the capacity columns
// and topic cells a candidate's rows read are loaded before the walk, so
// the verdicts after it wait on no load. A row that is not eligible
// skips the walk. (The first design, a lane a slot adding every kind in
// turn one match a step and reading each row and bound after the walk,
// took 0.0406 ms at the main path's M 512 against this one's 0.0203,
// scripts/ab_main_path.py --kernels, NVIDIA H100 80GB HBM3, 700.00 W.)
// The flag `more` is an integer OR a block into a scratch word (zeroed by
// a memset before the launch); the last block to finish writes it.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;            // candidate columns staged a pass
constexpr int kBytes = kChunk / 32;    // conflict bytes a lane a chunk
constexpr int kMaxSlots = 8;           // distinct metrics of a table
constexpr int kRowsShared = 64;        // table rows staged in shared memory
constexpr int kDense = 8;              // above: walk a window column by column
constexpr unsigned kFull = 0xffffffffu;

constexpr int64_t kMove = 0;           // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;           // MOVE_LEADERSHIP
constexpr int64_t kSwap = 2;           // MOVE_SWAP

enum Metric : int32_t {                // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };
// A row's guard (kernels.GUARD_KINDS).
enum GuardKind : int32_t {
  kInterval = 0,       // IntervalGoal.collective_guard
  kHardCap = 1,        // CapacityGoal.collective_guard
  kTopicReplica = 2,   // TopicReplicaDistributionGoal
  kTopicLeaders = 3,   // MinTopicLeadersPerBrokerGoal, topics configured
  kSerialize = 4       // no guard of its own: serialize shared brokers
};
// The topic tables a table reads (GuardArgs.reads).
enum Reads : int32_t { kTopicCells = 1, kLeaderCells = 2 };
// A staged column's kind byte: the move kind, then r == 0 and r2 == 0.
enum KindBits : uint8_t {
  kIsMove = 1, kIsLead = 2, kIsSwap = 4, kR0 = 8, kR20 = 16
};

}  // namespace

// One guard goal. Interval and capacity rows: the metric's slot, the
// bounds form (average: KN's (lower, upper) of row bound_row; capacity:
// cap[:, cap_col] * t; constant: t) and upper_only; topic replica: slot is
// its slot of KN's topic bounds; topic leaders: param the minimum, aux
// the interested topics (uint8[T]). ``must``: the pass goal, whose verdict
// a mandatory move overrides.
struct GuardRow {
  int32_t kind;
  int32_t slot;
  int32_t form;
  int32_t upper_only;
  int32_t cap_col;
  int32_t bound_row;
  int32_t param;
  int32_t must;
  float t;
  const uint8_t* aux;
};

struct GuardArgs {
  const int64_t* p;            // candidates [M]
  const int64_t* p2;
  const int64_t* r;
  const int64_t* r2;
  const int64_t* src;
  const int64_t* dst;
  const int64_t* kind;
  const uint8_t* must;
  const float* d_util_src;     // [M, 4]
  const float* d_util_dst;     // [M, 4]
  const int32_t* d_cnt;
  const int32_t* d_lead;
  const float* d_pot;
  const float* d_lni;
  const uint8_t* elig;         // KN's verdict [M]
  const uint8_t* pending;      // [M]
  const uint8_t* conflict;     // [M, M]: conflict_earlier
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const float* cap;            // [B1, 4]
  const uint8_t* balive;       // [B1]
  const int32_t* ptopic;       // [P]
  const int32_t* tc;           // [T, B1] or null
  const int32_t* tlc;          // [T, B1] or null
  const float* bounds;         // KN's [rows, 2]: an average row's (lo, up)
  const float* tbounds;        // KN's [slots, 2, T]: (lower, upper) a topic
  const GuardRow* rows;        // [n_rows], on the device
  int32_t* scratch;            // [3]: blocks done, any pending, any do
  uint8_t* do_out;             // [M]
  uint8_t* pending_out;        // [M]
  uint8_t* more_out;           // []
  int64_t M, P, B1, T;
  int32_t n_rows;
  int32_t n_slots;
  int32_t metric[kMaxSlots];   // each slot's metric code
  int32_t reads;               // Reads bits
};

namespace {

__device__ __forceinline__ float metric_value(const GuardArgs& a, int32_t m,
                                              int64_t b) {
  switch (m) {
    case kCount: return static_cast<float>(a.cnt[b]);
    case kLeaders: return static_cast<float>(a.lead[b]);
    case kPotential: return a.pot[b];
    case kLeaderNwIn: return a.lni[b];
    default: return a.util[b * 4 + m];
  }
}

// (d_src, d_dst) of metric m from a candidate's delta fields in registers
// (state.py:metric_deltas).
struct Deltas {
  float4 us, ud;                       // d_util_src, d_util_dst
  int32_t dc, dl;                      // d_cnt, d_lead
  float dp, dn;                        // d_pot, d_lni

  __device__ __forceinline__ void of(int32_t m, float& ds, float& dd) const {
    switch (m) {
      case kCount: dd = static_cast<float>(dc); ds = -dd; return;
      case kLeaders: dd = static_cast<float>(dl); ds = -dd; return;
      case kPotential: dd = dp; ds = -dd; return;
      case kLeaderNwIn: dd = dn; ds = -dd; return;
      case 0: ds = us.x; dd = ud.x; return;
      case 1: ds = us.y; dd = ud.y; return;
      case 2: ds = us.z; dd = ud.z; return;
      default: ds = us.w; dd = ud.w;
    }
  }
};

// Candidate j's delta fields, read-only loads issued together (the [M, 4]
// planes 16-byte aligned).
__device__ __forceinline__ Deltas load_deltas(const GuardArgs& a, int64_t j) {
  Deltas d;
  d.us = __ldg(reinterpret_cast<const float4*>(a.d_util_src) + j);
  d.ud = __ldg(reinterpret_cast<const float4*>(a.d_util_dst) + j);
  d.dc = __ldg(a.d_cnt + j);
  d.dl = __ldg(a.d_lead + j);
  d.dp = __ldg(a.d_pot + j);
  d.dn = __ldg(a.d_lni + j);
  return d;
}

__device__ __forceinline__ float column(const float4& v, int32_t c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint8_t kind_bits(int64_t kind, int64_t r,
                                             int64_t r2) {
  return (kind == kMove ? kIsMove : 0) | (kind == kLead ? kIsLead : 0)
         | (kind == kSwap ? kIsSwap : 0) | (r == 0 ? kR0 : 0)
         | (r2 == 0 ? kR20 : 0);
}

// The row a JAX gather reads for index i along an axis of n
// (goals._jax_index).
__device__ __forceinline__ int64_t jax_index(int64_t i, int64_t n) {
  return ordered::clamp_index(i < 0 ? i + n : i, n);
}

// A (topic, broker) cell's id, as the guards name it: topic * B1 + broker.
__device__ __forceinline__ int64_t cell(int32_t topic, int32_t b,
                                        int64_t B1) {
  return static_cast<int64_t>(topic) * B1 + b;
}

// A candidate's topic-count deltas on its four cells, in the order
// (t1, src), (t1, dst), (t2, dst), (t2, src)
// (TopicReplicaDistributionGoal._cell_deltas): a same-topic swap cancels.
__device__ __forceinline__ void topic_deltas(uint8_t kb, bool same_t,
                                             int32_t d[4]) {
  const int32_t m1 = (kb & (kIsMove | kIsSwap)) != 0;
  const int32_t m2 = (kb & kIsSwap) != 0;
  const int32_t m2_t1 = same_t ? m2 : 0, m2_t2 = same_t ? 0 : m2;
  d[0] = m2_t1 - m1;
  d[1] = m1 - m2_t1;
  d[2] = -m2_t2;
  d[3] = m2_t2;
}

// Leadership of the candidate's topic leaving src (d1) and of the swap
// counterpart's leaving dst (d2) (MinTopicLeadersPerBrokerGoal._cell_delta).
__device__ __forceinline__ void leader_deltas(uint8_t kb, int32_t& d1,
                                              int32_t& d2) {
  d1 = (kb & kIsLead) || ((kb & (kIsMove | kIsSwap)) && (kb & kR0));
  d2 = (kb & kIsSwap) && (kb & kR20);
}

__global__ void __launch_bounds__(kThreads)
round_guards_kernel(const __grid_constant__ GuardArgs a) {
  __shared__ int32_t s_src[kChunk];
  __shared__ int32_t s_dst[kChunk];
  __shared__ int32_t s_t1[kChunk];
  __shared__ int32_t s_t2[kChunk];
  __shared__ uint8_t s_elig[kChunk];
  __shared__ uint8_t s_kind[kChunk];
  // slot s's (d_src, d_dst) of column k at [k][2 * n_slots]: s, n_slots + s
  __shared__ float s_ab[kChunk * 2 * kMaxSlots];
  // the table's first rows, and each average row's (lower, upper)
  __shared__ GuardRow s_rows[kRowsShared];
  __shared__ float2 s_bounds[kRowsShared];
  __shared__ int s_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t M = a.M, B1 = a.B1;
  const int D = a.n_slots;
  const bool topics = (a.reads & (kTopicCells | kLeaderCells)) != 0;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = i < M;
  const int64_t ic = live ? i : M - 1;
  // the columns the block's rows walk for their guards: j < its last row
  const int64_t block_end = static_cast<int64_t>(blockIdx.x + 1) * kWarps;
  const int64_t rows_end = block_end < M ? block_end : M;

  // the row's own fields, in flight while the block stages
  const bool pend_i = a.pending[ic] != 0;
  const bool elig_i = live && pend_i && a.elig[ic] != 0;
  const int64_t src_l = a.src[ic], dst_l = a.dst[ic];
  const int32_t si = static_cast<int32_t>(src_l);
  const int32_t di = static_cast<int32_t>(dst_l);
  const bool must_i = a.must[ic] != 0;
  const int64_t src_c = ordered::clamp_index(src_l, B1);
  const int64_t dst_c = ordered::clamp_index(dst_l, B1);
  // lane s < D: slot s's deltas and values of this row
  float a_i = 0.0f, b_i = 0.0f, v_s = 0.0f, v_d = 0.0f;
  if (lane < D) {
    const int32_t m = a.metric[lane];
    load_deltas(a, ic).of(m, a_i, b_i);
    v_s = metric_value(a, m, src_c);
    v_d = metric_value(a, m, dst_c);
  }
  // what the capacity and topic rows read of this candidate
  const float4 cap_s = __ldg(reinterpret_cast<const float4*>(a.cap) + src_c);
  const float4 cap_d = __ldg(reinterpret_cast<const float4*>(a.cap) + dst_c);
  uint8_t kb_i = 0;
  int32_t t1r_i = 0, t2r_i = 0;
  if (topics) {
    kb_i = kind_bits(a.kind[ic], a.r[ic], a.r2[ic]);
    t1r_i = a.ptopic[ordered::clamp_index(a.p[ic], a.P)];
    t2r_i = a.ptopic[ordered::clamp_index(a.p2[ic], a.P)];
  }
  const int64_t T = a.T;
  const int64_t t1 = jax_index(t1r_i, T), t2 = jax_index(t2r_i, T);
  // tc (t1, src), (t1, dst), (t2, dst), (t2, src); tlc (t1, src), (t2, dst)
  int32_t tcell[4] = {0, 0, 0, 0};
  int32_t lcell[2] = {0, 0};
  bool alive_s = false, alive_d = false;
  if (elig_i && (a.reads & kTopicCells)) {
    tcell[0] = __ldg(a.tc + t1 * B1 + src_c);
    tcell[1] = __ldg(a.tc + t1 * B1 + dst_c);
    tcell[2] = __ldg(a.tc + t2 * B1 + dst_c);
    tcell[3] = __ldg(a.tc + t2 * B1 + src_c);
  }
  if (elig_i && (a.reads & kLeaderCells)) {
    lcell[0] = __ldg(a.tlc + t1 * B1 + src_c);
    lcell[1] = __ldg(a.tlc + t2 * B1 + dst_c);
    alive_s = __ldg(a.balive + src_c) != 0;
    alive_d = __ldg(a.balive + dst_c) != 0;
  }
  // the table's rows and their average bounds, read by every warp
  for (int g = threadIdx.x; g < a.n_rows && g < kRowsShared; g += kThreads) {
    const GuardRow row = a.rows[g];
    s_rows[g] = row;
    if (row.kind <= kHardCap && row.form == kAverage) {
      s_bounds[g] = make_float2(__ldg(a.bounds + 2 * row.bound_row),
                                __ldg(a.bounds + 2 * row.bound_row + 1));
    }
  }

  // Lane 4 s + q (s < D) sums slot s's terms of one match kind q: dst ==
  // dst (q 0: max(d_dst, 0) into hi), src == dst (1: max(d_src, 0)),
  // src == src (2: min(d_src, 0) into lo, max into hi), dst == src (3:
  // d_dst likewise): the six one-sided partial sums of KC.
  const int job = lane & 3, job_slot = lane >> 2;
  const bool job_live = job_slot < D;
  const int job_off = (job == 0 || job == 3 ? D : 0) + job_slot;
  float lo = 0.0f, hi = 0.0f;
  int32_t tr[4] = {0, 0, 0, 0};        // topic cells: net1, lo1, net2, lo2
  int32_t tl[2] = {0, 0};              // leader cells: (t1, src), (t2, dst)
  bool blocked = false, shared_broker = false;
  const int64_t q1 = cell(t1r_i, di, B1), q1s = cell(t1r_i, si, B1);
  const int64_t q2 = cell(t2r_i, si, B1), q2d = cell(t2r_i, di, B1);
  const bool vector_rows =
      M % 16 == 0 && reinterpret_cast<uintptr_t>(a.conflict) % 16 == 0;

  for (int64_t j0 = 0; j0 < M; j0 += kChunk) {
    const int n = static_cast<int>(M - j0 < kChunk ? M - j0 : kChunk);
    // this lane's conflict bytes of the chunk: columns lane * kBytes + u
    uint8_t conf[kBytes] = {};
    if (elig_i) {
      const uint8_t* row = a.conflict + i * M + j0 + lane * kBytes;
      if (vector_rows && lane * kBytes + kBytes <= n) {
        const uint4 v = *reinterpret_cast<const uint4*>(row);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < kBytes; ++u) {
          conf[u] = (w[u >> 2] >> (8 * (u & 3))) & 0xff;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kBytes; ++u) {
          conf[u] = lane * kBytes + u < n ? row[u] : 0;
        }
      }
    }
    __syncthreads();                   // the previous chunk is consumed
#pragma unroll
    for (int u = 0; u < kChunk / kThreads; ++u) {
      // a column's read-only loads all issued before its stores
      const int k = threadIdx.x + u * kThreads;
      if (k >= n) break;
      const int64_t j = j0 + k;
      const uint8_t pj = __ldg(a.pending + j), kj = __ldg(a.elig + j);
      const bool full = j < rows_end;  // a row of the block walks it
      int64_t sj = 0, dj = 0, kind = 0, r = 0, r2 = 0;
      int32_t tp1 = 0, tp2 = 0;
      Deltas d{};
      if (full) {
        sj = __ldg(a.src + j);
        dj = __ldg(a.dst + j);
        d = load_deltas(a, j);
        if (topics) {
          kind = __ldg(a.kind + j);
          r = __ldg(a.r + j);
          r2 = __ldg(a.r2 + j);
          tp1 = __ldg(a.ptopic + ordered::clamp_index(__ldg(a.p + j), a.P));
          tp2 = __ldg(a.ptopic + ordered::clamp_index(__ldg(a.p2 + j), a.P));
        }
      }
      s_elig[k] = pj != 0 && kj != 0;
      if (!full) continue;
      s_src[k] = static_cast<int32_t>(sj);
      s_dst[k] = static_cast<int32_t>(dj);
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s) {
        if (s < D) {
          float x, y;
          d.of(a.metric[s], x, y);
          s_ab[k * 2 * D + s] = x;
          s_ab[k * 2 * D + D + s] = y;
        }
      }
      if (topics) {
        s_kind[k] = kind_bits(kind, r, r2);
        s_t1[k] = tp1;
        s_t2[k] = tp2;
      }
    }
    __syncthreads();
    if (!elig_i) continue;             // whole warps; no block sync inside
#pragma unroll
    for (int u = 0; u < kBytes; ++u) {
      const int k = lane * kBytes + u;
      blocked |= conf[u] != 0 && k < n && s_elig[k] != 0;
    }
    const int64_t lim64 = i - j0 < n ? i - j0 : n;
    const int lim = static_cast<int>(lim64 < 0 ? 0 : lim64);
    for (int w0 = 0; w0 < lim; w0 += 32) {
      const int k = w0 + lane;
      const bool e = k < lim && s_elig[k] != 0;
      const int32_t sj = e ? s_src[k] : 0, dj = e ? s_dst[k] : 0;
      const unsigned m_dd = __ballot_sync(kFull, e && dj == di);
      const unsigned m_ds = __ballot_sync(kFull, e && sj == di);
      const unsigned m_ss = __ballot_sync(kFull, e && sj == si);
      const unsigned m_sd = __ballot_sync(kFull, e && dj == si);
      shared_broker |= (m_ss | m_dd) != 0;
      unsigned hit = job == 0 ? m_dd : job == 1 ? m_ds : job == 2 ? m_ss
                                                                  : m_sd;
      if (!job_live) hit = 0u;
      // this lane's terms in ascending column order: a dense window column
      // by column, else four matches a step; a missing term adds +0.0,
      // which changes no bit (a sum from +0.0 never becomes -0.0)
      const float* col = s_ab + static_cast<int64_t>(w0) * 2 * D + job_off;
      if (__any_sync(kFull, __popc(hit) > kDense)) {
        // a dense window: every column in order, +0.0 where none matches
#pragma unroll 8
        for (int l = 0; l < 32; ++l) {
          const float v = col[l * 2 * D];
          const float t = (hit >> l) & 1u ? v : 0.0f;
          if (job >= 2) lo = __fadd_rn(lo, fminf(t, 0.0f));
          hi = __fadd_rn(hi, fmaxf(t, 0.0f));
        }
        hit = 0u;
      }
      while (hit) {
        float t[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int l = __ffs(hit) - 1;
          const float v = col[(l < 0 ? 0 : l) * 2 * D];
          t[q] = l < 0 ? 0.0f : v;
          hit &= hit - 1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (job >= 2) lo = __fadd_rn(lo, fminf(t[q], 0.0f));
          hi = __fadd_rn(hi, fmaxf(t[q], 0.0f));
        }
      }
      if (topics && e) {               // integer cell terms, any order
        const uint8_t kb = s_kind[k];
        const int32_t ta = s_t1[k], tb = s_t2[k];
        if (a.reads & kTopicCells) {
          int32_t d[4];
          topic_deltas(kb, ta == tb, d);
          const int64_t key[4] = {cell(ta, sj, B1), cell(ta, dj, B1),
                                  cell(tb, dj, B1), cell(tb, sj, B1)};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int32_t in = d[c] > 0 ? d[c] : 0;
            const int32_t out = d[c] < 0 ? d[c] : 0;
            tr[0] += key[c] == q1 ? in : 0;
            tr[1] += key[c] == q1s ? out : 0;
            tr[2] += key[c] == q2 ? in : 0;
            tr[3] += key[c] == q2d ? out : 0;
          }
        }
        if (a.reads & kLeaderCells) {
          int32_t d1, d2;
          leader_deltas(kb, d1, d2);
          const int64_t k1 = cell(ta, sj, B1), k2 = cell(tb, dj, B1);
          tl[0] += (k1 == q1s ? d1 : 0) + (k2 == q1s ? d2 : 0);
          tl[1] += (k1 == q2d ? d1 : 0) + (k2 == q2d ? d2 : 0);
        }
      }
    }
  }

  bool do_i = false;
  if (elig_i) {
    blocked = __any_sync(kFull, blocked);
#pragma unroll
    for (int c = 0; c < 4; ++c) tr[c] = __reduce_add_sync(kFull, tr[c]);
    tl[0] = __reduce_add_sync(kFull, tl[0]);
    tl[1] = __reduce_add_sync(kFull, tl[1]);
    // lane s < D: slot s's pairs, summed last
    const int base = (lane & 7) * 4;
    const float dd = __shfl_sync(kFull, hi, base);
    const float ds = __shfl_sync(kFull, hi, base + 1);
    const float ss_lo = __shfl_sync(kFull, lo, base + 2);
    const float ss_hi = __shfl_sync(kFull, hi, base + 2);
    const float sd_lo = __shfl_sync(kFull, lo, base + 3);
    const float sd_hi = __shfl_sync(kFull, hi, base + 3);
    const float net_dst_hi = __fadd_rn(dd, ds);
    const float net_src_lo = __fadd_rn(ss_lo, sd_lo);
    const float net_src_hi = __fadd_rn(ss_hi, sd_hi);
    bool ok = true;                    // this lane's rows
    for (int g = 0; g < a.n_rows; ++g) {
      const bool staged = g < kRowsShared;
      const GuardRow row = staged ? s_rows[g] : a.rows[g];
      bool gok;
      if (row.kind <= kHardCap) {
        if (lane != row.slot) continue;
        float lo = -INFINITY, up_s, up_d;
        if (row.form == kAverage) {
          const int64_t k = 2 * row.bound_row;
          const float2 b = staged ? s_bounds[g]
                                  : make_float2(a.bounds[k], a.bounds[k + 1]);
          lo = b.x;
          up_s = up_d = b.y;
        } else if (row.form == kCapacity) {
          up_s = __fmul_rn(column(cap_s, row.cap_col), row.t);
          up_d = __fmul_rn(column(cap_d, row.cap_col), row.t);
        } else {
          up_s = up_d = row.t;
        }
        const float dst_after = __fadd_rn(__fadd_rn(v_d, net_dst_hi), b_i);
        const bool dst_sheds = __fadd_rn(net_dst_hi, b_i) <= 0.0f;
        if (row.kind == kHardCap) {
          const float src_after = __fadd_rn(__fadd_rn(v_s, net_src_hi), a_i);
          gok = (dst_sheds || dst_after <= up_d)
                && (__fadd_rn(net_src_hi, a_i) <= 0.0f || src_after <= up_s);
        } else {
          const float src_after = __fadd_rn(__fadd_rn(v_s, net_src_lo), a_i);
          gok = dst_sheds || dst_after <= up_d || dst_after <= src_after;
          if (!row.upper_only) {
            gok = gok && (__fadd_rn(net_src_lo, a_i) >= 0.0f
                          || src_after >= lo || src_after >= dst_after);
          }
        }
      } else {
        if (lane != 0) continue;
        if (row.kind == kTopicReplica) {
          int32_t d[4];
          topic_deltas(kb_i, t1r_i == t2r_i, d);
          const int32_t d_src_t1 = d[0], d_dst_t1 = d[1], m2 = d[3];
          const float* tb = a.tbounds + static_cast<int64_t>(row.slot) * 2 * T;
          const float up1 = tb[T + t1], up2 = tb[T + t2];
          const float net1 = static_cast<float>(tr[0]);
          const float lo1 = static_cast<float>(tr[1]);
          const float net2 = static_cast<float>(tr[2]);
          const float lo2 = static_cast<float>(tr[3]);
          const float after1 = __fadd_rn(
              __fadd_rn(static_cast<float>(tcell[1]), net1),
              static_cast<float>(d_dst_t1));
          const float src1_lo = __fadd_rn(
              __fadd_rn(static_cast<float>(tcell[0]), lo1),
              static_cast<float>(d_src_t1));
          const bool ok1 =
              __fadd_rn(net1, static_cast<float>(d_dst_t1)) <= 0.0f
              || after1 <= up1 || after1 <= src1_lo;
          const float after2 = __fadd_rn(
              __fadd_rn(static_cast<float>(tcell[3]), net2),
              static_cast<float>(m2));
          const float src2_lo = __fsub_rn(
              __fadd_rn(static_cast<float>(tcell[2]), lo2),
              static_cast<float>(m2));
          const bool ok2 = __fadd_rn(net2, static_cast<float>(m2)) <= 0.0f
                           || after2 <= up2 || after2 <= src2_lo;
          gok = ok1 && ok2;
        } else if (row.kind == kTopicLeaders) {
          int32_t d1, d2;
          leader_deltas(kb_i, d1, d2);
          const float m = static_cast<float>(row.param);
          auto side = [&](int64_t t, bool alive, int32_t count, float net,
                          int32_t d) {
            const bool active = row.aux[t] != 0 && alive;
            const float after = __fsub_rn(
                __fsub_rn(static_cast<float>(count), net),
                static_cast<float>(d));
            return !active || d <= 0 || after >= m;
          };
          gok = side(t1, alive_s, lcell[0], static_cast<float>(tl[0]), d1)
                && side(t2, alive_d, lcell[1], static_cast<float>(tl[1]), d2);
        } else {                       // kSerialize (ballots: warp-wide)
          gok = !shared_broker;
        }
      }
      ok = ok && (gok || (row.must && must_i));
    }
    do_i = !blocked && __all_sync(kFull, ok);
  }
  const bool pend_out = pend_i && !do_i;
  if (live && lane == 0) {
    a.do_out[i] = do_i;
    a.pending_out[i] = pend_out;
  }
  const bool any_do = __syncthreads_or(live && lane == 0 && do_i);
  const bool any_pend = __syncthreads_or(live && lane == 0 && pend_out);
  if (threadIdx.x == 0) {
    if (any_pend) atomicOr(a.scratch + 1, 1);
    if (any_do) atomicOr(a.scratch + 2, 1);
    __threadfence();
    s_last = atomicAdd(a.scratch, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    *a.more_out = __ldcg(a.scratch + 1) != 0 && __ldcg(a.scratch + 2) != 0;
  }
}

}  // namespace

extern "C" int cc_round_guards(const GuardArgs* args, void* stream) {
  const GuardArgs a = *args;
  if (a.M < 1 || a.M > (int64_t{1} << 31) * kWarps || a.n_rows < 0
      || a.n_slots < 0 || a.n_slots > kMaxSlots
      || ((a.reads & kTopicCells)
          && (a.tc == nullptr || a.tbounds == nullptr || a.T < 1))
      || ((a.reads & kLeaderCells) && (a.tlc == nullptr || a.T < 1))
      || (a.n_rows > 0 && a.rows == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.scratch, 0, 3 * sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((a.M + kWarps - 1) / kWarps);
  round_guards_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(GuardArgs) and sizeof(GuardRow), which the host's ctypes structs
// must equal
extern "C" int64_t cc_guard_args_size() { return sizeof(GuardArgs); }
extern "C" int64_t cc_guard_row_size() { return sizeof(GuardRow); }
