// KM: apply one partition-disjoint group of candidate actions to the
// search state, out of place.
//
// Replaces cruise_control_tpu/analyzer/state.py:apply_group (:420-532),
// which the goal pass runs once a drain round and once an apply round
// (analyzer/engine.py:PassSegments.drain and .round). In plain torch it is
// about 60 launches (100 with the topic tables): gathers, wheres, three
// index_puts a plane, KB for the float aggregates, index_adds.
//
// For candidates i < N with do[i] (their partition rows p, and p2 of a
// swap, distinct), as the reference computes them:
//  - slot writes into fresh rb / pos / offline [P, R]: slot (p, r), then
//    slot (p, 0), then a swap's counterpart (p2, r2), in that precedence;
//  - the float aggregates util [B1, 4], potential NW_OUT and leader NW_IN
//    [B1]: per broker the base, then every candidate's source row in
//    candidate order, then every destination row (KB's order; rows of
//    candidates that do not apply add +-0.0, as the reference's masked
//    scatter-adds do); no float atomics;
//  - replica and leader counts [B1] (int32, added per broker in the same
//    walk) and the [T, B1] topic and topic-leader tables (int32 atomics,
//    exact in any order; a topic outside [0, T) adds nothing);
//  - moves_applied + the count of do, and that count.
//
// Bound on the card: bytes (the state copied once, the candidates read
// once) — a few microseconds at the main path's shapes. The design is two
// launches:
//  1. stage: the placement planes and topic tables copied into their
//     outputs, and each of the 2N rows (every candidate's source row, then
//     every destination row) written compactly as its broker id and its
//     eight terms (util x 4, potential, leader NW_IN, replica and leader
//     count deltas) — a grid-stride pass; the last block counts do;
//  2. apply: one warp a broker (8 a block) walks the rows in order: the
//     block stages 4,096 ids at a time in shared memory, a ballot marks
//     the rows of the warp's broker, their indices queue in the warp's
//     list, and each full list of 64 is gathered (32-byte loads, every
//     lane at once) and added by lanes 0-7 in row order from registers;
//     blocks past the brokers' take one thread a candidate for the slot
//     writes and topic-table atomics.
// A candidate that does not apply adds +-0.0 (and integer zeros), which
// changes no bit of a sum that is not -0.0; a sum starting from any other
// base never becomes -0.0 (x + y is -0.0 only for two -0.0). So a broker
// chain adds only the applied rows — KB's sequence exactly — and takes the
// others too only where its base holds a -0.0. (Adding them all made the
// unused slots of a drain batch, all on the brokers of partition 0, into
// chains of ~10,000 rows: 2.1 ms a drain round on the H100.) The copy has
// its own launch because the slot writes must land after it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kMove = 0;   // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;   // MOVE_LEADERSHIP
constexpr int64_t kSwap = 2;   // MOVE_SWAP
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;      // brokers a block
constexpr int kIds = 4096;                 // row ids staged at a time
constexpr int kList = 64;                  // rows a warp gathers at once
constexpr int kTerms = 8;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Pointers and sizes of one call (passed by the host by address; the
// kernels take a copy by value).
struct ApplyArgs {
  const int64_t* rb;        // [P, R]
  const int64_t* pos;       // [P, R]
  const uint8_t* off;       // [P, R]
  const float* util;        // [B1, 4]
  const float* pot;         // [B1]
  const float* lni;         // [B1]
  const int32_t* cnt;       // [B1]
  const int32_t* lead;      // [B1]
  const int32_t* tc;        // [T, B1] or null
  const int32_t* tlc;       // [T, B1] or null
  const int64_t* moves;     // []
  const int32_t* topic;     // [P] partition topic
  const int64_t* p;         // candidates [N]
  const int64_t* r;
  const int64_t* p2;
  const int64_t* r2;
  const int64_t* src;
  const int64_t* dst;
  const int64_t* kind;
  const float* d_util_src;  // [N, 4]
  const float* d_util_dst;  // [N, 4]
  const int32_t* d_cnt;
  const int32_t* d_lead;
  const float* d_pot;
  const float* d_lni;
  const uint8_t* do_;       // [N]
  int64_t* rb_out;
  int64_t* pos_out;
  uint8_t* off_out;
  float* util_out;
  float* pot_out;
  float* lni_out;
  int32_t* cnt_out;
  int32_t* lead_out;
  int32_t* tc_out;
  int32_t* tlc_out;
  int64_t* moves_out;       // []
  int64_t* count_out;       // []
  int32_t* ids;             // [2N] scratch: each row's broker b if its
                            // candidate applies, else -2 - b (-1: none)
  float* terms;             // [2N, 8] scratch: each row's terms
  int64_t P, R, B1, T, N;
};

namespace {

// The eight terms candidate i adds to its source (side 0) or destination
// (side 1) broker: util x 4, potential, leader NW_IN (floats), then the
// replica and leader count deltas (int32 bits).
__device__ __forceinline__ void row_terms(const ApplyArgs& a, int64_t i,
                                          int side, float* t) {
  const bool d = a.do_[i] != 0;
  const int64_t k = a.kind[i];
  const bool mv = d && (k == kMove || k == kSwap);
  const bool move = d && k == kMove;
  const float* du = side == 0 ? a.d_util_src : a.d_util_dst;
#pragma unroll
  for (int c = 0; c < 4; ++c) t[c] = d ? du[i * 4 + c] : 0.0f;
  const float pot = mv ? a.d_pot[i] : 0.0f;
  const float lni = d ? a.d_lni[i] : 0.0f;
  const int32_t cnt = move ? a.d_cnt[i] : 0;
  const int32_t lead = d ? a.d_lead[i] : 0;
  t[4] = side == 0 ? -pot : pot;
  t[5] = side == 0 ? -lni : lni;
  t[6] = __int_as_float(side == 0 ? -cnt : cnt);
  t[7] = __int_as_float(side == 0 ? -lead : lead);
}

__global__ void __launch_bounds__(256) apply_stage_kernel(const ApplyArgs a) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t pr = a.P * a.R;
  for (int64_t i = tid; i < pr; i += stride) {
    a.rb_out[i] = a.rb[i];
    a.pos_out[i] = a.pos[i];
    a.off_out[i] = a.off[i];
  }
  const int64_t tb = a.T * a.B1;
  if (a.tc != nullptr) {
    for (int64_t i = tid; i < tb; i += stride) a.tc_out[i] = a.tc[i];
  }
  if (a.tlc != nullptr) {
    for (int64_t i = tid; i < tb; i += stride) a.tlc_out[i] = a.tlc[i];
  }
  for (int64_t j = tid; j < 2 * a.N; j += stride) {
    const int side = j < a.N ? 0 : 1;
    const int64_t i = j - side * a.N;
    const int64_t id = side == 0 ? a.src[i] : a.dst[i];
    const int32_t b = static_cast<int32_t>(id);
    a.ids[j] = (id < 0 || id >= a.B1) ? -1 : (a.do_[i] ? b : -2 - b);
    float t[kTerms];
    row_terms(a, i, side, t);
    float4* out = reinterpret_cast<float4*>(a.terms + j * kTerms);
    out[0] = make_float4(t[0], t[1], t[2], t[3]);
    out[1] = make_float4(t[4], t[5], t[6], t[7]);
  }
  if (blockIdx.x == gridDim.x - 1) {
    int64_t count = 0;
    for (int64_t base = 0; base < a.N; base += blockDim.x) {
      const int64_t i = base + threadIdx.x;
      count += __syncthreads_count(i < a.N && a.do_[i] != 0);
    }
    if (threadIdx.x == 0) {
      a.moves_out[0] = a.moves[0] + count;
      a.count_out[0] = count;
    }
  }
}

__device__ __forceinline__ void topic_add(int32_t* table, int64_t topic,
                                          int64_t broker, int64_t T,
                                          int64_t B1, int32_t d) {
  if (d == 0 || topic < 0 || topic >= T) return;
  const int64_t cell = topic * B1 + broker;
  if (cell >= 0 && cell < T * B1) atomicAdd(table + cell, d);
}

// Lanes 0-7 of a warp add the terms of the first n rows of its list, in
// order: lanes 0-5 the float terms, lanes 6-7 the integer ones. Every lane
// gathers rows first (all loads in flight at once), then each adding lane
// holds 32 rows' terms in registers, so only the adds wait on each other.
__device__ __forceinline__ void add_rows(const ApplyArgs& a,
                                         const int32_t* list, int n,
                                         float (*buf)[kTerms], int lane,
                                         float& acc, int32_t& iacc) {
  for (int k = lane; k < n; k += 32) {
    const float4* row = reinterpret_cast<const float4*>(
        a.terms + static_cast<int64_t>(list[k]) * kTerms);
    const float4 lo = row[0], hi = row[1];
    buf[k][0] = lo.x; buf[k][1] = lo.y; buf[k][2] = lo.z; buf[k][3] = lo.w;
    buf[k][4] = hi.x; buf[k][5] = hi.y; buf[k][6] = hi.z; buf[k][7] = hi.w;
  }
  __syncwarp();
  const int c = lane & 7;
  for (int k0 = 0; k0 < n; k0 += 32) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = buf[k0 + k][c];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k0 + k < n) {
        if (lane < 6) {
          acc = __fadd_rn(acc, v[k]);
        } else if (lane < 8) {
          iacc += __float_as_int(v[k]);
        }
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) apply_group_kernel(
    const ApplyArgs a, int64_t broker_blocks) {
  __shared__ int32_t s_id[kIds];
  __shared__ int32_t s_list[kWarps][kList];
  __shared__ float s_buf[kWarps][kList][kTerms];
  if (blockIdx.x < broker_blocks) {
    // ---- the per-broker aggregates: one warp a broker
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
    const bool live = b < a.B1;
    float acc = 0.0f;
    int32_t iacc = 0;
    if (live) {
      if (lane < 4) acc = a.util[b * 4 + lane];
      if (lane == 4) acc = a.pot[b];
      if (lane == 5) acc = a.lni[b];
      if (lane == 6) iacc = a.cnt[b];
      if (lane == 7) iacc = a.lead[b];
    }
    // rows of candidates that do not apply only where a base is -0.0
    const bool neg_zero = __any_sync(
        kFull, live && lane < 6 && acc == 0.0f && __float_as_int(acc) < 0);
    const int32_t also = neg_zero ? static_cast<int32_t>(-2 - b)
                                  : static_cast<int32_t>(0x80000000u);
    int queued = 0;
    const int64_t rows = 2 * a.N;
    for (int64_t c0 = 0; c0 < rows; c0 += kIds) {
      const int n = static_cast<int>(rows - c0 < kIds ? rows - c0 : kIds);
      __syncthreads();            // the previous chunk is consumed
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        s_id[k] = a.ids[c0 + k];
      }
      __syncthreads();
      if (!live) continue;
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const bool hit = j < n && (s_id[j] == b || s_id[j] == also);
        const unsigned hits = __ballot_sync(kFull, hit);
        if (hits == 0u) continue;
        const int count = __popc(hits);
        if (queued + count > kList) {
          add_rows(a, s_list[warp], queued, s_buf[warp], lane, acc, iacc);
          queued = 0;
        }
        if (hit) {
          s_list[warp][queued + __popc(hits & ((1u << lane) - 1u))] =
              static_cast<int32_t>(c0 + j);
        }
        __syncwarp();
        queued += count;
      }
    }
    if (live) {
      add_rows(a, s_list[warp], queued, s_buf[warp], lane, acc, iacc);
      if (lane < 4) a.util_out[b * 4 + lane] = acc;
      if (lane == 4) a.pot_out[b] = acc;
      if (lane == 5) a.lni_out[b] = acc;
      if (lane == 6) a.cnt_out[b] = iacc;
      if (lane == 7) a.lead_out[b] = iacc;
    }
    return;
  }
  // ---- the slot writes and topic tables: one thread a candidate
  const int64_t i = (static_cast<int64_t>(blockIdx.x) - broker_blocks)
                    * blockDim.x + threadIdx.x;
  if (i >= a.N || a.do_[i] == 0) return;
  const int64_t k = a.kind[i];
  const bool lead = k == kLead;
  const bool swap = k == kSwap;
  const bool mv = k == kMove || swap;
  const int64_t p = a.p[i], r = a.r[i], p2 = a.p2[i], r2 = a.r2[i];
  const int64_t src = a.src[i], dst = a.dst[i];
  if (p >= 0 && p < a.P && r >= 0 && r < a.R) {
    const int64_t row = p * a.R;
    const int64_t cur_slot = a.rb[row + r], cur0 = a.rb[row];
    const int64_t pos_r = a.pos[row + r], pos_0 = a.pos[row];
    const bool off_r = a.off[row + r] != 0, off_0 = a.off[row] != 0;
    a.rb_out[row + r] = mv ? dst : cur0;
    a.rb_out[row] = lead ? cur_slot : ((mv && r == 0) ? dst : cur0);
    a.pos_out[row + r] = lead ? pos_0 : pos_r;
    a.pos_out[row] = lead ? pos_r : pos_0;
    a.off_out[row + r] = !mv && (lead ? off_0 : off_r);
    a.off_out[row] = lead ? off_r : (!(mv && r == 0) && off_0);
  }
  if (swap && p2 >= 0 && p2 < a.P && r2 >= 0 && r2 < a.R) {
    a.rb_out[p2 * a.R + r2] = src;
    a.off_out[p2 * a.R + r2] = 0;
  }
  if (a.tc_out == nullptr && a.tlc_out == nullptr) return;
  const int64_t t1 = (p >= 0 && p < a.P) ? a.topic[p] : -1;
  const int64_t t2 = (p2 >= 0 && p2 < a.P) ? a.topic[p2] : -1;
  if (a.tc_out != nullptr) {
    // the swap counterpart's topic travels the other way
    const int32_t d = mv ? 1 : 0, d2 = swap ? 1 : 0;
    topic_add(a.tc_out, t1, src, a.T, a.B1, -d);
    topic_add(a.tc_out, t1, dst, a.T, a.B1, d);
    topic_add(a.tc_out, t2, dst, a.T, a.B1, -d2);
    topic_add(a.tc_out, t2, src, a.T, a.B1, d2);
  }
  if (a.tlc_out != nullptr) {
    // leadership of p lands on dst for transfers and leader-slot moves;
    // a swap counterpart in slot 0 hauls p2's leadership to src
    const int32_t d = (lead || (mv && r == 0)) ? 1 : 0;
    const int32_t d2 = (swap && r2 == 0) ? 1 : 0;
    topic_add(a.tlc_out, t1, src, a.T, a.B1, -d);
    topic_add(a.tlc_out, t1, dst, a.T, a.B1, d);
    topic_add(a.tlc_out, t2, dst, a.T, a.B1, -d2);
    topic_add(a.tlc_out, t2, src, a.T, a.B1, d2);
  }
}

}  // namespace

// KM's two launches on ``stream``; returns cudaGetLastError().
extern "C" int cc_apply_group(const ApplyArgs* args, void* stream) {
  const ApplyArgs a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t work = a.P * a.R > a.T * a.B1 ? a.P * a.R : a.T * a.B1;
  work = work > 2 * a.N ? work : 2 * a.N;
  int64_t copy_blocks = (work + 1023) / 1024;
  copy_blocks = copy_blocks < 1 ? 1 : (copy_blocks > 1024 ? 1024
                                                          : copy_blocks);
  apply_stage_kernel<<<static_cast<unsigned>(copy_blocks), 256, 0, s>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t broker_blocks = (a.B1 + kWarps - 1) / kWarps;
  const int64_t cand_blocks = (a.N + kThreads - 1) / kThreads;
  apply_group_kernel<<<static_cast<unsigned>(broker_blocks + cand_blocks),
                       kThreads, 0, s>>>(a, broker_blocks);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(ApplyArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_apply_args_size() { return sizeof(ApplyArgs); }
