// The goals' bounds on the card, shared by KN (eligibility.cu), KX / KY
// (violation.cu) and the drains KZ / KAA (drain.cuh), so the acceptance
// tests, the residuals and the drains read the same float32 bounds:
//  - average: an interval goal's [avg * (2 - t), avg * t] over the alive
//    brokers (IntervalGoal._avg_bounds, cruise_control_tpu/analyzer/
//    goals.py:325-356), widened to floor / ceil of the average for the
//    integer-count goals, from the valid brokers' total in XLA's tree
//    order (the caller sums it: ordered.cuh:tree_sum);
//  - capacity: a capacity goal's per-broker cap * t, one rounded product
//    (CapacityGoal.bounds; where the residual subtracts it, the reference
//    contracts the product into an FMA instead: minus_capacity);
//  - topic: TopicReplicaDistributionGoal._bounds of one topic, from its
//    valid brokers' integer total (exact in any order).
// Below them, an interval row's broker planes as KY forms them (ViolRow, a
// row of KX's table, read through View; IntervalBounds), which KX's rows,
// KY and the drains' quota all read.
// Each rounds every float32 operation on its own, as the sources that
// include it are compiled with -fmad=false.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace bounds {

// An average row's (lower, upper) from the valid brokers' total and the
// alive count (clamped at 1): upper = avg * t, lower = avg * lower_t (-inf
// for an upper-only goal); an integer row widens them to ceil / floor of
// the average.
__device__ __forceinline__ void average(float total, float n_alive, float t,
                                        float lower_t, bool upper_only,
                                        bool integer, float& lo, float& up) {
  const float avg = __fdiv_rn(total, n_alive);
  up = __fmul_rn(avg, t);
  lo = upper_only ? -INFINITY : __fmul_rn(avg, lower_t);
  if (integer) {
    up = fmaxf(up, ceilf(avg));
    if (!upper_only) lo = fminf(lo, floorf(avg));
  }
}

// A capacity row's upper bound on one broker: cap * t, rounded once.
__device__ __forceinline__ float capacity(float cap, float t) {
  return __fmul_rn(cap, t);
}

// value - cap * t over the whole broker axis, as the reference's program
// contracts it: one FMA (IntervalGoal._minus_upper).
__device__ __forceinline__ float minus_capacity(float value, float cap,
                                                float t) {
  return __fmaf_rn(-cap, t, value);
}

// One topic's (lower, upper) from its valid brokers' count total and the
// alive count (clamped at 1): avg = total / n, gap = clamp(avg * c, gap_lo,
// gap_hi) (c = threshold - 1.0), lower = max(avg - gap, 0), upper = avg +
// gap.
__device__ __forceinline__ void topic(long long total, float n_alive,
                                      float c, float gap_lo, float gap_hi,
                                      float& lo, float& up) {
  const float avg = __fdiv_rn(static_cast<float>(total), n_alive);
  float gap = __fmul_rn(avg, c);
  gap = fminf(fmaxf(gap, gap_lo), gap_hi);
  lo = ordered::clamp0(__fsub_rn(avg, gap));
  up = __fadd_rn(avg, gap);
}

}  // namespace bounds

// One goal's row (kernels._ViolRow): KN's kind and fields, and the row's
// sum: an interval row's vector loop (vf 0: XLA's tree), a topic row's
// form (with the rows form's loop, or the lanes form's vf).
struct ViolRow {
  int32_t kind;
  int32_t metric;
  int32_t form;
  int32_t upper_only;
  int32_t integer;
  int32_t cap_col;
  int32_t param;               // topic leaders: min_count; broker set: sets
  int32_t vf, ic, epi, tail;
  int32_t sum;                 // a topic row's TopicSum
  float t;                     // topic replica: threshold - 1.0
  float lower;                 // topic replica: the minimum gap
  float hi;                    // topic replica: the maximum gap
  // topic leaders: uint8 interested[T]; broker set: int32 topic_set[param]
  const void* aux;
};

namespace bounds {

enum Metric : int32_t {        // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };

// One scenario's broker planes.
struct Brokers {
  const float* util;
  const int32_t* cnt;
  const int32_t* lead;
  const float* pot;
  const float* lni;
  const float* cap;
  const uint8_t* bvalid;
  const uint8_t* balive;

  __device__ float value(int32_t m, int64_t b) const {
    switch (m) {
      case kCount: return static_cast<float>(cnt[b]);
      case kLeaders: return static_cast<float>(lead[b]);
      case kPotential: return pot[b];
      case kLeaderNwIn: return lni[b];
      default: return util[b * 4 + m];
    }
  }
};

// An interval row's broker planes: its metric, capacity column and masks,
// staged in shared memory (vals, caps, flags: bit 0 valid, bit 1 alive)
// or read from the planes themselves.
struct View {
  Brokers br;
  int32_t metric, cap_col;
  const float* vals;           // null: not staged
  const float* caps;
  const uint8_t* flags;

  __device__ float value(int64_t b) const {
    return vals != nullptr ? vals[b] : br.value(metric, b);
  }
  __device__ float cap(int64_t b) const {
    return vals != nullptr ? caps[b] : br.cap[b * 4 + cap_col];
  }
  __device__ bool valid(int64_t b) const {
    return vals != nullptr ? (flags[b] & 1) != 0 : br.bvalid[b] != 0;
  }
  __device__ bool alive(int64_t b) const {
    return vals != nullptr ? (flags[b] & 2) != 0 : br.balive[b] != 0;
  }
};

// The block's int64 sum of every thread's ``v`` (exact in any order),
// returned to every thread; ``red`` holds a word a warp. Opens with a
// barrier, so what the block wrote before is visible after it.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();                     // red is free (an earlier sum read)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long total = 0;
  for (int k = 0; k < warps; ++k) total += red[k];
  return total;
}

// A block's sum of f(b) over the B1 brokers in XLA's tree order, or, with
// vf > 0, thread 0's vector loop (vf, ic, epi, tail), returned to every
// thread (the loop's to thread 0). With ``work`` (B1 floats of shared
// memory) the block first writes every f(b) there in one parallel pass
// and the sum reads that row: f's loads then cost no round trip an
// element (an accessor read inside the sum's window took ~300 cycles an
// element). Ends with the block's barrier.
template <class F>
__device__ __forceinline__ float staged_sum(F f, int64_t B1, float* work,
                                            float* scratch, int vf = 0,
                                            int ic = 0, int epi = 0,
                                            int tail = 0) {
  float total;
  if (work != nullptr) {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) work[b] = f(b);
    __syncthreads();
    auto x = [work](int64_t b) { return work[b]; };
    total = vf > 0 ? (threadIdx.x == 0
                          ? ordered::vector_loop_sum(x, static_cast<int>(B1),
                                                     vf, ic, epi, tail, 0.0f)
                          : 0.0f)
                   : ordered::tree_sum(ordered::Block{}, x, B1, scratch);
  } else {
    total = vf > 0 ? (threadIdx.x == 0
                          ? ordered::vector_loop_sum(f, static_cast<int>(B1),
                                                     vf, ic, epi, tail, 0.0f)
                          : 0.0f)
                   : ordered::tree_sum(ordered::Block{}, f, B1, scratch);
  }
  __syncthreads();
  return total;
}

// Stage an interval row's planes into shared memory (a thread a broker,
// every load issued in one pass) where ``planes`` holds [4, B1] floats
// (the metric, the capacity column, a work row, the masks); returns the
// alive count (clamped at 1) and the view of the planes.
__device__ __forceinline__ float stage_interval(const ViolRow& row,
                                                const Brokers& br, int64_t B1,
                                                float* planes, long long* red,
                                                View& view) {
  view = View{br, row.metric, row.cap_col, nullptr, nullptr, nullptr};
  long long n = 0;
  if (planes != nullptr) {
    float* vals = planes;
    float* caps = planes + B1;
    uint8_t* flags = reinterpret_cast<uint8_t*>(planes + 3 * B1);
    const bool cap = row.form == kCapacity;
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      const float v = br.value(row.metric, b);
      const float c = cap ? br.cap[b * 4 + row.cap_col] : 0.0f;
      const uint8_t valid = br.bvalid[b], alive = br.balive[b];
      vals[b] = v;
      caps[b] = c;
      flags[b] = static_cast<uint8_t>((valid != 0) | ((alive != 0) << 1));
      n += alive != 0;
    }
    view.vals = vals;
    view.caps = caps;
    view.flags = flags;
  } else {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      n += br.balive[b] != 0;
    }
  }
  n = block_sum(n, red);
  return static_cast<float>(n < 1 ? 1 : n);
}

// An interval row's bounds: (lo, up) scalars of an average row, else -inf
// and the per-broker bound (upper(b)).
struct IntervalBounds {
  float lo, up;
  int32_t form;
  float t;

  __device__ float lower() const { return form == kAverage ? lo : -INFINITY; }
  template <class V>
  __device__ float upper(const V& view, int64_t b) const {
    if (form == kAverage) return up;
    return form == kCapacity ? bounds::capacity(view.cap(b), t) : t;
  }
  // value - upper over the whole broker axis (IntervalGoal._minus_upper:
  // one FMA against capacity x t)
  template <class V>
  __device__ float minus_upper(const V& view, float v, int64_t b) const {
    if (form == kCapacity) return bounds::minus_capacity(v, view.cap(b), t);
    return __fsub_rn(v, upper(view, b));
  }
  // upper - value over the whole broker axis (IntervalGoal._upper_minus:
  // one FMA against capacity x t)
  template <class V>
  __device__ float upper_minus(const V& view, float v, int64_t b) const {
    if (form == kCapacity) return __fmaf_rn(view.cap(b), t, -v);
    return __fsub_rn(upper(view, b), v);
  }
  // the excess over the upper bound; everything on a dead broker
  template <class V>
  __device__ float excess(const V& view, float v, int64_t b) const {
    return view.alive(b) ? ordered::clamp0(minus_upper(view, v, b)) : v;
  }
};

template <class V>
__device__ __forceinline__ IntervalBounds interval_bounds(
    const ViolRow& row, const V& view, float n_alive, int64_t B1,
    float* scratch, float* work) {
  IntervalBounds ib{-INFINITY, 0.0f, row.form, row.t};
  if (row.form == kAverage) {
    const float total = staged_sum(
        [=](int64_t b) {
          const float v = view.value(b);
          return view.valid(b) ? v : 0.0f;
        },
        B1, work, scratch);
    bounds::average(total, n_alive, row.t, row.lower, row.upper_only != 0,
                    row.integer != 0, ib.lo, ib.up);
  }
  return ib;
}

}  // namespace bounds
