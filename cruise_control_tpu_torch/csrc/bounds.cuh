// The goals' bounds on the card, shared by KN (eligibility.cu) and KX / KY
// (violation.cu), so the acceptance tests and the residuals read the same
// float32 bounds:
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
