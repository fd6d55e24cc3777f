// KG: cluster statistics over the alive brokers.
//
// Seven columns of per-broker values — utilization of the four resources,
// replica count, leader count, potential NW_OUT — each reduced over the
// brokers whose alive mask is set to
//   avg = sum(v) / n,  std = sqrt(sum((v - avg)^2) / n),  max(v),  min(v)
// with n = max(number alive, 1); dead and padding brokers count as 0 in
// the sums, -inf in the max and +inf in the min. The alive count itself is
// the eighth output.
//
// Replaces cruise_control_tpu/model/stats.py:cluster_stats (:20-52), the
// numbers of stats_summary (:61) that /load and every rebalance response
// report.
//
// The reference computes each step as its own XLA operation on the CPU,
// and XLA reduces a column of n values in its tree order: windows of 32
// (the padding split evenly in front and behind) summed in order, repeated
// until at most 32 partial sums remain, which are summed in order. This
// kernel follows that order exactly, with every add, subtract, multiply,
// divide and square root rounded on its own (no contraction into FMAs), so
// its bits equal the reference's. Max and min are exact in any order
// (NaN propagates, as in jnp.max).
//
// One block; warp c owns column c. A level's windows are spread over the
// warp's lanes (each lane sums its windows in order) into a ping-pong pair
// of shared-memory buffers of ceil(n / 32) floats per warp.
//
// Bound on the card: bytes (B x 7 values and the mask read once) — but a
// single block of seven warps and a chain of levels is latency-bound: a
// launch costs far more than the work at a few hundred brokers.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 7;
constexpr int kWindow = 32;

struct Column {
  const float* util;        // [B, 4]
  const int32_t* replicas;  // [B]
  const int32_t* leaders;   // [B]
  const float* potential;   // [B]
  const uint8_t* alive;     // [B]
  int col;

  __device__ float value(int64_t b) const {
    if (col < 4) return util[b * 4 + col];
    if (col == 4) return static_cast<float>(replicas[b]);
    if (col == 5) return static_cast<float>(leaders[b]);
    return potential[b];
  }
};

// XLA's CPU tree order over n values produced by term(i). The first level
// reads the terms; later levels read the previous level's partial sums.
template <typename Term>
__device__ float tree_sum(Term term, int64_t n, float* buf_a, float* buf_b,
                          int lane) {
  const float* src = nullptr;        // null: read the terms
  float* dst = buf_a;
  while (n > kWindow) {
    const int64_t windows = (n + kWindow - 1) / kWindow;
    const int64_t front = (windows * kWindow - n) / 2;
    for (int64_t w = lane; w < windows; w += kWindow) {
      float acc = 0.0f;
      for (int64_t j = 0; j < kWindow; ++j) {
        const int64_t i = w * kWindow + j - front;
        float x = 0.0f;
        if (i >= 0 && i < n) x = src == nullptr ? term(i) : src[i];
        acc = __fadd_rn(acc, x);
      }
      dst[w] = acc;
    }
    __syncwarp();
    src = dst;
    dst = dst == buf_a ? buf_b : buf_a;
    n = windows;
  }
  float acc = 0.0f;
  if (lane == 0) {
    for (int64_t i = 0; i < n; ++i) {
      acc = __fadd_rn(acc, src == nullptr ? term(i) : src[i]);
    }
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, acc, 0);
}

__device__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__global__ void cluster_stats_kernel(const float* __restrict__ util,
                                     const int32_t* __restrict__ replicas,
                                     const int32_t* __restrict__ leaders,
                                     const float* __restrict__ potential,
                                     const uint8_t* __restrict__ alive,
                                     float* __restrict__ out,
                                     int32_t* __restrict__ num_alive,
                                     int64_t num_brokers) {
  extern __shared__ float shared[];
  const int warp = threadIdx.x / kWindow;
  const int lane = threadIdx.x % kWindow;
  if (warp >= kCols) return;
  const int64_t level = (num_brokers + kWindow - 1) / kWindow;
  float* buf_a = shared + static_cast<int64_t>(warp) * 2 * level;
  float* buf_b = buf_a + level;
  const Column column{util, replicas, leaders, potential, alive, warp};

  int count = 0;
  float big = -INFINITY;
  float small = INFINITY;
  for (int64_t b = lane; b < num_brokers; b += kWindow) {
    if (!alive[b]) continue;
    const float v = column.value(b);
    ++count;
    big = max_nan(big, v);
    small = min_nan(small, v);
  }
  for (int offset = kWindow / 2; offset > 0; offset /= 2) {
    count += __shfl_down_sync(0xffffffffu, count, offset);
    big = max_nan(big, __shfl_down_sync(0xffffffffu, big, offset));
    small = min_nan(small, __shfl_down_sync(0xffffffffu, small, offset));
  }
  count = __shfl_sync(0xffffffffu, count, 0);
  const float n = static_cast<float>(count > 1 ? count : 1);

  const float total = tree_sum(
      [&](int64_t b) { return alive[b] ? column.value(b) : 0.0f; },
      num_brokers, buf_a, buf_b, lane);
  const float mean = __fdiv_rn(total, n);
  const float squares = tree_sum(
      [&](int64_t b) {
        if (!alive[b]) return 0.0f;
        const float d = __fsub_rn(column.value(b), mean);
        return __fmul_rn(d, d);
      },
      num_brokers, buf_a, buf_b, lane);
  const float var = __fdiv_rn(squares, n);
  if (lane == 0) {
    out[0 * kCols + warp] = mean;
    out[1 * kCols + warp] = __fsqrt_rn(var);
    out[2 * kCols + warp] = big;
    out[3 * kCols + warp] = small;
    if (warp == 0) *num_alive = count;
  }
}

}  // namespace

extern "C" int cc_cluster_stats(const void* util, const void* replicas,
                                const void* leaders, const void* potential,
                                const void* alive, void* out, void* num_alive,
                                int64_t num_brokers, void* stream) {
  const int64_t level = (num_brokers + kWindow - 1) / kWindow;
  const size_t shared = static_cast<size_t>(kCols) * 2 * level * sizeof(float);
  cluster_stats_kernel<<<1, kCols * kWindow, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(util), static_cast<const int32_t*>(replicas),
      static_cast<const int32_t*>(leaders),
      static_cast<const float*>(potential),
      static_cast<const uint8_t*>(alive), static_cast<float*>(out),
      static_cast<int32_t*>(num_alive), num_brokers);
  return static_cast<int>(cudaGetLastError());
}
