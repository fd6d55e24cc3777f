// KK: net flow of earlier candidates on (topic, broker) cells (the
// topic-cell collective guards).
//
// For query a and candidate i, over every j with earlier[i, j]:
//   out[a, i] = sum_k [query[a, i] == key[k, j]] * val[a, k, j]
// query int64[A, M], key int64[K, M] (cell ids topic * B1 + broker),
// val float32[A, K, M] (each query's one-sided clipping already applied),
// earlier bool[M, M]; A, K <= 4.
//
// Replaces the masked [M, M] float products of
// cruise_control_tpu/analyzer/goals.py: TopicReplicaDistributionGoal's
// collective guard (:1390-1420, four queries over four cell slots) and
// MinTopicLeadersPerBrokerGoal's (:1552-1578, two losing cells). Eager
// PyTorch would build A * K masks of M^2 floats in device memory.
//
// Exactness: every term is an integer of magnitude <= 4 M, so every
// partial sum is an exact float32 integer and any order gives the same
// bits; a lane's accumulator starts at +0.0, as the reference's does.
//
// Design: a warp a row, A accumulators a lane. A block stages a chunk of
// 256 columns of the keys and values in shared memory for its 8 rows; lane
// l tests the columns j = j0 + l, j0 + l + 32, ... of its row's mask (byte
// loads, coalesced across the warp) and adds the matching terms; the warp
// then sums its lanes by shuffles. Bound: the M^2 mask bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 256;          // columns staged a pass
constexpr int kMax = 4;              // A and K at most
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
cell_net_flow_kernel(const int64_t* __restrict__ query,
                     const int64_t* __restrict__ key,
                     const float* __restrict__ val,
                     const uint8_t* __restrict__ earlier,
                     float* __restrict__ out, int64_t m, int num_a,
                     int num_k) {
  __shared__ int64_t s_key[kMax][kChunk];
  __shared__ float s_val[kMax][kMax][kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = i < m;
  int64_t q[kMax];
  float acc[kMax];
#pragma unroll
  for (int a = 0; a < kMax; ++a) {
    q[a] = (live && a < num_a) ? query[a * m + i] : 0;
    acc[a] = 0.0f;
  }
  const uint8_t* row = earlier + (live ? i : 0) * m;

  for (int64_t j0 = 0; j0 < m; j0 += kChunk) {
    const int n = static_cast<int>(m - j0 < kChunk ? m - j0 : kChunk);
    __syncthreads();                 // the previous chunk is consumed
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      for (int k = 0; k < num_k; ++k) {
        s_key[k][t] = key[k * m + j0 + t];
        for (int a = 0; a < num_a; ++a)
          s_val[a][k][t] = val[(a * num_k + k) * m + j0 + t];
      }
    }
    __syncthreads();
    if (!live) continue;             // whole warps; no block sync inside
    for (int t = lane; t < n; t += 32) {
      if (!row[j0 + t]) continue;
#pragma unroll
      for (int k = 0; k < kMax; ++k) {
        if (k >= num_k) break;
        const int64_t cell = s_key[k][t];
#pragma unroll
        for (int a = 0; a < kMax; ++a) {
          if (a < num_a && q[a] == cell)
            acc[a] = __fadd_rn(acc[a], s_val[a][k][t]);
        }
      }
    }
  }
  // Every lane of a warp reaches here (rows are whole warps).
#pragma unroll
  for (int a = 0; a < kMax; ++a) {
    float s = acc[a];
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    if (live && lane == 0 && a < num_a) out[a * m + i] = s;
  }
}

}  // namespace

extern "C" int cc_cell_net_flow(const void* query, const void* key,
                                const void* val, const void* earlier,
                                void* out, int64_t m, int64_t num_a,
                                int64_t num_k, void* stream) {
  if (num_a < 1 || num_a > kMax || num_k < 1 || num_k > kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const int64_t blocks = (m + kWarps - 1) / kWarps;
    cell_net_flow_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(query), static_cast<const int64_t*>(key),
        static_cast<const float*>(val), static_cast<const uint8_t*>(earlier),
        static_cast<float*>(out), m, static_cast<int>(num_a),
        static_cast<int>(num_k));
  }
  return static_cast<int>(cudaGetLastError());
}
