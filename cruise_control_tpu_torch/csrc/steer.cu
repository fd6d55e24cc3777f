// KV: a goal pass's steered destinations -- the reference's steer_ctx
// (cruise_control_tpu/analyzer/engine.py:192-209): the AND of every
// earlier goal's receptive_dest (goals.py:427, an interval goal's
//     values + 1 <= upper    for the count and leader-count metrics,
//     values < upper         for the others;
// every other goal's is all brokers) with ctx.dest_allowed, or
// ctx.dest_allowed itself where nothing is left. In plain torch each
// earlier goal's bounds were a dozen launches: up to 15 goals at the
// default chain's last position, in every proposal and drain round.
//
// One block over the B1 brokers. The rows (SteerRow, built once a chain
// position on the host from the goals' rows of KN's table, staged in
// shared memory) name each earlier interval goal's metric and upper
// bound: an average row's avg * t (avg = the valid brokers' sum in XLA's
// tree order over the alive count, as KN's eligibility.cu sums it; the
// integer rows' max(avg * t, ceil(avg))), a capacity row's cap * t (one
// rounded product), a constant row's t. A warp sums each average row
// from global memory (ordered.cuh:tree_sum, its scratch in shared
// memory, or in the caller's global buffer past 48 KB); then a thread a
// broker ANDs the rows' tests (every row's loads issued, none waiting on
// another's test) and the block's OR says whether the fallback applies.
// The mask goes to a buffer the caller owns, so a CUDA graph replays it
// in place.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int kThreads = 256;

enum Metric : int32_t {        // 0-3: a util column
  kCount = 4, kLeaders = 5, kPotential = 6, kLeaderNwIn = 7
};
enum Form : int32_t { kAverage = 0, kCapacity = 1, kConstant = 2 };

}  // namespace

// An earlier interval goal's receptive test: its metric and upper bound
// (kernels._SteerRow).
struct SteerRow {
  int32_t metric;
  int32_t form;
  int32_t integer;
  int32_t cap_col;
  float t;
};

struct SteerArgs {
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const float* cap;            // [B1, 4]
  const uint8_t* bvalid;       // [B1]
  const uint8_t* balive;       // [B1]
  const uint8_t* dest;         // [B1] ctx.dest_allowed
  const SteerRow* rows;        // [n_rows] on the card
  float* scratch;              // tree_sum's levels a warp, or null (shared)
  uint8_t* out;                // [B1] the steered dest_allowed
  int64_t B1;
  int32_t n_rows;
};

namespace {

__device__ __forceinline__ float metric_value(const SteerArgs& a, int32_t m,
                                              int64_t b) {
  switch (m) {
    case kCount: return static_cast<float>(a.cnt[b]);
    case kLeaders: return static_cast<float>(a.lead[b]);
    case kPotential: return a.pot[b];
    case kLeaderNwIn: return a.lni[b];
    default: return a.util[b * 4 + m];
  }
}

__global__ void __launch_bounds__(kThreads) steer_kernel(const SteerArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_alive;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t B1 = a.B1;
  SteerRow* s_rows = reinterpret_cast<SteerRow*>(smem);  // [n_rows]
  float* s_up = smem + a.n_rows * (sizeof(SteerRow) / sizeof(float));
  const int64_t level = ordered::tree_scratch(B1);
  float* tree = (a.scratch != nullptr ? a.scratch : s_up + a.n_rows)
                + warp * level;
  for (int g = threadIdx.x; g < a.n_rows; g += blockDim.x) {
    s_rows[g] = a.rows[g];
  }
  // the alive count (clamped at 1)
  int alive = 0;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    alive += a.balive[b] != 0;
  }
  if (threadIdx.x == 0) s_alive = 0;
  __syncthreads();
  alive = __reduce_add_sync(0xffffffffu, alive);
  if (lane == 0) atomicAdd(&s_alive, alive);
  __syncthreads();
  const float n_alive = static_cast<float>(s_alive < 1 ? 1 : s_alive);
  // each average row's upper bound, a warp a row
#pragma unroll 1
  for (int g = warp; g < a.n_rows; g += warps) {
    const SteerRow row = s_rows[g];
    if (row.form != kAverage) continue;
    const float total = ordered::tree_sum(
        ordered::Warp{},
        [&](int64_t b) {
          const float v = metric_value(a, row.metric, b);
          return a.bvalid[b] ? v : 0.0f;
        },
        B1, tree);
    if (lane == 0) {
      const float avg = __fdiv_rn(total, n_alive);
      float up = __fmul_rn(avg, row.t);
      if (row.integer) up = fmaxf(up, ceilf(avg));
      s_up[g] = up;
    }
    __syncwarp();
  }
  __syncthreads();
  // a thread a broker: every row's test (each row's loads independent of
  // the others'), then the fallback
  bool any = false;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    bool ok = a.dest[b] != 0;
#pragma unroll 4
    for (int g = 0; g < a.n_rows; ++g) {
      const SteerRow row = s_rows[g];
      const float up = row.form == kAverage
                           ? s_up[g]
                           : (row.form == kCapacity
                                  ? __fmul_rn(a.cap[b * 4 + row.cap_col],
                                              row.t)
                                  : row.t);
      const float v = metric_value(a, row.metric, b);
      ok &= (row.metric == kCount || row.metric == kLeaders)
                ? __fadd_rn(v, 1.0f) <= up
                : v < up;
    }
    a.out[b] = ok;
    any = any || ok;
  }
  any = __syncthreads_or(any);
  if (!any) {
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      a.out[b] = a.dest[b] != 0;
    }
  }
}

}  // namespace

// Floats of global scratch a launch over B1 brokers needs (0: its
// scratch fits in shared memory with n_rows rows).
extern "C" int64_t cc_steer_scratch(int64_t B1, int64_t n_rows) {
  const int64_t floats = (kThreads / 32) * ordered::tree_scratch(B1);
  const int64_t rows = n_rows * (sizeof(SteerRow) / sizeof(float) + 1);
  return (floats + rows) * 4 <= 48 * 1024 ? 0 : floats;
}

extern "C" int cc_steer_dest(const SteerArgs* args, void* stream) {
  const SteerArgs a = *args;
  if (a.B1 < 1 || a.B1 >= (int64_t{1} << 31) || a.n_rows < 1
      || a.rows == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t need = cc_steer_scratch(a.B1, a.n_rows);
  if (need > 0 && a.scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t floats =
      a.n_rows * (sizeof(SteerRow) / sizeof(float) + 1)
      + (need > 0 ? 0 : (kThreads / 32) * ordered::tree_scratch(a.B1));
  steer_kernel<<<1, kThreads, floats * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the structs the host's ctypes structs must equal
extern "C" int64_t cc_steer_args_size() { return sizeof(SteerArgs); }
extern "C" int64_t cc_steer_row_size() { return sizeof(SteerRow); }
