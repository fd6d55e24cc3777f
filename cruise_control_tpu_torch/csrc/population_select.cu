// KI: one generation boundary of the population search.
//
// For K candidate plans with violation stacks boundary[K, G], cumulative
// move counts moves[K] and per-goal scales[G]:
//   norm[j, g]  = boundary / max(scale_g, 1), or 0 where boundary <= tol_g,
//                 tol_g = fma(1e-6, scale_g, 1e-6);
//   weighted[j] = sum_g norm[j, g] * w_g (+ fma(move_weight, moves[j], .)),
//                 w_g = hard_weight for a hard goal, else 1;
//   ranks[j]    = how many plans dominate plan j (every goal <=, one <);
//   order       = plans sorted by (ranks as float if pareto else 0,
//                 weighted, index), NaN last;
//   perm[j]     = order[j % n_surv], perm[0] = 0 (the truncation selection:
//                 slot j adopts survivor j mod n_surv; slot 0, the anchor,
//                 keeps its own plan).
//
// Replaces cruise_control_tpu/parallel/population.py:_survivor_perm
// (:262-275) and _scores (:255-260), over analyzer/engine.py:56-96, inside
// the reference's jitted population program.
//
// Rounding follows that program as XLA's CPU backend compiles it (probed):
// the tolerance and the move term are FMAs; the weighted row sum runs from
// zero in goal order, each product contracted into the sum when the
// weights differ and rounded on its own when they are all equal — the
// reference's bits for up to 22 goals (kMaxGoals; the wrapper refuses
// wider rows). Every other operation is rounded on its own (__fdiv_rn,
// __fmul_rn, __fadd_rn).
//
// Bound on the card: a launch. K <= 1,024 plans and G <= 22 goals fit one
// block with one thread per plan; the dominance counts and the sort
// positions are O(K^2 G) and O(K^2) comparisons over the block's shared
// copy of the normalized stacks.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGoals = 22;

// a < b with NaN after every number (and two NaNs equal), -0 == +0: the
// order of jnp.lexsort's float keys.
__device__ bool less_nan_last(float a, float b) {
  if (isnan(a)) return false;
  if (isnan(b)) return true;
  return a < b;
}

__device__ bool equal_nan(float a, float b) {
  return (isnan(a) && isnan(b)) || a == b;
}

__global__ void population_select_kernel(
    const float* __restrict__ boundary, const int32_t* __restrict__ moves,
    const float* __restrict__ scales, const uint8_t* __restrict__ hard,
    float hard_weight, float move_weight, int32_t with_moves, int32_t K,
    int32_t G, int32_t n_surv, int32_t pareto, int32_t* __restrict__ ranks,
    float* __restrict__ weighted, int32_t* __restrict__ perm) {
  extern __shared__ float shared[];
  float* norm = shared;                          // [K, G]
  float* score = norm + K * G;                   // [K]
  float* primary = score + K;                    // [K]
  int32_t* order = reinterpret_cast<int32_t*>(primary + K);   // [K]
  __shared__ float w[kMaxGoals];
  __shared__ bool contract;                      // the weights differ

  const int j = threadIdx.x;
  if (j < G) w[j] = hard[j] ? hard_weight : 1.0f;
  __syncthreads();
  if (j == 0) {
    bool uniform = true;
    for (int g = 1; g < G; ++g) uniform = uniform && w[g] == w[0];
    contract = !uniform;
  }
  if (j < K) {
    for (int g = 0; g < G; ++g) {
      const float x = boundary[j * G + g];
      const float s = scales[g];
      const float tol = __fmaf_rn(1e-6f, s, 1e-6f);
      const float n = __fdiv_rn(x, fmaxf(s, 1.0f));
      norm[j * G + g] = x <= tol ? 0.0f : n;
    }
  }
  __syncthreads();

  if (j < K) {
    const float* row = norm + j * G;
    float acc = 0.0f;
    for (int g = 0; g < G; ++g) {
      acc = contract ? __fmaf_rn(row[g], w[g], acc)
                     : __fadd_rn(acc, __fmul_rn(row[g], w[g]));
    }
    if (with_moves) {
      acc = __fmaf_rn(move_weight, static_cast<float>(moves[j]), acc);
    }
    score[j] = acc;
    weighted[j] = acc;

    int32_t dominated_by = 0;
    for (int i = 0; i < K; ++i) {
      const float* other = norm + i * G;
      bool le = true;
      bool lt = false;
      for (int g = 0; g < G; ++g) {
        le = le && other[g] <= row[g];
        lt = lt || other[g] < row[g];
      }
      dominated_by += (le && lt) ? 1 : 0;
    }
    ranks[j] = dominated_by;
    primary[j] = pareto ? static_cast<float>(dominated_by) : 0.0f;
  }
  __syncthreads();

  if (j < K) {
    // This plan's position in the (primary, weighted, index) order.
    int32_t pos = 0;
    for (int i = 0; i < K; ++i) {
      bool before;
      if (!equal_nan(primary[i], primary[j])) {
        before = less_nan_last(primary[i], primary[j]);
      } else if (!equal_nan(score[i], score[j])) {
        before = less_nan_last(score[i], score[j]);
      } else {
        before = i < j;
      }
      pos += before ? 1 : 0;
    }
    order[pos] = j;
  }
  __syncthreads();
  if (j < K) perm[j] = j == 0 ? 0 : order[j % n_surv];
}

}  // namespace

extern "C" int cc_population_select(const void* boundary, const void* moves,
                                    const void* scales, const void* hard,
                                    float hard_weight, float move_weight,
                                    int64_t with_moves, int64_t K, int64_t G,
                                    int64_t n_surv, int64_t pareto,
                                    void* ranks, void* weighted, void* perm,
                                    void* stream) {
  const int threads = static_cast<int>(((K > G ? K : G) + 31) / 32 * 32);
  const size_t shared = static_cast<size_t>(K) * (G + 3) * sizeof(float);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        population_select_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  population_select_kernel<<<1, threads, shared,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boundary),
      static_cast<const int32_t*>(moves), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(hard), hard_weight, move_weight,
      static_cast<int32_t>(with_moves), static_cast<int32_t>(K),
      static_cast<int32_t>(G), static_cast<int32_t>(n_surv),
      static_cast<int32_t>(pareto), static_cast<int32_t*>(ranks),
      static_cast<float*>(weighted), static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}
