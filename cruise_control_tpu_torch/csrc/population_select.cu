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
// Rounding follows that program as XLA's CPU backend compiles it (probed,
// scripts/probe_sum_order.py --weighted, scripts/probe_row_fusion.py): the
// tolerance and the move term are FMAs; the weighted row (weighted_row
// below) runs in goal order from zero up to 22 goals, in LLVM's vector
// loop of FMAs at 23-32 (its shape passed by the wrapper: it differs
// between the generation boundaries and the final scores) and in XLA's
// windowed tree past 32 (up to 1,024 goals, one level of windows). Every
// other operation is rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn).
//
// Bound on the card: a launch. K <= 1,024 plans fit one block with one
// thread per plan; the dominance counts and the sort positions are
// O(K^2 G) and O(K^2) comparisons over the block's copy of the normalized
// stacks: in shared memory when [K, G] fits beside the per-plan arrays,
// else in the caller's global scratch (read through L1).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// lanes[0..n) folded by halves (x86's reduce.fadd): 0-3 + 4-7, ...
__device__ float fold_halves(float* lanes, int n) {
  for (; n > 1; n /= 2) {
    for (int k = 0; k < n / 2; ++k) {
      lanes[k] = __fadd_rn(lanes[k], lanes[k + n / 2]);
    }
  }
  return lanes[0];
}

// LLVM's vectorized loop of FMAs (utils/ordered.py:fma_loop_sum): ic
// accumulators of vf <= 8 lanes over the whole vf * ic chunks, in one
// chain (the first accumulator's chunks in order, then each other one's
// with its second chunk first), folded by halves; an epi-lane epilogue
// seeded with that total; then the rest in order.
__device__ float fma_loop(const float* row, const float* w, int G, int vf,
                          int ic, int epi) {
  float lanes[8];
  const int iters = G / (vf * ic);
  int pos = iters * vf * ic;
  float total = 0.0f;
  if (iters > 0) {
    lanes[0] = 0.0f;
    for (int l = 1; l < vf; ++l) lanes[l] = -0.0f;
    for (int k = 0; k < ic; ++k) {
      for (int t = 0; t < iters; ++t) {
        const int it = (k > 0 && iters > 1 && t < 2) ? 1 - t : t;
        const int c = (it * ic + k) * vf;
        for (int l = 0; l < vf; ++l) {
          lanes[l] = __fmaf_rn(row[c + l], w[c + l], lanes[l]);
        }
      }
    }
    total = fold_halves(lanes, vf);
  }
  if (epi > 0 && G - pos >= epi) {
    lanes[0] = total;
    for (int l = 1; l < epi; ++l) lanes[l] = -0.0f;
    for (; G - pos >= epi; pos += epi) {
      for (int l = 0; l < epi; ++l) {
        lanes[l] = __fmaf_rn(row[pos + l], w[pos + l], lanes[l]);
      }
    }
    total = fold_halves(lanes, epi);
  }
  for (; pos < G; ++pos) total = __fmaf_rn(row[pos], w[pos], total);
  return total;
}

// sum_g row[g] * w[g] as the reference's population program computes it
// (analyzer/engine.py:_fused_weighted_sum): up to 22 goals from zero in
// goal order, each product contracted into the sum when the weights differ
// and rounded on its own when they are all equal; at 23-32 goals the loop
// (vf, ic, epi) of FMAs; past 32 goals XLA's windowed tree of the rounded
// products.
__device__ float weighted_row(const float* row, const float* w, int G,
                              bool contract, int vf, int ic, int epi) {
  if (vf > 0) return fma_loop(row, w, G, vf, ic, epi);
  if (G > 32) {
    // windows of 32 (the padding split evenly in front and behind), each
    // in order from zero, then the window sums in order from zero
    const int windows = (G + 31) / 32;
    const int front = (windows * 32 - G) / 2;
    float total = 0.0f;
    for (int v = 0; v < windows; ++v) {
      float part = 0.0f;
      for (int e = 0; e < 32; ++e) {
        const int g = v * 32 - front + e;
        if (g >= 0 && g < G) part = __fadd_rn(part, __fmul_rn(row[g], w[g]));
      }
      total = __fadd_rn(total, part);
    }
    return total;
  }
  float acc = 0.0f;
  for (int g = 0; g < G; ++g) {
    acc = contract ? __fmaf_rn(row[g], w[g], acc)
                   : __fadd_rn(acc, __fmul_rn(row[g], w[g]));
  }
  return acc;
}

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
    int32_t G, int32_t vf, int32_t ic, int32_t epi, int32_t n_surv,
    int32_t pareto, float* norm_global,
    int32_t* __restrict__ ranks, float* __restrict__ weighted,
    int32_t* __restrict__ perm) {
  extern __shared__ float shared[];
  float* score = shared;                         // [K]
  float* primary = score + K;                    // [K]
  int32_t* order = reinterpret_cast<int32_t*>(primary + K);   // [K]
  float* w = reinterpret_cast<float*>(order + K);             // [G]
  // [K, G]: after w in shared memory, or the global scratch
  float* norm = norm_global ? norm_global : w + G;
  __shared__ bool contract;                      // the weights differ

  const int j = threadIdx.x;
  for (int g = j; g < G; g += blockDim.x) w[g] = hard[g] ? hard_weight : 1.0f;
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
    float acc = weighted_row(row, w, G, contract, vf, ic, epi);
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
                                    int64_t vf, int64_t ic, int64_t epi,
                                    int64_t n_surv, int64_t pareto,
                                    void* norm_scratch, void* ranks,
                                    void* weighted, void* perm,
                                    void* stream) {
  const int threads = static_cast<int>((K + 31) / 32 * 32);
  // the per-plan arrays and the weights, then [K, G] where it fits
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const size_t fixed = (3 * static_cast<size_t>(K) + G) * sizeof(float);
  const size_t whole = fixed + static_cast<size_t>(K) * G * sizeof(float);
  const bool staged = whole <= static_cast<size_t>(optin);
  const size_t shared = staged ? whole : fixed;
  if (shared > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // raised once to the largest size asked for (not again while a CUDA
  // graph captures the launch)
  static size_t allowed = 48 * 1024;
  if (shared > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        population_select_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = shared;
  }
  population_select_kernel<<<1, threads, shared,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boundary),
      static_cast<const int32_t*>(moves), static_cast<const float*>(scales),
      static_cast<const uint8_t*>(hard), hard_weight, move_weight,
      static_cast<int32_t>(with_moves), static_cast<int32_t>(K),
      static_cast<int32_t>(G), static_cast<int32_t>(vf),
      static_cast<int32_t>(ic), static_cast<int32_t>(epi),
      static_cast<int32_t>(n_surv),
      static_cast<int32_t>(pareto),
      staged ? nullptr : static_cast<float*>(norm_scratch),
      static_cast<int32_t*>(ranks),
      static_cast<float*>(weighted), static_cast<int32_t*>(perm));
  return static_cast<int>(cudaGetLastError());
}
