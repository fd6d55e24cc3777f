// KI: one generation boundary of the population search.
//
// For K candidate plans with violation stacks boundary[K, G], cumulative
// move counts moves[K] and per-goal scales[G]:
//   norm[j, g]  = boundary / max(scale_g, 1), or 0 where boundary <= tol_g,
//                 tol_g = fma(1e-6, scale_g, 1e-6);
//   weighted[j] = sum_g norm[j, g] * w_g (+ move_weight * moves[j]),
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
// tolerance and the move term are FMAs; the weighted row (plan_score
// below) runs in goal order from zero up to 22 goals, in LLVM's vector
// loop of FMAs at 23-32 (its shape passed by the wrapper: it differs
// between the generation boundaries and the final scores) and in XLA's
// windowed tree past 32 (up to 1,024 goals, one level of windows). Every
// other operation is rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn).
//
// Bound on the card: a launch, up to thousands of plans. The design:
//  - the stacks are normalized in one coalesced pass over all threads, and
//    whether the weights differ is one block vote;
//  - each plan's weighted row stays in one thread, in the fixed order
//    above (the order is part of the result);
//  - the dominance counts and the sort positions go a warp a plan j, its
//    lanes over the other plans i, counted by __ballot_sync/__popc
//    (integer counts: the same in any order);
//  - up to kSingleWork compares (K * K * G) with [K, G] in shared memory,
//    one block does it all in one launch; past that a grid of kTileJ-plan
//    tiles scores and ranks (each block normalizing the other plans' rows
//    into shared memory tile by tile), and a second launch places the
//    plans and scatters the permutation (slot t takes the plan at
//    position t mod n_surv).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileJ = 8;                     // plans a grid block ranks
constexpr int kGridThreads = kTileJ * 32;     // a warp a plan
constexpr int kOrderThreads = 256;            // second launch: 8 warps
constexpr int64_t kSingleWork = 1 << 17;      // K * K * G of one block
constexpr size_t kGridShared = 100 * 1024;    // a grid block's allotment

// The row stride of a [., G] tile in shared memory: odd, so that lanes
// reading column g of consecutive rows hit distinct banks.
__host__ __device__ inline int padded(int G) { return G | 1; }

// lanes[0..n) folded by halves (x86's reduce.fadd): 0-3 + 4-7, ..., with
// n <= VF a power of two (unrolled over VF: the lanes stay registers).
template <int VF>
__device__ __forceinline__ float fold_halves(float (&lanes)[VF], int n) {
#pragma unroll
  for (int h = VF / 2; h >= 1; h /= 2) {
    if (2 * h <= n) {
#pragma unroll
      for (int k = 0; k < h; ++k) lanes[k] = __fadd_rn(lanes[k], lanes[k + h]);
    }
  }
  return lanes[0];
}

// LLVM's vectorized loop of FMAs (utils/ordered.py:fma_loop_sum) over
// x[0..n) * w[0..n) (n <= 32): ic accumulators of VF lanes over the whole VF * ic
// chunks, in one chain (the first accumulator's chunks in order, then each
// other one's with its second chunk first), folded by halves; an epi-lane
// epilogue seeded with that total; then the rest in order.
template <int VF>
__device__ float fma_loop(const float* x, const float* w, int n, int ic,
                          int epi) {
  float lanes[VF];
  const int iters = n / (VF * ic);
  int pos = iters * VF * ic;
  float total = 0.0f;
  if (iters > 0) {
    lanes[0] = 0.0f;
#pragma unroll
    for (int l = 1; l < VF; ++l) lanes[l] = -0.0f;
    for (int k = 0; k < ic; ++k) {
      for (int t = 0; t < iters; ++t) {
        const int it = (k > 0 && iters > 1 && t < 2) ? 1 - t : t;
        const int c = (it * ic + k) * VF;
#pragma unroll
        for (int l = 0; l < VF; ++l) {
          lanes[l] = __fmaf_rn(x[c + l], w[c + l], lanes[l]);
        }
      }
    }
    total = fold_halves(lanes, VF);
  }
  if (epi > 0 && n - pos >= epi) {
    lanes[0] = total;
#pragma unroll
    for (int l = 1; l < VF; ++l) lanes[l] = -0.0f;
    for (; n - pos >= epi; pos += epi) {
#pragma unroll
      for (int l = 0; l < VF; ++l) {
        if (l < epi) lanes[l] = __fmaf_rn(x[pos + l], w[pos + l], lanes[l]);
      }
    }
    total = fold_halves(lanes, epi);
  }
  for (; pos < n; ++pos) total = __fmaf_rn(x[pos], w[pos], total);
  return total;
}

// LLVM's vectorized loop of adds (utils/ordered.py:vector_loop_sum) over
// the rounded products x[g] * w[g], g < n <= 32: ic <= 4 accumulators of
// VF lanes over the whole VF * ic chunks (XLA's init 0.0 in lane 0 of the
// first, -0.0 elsewhere), combined in order and folded by halves; an
// epi-lane epilogue seeded with that total; then the rest in order.
template <int VF>
__device__ float add_loop(const float* x, const float* w, int n, int ic,
                          int epi) {
  constexpr int kMaxIc = 4;
  float acc[kMaxIc][VF];
  const int iters = VF > 1 ? n / (VF * ic) : 0;
  int pos = iters * VF * ic;
  float total = 0.0f;
  if (iters > 0) {
#pragma unroll
    for (int k = 0; k < kMaxIc; ++k) {
#pragma unroll
      for (int l = 0; l < VF; ++l) {
        acc[k][l] = k == 0 && l == 0 ? 0.0f : -0.0f;
      }
    }
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int k = 0; k < kMaxIc; ++k) {
        if (k < ic) {
          const int c = (it * ic + k) * VF;
#pragma unroll
          for (int l = 0; l < VF; ++l) {
            acc[k][l] = __fadd_rn(acc[k][l], __fmul_rn(x[c + l], w[c + l]));
          }
        }
      }
    }
#pragma unroll
    for (int k = 1; k < kMaxIc; ++k) {
      if (k < ic) {
#pragma unroll
        for (int l = 0; l < VF; ++l) acc[0][l] = __fadd_rn(acc[0][l], acc[k][l]);
      }
    }
    total = fold_halves(acc[0], VF);
  }
  float lanes[VF];
  if (epi > 0 && n - pos >= epi) {
    lanes[0] = total;
#pragma unroll
    for (int l = 1; l < VF; ++l) lanes[l] = -0.0f;
    for (; n - pos >= epi; pos += epi) {
#pragma unroll
      for (int l = 0; l < VF; ++l) {
        if (l < epi) {
          lanes[l] = __fadd_rn(lanes[l], __fmul_rn(x[pos + l], w[pos + l]));
        }
      }
    }
    total = fold_halves(lanes, epi);
  }
  for (; pos < n; ++pos) total = __fadd_rn(total, __fmul_rn(x[pos], w[pos]));
  return total;
}

// How a plan's score is formed (set by the wrapper from the goal count,
// the scoring site and the plan count): the 23-32-goal loop (vf, ic, epi)
// of each weight form (analyzer/engine.py:WEIGHT_FORMS): where the weights
// differ (every product an FMA), where they are all equal and where they
// are all 1 (every product rounded); vf 0: goal order up to 22 goals,
// XLA's tree past 32.
struct RowForm {
  int loop[3][3];        // [mixed, equal, unit][vf, ic, epi]
  int with_moves;        // a move term is added
  float hard_weight, move_weight;
};

// sum_g row[g] * w[g] + move_weight * moves as the reference's population
// program computes it (analyzer/engine.py:weighted_objective): where the
// weights differ, every product contracted into the sum, from zero in goal
// order up to 22 goals and in the loop of FMAs at 23-32; where they are
// all equal (the program's weights a splat constant), every product
// rounded on its own, in goal order or the loop of adds of its form;
// past 32 goals XLA's windowed tree of the rounded products; then the
// move term, an FMA onto the sum.
__device__ float plan_score(const float* row, const float* w, int G,
                            bool contract, const RowForm& f, float moves) {
  float acc = 0.0f;
  if (G > 32) {
    // windows of 32 (the padding split evenly in front and behind), each
    // in order from zero, then the window sums in order from zero
    const int windows = (G + 31) / 32;
    const int front = (windows * 32 - G) / 2;
    for (int v = 0; v < windows; ++v) {
      float part = 0.0f;
      for (int e = 0; e < 32; ++e) {
        const int g = v * 32 - front + e;
        if (g >= 0 && g < G) part = __fadd_rn(part, __fmul_rn(row[g], w[g]));
      }
      acc = __fadd_rn(acc, part);
    }
  } else if (contract) {
    const int* l = f.loop[0];
    switch (l[0]) {
      case 2: acc = fma_loop<2>(row, w, G, l[1], l[2]); break;
      case 4: acc = fma_loop<4>(row, w, G, l[1], l[2]); break;
      case 8: acc = fma_loop<8>(row, w, G, l[1], l[2]); break;
      default: acc = fma_loop<1>(row, w, G, 1, 0); break;
    }
  } else {
    const int* l = f.loop[G > 0 && w[0] == 1.0f ? 2 : 1];
    switch (l[0]) {
      case 2: acc = add_loop<2>(row, w, G, l[1], l[2]); break;
      case 4: acc = add_loop<4>(row, w, G, l[1], l[2]); break;
      case 8: acc = add_loop<8>(row, w, G, l[1], l[2]); break;
      default: acc = add_loop<1>(row, w, G, 1, 0); break;
    }
  }
  if (f.with_moves) acc = __fmaf_rn(f.move_weight, moves, acc);
  return acc;
}

__device__ __forceinline__ float normalized(float x, float s) {
  const float tol = __fmaf_rn(1e-6f, s, 1e-6f);
  return x <= tol ? 0.0f : __fdiv_rn(x, fmaxf(s, 1.0f));
}

// Rows [r0, r0 + n) of the normalized stacks into tile[n][padded(G)]
// (coalesced over the block's threads).
__device__ void normalize_rows(const float* __restrict__ boundary,
                               const float* __restrict__ scales, int r0,
                               int n, int G, float* tile) {
  const int Gp = padded(G);
  for (int e = threadIdx.x; e < n * G; e += blockDim.x) {
    const int r = e / G;
    const int g = e - r * G;
    tile[r * Gp + g] = normalized(boundary[(r0 + r) * G + g], scales[g]);
  }
}

// The weights into w[G]; true where they differ (a block vote, which is
// also the barrier after w is written).
__device__ bool load_weights(const uint8_t* __restrict__ hard, float hw,
                             int G, float* w) {
  const float w0 = G > 0 && hard[0] ? hw : 1.0f;
  bool differ = false;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    w[g] = hard[g] ? hw : 1.0f;
    differ = differ || w[g] != w0;
  }
  return __syncthreads_or(differ) != 0;
}

// How many rows of others[0..n) (stride Gp) dominate row: every goal <=,
// one <. Lanes take the rows, four goals at a time (independent loads),
// until a goal is greater; the count is every lane's.
__device__ int dominated_by(const float* row, const float* others, int n,
                            int G) {
  const int Gp = padded(G);
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    bool dom = false;
    if (i < n) {
      const float* other = others + i * Gp;
      bool le = true, lt = false;
      for (int g0 = 0; g0 < G && le; g0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g0 + u < G) {
            const float a = other[g0 + u], b = row[g0 + u];
            le = le && a <= b;
            lt = lt || a < b;
          }
        }
      }
      dom = le && lt;
    }
    count += __popc(__ballot_sync(0xFFFFFFFFu, dom));
  }
  return count;
}

// a before b in jnp.lexsort's order of float keys: NaN after every number
// (two NaNs equal), -0 == +0.
__device__ __forceinline__ bool less_nan_last(float a, float b) {
  if (isnan(a)) return false;
  if (isnan(b)) return true;
  return a < b;
}

__device__ __forceinline__ bool equal_nan(float a, float b) {
  return (isnan(a) && isnan(b)) || a == b;
}

// Plan j's position in the (primary, score, index) order (a warp, lanes
// over i); its lanes then write perm[t] = j for every slot t whose
// survivor it is (t = pos mod n_surv), perm[0] = 0.
__device__ void place(int j, int K, const float* primary, const float* score,
                      int n_surv, int32_t* __restrict__ perm) {
  const int lane = threadIdx.x & 31;
  int pos = 0;
  for (int i0 = 0; i0 < K; i0 += 32) {
    const int i = i0 + lane;
    bool before = false;
    if (i < K) {
      if (!equal_nan(primary[i], primary[j])) {
        before = less_nan_last(primary[i], primary[j]);
      } else if (!equal_nan(score[i], score[j])) {
        before = less_nan_last(score[i], score[j]);
      } else {
        before = i < j;
      }
    }
    pos += __popc(__ballot_sync(0xFFFFFFFFu, before));
  }
  if (pos < n_surv) {
    for (int t = pos + lane * n_surv; t < K; t += 32 * n_surv) {
      perm[t] = t == 0 ? 0 : j;
    }
  }
}

// One block: normalize, score, rank, place, all K plans.
__global__ void population_select_kernel(
    const float* __restrict__ boundary, const int32_t* __restrict__ moves,
    const float* __restrict__ scales, const uint8_t* __restrict__ hard,
    RowForm form, int32_t K, int32_t G, int32_t n_surv, int32_t pareto,
    int32_t* __restrict__ ranks, float* __restrict__ weighted,
    int32_t* __restrict__ perm) {
  extern __shared__ float shared[];
  float* score = shared;                         // [K]
  float* primary = score + K;                    // [K]
  float* w = primary + K;                        // [G]
  float* norm = w + G;                           // [K][padded(G)]
  const int Gp = padded(G);
  const int j = threadIdx.x;
  const float mv = j < K ? static_cast<float>(moves[j]) : 0.0f;
  normalize_rows(boundary, scales, 0, K, G, norm);
  const bool contract = load_weights(hard, form.hard_weight, G, w);

  if (j < K) {
    const float acc = plan_score(norm + j * Gp, w, G, contract, form, mv);
    score[j] = acc;
    weighted[j] = acc;
  }
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int jj = warp; jj < K; jj += warps) {
    const int n = dominated_by(norm + jj * Gp, norm, K, G);
    if ((threadIdx.x & 31) == 0) {
      ranks[jj] = n;
      primary[jj] = pareto ? static_cast<float>(n) : 0.0f;
    }
  }
  __syncthreads();
  for (int jj = warp; jj < K; jj += warps) {
    place(jj, K, primary, score, n_surv, perm);
  }
}

// Past one block, launch 1: block b scores and ranks plans
// [b * kTileJ, b * kTileJ + kTileJ), a warp a plan, the other plans'
// normalized rows staged through shared memory `rows` at a time.
__global__ void __launch_bounds__(kGridThreads)
population_rank_kernel(
    const float* __restrict__ boundary, const int32_t* __restrict__ moves,
    const float* __restrict__ scales, const uint8_t* __restrict__ hard,
    RowForm form, int32_t K, int32_t G, int32_t rows,
    int32_t* __restrict__ ranks, float* __restrict__ weighted) {
  extern __shared__ float shared[];
  const int Gp = padded(G);
  float* w = shared;                             // [G]
  float* own = w + G;                            // [kTileJ][Gp]
  float* tile = own + kTileJ * Gp;               // [rows][Gp]
  const int j0 = blockIdx.x * kTileJ;
  const int mine = K - j0 < kTileJ ? K - j0 : kTileJ;
  const int t = threadIdx.x;
  const float mv = t < mine ? static_cast<float>(moves[j0 + t]) : 0.0f;
  normalize_rows(boundary, scales, j0, mine, G, own);
  const bool contract = load_weights(hard, form.hard_weight, G, w);
  if (t < mine) {
    weighted[j0 + t] = plan_score(own + t * Gp, w, G, contract, form, mv);
  }
  const int warp = threadIdx.x >> 5;
  int count = 0;
  for (int i0 = 0; i0 < K; i0 += rows) {
    const int n = K - i0 < rows ? K - i0 : rows;
    __syncthreads();
    normalize_rows(boundary, scales, i0, n, G, tile);
    __syncthreads();
    if (warp < mine) count += dominated_by(own + warp * Gp, tile, n, G);
  }
  if (warp < mine && (threadIdx.x & 31) == 0) ranks[j0 + warp] = count;
}

// Past one block, launch 2: every block reads all K scores and ranks and
// places its tile of plans, a warp a plan.
__global__ void population_place_kernel(
    const int32_t* __restrict__ ranks, const float* __restrict__ weighted,
    int32_t K, int32_t n_surv, int32_t pareto, int32_t per_block,
    int32_t* __restrict__ perm) {
  extern __shared__ float shared[];
  float* score = shared;                         // [K]
  float* primary = score + K;                    // [K]
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    score[i] = weighted[i];
    primary[i] = pareto ? static_cast<float>(ranks[i]) : 0.0f;
  }
  __syncthreads();
  const int j0 = blockIdx.x * per_block;
  const int j1 = j0 + per_block < K ? j0 + per_block : K;
  for (int j = j0 + (threadIdx.x >> 5); j < j1; j += blockDim.x >> 5) {
    place(j, K, primary, score, n_surv, perm);
  }
}

// The dynamic shared memory `fn` may use: raised to `bytes` when above
// the default (never while a CUDA graph captures a launch: the first call
// at a shape runs uncaptured).
template <typename F>
cudaError_t allow_shared(F* fn, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

int shared_optin() {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return optin;
}

}  // namespace

// 1: one block serves this shape in one launch; 0: the grid and a second
// launch.
extern "C" int64_t cc_population_select_single(int64_t K, int64_t G) {
  const size_t bytes = (2 * static_cast<size_t>(K) + G
                        + static_cast<size_t>(K) * padded(G)) * sizeof(float);
  return K * K * G <= kSingleWork
         && bytes <= static_cast<size_t>(shared_optin());
}

extern "C" int cc_population_select(
    const void* boundary, const void* moves, const void* scales,
    const void* hard, float hard_weight, float move_weight,
    int64_t with_moves, int64_t K, int64_t G,
    int64_t mvf, int64_t mic, int64_t mepi, int64_t evf, int64_t eic,
    int64_t eepi, int64_t uvf, int64_t uic, int64_t uepi, int64_t n_surv,
    int64_t pareto,
    void* ranks, void* weighted, void* perm, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const RowForm form{
      {{static_cast<int>(mvf), static_cast<int>(mic), static_cast<int>(mepi)},
       {static_cast<int>(evf), static_cast<int>(eic), static_cast<int>(eepi)},
       {static_cast<int>(uvf), static_cast<int>(uic), static_cast<int>(uepi)}},
      static_cast<int>(with_moves), hard_weight, move_weight};
  const auto b = static_cast<const float*>(boundary);
  const auto m = static_cast<const int32_t*>(moves);
  const auto s = static_cast<const float*>(scales);
  const auto h = static_cast<const uint8_t*>(hard);
  const auto r = static_cast<int32_t*>(ranks);
  const auto w = static_cast<float*>(weighted);
  const auto p = static_cast<int32_t*>(perm);
  const int32_t k32 = static_cast<int32_t>(K), g32 = static_cast<int32_t>(G);
  const int32_t ns = static_cast<int32_t>(n_surv);
  const int32_t pa = static_cast<int32_t>(pareto);
  const int Gp = padded(static_cast<int>(G));
  if (cc_population_select_single(K, G)) {
    static size_t allowed = 48 * 1024;
    const size_t bytes = (2 * K + G + K * Gp) * sizeof(float);
    const cudaError_t err = allow_shared(population_select_kernel, bytes,
                                         allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    // a warp a plan, up to 32 warps (at least 4)
    const int threads = static_cast<int>(K < 4    ? 128
                                         : K > 32 ? 1024
                                                  : 32 * K);
    population_select_kernel<<<1, threads, bytes, st>>>(
        b, m, s, h, form, k32, g32, ns, pa, r, w, p);
    return static_cast<int>(cudaGetLastError());
  }
  // the other plans' rows a grid block stages at a time: what the
  // allotment holds, a multiple of 32 (at least 32, at most K)
  const size_t fixed = (G + static_cast<size_t>(kTileJ) * Gp) * sizeof(float);
  int64_t rows = kGridShared > fixed
                     ? static_cast<int64_t>((kGridShared - fixed)
                                            / (Gp * sizeof(float)))
                     : 0;
  rows = rows / 32 * 32;
  rows = rows < 32 ? 32 : rows;
  rows = rows > K ? K : rows;
  const size_t bytes = fixed + rows * Gp * sizeof(float);
  if (bytes > static_cast<size_t>(shared_optin())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t allowed_rank = 48 * 1024;
  cudaError_t err = allow_shared(population_rank_kernel, bytes,
                                 allowed_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((K + kTileJ - 1) / kTileJ);
  population_rank_kernel<<<tiles, kGridThreads, bytes, st>>>(
      b, m, s, h, form, k32, g32, static_cast<int32_t>(rows), r, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t per_block = 32;
  const unsigned blocks = static_cast<unsigned>((K + per_block - 1)
                                                / per_block);
  population_place_kernel<<<blocks, kOrderThreads,
                            2 * K * sizeof(float), st>>>(
      r, w, k32, ns, pa, per_block, p);
  return static_cast<int>(cudaGetLastError());
}
