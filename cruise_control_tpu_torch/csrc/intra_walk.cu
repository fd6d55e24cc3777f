// KH: the intra-broker disk walk, every iteration in one launch.
//
// Each iteration, every broker b computes its disks' utilization util[d]
// (the sizes of the replicas on disk d, added in flat replica order), the
// mean over its live disks (valid, capacity > 0), the pressure of each
// disk (+inf for a draining disk that still holds data, util - mean for a
// live disk, -inf otherwise), src = the first disk of greatest pressure,
// dst = the first live disk of least utilization, gap = util[src] -
// util[dst], and moves its heaviest movable replica on src to dst — a
// replica fits when its size is at most gap * 0.5 or src drains, and a
// zero-size replica moves only off a draining disk; among equal sizes the
// lowest flat index wins. The walk stops when no broker moves or after
// max_iters iterations.
//
// Replaces cruise_control_tpu/analyzer/intra.py:optimize_intra_broker
// (:182-249), a lax.while_loop over the whole cluster.
//
// Logdir moves never leave their broker and every quantity above depends
// only on the broker's own replicas, so the brokers walk independently: a
// broker that makes no move sees the same inputs in the next iteration and
// never moves again. One block per broker loops until it stops; broker b's
// moves m_b reproduce the reference's, and the reference's iteration count
// is min(max_iters, max_b m_b + 1), the max taken with atomicMax (an
// integer, so exact in any order).
//
// Every float operation is rounded on its own (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn): the disk sums are rebuilt from zero each
// iteration in flat index order (XLA's scatter-add order), as the
// reference rebuilds them, rather than updated by the moved size; the
// mean's sum over the D disks follows XLA's tree order (in order up to 32
// disks, windows of 32 beyond; probed at D = 1-64).
//
// Bound on the card: the chain of dependent steps, not bytes. An iteration
// is a sequence of in-order sums over the broker's replicas (one thread per
// disk, each scanning the broker's list), a few scalar steps and a block
// reduction of (size, index) over the list, repeated for up to max_iters
// iterations. The broker's sizes and disk slots are staged in shared memory
// when the largest broker's list fits, else in a global scratch copy.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDisks = 64;
constexpr int kThreads = 256;

struct Best {
  float size;
  int64_t index;     // local position in the broker's list; n = none
};

__device__ Best better(Best a, Best b) {
  // Larger size first, then the lower index; a NaN size never wins here
  // (the caller poisons the broker instead).
  if (b.size > a.size) return b;
  if (b.size == a.size && b.index < a.index) return b;
  return a;
}

__global__ void intra_walk_kernel(
    const int64_t* __restrict__ offsets, const int64_t* __restrict__ rows,
    const float* __restrict__ size, int32_t* __restrict__ rd,
    const float* __restrict__ capacity, const uint8_t* __restrict__ valid,
    float* __restrict__ scratch_size, int32_t* __restrict__ scratch_rd,
    int32_t D, int32_t max_iters, int32_t staged,
    int32_t* __restrict__ moves_out, int32_t* __restrict__ max_moves) {
  extern __shared__ unsigned char smem[];
  __shared__ float util[kMaxDisks];
  __shared__ float cap[kMaxDisks];
  __shared__ bool ok[kMaxDisks];
  __shared__ int src_s, dst_s, stop_s, poisoned_s;
  __shared__ float half_s;
  __shared__ bool drain_s;
  __shared__ float warp_size[kThreads / 32];
  __shared__ int64_t warp_index[kThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t start = offsets[b];
  const int64_t n = offsets[b + 1] - start;
  float* sz;
  int32_t* slot;
  if (staged) {
    sz = reinterpret_cast<float*>(smem);
    slot = reinterpret_cast<int32_t*>(smem + n * sizeof(float));
  } else {
    sz = scratch_size + start;
    slot = scratch_rd + start;
  }
  for (int64_t i = tid; i < n; i += blockDim.x) {
    const int64_t flat = rows[start + i];
    sz[i] = size[flat];
    slot[i] = rd[flat];
  }
  if (tid < D) {
    cap[tid] = capacity[static_cast<int64_t>(b) * D + tid];
    ok[tid] = valid[static_cast<int64_t>(b) * D + tid] != 0;
  }
  __syncthreads();

  int32_t moves = 0;
  for (int32_t it = 0; it < max_iters; ++it) {
    // 1. Disk sums from zero, in flat order.
    if (tid < D) {
      float acc = 0.0f;
      for (int64_t i = 0; i < n; ++i) {
        if (slot[i] == tid) acc = __fadd_rn(acc, sz[i]);
      }
      util[tid] = acc;
    }
    if (tid == 0) poisoned_s = 0;
    __syncthreads();

    // 2. Mean, pressure, source and destination (one thread, D values).
    if (tid == 0) {
      // XLA's row order: windows of 32 disks (the padding split evenly in
      // front and behind), each summed in order, then the window sums.
      int n_live = 0;
      float total = 0.0f;
      const int windows = (D + 31) / 32;
      const int front = (windows * 32 - D) / 2;
      for (int w = 0; w < windows; ++w) {
        const int lo = w * 32 - front > 0 ? w * 32 - front : 0;
        const int hi = (w + 1) * 32 - front < D ? (w + 1) * 32 - front : D;
        float part = 0.0f;
        for (int d = lo; d < hi; ++d) {
          const bool live = ok[d] && cap[d] > 0.0f;
          n_live += live ? 1 : 0;
          part = __fadd_rn(part, live ? util[d] : 0.0f);
        }
        total = __fadd_rn(total, part);
      }
      const float avg = __fdiv_rn(total,
                                  static_cast<float>(n_live > 1 ? n_live : 1));
      int src = 0;
      int dst = 0;
      float best_p = 0.0f;
      float best_u = 0.0f;
      for (int d = 0; d < D; ++d) {
        const bool live = ok[d] && cap[d] > 0.0f;
        const float p = (ok[d] && cap[d] <= 0.0f && util[d] > 0.0f)
                            ? INFINITY
                            : (live ? __fsub_rn(util[d], avg) : -INFINITY);
        const float u = live ? util[d] : INFINITY;
        // argmax / argmin: the first extreme, NaN counting as extreme
        if (d == 0 || (!isnan(best_p) && (isnan(p) || p > best_p))) {
          best_p = p;
          src = d;
        }
        if (d == 0 || (!isnan(best_u) && (isnan(u) || u < best_u))) {
          best_u = u;
          dst = d;
        }
      }
      src_s = src;
      dst_s = dst;
      half_s = __fmul_rn(__fsub_rn(util[src], util[dst]), 0.5f);
      drain_s = cap[src] <= 0.0f;
    }
    __syncthreads();

    // 3. The broker's heaviest movable replica on src.
    const int src = src_s;
    const float half = half_s;
    const bool drain = drain_s;
    Best best{-INFINITY, n};
    for (int64_t i = tid; i < n; i += blockDim.x) {
      if (slot[i] != src) continue;
      const float s = sz[i];
      const bool movable = (s <= half || drain) && (s > 0.0f || drain);
      if (!movable || s == -INFINITY) continue;
      if (isnan(s) || s == INFINITY) {
        poisoned_s = 1;   // the reference's segment max is then not finite
        continue;
      }
      best = better(best, Best{s, i});
    }
    for (int offset = 16; offset > 0; offset /= 2) {
      const float os = __shfl_down_sync(0xffffffffu, best.size, offset);
      const int64_t oi = __shfl_down_sync(0xffffffffu, best.index, offset);
      best = better(best, Best{os, oi});
    }
    if ((tid & 31) == 0) {
      warp_size[tid / 32] = best.size;
      warp_index[tid / 32] = best.index;
    }
    __syncthreads();

    // 4. Move it.
    if (tid == 0) {
      Best win{-INFINITY, n};
      for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) {
        win = better(win, Best{warp_size[w], warp_index[w]});
      }
      const bool move = win.index < n && dst_s != src && !poisoned_s;
      if (move) {
        slot[win.index] = dst_s;
        ++moves;
      }
      stop_s = move ? 0 : 1;
    }
    __syncthreads();
    if (stop_s) break;
  }

  for (int64_t i = tid; i < n; i += blockDim.x) rd[rows[start + i]] = slot[i];
  if (tid == 0) {
    moves_out[b] = moves;
    atomicMax(max_moves, moves);
  }
}

}  // namespace

extern "C" int cc_intra_broker_walk(const void* offsets, const void* rows,
                                    const void* size, void* rd,
                                    const void* capacity, const void* valid,
                                    void* scratch_size, void* scratch_rd,
                                    int64_t B, int64_t D, int64_t max_iters,
                                    int64_t max_rows, void* moves_out,
                                    void* max_moves, void* stream) {
  const size_t per_row = sizeof(float) + sizeof(int32_t);
  const size_t want = static_cast<size_t>(max_rows) * per_row;
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  // leave room for the kernel's static shared arrays
  const bool staged = want + 4096 <= static_cast<size_t>(optin);
  const size_t shared = staged ? want : 0;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        intra_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  intra_walk_kernel<<<static_cast<unsigned>(B), kThreads, shared,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(rows),
      static_cast<const float*>(size), static_cast<int32_t*>(rd),
      static_cast<const float*>(capacity),
      static_cast<const uint8_t*>(valid), static_cast<float*>(scratch_size),
      static_cast<int32_t*>(scratch_rd), static_cast<int32_t>(D),
      static_cast<int32_t>(max_iters), staged ? 1 : 0,
      static_cast<int32_t*>(moves_out), static_cast<int32_t*>(max_moves));
  return static_cast<int>(cudaGetLastError());
}
