// KE: first-fit batch assignment of a move schedule.
//
// Moves i = 0..M-1, in strategy order, each land in the lowest batch k < K
// where, for every touched broker row r of the move, count[r, k] <
// caps[r]; size[k] < cluster_cap; for every destination row d of the move
// (d < B1 - 1), mb[d, k] + size_mb[i] <= budget (a float32 add, then the
// compare) or mb[d, k] == 0 (a first move into a broker is always
// admitted); and the move is valid. A move no batch admits, and every
// invalid (padding) move, is assigned K. An admitted move then adds one to
// count[r, k] per touched row (a repeated padding row adds once per
// occurrence), one to size[k], and size_mb[i] to mb[d, k] per destination.
//
// Replaces cruise_control_tpu/executor/schedule.py:_first_fit_program
// (:105-141), a lax.fori_loop over the moves.
//
// Bound on the card: neither bytes nor operations. Each move's choice
// depends on every earlier move's updates, so the M moves are a chain of
// M dependent steps; one block walks them in order, its threads striding
// over the K batch slots (each thread tests its slots in ascending order
// and stops at its first feasible one), a block-wide minimum picks the
// lowest feasible k, and thread 0 applies the updates. The state
// (count int32[B1, K], size int32[K], mb float32[B1, K]) lives in global
// memory, zeroed by the wrapper; __syncthreads orders each move's updates
// before the next move's tests.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void first_fit_kernel(const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ dest_rows,
                                 const float* __restrict__ size_mb,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ caps,
                                 int32_t cluster_cap, float budget,
                                 int32_t* count, int32_t* size, float* mb,
                                 int32_t* __restrict__ assign, int32_t M,
                                 int32_t W, int32_t K, int32_t B1) {
  __shared__ int32_t warp_min[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int num_warps = (blockDim.x + 31) / 32;
  for (int32_t i = 0; i < M; ++i) {
    if (valid[i] == 0) {
      if (tid == 0) assign[i] = K;
      continue;
    }
    const int32_t* r = rows + static_cast<int64_t>(i) * W;
    const int32_t* d = dest_rows + static_cast<int64_t>(i) * W;
    const float add_mb = size_mb[i];
    int32_t local = K;
    for (int32_t k = tid; k < K; k += blockDim.x) {
      bool ok = size[k] < cluster_cap;
      for (int32_t w = 0; ok && w < W; ++w) {
        const int32_t rw = r[w];
        ok = count[static_cast<int64_t>(rw) * K + k] < caps[rw];
      }
      for (int32_t w = 0; ok && w < W; ++w) {
        const int32_t dw = d[w];
        if (dw < B1 - 1) {
          const float dmb = mb[static_cast<int64_t>(dw) * K + k];
          ok = __fadd_rn(dmb, add_mb) <= budget || dmb == 0.0f;
        }
      }
      if (ok) {
        local = k;
        break;
      }
    }
    local = __reduce_min_sync(0xffffffffu, local);
    if (lane == 0) warp_min[tid >> 5] = local;
    __syncthreads();
    if (tid < 32) {
      int32_t v = lane < num_warps ? warp_min[lane] : K;
      v = __reduce_min_sync(0xffffffffu, v);
      if (tid == 0) {
        assign[i] = v;
        if (v < K) {
          for (int32_t w = 0; w < W; ++w)
            count[static_cast<int64_t>(r[w]) * K + v] += 1;
          size[v] += 1;
          for (int32_t w = 0; w < W; ++w) {
            const int32_t dw = d[w];
            if (dw < B1 - 1) {
              float* cell = mb + static_cast<int64_t>(dw) * K + v;
              *cell = __fadd_rn(*cell, add_mb);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int cc_first_fit(const void* rows, const void* dest_rows,
                            const void* size_mb, const void* valid,
                            const void* caps, int64_t cluster_cap,
                            float budget, void* count, void* size, void* mb,
                            void* assign, int64_t M, int64_t W, int64_t K,
                            int64_t B1, void* stream) {
  if (M > 0) {
    int threads = static_cast<int>(((K + 31) / 32) * 32);
    if (threads < 32) threads = 32;
    if (threads > 1024) threads = 1024;
    first_fit_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(dest_rows),
        static_cast<const float*>(size_mb),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(caps),
        static_cast<int32_t>(cluster_cap), budget,
        static_cast<int32_t*>(count), static_cast<int32_t*>(size),
        static_cast<float*>(mb), static_cast<int32_t*>(assign),
        static_cast<int32_t>(M), static_cast<int32_t>(W),
        static_cast<int32_t>(K), static_cast<int32_t>(B1));
  }
  return static_cast<int>(cudaGetLastError());
}
