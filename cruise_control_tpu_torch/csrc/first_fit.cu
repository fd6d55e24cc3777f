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
// (:88-143), a lax.fori_loop over the moves.
//
// Bound on the card: neither bytes nor operations. Each move's choice
// depends on every earlier move's updates, so the M moves are a chain of
// M dependent steps, and the design shortens each link:
//
// - Slot ownership: thread t of the block's T threads owns the batch slots
//   k = t (mod T): only the owner of slot k ever tests or updates its
//   state, so the owner of the winning slot applies the move itself, and
//   each move needs one block barrier (the per-warp minima are double
//   buffered, so a warp that runs ahead never overwrites a minimum another
//   warp has yet to read).
// - Frontier-limited tests: F = the highest slot admitted so far + 1. Every
//   slot above F is empty, so it is equivalent to slot F, and first fit
//   never picks one; slots 0..min(F, K - 1) are tested (slot F is tested,
//   never assumed feasible: a cap of 0 makes every slot infeasible). Each
//   thread tests its slots in ascending order and stops at its first
//   feasible one; with F < T that is one test a thread.
// - State in shared memory: count and mb of the first S slots ([B1, S],
//   with size[S]) live in shared memory, S as many as fit (a multiple of
//   32); slots from S on live in the global arrays [B1, K] the wrapper
//   zeroes. A schedule whose frontier stays below S never leaves shared
//   memory.
// - Inputs staged ahead: the move stream (rows, dest_rows, size_mb, valid)
//   comes into shared memory in double-buffered chunks with cp.async, the
//   next chunk in flight while the block walks the current one.
// - Short tests: the touched rows a move (W) is a compile-time constant
//   for W = 1-8, so a slot's test is a few independent loads and compares.
//   Any other W takes the generic form: it reads the move's rows from the
//   global arrays in a run-time loop over W (only size_mb and valid are
//   staged), so any W runs. A walk is issue-bound: the block's warps (one
//   a 32 slots of K, at most kWarps) spread the tests over the SM's four
//   schedulers.
//
// Every float add is __fadd_rn, and each slot's mb adds its moves' sizes
// in move order (only its owner thread adds to it), as the reference does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 128;    // moves a staged chunk
constexpr int kWarps = 8;      // the block's most warps

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One staged chunk: rows[kChunk * W], dest[kChunk * W], size[kChunk],
// valid[kChunk] (int32 words); W = 0 stages size and valid alone.
__host__ __device__ __forceinline__ int chunk_words(int W) {
  return 2 * kChunk * W + 2 * kChunk;
}

__device__ void stage_chunk(int32_t* buf, const int32_t* rows,
                            const int32_t* dest, const float* size_mb,
                            const int32_t* valid, int32_t c, int32_t M,
                            int32_t W) {
  const int64_t i0 = static_cast<int64_t>(c) * kChunk;
  const int n = static_cast<int>(M - i0 < kChunk ? M - i0 : kChunk);
  if (n > 0) {
    for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
      cp_async4(buf + e, rows + i0 * W + e);
      cp_async4(buf + kChunk * W + e, dest + i0 * W + e);
    }
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      cp_async4(buf + 2 * kChunk * W + e, size_mb + i0 + e);
      cp_async4(buf + 2 * kChunk * W + kChunk + e, valid + i0 + e);
    }
  }
  cp_async_commit();
}

// The block's least admitting slot: a shuffle minimum a warp, then every
// thread reads the warps' minima (double buffered: one barrier a move).
__device__ __forceinline__ int32_t winner(int32_t local, int32_t* warp_min,
                                          int& buf, int lane, int warp,
                                          int warps) {
  int32_t win = __reduce_min_sync(kFull, local);
  if (warps > 1) {
    if (lane == 0) warp_min[buf * 32 + warp] = win;
    __syncthreads();
    for (int v = 0; v < warps; ++v) {
      const int32_t o = warp_min[buf * 32 + v];
      win = o < win ? o : win;
    }
    buf ^= 1;
  }
  return win;
}

// Slot k admits the move: its batch is not full, no touched row is at
// its cap, and every destination's bandwidth stays within the budget (or
// the slot holds nothing for it yet). Every compare is independent of the
// others: a few loads in flight at once.
template <int kW>
__device__ __forceinline__ bool slot_ok(
    const int32_t* cnt, const int32_t* size, const float* mb, int64_t stride,
    int32_t k, const int32_t (&r)[kW], const int32_t (&cap)[kW],
    const int32_t (&d)[kW], int32_t cluster_cap, float add_mb, float budget) {
  bool ok = size[k] < cluster_cap;
#pragma unroll
  for (int w = 0; w < kW; ++w) ok &= cnt[r[w] * stride + k] < cap[w];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (d[w] >= 0) {
      const float m = mb[d[w] * stride + k];
      ok &= (__fadd_rn(m, add_mb) <= budget) | (m == 0.0f);
    }
  }
  return ok;
}

// The move lands in slot k: its owner adds one to each touched row's count
// and to the batch size, and the size to each destination's megabytes.
template <int kW>
__device__ __forceinline__ void apply(int32_t* cnt, int32_t* size, float* mb,
                                      int64_t stride, int32_t k,
                                      const int32_t (&r)[kW],
                                      const int32_t (&d)[kW], float add_mb) {
#pragma unroll
  for (int w = 0; w < kW; ++w) cnt[r[w] * stride + k] += 1;
  size[k] += 1;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (d[w] >= 0) {
      float* cell = mb + d[w] * stride + k;
      *cell = __fadd_rn(*cell, add_mb);
    }
  }
}

// The generic forms: the move's W rows and destinations read in a
// run-time loop (rows[w], dest[w]; a destination of the padding row is
// none).
__device__ __forceinline__ bool slot_ok_any(
    const int32_t* cnt, const int32_t* size, const float* mb, int64_t stride,
    int32_t k, const int32_t* rows, const int32_t* dest, int W,
    const int32_t* caps, int32_t pad, int32_t cluster_cap, float add_mb,
    float budget) {
  if (size[k] >= cluster_cap) return false;
  for (int w = 0; w < W; ++w) {
    const int32_t r = rows[w];
    if (cnt[r * stride + k] >= caps[r]) return false;
    const int32_t d = dest[w];
    if (d < pad) {
      const float m = mb[d * stride + k];
      if (!(__fadd_rn(m, add_mb) <= budget) && m != 0.0f) return false;
    }
  }
  return true;
}

__device__ __forceinline__ void apply_any(int32_t* cnt, int32_t* size,
                                          float* mb, int64_t stride,
                                          int32_t k, const int32_t* rows,
                                          const int32_t* dest, int W,
                                          int32_t pad, float add_mb) {
  size[k] += 1;
  for (int w = 0; w < W; ++w) {
    cnt[rows[w] * stride + k] += 1;
    const int32_t d = dest[w];
    if (d < pad) {
      float* cell = mb + d * stride + k;
      *cell = __fadd_rn(*cell, add_mb);
    }
  }
}

// kW: the touched rows a move, fixed at compile time (1-8), so that a
// slot's test is a few independent loads and compares; 0 takes any W from
// the launch and reads the rows from global memory.
template <int kW>
__global__ void first_fit_kernel(const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ dest_rows,
                                 const float* __restrict__ size_mb,
                                 const int32_t* __restrict__ valid,
                                 const int32_t* __restrict__ caps,
                                 int32_t cluster_cap, float budget,
                                 int32_t* count_g, int32_t* size_g,
                                 float* mb_g, int32_t* __restrict__ assign,
                                 int32_t M, int32_t W_launch, int32_t K,
                                 int32_t B1, int32_t S) {
  const int W = kW > 0 ? kW : W_launch;
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = T >> 5;
  int32_t* warp_min = smem;                             // [2, 32]
  int32_t* caps_s = warp_min + 64;                      // [B1]
  int32_t* stage = caps_s + B1;                         // [2, chunk]
  const int cw = chunk_words(kW);
  int32_t* size_s = stage + 2 * cw;                     // [S]
  int32_t* count_s = size_s + S;                        // [B1, S]
  float* mb_s =
      reinterpret_cast<float*>(count_s + static_cast<int64_t>(B1) * S);

  stage_chunk(stage, rows, dest_rows, size_mb, valid, 0, M, kW);
  for (int r = t; r < B1; r += T) caps_s[r] = caps[r];
  for (int k = t; k < S; k += T) size_s[k] = 0;
  for (int64_t e = t; e < static_cast<int64_t>(B1) * S; e += T) {
    count_s[e] = 0;
    mb_s[e] = 0.0f;
  }

  const int32_t pad = B1 - 1;
  const int32_t chunks = (M + kChunk - 1) / kChunk;
  int32_t frontier = 0;                                 // F
  int buf = 0;                                          // warp_min buffer
  for (int32_t c = 0; c < chunks; ++c) {
    stage_chunk(stage + ((c + 1) & 1) * cw, rows, dest_rows, size_mb, valid,
                c + 1, M, kW);
    cp_async_wait_one();
    __syncthreads();
    const int32_t* cur_rows = stage + (c & 1) * cw;
    const int32_t* cur_dest = cur_rows + kChunk * kW;
    const float* cur_size =
        reinterpret_cast<const float*>(cur_rows + 2 * kChunk * kW);
    const int32_t* cur_valid = cur_rows + 2 * kChunk * kW + kChunk;
    const int n = M - c * kChunk < kChunk ? M - c * kChunk : kChunk;
    for (int ii = 0; ii < n; ++ii) {
      const int32_t i = c * kChunk + ii;
      if (cur_valid[ii] == 0) {
        if (t == 0) assign[i] = K;
        continue;
      }
      const float add_mb = cur_size[ii];
      const int32_t last = frontier < K - 1 ? frontier : K - 1;
      int32_t local = K;
      if constexpr (kW > 0) {
        // the move's rows (r), caps and destinations (d, -1: none)
        int32_t r[kW], cap[kW], d[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          r[w] = cur_rows[ii * kW + w];
          const int32_t dw = cur_dest[ii * kW + w];
          d[w] = dw < pad ? dw : -1;
        }
#pragma unroll
        for (int w = 0; w < kW; ++w) cap[w] = caps_s[r[w]];
        for (int32_t k = t; k <= last; k += T) {
          const bool ok =
              k < S ? slot_ok<kW>(count_s, size_s, mb_s, S, k, r, cap, d,
                                  cluster_cap, add_mb, budget)
                    : slot_ok<kW>(count_g, size_g, mb_g, K, k, r, cap, d,
                                  cluster_cap, add_mb, budget);
          if (ok) {
            local = k;
            break;
          }
        }
        local = winner(local, warp_min, buf, lane, warp, warps);
        if (t == 0) assign[i] = local;
        if (local == K) continue;
        if (local >= frontier) frontier = local + 1;
        if (t == local % T) {
          if (local < S) {
            apply<kW>(count_s, size_s, mb_s, S, local, r, d, add_mb);
          } else {
            apply<kW>(count_g, size_g, mb_g, K, local, r, d, add_mb);
          }
        }
      } else {
        const int32_t* mr = rows + static_cast<int64_t>(i) * W;
        const int32_t* md = dest_rows + static_cast<int64_t>(i) * W;
        for (int32_t k = t; k <= last; k += T) {
          const bool ok =
              k < S ? slot_ok_any(count_s, size_s, mb_s, S, k, mr, md, W,
                                  caps_s, pad, cluster_cap, add_mb, budget)
                    : slot_ok_any(count_g, size_g, mb_g, K, k, mr, md, W,
                                  caps_s, pad, cluster_cap, add_mb, budget);
          if (ok) {
            local = k;
            break;
          }
        }
        local = winner(local, warp_min, buf, lane, warp, warps);
        if (t == 0) assign[i] = local;
        if (local == K) continue;
        if (local >= frontier) frontier = local + 1;
        if (t == local % T) {
          if (local < S) {
            apply_any(count_s, size_s, mb_s, S, local, mr, md, W, pad, add_mb);
          } else {
            apply_any(count_g, size_g, mb_g, K, local, mr, md, W, pad, add_mb);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Shared memory of a launch with S slots in shared memory (the staged
// width: W for W = 1-8, else 0).
size_t shared_bytes(int64_t W, int64_t B1, int64_t S) {
  const int64_t staged = W >= 1 && W <= 8 ? W : 0;
  return (64 + static_cast<size_t>(B1) + 2 * chunk_words(staged) + S +
          2 * static_cast<size_t>(B1) * S) *
         sizeof(int32_t);
}

// The batch slots a launch keeps in shared memory: as many 32-slot groups
// as fit, at most K's; -1 when not even the fixed part fits.
int64_t slots_in_shared(int64_t W, int64_t K, int64_t B1) {
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  int64_t S = (K + 31) / 32 * 32;
  while (S > 0 && shared_bytes(W, B1, S) > static_cast<size_t>(optin)) S -= 32;
  return shared_bytes(W, B1, S) > static_cast<size_t>(optin) ? -1 : S;
}

struct Launch {
  const int32_t* rows;
  const int32_t* dest;
  const float* size_mb;
  const int32_t* valid;
  const int32_t* caps;
  int32_t cluster_cap;
  float budget;
  int32_t* count;
  int32_t* size;
  float* mb;
  int32_t* assign;
  int32_t M, W, K, B1, S;
};

template <int kW>
cudaError_t launch(const Launch& a, dim3 block, size_t shared,
                   cudaStream_t stream) {
  // raised once to the largest size asked for (not again while a CUDA
  // graph captures the launch)
  static size_t allowed = 48 * 1024;
  if (shared > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        first_fit_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    allowed = shared;
  }
  first_fit_kernel<kW><<<1, block, shared, stream>>>(
      a.rows, a.dest, a.size_mb, a.valid, a.caps, a.cluster_cap, a.budget,
      a.count, a.size, a.mb, a.assign, a.M, a.W, a.K, a.B1, a.S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int64_t cc_first_fit_shared_slots(int64_t W, int64_t K,
                                             int64_t B1) {
  return slots_in_shared(W, K, B1);
}

extern "C" int cc_first_fit(const void* rows, const void* dest_rows,
                            const void* size_mb, const void* valid,
                            const void* caps, int64_t cluster_cap,
                            float budget, void* count, void* size, void* mb,
                            void* assign, int64_t M, int64_t W, int64_t K,
                            int64_t B1, void* stream) {
  const int64_t S = slots_in_shared(W, K, B1);
  if (S < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = shared_bytes(W, B1, S);
  // one warp a 32 slots of K, at most kWarps (every slot of a frontier
  // below 32 x kWarps tested at once)
  int64_t warps = (K + 31) / 32 < kWarps ? (K + 31) / 32 : kWarps;
  if (warps < 1) warps = 1;
  if (M == 0) return static_cast<int>(cudaGetLastError());
  const Launch args{static_cast<const int32_t*>(rows),
                    static_cast<const int32_t*>(dest_rows),
                    static_cast<const float*>(size_mb),
                    static_cast<const int32_t*>(valid),
                    static_cast<const int32_t*>(caps),
                    static_cast<int32_t>(cluster_cap), budget,
                    static_cast<int32_t*>(count), static_cast<int32_t*>(size),
                    static_cast<float*>(mb), static_cast<int32_t*>(assign),
                    static_cast<int32_t>(M), static_cast<int32_t>(W),
                    static_cast<int32_t>(K), static_cast<int32_t>(B1),
                    static_cast<int32_t>(S)};
  const dim3 block(static_cast<unsigned>(32 * warps));
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (W) {
    case 1: err = launch<1>(args, block, shared, st); break;
    case 2: err = launch<2>(args, block, shared, st); break;
    case 3: err = launch<3>(args, block, shared, st); break;
    case 4: err = launch<4>(args, block, shared, st); break;
    case 5: err = launch<5>(args, block, shared, st); break;
    case 6: err = launch<6>(args, block, shared, st); break;
    case 7: err = launch<7>(args, block, shared, st); break;
    case 8: err = launch<8>(args, block, shared, st); break;
    default: err = launch<0>(args, block, shared, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
