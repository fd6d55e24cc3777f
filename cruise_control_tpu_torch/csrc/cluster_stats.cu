// KG: cluster statistics over the alive brokers, and the replica and
// leader counts, in one launch.
//
// Seven columns of per-broker values — utilization of the four resources,
// replica count, leader count, potential NW_OUT — each reduced over the
// brokers whose alive mask is set to
//   avg = sum(v) / n,  std = sqrt(sum((v - avg)^2) / n),  max(v),  min(v)
// with n = max(number alive, 1); dead and padding brokers count as 0 in
// the sums, -inf in the max and +inf in the min. Beside them: the alive
// count, the set slots of replica_valid [P, R] and of partition_valid [P].
// One output buffer of 31 words: the [4, 7] table (float32, rows avg,
// std, max, min), then the three counts (int32).
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
// (NaN propagates, as in jnp.max); integer counts are exact in any order.
//
// Bound on the card: a chain of dependent adds and barriers. The bytes
// (B x 29 for the columns and the mask, P x (R + 1) mask bytes) are a few
// tens of KB at the main path's shapes, far below a launch's cost. So the
// design keeps the chain short and off global memory. The launch is one
// cluster of 8 blocks of 1,024 threads. Block 0 computes the statistics:
// it stages the columns in shared memory in one coalesced pass (util as
// 16-byte loads, a window's alive mask as one word of bits: the ballot of
// the warp that stages it); both tree sums (the sum, then the squares
// about the mean) then read only shared memory. A thread owns a (column,
// window) pair of a level and adds its 32 values in order, without a
// branch (a cleared mask bit selects 0; each pass has its own code); in
// the first pass it also takes the window's max and min, and the alive
// count adds the windows' popcounts. Shared arrays put one unused word
// after every 32 (index i at i + i / 32), so the 32 threads of a warp,
// each walking its own window, read 32 different banks. Only the windows'
// results are reduced across threads: a warp a column for max and min,
// beside the upper levels of the sums. Blocks 1-7 count the masks
// meanwhile, on their own SMs (block 0 alone took about 7 us to stream
// the 600 KB of the scale cell's masks): popcounts of 16-byte loads (a
// bool is one byte, 0 or 1), four in flight a thread, summed by warp
// reductions; each block stores its totals into block 0's shared memory
// (distributed shared memory), and block 0 waits for them on the cluster
// barrier only at its end.
//
// Any broker count: the first level is staged chunk by chunk (chunk edges
// on window edges, counted from -front), so a column need not fit in
// shared memory; with more than one chunk the squares pass stages each
// chunk again. Level sums live in shared memory, or, past what it holds
// beside the stage (past about 27,000 brokers), in a global scratch
// buffer the wrapper allocates.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 7;
constexpr int kWindow = 32;
constexpr int kThreads = 1024;
// blocks of the launch's one cluster: block 0 the statistics, the others
// the mask counts
constexpr int kCluster = 8;
// a window's 32 adds, unrolled
constexpr int kWindowUnroll = 32;
// first-level windows staged at once: 5,120 brokers, 153 KB
constexpr int64_t kStageWindows = 160;
// dynamic shared memory a block may use beside the static arrays
constexpr int64_t kSharedBytes = 232448 - 4096;

__host__ __device__ int64_t padded(int64_t i) { return i + (i >> 5); }

// words an array of n entries takes in the padded layout
__host__ __device__ int64_t padded_len(int64_t n) {
  return n + (n >> 5) + 1;
}

__host__ __device__ int64_t round16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}

struct Plan {
  int64_t windows;        // first-level windows (1 when B <= 32)
  int64_t front;          // padding positions in front of broker 0
  int64_t stage_windows;  // windows staged at once
  int64_t stage_len;      // padded words a staged column takes
  int64_t level_a;        // padded words of a column in each first-level
                          // array: sums, window maxima, window minima
  int64_t level_b;        // ... in the second level's sums
  int64_t stage_bytes;
  int64_t level_bytes;
  bool levels_shared;
};

Plan make_plan(int64_t num_brokers) {
  Plan p;
  p.windows = num_brokers > kWindow
                  ? (num_brokers + kWindow - 1) / kWindow : 1;
  p.front = num_brokers > kWindow
                ? (p.windows * kWindow - num_brokers) / 2 : 0;
  p.stage_windows = p.windows < kStageWindows ? p.windows : kStageWindows;
  p.stage_len = padded_len(p.stage_windows * kWindow);
  p.level_a = padded_len(p.windows);
  p.level_b = padded_len((p.windows + kWindow - 1) / kWindow);
  p.stage_bytes = round16((kCols * p.stage_len + p.stage_windows) * 4);
  p.level_bytes = kCols * (3 * p.level_a + p.level_b) * 4;
  p.levels_shared = p.stage_bytes + p.level_bytes <= kSharedBytes;
  return p;
}

struct Args {
  const float* util;        // [B, 4], 16-byte aligned
  const int32_t* replicas;  // [B]
  const int32_t* leaders;   // [B]
  const float* potential;   // [B]
  const uint8_t* alive;     // [B]
  const uint8_t* replica_valid;    // [P * R]
  const uint8_t* partition_valid;  // [P]
  float* out;               // [31]
  float* scratch;           // level arrays when they leave shared memory
  int64_t num_brokers, replica_slots, partitions;
  Plan plan;
};

__device__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// The cluster barrier in two halves (every thread of every block arrives,
// then waits): arriving orders this thread's writes before the other
// blocks' reads after their wait (relaxed: orders nothing, for a phase
// that only says the block is running).
__device__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// set bytes of n bools, the share of thread t of `threads`, four 16-byte
// loads in flight at a time
__device__ uint32_t count_set(const uint8_t* p, int64_t n, int t,
                              int threads) {
  constexpr int kInFlight = 4;
  const int64_t misaligned = reinterpret_cast<uintptr_t>(p) & 15;
  const int64_t head = misaligned == 0 ? 0
                       : (16 - misaligned < n ? 16 - misaligned : n);
  const int64_t body = (n - head) / 16;
  uint32_t acc = 0;
  for (int64_t i = t; i < head; i += threads) acc += p[i] != 0;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int64_t i0 = t; i0 < body; i0 += kInFlight * threads) {
    uint4 x[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int64_t i = i0 + static_cast<int64_t>(k) * threads;
      x[k] = i < body ? v[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      acc += __popc(x[k].x) + __popc(x[k].y) + __popc(x[k].z) +
             __popc(x[k].w);
    }
  }
  for (int64_t i = head + body * 16 + t; i < n; i += threads) {
    acc += p[i] != 0;
  }
  return acc;
}

// Stage first-level windows [w0, w0 + cw) of every column: position s of
// the stage holds broker w0 * 32 - front + s (0 and a clear mask bit
// outside [0, B)); a warp stages whole windows, so its ballot is the
// window's mask word. A thread loads two positions before it stores.
__device__ void stage(const Args& a, float* sv, uint32_t* sm, int64_t w0,
                      int cw) {
  constexpr int kInFlight = 2;
  const int64_t g0 = w0 * kWindow - a.plan.front;
  const int len = static_cast<int>(a.plan.stage_len);
  const int positions = cw * kWindow;
  for (int s0 = threadIdx.x; s0 < positions; s0 += kInFlight * kThreads) {
    float v[kInFlight][kCols];
    bool alive[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int s = s0 + k * kThreads;
      const int64_t g = g0 + s;
      alive[k] = false;
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[k][c] = 0.0f;
      if (s < positions && g >= 0 && g < a.num_brokers) {
        const float4 u = reinterpret_cast<const float4*>(a.util)[g];
        v[k][0] = u.x;
        v[k][1] = u.y;
        v[k][2] = u.z;
        v[k][3] = u.w;
        v[k][4] = static_cast<float>(a.replicas[g]);
        v[k][5] = static_cast<float>(a.leaders[g]);
        v[k][6] = a.potential[g];
        alive[k] = a.alive[g] != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int s = s0 + k * kThreads;
      if (s < positions) {          // whole warps: positions is 32 * cw
        const int p = s + s / kWindow;
#pragma unroll
        for (int c = 0; c < kCols; ++c) sv[c * len + p] = v[k][c];
        const uint32_t bits = __ballot_sync(0xffffffffu, alive[k]);
        if (threadIdx.x % kWindow == 0) sm[s / kWindow] = bits;
      }
    }
  }
}

// A window of 32 staged values v (alive where `bits` is set) summed in
// order from 0: the values, taking their max and min into big and small,
// or (kSquares) the squares of their differences from m. A cleared bit
// selects 0; the pass is a template argument, so the unrolled adds carry
// no branch (a branch an element, with its reconvergence, cost ~90 cycles
// an element).
template <bool kSquares>
__device__ float window_sum(const float* v, uint32_t bits, float m,
                            float& big, float& small) {
  float acc = 0.0f;
#pragma unroll kWindowUnroll
  for (int j = 0; j < kWindow; ++j) {
    const bool on = (bits >> j) & 1u;
    const float y = v[j];
    float x;
    if (kSquares) {
      const float d = __fsub_rn(y, m);
      x = on ? __fmul_rn(d, d) : 0.0f;
    } else {
      x = on ? y : 0.0f;
      big = on ? max_nan(big, y) : big;
      small = on ? min_nan(small, y) : small;
    }
    acc = __fadd_rn(acc, x);
  }
  return acc;
}

// The levels above the first, in XLA's order, over `windows` first-level
// sums per column in `src`; column c's total lands in total[c].
__device__ void reduce_levels(float* src, int64_t src_len, float* dst,
                              int64_t dst_len, int64_t windows,
                              float* total) {
  int64_t n = windows;
  while (n > kWindow) {
    const int64_t w_next = (n + kWindow - 1) / kWindow;
    const int64_t front = (w_next * kWindow - n) / 2;
    for (int64_t item = threadIdx.x; item < kCols * w_next;
         item += kThreads) {
      const int64_t c = item / w_next;
      const int64_t w = item - c * w_next;
      const float* col = src + c * src_len;
      float acc = 0.0f;
#pragma unroll kWindowUnroll
      for (int j = 0; j < kWindow; ++j) {
        const int64_t i = w * kWindow + j - front;
        acc = __fadd_rn(acc, (i >= 0 && i < n) ? col[padded(i)] : 0.0f);
      }
      dst[c * dst_len + padded(w)] = acc;
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
    const int64_t l = src_len;
    src_len = dst_len;
    dst_len = l;
    n = w_next;
  }
  if (threadIdx.x < kCols) {
    const float* col = src + threadIdx.x * src_len;
    float acc = 0.0f;
    for (int64_t i = 0; i < n; ++i) acc = __fadd_rn(acc, col[padded(i)]);
    total[threadIdx.x] = acc;
  }
  __syncthreads();
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1) cluster_stats_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char shared[];
  // block 0's: each counting block's two totals, stored by that block
  __shared__ uint32_t block_slots[kCluster][2];
  __shared__ uint32_t warp_slots[kThreads / kWindow][2];
  __shared__ int alive_count;
  __shared__ float mean[kCols];
  __shared__ float total[kCols];
  __shared__ float n_alive;

  const Plan& plan = a.plan;
  const int len = static_cast<int>(plan.stage_len);
  float* sv = reinterpret_cast<float*>(shared);
  uint32_t* sm = reinterpret_cast<uint32_t*>(sv + kCols * len);
  float* level_a = plan.levels_shared
                       ? reinterpret_cast<float*>(shared + plan.stage_bytes)
                       : a.scratch;
  float* win_max = level_a + kCols * plan.level_a;
  float* win_min = win_max + kCols * plan.level_a;
  float* level_b = win_min + kCols * plan.level_a;
  const int lane = threadIdx.x % kWindow;
  const int warp = threadIdx.x / kWindow;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  // first barrier phase: a block touches another's shared memory only
  // after every block of the cluster has arrived (is running)
  cluster_arrive_relaxed();
  if (rank != 0) {
    // the mask counts, spread over the other blocks' SMs, each block's
    // totals stored into block 0's shared memory
    const int t = (rank - 1) * kThreads + threadIdx.x;
    constexpr int threads = (kCluster - 1) * kThreads;
    const uint32_t r = __reduce_add_sync(
        0xffffffffu, count_set(a.replica_valid, a.replica_slots, t, threads));
    const uint32_t q = __reduce_add_sync(
        0xffffffffu, count_set(a.partition_valid, a.partitions, t, threads));
    if (lane == 0) {
      warp_slots[warp][0] = r;
      warp_slots[warp][1] = q;
    }
    __syncthreads();
    cluster_wait();
    if (warp == 0) {
      const uint32_t r_block = __reduce_add_sync(
          0xffffffffu, lane < kThreads / kWindow ? warp_slots[lane][0] : 0);
      const uint32_t q_block = __reduce_add_sync(
          0xffffffffu, lane < kThreads / kWindow ? warp_slots[lane][1] : 0);
      if (lane == 0) {
        uint32_t* dst = cluster.map_shared_rank(&block_slots[rank][0], 0);
        dst[0] = r_block;
        dst[1] = q_block;
      }
    }
    cluster_arrive();               // block 0 reads the totals after it
    cluster_wait();
    return;
  }
  if (threadIdx.x == 0) alive_count = 0;

  const int64_t chunks =
      (plan.windows + plan.stage_windows - 1) / plan.stage_windows;
  for (int pass = 0; pass < 2; ++pass) {
    for (int64_t ch = 0; ch < chunks; ++ch) {
      const int64_t w0 = ch * plan.stage_windows;
      const int cw = static_cast<int>(
          plan.windows - w0 < plan.stage_windows ? plan.windows - w0
                                                 : plan.stage_windows);
      if (pass == 0 || chunks > 1) {
        __syncthreads();            // the stage's last readers are done
        stage(a, sv, sm, w0, cw);
        __syncthreads();
      }
      // a thread a (column, window)
      for (int item = threadIdx.x; item < kCols * cw; item += kThreads) {
        const int c = item / cw;
        const int w = item - c * cw;
        const float* v = sv + c * len + w * (kWindow + 1);
        const uint32_t bits = sm[w];
        const int64_t at = c * plan.level_a + padded(w0 + w);
        float big = -INFINITY, small = INFINITY;
        if (pass == 0) {
          level_a[at] = window_sum<false>(v, bits, 0.0f, big, small);
          win_max[at] = big;
          win_min[at] = small;
          if (c == 0) atomicAdd(&alive_count, __popc(bits));
        } else {
          level_a[at] = window_sum<true>(v, bits, mean[c], big, small);
        }
      }
    }
    __syncthreads();
    if (pass == 0 && warp >= 1 && warp <= kCols) {
      // warp c + 1 a column c: the windows' maxima and minima, beside
      // warp 0's upper levels
      const int c = warp - 1;
      float big = -INFINITY, small = INFINITY;
      for (int64_t w = lane; w < plan.windows; w += kWindow) {
        const int64_t at = c * plan.level_a + padded(w);
        big = max_nan(big, win_max[at]);
        small = min_nan(small, win_min[at]);
      }
      for (int offset = kWindow / 2; offset > 0; offset /= 2) {
        big = max_nan(big, __shfl_down_sync(0xffffffffu, big, offset));
        small = min_nan(small, __shfl_down_sync(0xffffffffu, small, offset));
      }
      if (lane == 0) {
        a.out[2 * kCols + c] = big;
        a.out[3 * kCols + c] = small;
      }
    } else if (pass == 0 && threadIdx.x == (kCols + 1) * kWindow) {
      reinterpret_cast<int32_t*>(a.out)[4 * kCols] = alive_count;
      n_alive = static_cast<float>(alive_count > 1 ? alive_count : 1);
    }
    reduce_levels(level_a, plan.level_a, level_b, plan.level_b,
                  plan.windows, total);
    if (pass == 0) {
      if (threadIdx.x < kCols) {
        mean[threadIdx.x] = __fdiv_rn(total[threadIdx.x], n_alive);
        a.out[threadIdx.x] = mean[threadIdx.x];
      }
      __syncthreads();
    } else if (threadIdx.x < kCols) {
      a.out[kCols + threadIdx.x] =
          __fsqrt_rn(__fdiv_rn(total[threadIdx.x], n_alive));
    }
  }
  // the counting blocks' totals, waited for last: they count while this
  // block computes the statistics
  cluster_wait();
  cluster_arrive_relaxed();
  cluster_wait();
  if (threadIdx.x < 2) {
    unsigned long long slots = 0;
    for (int b = 1; b < kCluster; ++b) slots += block_slots[b][threadIdx.x];
    reinterpret_cast<int32_t*>(a.out)[4 * kCols + 1 + threadIdx.x] =
        static_cast<int32_t>(slots);
  }
}

}  // namespace

// bytes of global scratch the wrapper allocates for B brokers (0 when the
// level sums fit in shared memory beside the stage)
extern "C" int64_t cc_cluster_stats_scratch(int64_t num_brokers) {
  const Plan p = make_plan(num_brokers);
  return p.levels_shared ? 0 : p.level_bytes;
}

extern "C" int cc_cluster_stats(const void* util, const void* replicas,
                                const void* leaders, const void* potential,
                                const void* alive, const void* replica_valid,
                                int64_t replica_slots,
                                const void* partition_valid,
                                int64_t partitions, void* out, void* scratch,
                                int64_t num_brokers, void* stream) {
  const Plan plan = make_plan(num_brokers);
  const int64_t shared =
      plan.stage_bytes + (plan.levels_shared ? plan.level_bytes : 0);
  // raised once to the largest size asked for (not again while a CUDA
  // graph captures the launch)
  static int64_t allowed = 48 * 1024;
  if (shared > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = shared;
  }
  const Args args{static_cast<const float*>(util),
                  static_cast<const int32_t*>(replicas),
                  static_cast<const int32_t*>(leaders),
                  static_cast<const float*>(potential),
                  static_cast<const uint8_t*>(alive),
                  static_cast<const uint8_t*>(replica_valid),
                  static_cast<const uint8_t*>(partition_valid),
                  static_cast<float*>(out), static_cast<float*>(scratch),
                  num_brokers, replica_slots, partitions, plan};
  cluster_stats_kernel<<<kCluster, kThreads, static_cast<size_t>(shared),
                         static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
