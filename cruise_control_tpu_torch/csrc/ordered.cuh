// The reference's fixed float orders on the card (utils/ordered.py), for
// the goal-pass kernels (apply_group.cu, eligibility.cu,
// flow_candidates.cu, drain_fill.cu), over a group of threads that is a
// warp, a block or a whole cluster:
//  - scan16: XLA's CPU cumulative sum (utils/ordered.py:scan_sum):
//    sequential prefix sums in blocks of 16 from 0.0, the block totals
//    scanned the same way, each block's carry added after;
//  - tree_sum: XLA's CPU reduction (tree_sum): windows of 32, the padding
//    split evenly in front and behind, each window summed in order from
//    0.0, repeated until at most 32 partial sums remain, summed in order;
//  - rank_sort: a stable ascending argsort (the lower index first among
//    ties, -0.0 equal to +0.0, as torch.sort(stable=True) compares);
//  - lower_bound: searchsorted(side="left") on a non-decreasing array;
//  - stream_rows: a warp's in-order walk over rows in global memory,
//    copied ahead through a ring in shared memory.
// The sources that include this are compiled with -fmad=false: every add
// and product rounds on its own, as in the reference's program.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace ordered {

namespace cg = cooperative_groups;

constexpr int kScanBlock = 16;
constexpr int kWindow = 32;

// The threads of one warp.
struct Warp {
  __device__ int64_t rank() const { return threadIdx.x & 31; }
  __device__ int64_t size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// The threads of one block.
struct Block {
  __device__ int64_t rank() const { return threadIdx.x; }
  __device__ int64_t size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

// Every thread of a launch whose grid is one thread-block cluster: the
// barrier orders global memory across the cluster's blocks (a fence at
// device scope, then the cluster's release/acquire barrier).
struct Cluster {
  __device__ int64_t rank() const {
    return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  __device__ int64_t size() const {
    return static_cast<int64_t>(gridDim.x) * blockDim.x;
  }
  __device__ void sync() const {
    __threadfence();
    cg::this_cluster().sync();
  }
};

// Floats of scratch scan16 needs for n elements (its upper levels).
__host__ __device__ inline int64_t scan_scratch(int64_t n) {
  int64_t s = 0;
  while (n > kScanBlock) {
    n = (n + kScanBlock - 1) / kScanBlock;
    s += n;
  }
  return s;
}

// Floats of scratch tree_sum needs for n elements (its levels).
__host__ __device__ inline int64_t tree_scratch(int64_t n) {
  int64_t s = 0;
  while (n > kWindow) {
    n = (n + kWindow - 1) / kWindow;
    s += n;
  }
  return s;
}

// out[i] = inclusive scan_sum of x(0..n) in XLA's order. ``x`` is a
// device functor of the index; ``out`` and ``scratch``
// (scan_scratch(n) floats) are visible to the whole group. Ends with the
// group's barrier.
template <class G, class In>
__device__ void scan16(const G& g, In x, float* out, int64_t n,
                       float* scratch) {
  // (the levels are walked with scalars -- level l has ceil(n / 16^l)
  // values, level 0 in ``out``, the others back to back in ``scratch`` --
  // so nothing lives in local memory; a block's 16 values are loaded
  // before its adds, every load at an index in range)
  // up: each level's prefix sums within blocks of 16, its block totals
  // into the next level
  int top = 0;
  {
    int64_t m = n;
    float* cur = out;
    float* next = scratch;
    for (;;) {
      const int64_t blocks = (m + kScanBlock - 1) / kScanBlock;
      const bool more = m > kScanBlock;
      for (int64_t blk = g.rank(); blk < blocks; blk += g.size()) {
        const int64_t lo = blk * kScanBlock;
        const int cnt = static_cast<int>(m - lo < kScanBlock ? m - lo
                                                             : kScanBlock);
        float v[kScanBlock];
#pragma unroll
        for (int j = 0; j < kScanBlock; ++j) {
          const int64_t i = lo + (j < cnt ? j : cnt - 1);   // no branch
          v[j] = top == 0 ? x(i) : cur[i];
        }
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kScanBlock; ++j) {
          if (j < cnt) {
            acc = __fadd_rn(acc, v[j]);
            cur[lo + j] = acc;
          }
        }
        if (more) next[blk] = acc;
      }
      g.sync();
      if (!more) break;
      cur = next;
      next += blocks;
      m = blocks;
      ++top;
    }
  }
  // down: each block past the first adds the scanned total before it,
  // from the level below the top to level 0
  for (int l = top - 1; l >= 0; --l) {
    int64_t m = n, off = 0;                // level l's size, level l + 1's
    for (int k = 1; k <= l; ++k) {
      m = (m + kScanBlock - 1) / kScanBlock;
      off += m;
    }
    float* cur = l == 0 ? out : scratch + (off - m);
    const float* up = scratch + off;
    for (int64_t i = kScanBlock + g.rank(); i < m; i += g.size()) {
      cur[i] = __fadd_rn(cur[i], up[i / kScanBlock - 1]);
    }
    g.sync();
  }
}

// tree_sum of x(0..n) in XLA's order, returned to every thread of the
// group (each adds the last <= 32 partial sums itself). ``scratch``
// (tree_scratch(n) floats) is visible to the whole group.
template <class G, class In>
__device__ float tree_sum(const G& g, In x, int64_t n, float* scratch) {
  const float* src = nullptr;
  int64_t m = n;
  int64_t off = 0;
  while (m > kWindow) {
    const int64_t w = (m + kWindow - 1) / kWindow;
    const int64_t front = (w * kWindow - m) / 2;
    float* dst = scratch + off;
    for (int64_t k = g.rank(); k < w; k += g.size()) {
      // the window's values loaded before its adds
      float v[kWindow];
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        int64_t i = k * kWindow + j - front;
        i = i < 0 ? 0 : (i < m ? i : m - 1);               // no branch
        v[j] = src == nullptr ? x(i) : src[i];
      }
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        const int64_t i = k * kWindow + j - front;
        if (i >= 0 && i < m) acc = __fadd_rn(acc, v[j]);
      }
      dst[k] = acc;
    }
    g.sync();
    src = dst;
    off += w;
    m = w;
  }
  if (m <= 0) return 0.0f;
  float v[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int64_t i = j < m ? j : m - 1;
    v[j] = src == nullptr ? x(i) : src[i];
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    if (j < m) acc = __fadd_rn(acc, v[j]);
  }
  return acc;
}

// order[r] = the index of the r-th smallest key(0..n), stable. Ends with
// the group's barrier.
template <class G, class Key>
__device__ void rank_sort(const G& g, Key key, int64_t n, int64_t* order) {
  for (int64_t i = g.rank(); i < n; i += g.size()) {
    const float k = key(i);
    int64_t r = 0;
    for (int64_t j = 0; j < n; ++j) {
      const float kj = key(j);
      r += (kj < k) || (kj == k && j < i);
    }
    order[r] = i;
  }
  g.sync();
}

// The first index i of the non-decreasing a[0..n) with a[i] >= v (n if
// none): torch.searchsorted(a, v) (side "left").
__device__ __forceinline__ int64_t lower_bound(const float* a, int64_t n,
                                               float v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// An asynchronous copy of kBytes (4, 8 or 16, aligned so) from global to
// shared memory.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(gmem), "n"(kBytes));
  }
}

// A warp's in-order walk over rows of kStride floats in global memory
// (``src``), handed out in chunks of at most 32 rows by ``next(row0)``
// (the chunk's row count, 0 at the end; called in order, the same on every
// lane). The chunks flow through ``ring`` (kRing chunks of 32 x kStride
// floats in shared memory, 16-byte aligned; ``ring_n`` kRing ints), kRing
// - 1 asynchronous copies in flight; each lane reads column (lane %
// kStride) of the next chunk's rows into registers while it adds the
// current chunk's, so a row costs one dependent ``add(value)`` and no
// exposed load. Every lane of the warp calls it.
template <int kStride, int kRing, class Next, class Add>
__device__ void stream_rows(const float* src, float* ring, int* ring_n,
                            Next next, Add add) {
  constexpr int kChunk = 32 * kStride;
  constexpr int kBytes = kStride % 4 == 0 ? 16 : 4;
  constexpr int kFloats = kBytes / 4;
  const int lane = threadIdx.x & 31;
  const int col = lane % kStride;
  auto fetch = [&](int slot) {
    int64_t row0 = 0;
    const int n = next(row0);
    if (lane == 0) ring_n[slot] = n;
    const float* g = src + row0 * kStride;
    float* s = ring + slot * kChunk;
    for (int q = lane; q * kFloats < n * kStride; q += 32) {
      cp_async<kBytes>(s + q * kFloats, g + q * kFloats);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // add chunk ``n`` rows of ``cur`` in order while reading the next
  // chunk's column (``from``) into ``nxt``
  auto step = [&](const float (&cur)[32], int n, float (&nxt)[32],
                  const float* from) {
    if (n == 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        add(cur[j]);
        nxt[j] = from[j * kStride];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < n) add(cur[j]);
        nxt[j] = from[j * kStride];
      }
    }
  };
  for (int d = 0; d < kRing - 1; ++d) fetch(d);
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 2));
  __syncwarp();
  float a[32], b[32];
  int na = ring_n[0];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = ring[col + j * kStride];
  for (int k = 0; na > 0; k += 2) {
    // chunk k in a, chunk k + 1 into b; the chunk kRing - 1 ahead into
    // the slot of chunk k - 1, read one step ago
    fetch((k + kRing - 1) % kRing);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 2));
    __syncwarp();
    const int nb = ring_n[(k + 1) % kRing];
    step(a, na, b, ring + ((k + 1) % kRing) * kChunk + col);
    __syncwarp();
    if (nb == 0) break;
    fetch((k + kRing) % kRing);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kRing - 2));
    __syncwarp();
    const int nn = ring_n[(k + 2) % kRing];
    step(b, nb, a, ring + ((k + 2) % kRing) * kChunk + col);
    __syncwarp();
    na = nn;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// torch.clamp(x, min=0.0) (NaN stays NaN).
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// The row a JAX gather reads for index i along an axis of n: clamped.
__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

}  // namespace ordered
