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
//  - lower_bound: searchsorted(side="left") on a non-decreasing array.
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
constexpr int kMaxLevels = 12;

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
  int64_t nl[kMaxLevels];
  float* buf[kMaxLevels];
  int top = 0;
  nl[0] = n;
  buf[0] = out;
  int64_t off = 0;
  while (nl[top] > kScanBlock && top + 1 < kMaxLevels) {
    nl[top + 1] = (nl[top] + kScanBlock - 1) / kScanBlock;
    buf[top + 1] = scratch + off;
    off += nl[top + 1];
    ++top;
  }
  // up: each level's prefix sums within blocks of 16, its block totals
  // into the next level
  for (int l = 0; l <= top; ++l) {
    const int64_t m = nl[l];
    const int64_t blocks = (m + kScanBlock - 1) / kScanBlock;
    for (int64_t blk = g.rank(); blk < blocks; blk += g.size()) {
      float acc = 0.0f;
      const int64_t lo = blk * kScanBlock;
      const int64_t hi = lo + kScanBlock < m ? lo + kScanBlock : m;
      for (int64_t i = lo; i < hi; ++i) {
        acc = __fadd_rn(acc, l == 0 ? x(i) : buf[l][i]);
        buf[l][i] = acc;
      }
      if (l < top) buf[l + 1][blk] = acc;
    }
    g.sync();
  }
  // down: each block past the first adds the scanned total before it
  for (int l = top - 1; l >= 0; --l) {
    for (int64_t i = kScanBlock + g.rank(); i < nl[l]; i += g.size()) {
      buf[l][i] = __fadd_rn(buf[l][i], buf[l + 1][i / kScanBlock - 1]);
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
      float acc = 0.0f;
      for (int j = 0; j < kWindow; ++j) {
        const int64_t i = k * kWindow + j - front;
        if (i >= 0 && i < m) {
          acc = __fadd_rn(acc, src == nullptr ? x(i) : src[i]);
        }
      }
      dst[k] = acc;
    }
    g.sync();
    src = dst;
    off += w;
    m = w;
  }
  float acc = 0.0f;
  for (int64_t i = 0; i < m; ++i) {
    acc = __fadd_rn(acc, src == nullptr ? x(i) : src[i]);
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

// torch.clamp(x, min=0.0) (NaN stays NaN).
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// The row a JAX gather reads for index i along an axis of n: clamped.
__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

}  // namespace ordered
