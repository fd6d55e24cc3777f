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
//    copied ahead through a ring in shared memory;
//  - vector_loop_sum: one thread's sum in the order of LLVM's vectorized
//    reduction loop over a goal's fused violation row
//    (utils/ordered.py:vector_loop_sum, _fold_halves);
//  - small_sum / matrix_sum: XLA's eager order of a whole matrix, its
//    windows' lanes (utils/ordered.py:_lanes, _small_sums, matrix_sum);
//  - topic_rows_sum / topic_lanes_sum: the fused loops of the topic goal's
//    [T, B1] cells within 32 x 32 (utils/ordered.py:_topic_loop,
//    topic_cell_sum).
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

// torch.clamp(x, min=0.0) (NaN stays NaN).
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// The row a JAX gather reads for index i along an axis of n: clamped.
__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

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

// x86's lowering of a reassoc llvm.vector.reduce.fadd over w lanes (a
// power of two): folded by halves -- lanes 0-3 + 4-7, then 0-1 + 2-3, then
// 0 + 1 (utils/ordered.py:_fold_halves). Overwrites ``lanes``.
__device__ __forceinline__ float fold_halves(float* lanes, int w) {
  while (w > 1) {
    w >>= 1;
    for (int i = 0; i < w; ++i) lanes[i] = __fadd_rn(lanes[i], lanes[i + w]);
  }
  return lanes[0];
}

// The most lanes a vector loop keeps (VF x IC: 8 x 4 at most was read).
constexpr int kMaxLoopLanes = 32;

// One thread's sum of x(0..n) in the order of LLVM's vectorized
// reduction loop (utils/ordered.py:vector_loop_sum): ``ic`` accumulators
// of ``vf`` lanes over the whole vf * ic chunks (at least ``tail``
// elements left for the scalar loop), the running total ``seed`` (XLA's
// init 0.0) in lane 0 of the first, the accumulators combined in order
// and folded by halves; an ``epi``-lane epilogue seeded with that total
// (the other lanes -0.0); then the rest in order. An add of -0.0 changes
// no value, so the other lanes of the first accumulator start at the
// chunk's elements themselves.
template <class In>
__device__ __forceinline__ float vector_loop_sum(In x, int n, int vf, int ic, int epi,
                                 int tail, float seed) {
  float total = seed;
  int pos = 0;
  const int chunk = vf * ic;
  const int iters = vf > 1 ? (n - tail) / chunk : 0;
  if (iters > 0) {
    float acc[kMaxLoopLanes];
    for (int j = 0; j < chunk; ++j) acc[j] = x(j);
    acc[0] = __fadd_rn(acc[0], total);
    for (int it = 1; it < iters; ++it) {
      for (int j = 0; j < chunk; ++j) {
        acc[j] = __fadd_rn(acc[j], x(it * chunk + j));
      }
    }
    for (int k = 1; k < ic; ++k) {
      for (int l = 0; l < vf; ++l) acc[l] = __fadd_rn(acc[l], acc[k * vf + l]);
    }
    total = fold_halves(acc, vf);
    pos = iters * chunk;
  }
  if (epi > 0 && n - pos - tail >= epi) {
    float lanes[kMaxLoopLanes];
    lanes[0] = total;
    for (int l = 1; l < epi; ++l) lanes[l] = -0.0f;
    while (n - pos - tail >= epi) {
      for (int l = 0; l < epi; ++l) lanes[l] = __fadd_rn(lanes[l], x(pos + l));
      pos += epi;
    }
    total = fold_halves(lanes, epi);
  }
  for (; pos < n; ++pos) total = __fadd_rn(total, x(pos));
  return total;
}

// Accumulators XLA's CPU backend gives an eager sum of a [b, d] matrix (2
// <= b, d <= 32; utils/ordered.py:_lanes): 1 is in order from zero.
__host__ __device__ inline int eager_lanes(int b, int d) {
  if (d >= 9) return 1;
  if (b < 16) return (b == 2 || b == 4 || b == 8) ? b : 1;
  if (d >= 7) return 4;
  return (b % 8 < 4 || (d == 2 && b >= 28)) ? 8 : 4;
}

// One thread's eager sum of a [b, d] matrix get(i, j) (2 <= b, d <= 32;
// utils/ordered.py:_small_sums): f = eager_lanes accumulators, lane l
// adding rows l, l + f, ... of the whole f-row groups in order from 0.0,
// folded by halves, then the leftover rows' elements in order; ``split``:
// the last row is a window's peeled row, so the lanes cover the first b - 1
// rows' groups only.
template <class Get>
__device__ __forceinline__ float small_sum(Get get, int b, int d, bool split) {
  const int rows = split ? b - 1 : b;
  const int f = eager_lanes(rows, d);
  const int full = f > 1 ? rows / f * f : 0;
  float total = 0.0f;
  if (full > 0) {
    float acc[8];
    for (int l = 0; l < f; ++l) acc[l] = 0.0f;
    for (int i = 0; i < full; ++i) {
      for (int j = 0; j < d; ++j) {
        acc[i % f] = __fadd_rn(acc[i % f], get(i, j));
      }
    }
    total = __fadd_rn(total, fold_halves(acc, f));
  }
  for (int i = full; i < b; ++i) {
    for (int j = 0; j < d; ++j) total = __fadd_rn(total, get(i, j));
  }
  return total;
}

// Floats of scratch matrix_sum needs for a [B, D] matrix: its window
// levels back to back, the last vector's tree levels, one broadcast slot.
__host__ __device__ inline int64_t matrix_scratch(int64_t B, int64_t D) {
  int64_t s = 1;
  while (B > 1 && D > 1 && (B > kWindow || D > kWindow)) {
    const int64_t wb = B < kWindow ? B : kWindow;
    const int64_t wd = D < kWindow ? D : kWindow;
    B = (B + wb - 1) / wb;
    D = (D + wd - 1) / wd;
    s += B * D;
  }
  return s + tree_scratch(B * D);
}

// One window's sum in XLA's eager matrix order (utils/ordered.py:
// _matrix_sums), from elem(i, j) (0.0 on the padding): in row order from
// zero where the window holds padding, but with one padding column (pd 1)
// the first wd - 1 columns in row order then the last column down the
// rows, and with one padding row and no padding column a small_sum with
// its last row peeled; without padding a small_sum.
template <class Elem>
__device__ __forceinline__ float window_sum(Elem elem, int64_t wb,
                                            int64_t wd, int64_t pb,
                                            int64_t pd) {
  float acc = 0.0f;
  if (pd == 1) {
    for (int64_t i = 0; i < wb; ++i) {
      for (int64_t j = 0; j + 1 < wd; ++j) acc = __fadd_rn(acc, elem(i, j));
    }
    for (int64_t i = 0; i < wb; ++i) acc = __fadd_rn(acc, elem(i, wd - 1));
  } else if (pb == 1 && pd == 0) {
    acc = small_sum(elem, static_cast<int>(wb), static_cast<int>(wd), true);
  } else if (pb != 0 || pd != 0) {
    for (int64_t i = 0; i < wb; ++i) {
      for (int64_t j = 0; j < wd; ++j) acc = __fadd_rn(acc, elem(i, j));
    }
  } else {
    acc = small_sum(elem, static_cast<int>(wb), static_cast<int>(wd), false);
  }
  return acc;
}

// Whether window_sum adds a [wb, wd] window with padding (pb, pd) in
// row order from one running total: no peeled last column and no vector
// lanes (every window wider than 8 columns).
__host__ __device__ inline bool window_in_row_order(int64_t wb, int64_t wd,
                                                    int64_t pb, int64_t pd) {
  if (pd == 1) return false;
  if (pb == 1 && pd == 0) {
    return eager_lanes(static_cast<int>(wb - 1), static_cast<int>(wd)) == 1;
  }
  if (pb != 0 || pd != 0) return true;
  return eager_lanes(static_cast<int>(wb), static_cast<int>(wd)) == 1;
}

// matrix_sum's first level where every window adds in row order
// (window_in_row_order) and a thread of the block can take each: a
// thread a window, its running total in a register. The block stages
// ``k`` rows of every window at a time into ``stage`` (a window's k rows
// back to back, one float of padding between windows so the threads'
// reads fall in distinct banks; a warp a row of a band of windows, kLoads
// loads a lane in flight, no division an element), then each thread adds
// its window's staged rows in order. Every window's
// chain runs at once (a window's 1,024 adds are one dependent chain, in
// XLA's order), where a warp a window ran 16 chains. Returns false (and
// does nothing) where the windows outnumber the threads or ``stage``
// (``cap`` floats) cannot hold one row of every window. Ends with the
// block's barrier.
template <class Get>
__device__ __forceinline__ bool window_rows_sums(Get get, int64_t B,
                                                 int64_t D, int64_t wb,
                                                 int64_t wd, int64_t nb,
                                                 int64_t nd, int64_t fb,
                                                 int64_t fd, float* dst,
                                                 float* stage, int64_t cap) {
  const int64_t W = nb * nd;
  if (W > blockDim.x || W * (wd + 1) > cap) return false;
  int64_t k = (cap / W - 1) / wd;               // rows of a window a step
  if (k > wb) k = wb;
  constexpr int kLoads = 8;                     // a lane's loads in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float acc = 0.0f;
  const int64_t w_me = threadIdx.x;
  for (int64_t i0 = 0; i0 < wb; i0 += k) {
    const int64_t kk = wb - i0 < k ? wb - i0 : k;
    const int64_t stride = kk * wd + 1;
    // a warp a (band of windows, row): lane j loads column j of the row's
    // window in each of the band's nd windows (wd is 32, or the whole
    // row when nd is 1)
    for (int64_t q = warp; q < nb * kk; q += warps) {
      const int64_t band = q / kk, ii = q - band * kk;
      const int64_t r = band * wb - fb + i0 + ii;
      const int64_t rc = clamp_index(r, B);
      const bool r_in = r >= 0 && r < B;
      float* out = stage + band * nd * stride + ii * wd + lane;
      for (int64_t t0 = 0; t0 < nd; t0 += kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int64_t c = (t0 + u) * wd - fd + lane;
          const float x = get(rc, clamp_index(c, D));
          v[u] = (r_in && c >= 0 && c < D) ? x : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (t0 + u < nd && lane < wd) out[(t0 + u) * stride] = v[u];
        }
      }
    }
    __syncthreads();
    if (w_me < W) {
      const float* mine = stage + w_me * stride;
      const int64_t per = stride - 1;
      for (int64_t e = 0; e < per; e += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = e + u < per ? mine[e + u] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (e + u < per) acc = __fadd_rn(acc, x[u]);
        }
      }
    }
    __syncthreads();
  }
  if (w_me < W) dst[w_me] = acc;
  return true;
}

// XLA's eager order of the sum of a whole [B, D] matrix get(i, j)
// (utils/ordered.py:matrix_sum), returned to every thread of the block:
// one row or one column as a vector (tree_sum); at most 32 x 32 as one
// small_sum; larger, windows of min(n, 32) along each axis (each axis'
// padding split evenly in front and behind) summed by window_sum, and the
// window sums reduce as a matrix again. Where ``stage`` (32 x 32 floats
// a warp of shared memory) is given, the first level's windows go a
// thread a window through it where they outnumber the warps four times,
// add in row order and fit (window_rows_sums; the scale cell's 416
// windows of T 400 x B1 1,001), else a warp a window (fewer windows, as
// the main path's 28 of T 200 x B1 105, where the warps' path is the
// faster): the warp loads the window into its part, a column a lane, and
// lane 0 adds it from there; without it a thread a window from get().
// ``scratch``
// (matrix_scratch(B, D) floats) is visible to the whole block; ends with
// the block's barrier.
template <class Get>
__device__ __forceinline__ float matrix_sum(Get get, int64_t B, int64_t D, float* scratch,
                            float* stage) {
  const Block g{};
  const float* src = nullptr;         // the level's sums; null: get()
  int64_t off = 0;
  auto at = [&](int64_t i, int64_t j) -> float {
    return src == nullptr ? get(i, j) : src[i * D + j];
  };
  while (B > 1 && D > 1 && (B > kWindow || D > kWindow)) {
    const int64_t wb = B < kWindow ? B : kWindow;
    const int64_t wd = D < kWindow ? D : kWindow;
    const int64_t nb = (B + wb - 1) / wb, nd = (D + wd - 1) / wd;
    const int64_t pb = nb * wb - B, pd = nd * wd - D;
    const int64_t fb = pb / 2, fd = pd / 2;
    float* dst = scratch + 1 + off;
    if (src == nullptr && stage != nullptr
        && nb * nd > 4 * (blockDim.x >> 5)
        && window_in_row_order(wb, wd, pb, pd)
        && window_rows_sums(get, B, D, wb, wd, nb, nd, fb, fd, dst, stage,
                            (blockDim.x >> 5) * kWindow * kWindow)) {
      // a thread a window (window_rows_sums): more than four windows a
      // warp
    } else if (src == nullptr && stage != nullptr) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      float* st = stage + warp * kWindow * kWindow;
      for (int64_t w = warp; w < nb * nd; w += blockDim.x >> 5) {
        const int64_t r0 = (w / nd) * wb - fb, c = (w % nd) * wd - fd + lane;
        // the lane's column, eight loads in flight at a time
        for (int i0 = 0; i0 < wb; i0 += 8) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = get(clamp_index(r0 + i0 + i, B), clamp_index(c, D));
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int64_t r = r0 + i0 + i;
            if (i0 + i < wb) {
              st[(i0 + i) * kWindow + lane] =
                  (lane < wd && r >= 0 && r < B && c >= 0 && c < D) ? v[i]
                                                                     : 0.0f;
            }
          }
        }
        __syncwarp();
        if (lane == 0) {
          dst[w] = window_sum(
              [st](int64_t i, int64_t j) { return st[i * kWindow + j]; },
              wb, wd, pb, pd);
        }
        __syncwarp();
      }
    } else {
      for (int64_t w = g.rank(); w < nb * nd; w += g.size()) {
        const int64_t r0 = (w / nd) * wb - fb, c0 = (w % nd) * wd - fd;
        // every element loaded (at a clamped index), then selected: a
        // branch around the load would wait on each one in turn
        dst[w] = window_sum(
            [&](int64_t i, int64_t j) -> float {
              const int64_t r = r0 + i, c = c0 + j;
              const float v = at(clamp_index(r, B), clamp_index(c, D));
              return (r >= 0 && r < B && c >= 0 && c < D) ? v : 0.0f;
            },
            wb, wd, pb, pd);
      }
    }
    g.sync();
    src = dst;
    off += nb * nd;
    B = nb;
    D = nd;
  }
  float total;
  if (B == 1 || D == 1) {
    const int64_t cols = D;
    total = tree_sum(g, [&](int64_t k) { return at(k / cols, k % cols); },
                     B * D, scratch + 1 + off);
  } else {
    if (g.rank() == 0) {
      scratch[0] = small_sum(at, static_cast<int>(B), static_cast<int>(D),
                             false);
    }
    g.sync();
    total = scratch[0];
  }
  g.sync();
  return total;
}

// One thread's fused sum of a [T, B1] table get(t, b) (T, B1 <= 32) when
// LLVM vectorizes the row loop (utils/ordered.py:_topic_loop's "rows"):
// each row a vector_loop_sum seeded with the running total.
template <class Get>
__device__ __forceinline__ float topic_rows_sum(Get get, int T, int B1, int vf, int ic,
                                int epi, int tail) {
  float total = 0.0f;
  for (int t = 0; t < T; ++t) {
    total = vector_loop_sum([&](int b) { return get(t, b); }, B1, vf, ic,
                            epi, tail, total);
  }
  return total;
}

// One thread's fused sum of a [T, B1] table (T, B1 <= 32) when LLVM
// vectorizes the loop over rows (_topic_loop's "lanes"): lane l adds rows
// l, l + vf, ... of the whole vf-row groups, each in column order, from
// 0.0; the lanes folded by halves, then the rows left over in order from
// 0.0 after that total (vf 1: every cell in row order).
template <class Get>
__device__ __forceinline__ float topic_lanes_sum(Get get, int T, int B1, int vf) {
  const int full = vf > 1 ? T / vf * vf : 0;
  float total = 0.0f;
  if (full > 0) {
    float lanes[8];
    for (int l = 0; l < vf; ++l) {
      float acc = 0.0f;
      for (int t = l; t < full; t += vf) {
        for (int b = 0; b < B1; ++b) acc = __fadd_rn(acc, get(t, b));
      }
      lanes[l] = acc;
    }
    total = __fadd_rn(total, fold_halves(lanes, vf));
  }
  for (int t = full; t < T; ++t) {
    for (int b = 0; b < B1; ++b) total = __fadd_rn(total, get(t, b));
  }
  return total;
}

}  // namespace ordered
