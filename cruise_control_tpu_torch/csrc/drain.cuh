// The bulk drains' shared device code: KZ (drain_order.cu), KAA
// (leadership_drain.cu) and KP (drain_fill.cu) include it.
//
//  - shed_quota: one block forms an interval row's broker planes as KY
//    does (bounds.cuh: the metric, its bounds, the excess over the upper
//    bound) and the drain's shed quota, IntervalGoal._shed_quota
//    (cruise_control_tpu/analyzer/goals.py:505-525): the valid brokers'
//    average, the deficits' and excesses' sums, the pool of above-average
//    surplus and its scale, four sums in XLA's tree order
//    (ordered.cuh:tree_sum), the quota one FMA (pool x scale + excess);
//    the alive count an integer. The leadership drain's intake budget is
//    the upper bound less the metric (IntervalGoal._upper_minus).
//  - the segmented sort: the rows are grouped by segment (a broker) with
//    integer atomics -- a warp's rows of one segment take one atomic --
//    into the segments' runs, each row under a unique 64-bit key whose low
//    bits are the row's index (so the order the atomics give does not
//    matter); each run is then sorted by key: a block a run in shared
//    memory (a bitonic network) up to kSortTile keys, and a longer run in
//    chunks of kSortTile sorted so, then merged in one launch: a row's
//    place is its place in its chunk plus, for every other chunk of the
//    run, the keys there below its own (a binary search). Any run length,
//    no float atomics. sort_image maps a float to its place in
//    jnp.lexsort's ascending order: -0.0 equal to +0.0 and every NaN,
//    either sign, after +inf (equal to each other).
//  - _segment_cum_before (goals.py:68), the cumulative weight of the
//    earlier rows of a key-sorted run, as KP computes it: XLA's scan_sum
//    of the whole sorted array (scan16's levels a chunk of 4,096 = 16^3
//    slots, chunk_scan and cum_at), each run's in-order sum (KB's order,
//    run_sum) and the scan of those sums (staged_scan16).
// The sources that include it are compiled with -fmad=false: every float
// operation rounds on its own, except the quota's FMA.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bounds.cuh"
#include "ordered.cuh"

namespace drain {

constexpr int kChunk = 4096;               // slots a scan chunk (16^3)
constexpr int kStage = 2048;               // the one-block scans' arrays
                                           // in shared memory up to this
constexpr int kSortTile = 4096;            // keys a block sorts
constexpr int kSortThreads = 512;
constexpr uint64_t kNoKey = ~uint64_t{0};
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The shed quota
// ---------------------------------------------------------------------------

// The broker planes one block forms (each [B1]; ``budget`` may be null).
struct QuotaOut {
  float* values;
  float* up;
  float* excess;
  float* deficit;
  float* pool;
  float* quota;
  float* budget;               // the leadership drain's intake budget
};

// IntervalGoal._shed_quota of ``row`` over the brokers ``br`` by one block
// (every thread calls it; it ends with the block's barrier): the planes
// into ``o``, the leadership drain's budget where ``o.budget`` is set (its
// destinations' mask ``ldest``). ``scratch``: tree_scratch(B1) floats the
// block sees; ``red``: a word a warp of shared memory.
__device__ __forceinline__ void shed_quota(const ViolRow& row,
                                           const bounds::Brokers& br,
                                           int64_t B1, const uint8_t* ldest,
                                           const QuotaOut& o, float* scratch,
                                           long long* red) {
  bounds::View view;
  const float n_alive =
      bounds::stage_interval(row, br, B1, nullptr, red, view);
  const bounds::IntervalBounds ib =
      bounds::interval_bounds(row, view, n_alive, B1, scratch, nullptr);
  __syncthreads();                     // the bounds' scratch is free again
  const bool upper_only = row.upper_only != 0;
  const float lo = ib.lower();
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    const float v = view.value(b);
    const bool alive = view.alive(b);
    o.values[b] = v;
    o.up[b] = ib.upper(view, b);
    o.excess[b] = ib.excess(view, v, b);
    // (unlike a proposal's plane, an infinite lower bound is not masked:
    // no drain goal has one both sides)
    o.deficit[b] = (upper_only || !alive)
                       ? 0.0f
                       : ordered::clamp0(__fsub_rn(lo, v));
    if (o.budget != nullptr) {
      o.budget[b] = (alive && ldest[b] != 0 && view.valid(b))
                        ? ordered::clamp0(ib.upper_minus(view, v, b))
                        : 0.0f;
    }
  }
  __syncthreads();
  const ordered::Block blk{};
  const float* values = o.values;
  const float total = ordered::tree_sum(
      blk, [=](int64_t b) { return view.valid(b) ? values[b] : 0.0f; }, B1,
      scratch);
  __syncthreads();
  const float* deficit = o.deficit;
  const float dsum = ordered::tree_sum(
      blk, [=](int64_t b) { return deficit[b]; }, B1, scratch);
  __syncthreads();
  const float* excess = o.excess;
  const float esum = ordered::tree_sum(
      blk, [=](int64_t b) { return excess[b]; }, B1, scratch);
  __syncthreads();
  const float avg = __fdiv_rn(total, n_alive);
  const float need = ordered::clamp0(__fsub_rn(dsum, esum));
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    o.pool[b] = (view.alive(b) && o.excess[b] <= 0.0f)
                    ? ordered::clamp0(__fsub_rn(o.values[b], avg))
                    : 0.0f;
  }
  __syncthreads();
  const float* pool = o.pool;
  const float psum = ordered::tree_sum(
      blk, [=](int64_t b) { return pool[b]; }, B1, scratch);
  // torch.clamp keeps a NaN
  const float den = psum < 1e-9f ? 1e-9f : psum;
  float scale = __fdiv_rn(need, den);
  scale = scale > 1.0f ? 1.0f : scale;
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    o.quota[b] = __fmaf_rn(o.pool[b], scale, o.excess[b]);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The segmented sort
// ---------------------------------------------------------------------------

// x's place in jnp.lexsort's ascending order as an unsigned image: -0.0
// equal to +0.0, every NaN after +inf.
__device__ __forceinline__ uint32_t sort_image(float x) {
  if (isnan(x)) return 0xffffffffu;
  uint32_t b = __float_as_uint(x);
  if ((b & 0x7fffffffu) == 0u) b = 0u;             // -0.0 as +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One more row of segment ``seg`` (-1: none) for each lane: a warp's rows
// of one segment take one atomic on ``counts[seg]``. Returns the row's
// place among the segment's rows so far. Every lane of the warp calls it.
__device__ __forceinline__ int32_t claim(int32_t* counts, int32_t seg) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, seg);
  const int leader = __ffs(static_cast<int>(peers)) - 1;
  int32_t base = 0;
  if (seg >= 0 && lane == leader) {
    base = atomicAdd(counts + seg, __popc(peers));
  }
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// The exclusive prefix of ``v`` over the block's threads in order and the
// block's total (``s_warp``: 33 ints of shared memory). Opens with a
// barrier.
__device__ __forceinline__ int64_t block_exclusive(int64_t v,
                                                   int64_t* s_warp,
                                                   int64_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  int64_t incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int64_t before = 0;
  total = 0;
  for (int w = 0; w < warps; ++w) {
    const int64_t t = s_warp[w];
    if (w < warp) before += t;
    total += t;
  }
  return before + incl - v;
}

// Where each segment's run starts (``start``, B1 + 1 entries, the last n)
// and its first sort chunk (``chunk_first``, B1 + 1, the last the chunks'
// count) from the rows a segment ``counts``: one block.
__device__ __forceinline__ void segment_starts(const int32_t* counts,
                                               int64_t B1, int32_t* start,
                                               int32_t* chunk_first) {
  __shared__ int64_t s_warp[33];
  int64_t rows = 0, chunks = 0;
  for (int64_t b0 = 0; b0 < B1; b0 += blockDim.x) {
    const int64_t b = b0 + threadIdx.x;
    const int64_t c = b < B1 ? counts[b] : 0;
    int64_t total;
    const int64_t r = block_exclusive(c, s_warp, total);
    const int64_t k = (c + kSortTile - 1) / kSortTile;
    int64_t ktotal;
    const int64_t q = block_exclusive(k, s_warp, ktotal);
    if (b < B1) {
      start[b] = static_cast<int32_t>(rows + r);
      chunk_first[b] = static_cast<int32_t>(chunks + q);
    }
    rows += total;
    chunks += ktotal;
  }
  if (threadIdx.x == 0) {
    start[B1] = static_cast<int32_t>(rows);
    chunk_first[B1] = static_cast<int32_t>(chunks);
  }
}

// The last index b < n of the non-decreasing a[0..n] with a[b] <= v.
__device__ __forceinline__ int64_t last_at_most(const int32_t* a, int64_t n,
                                                int64_t v) {
  int64_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    if (a[mid] <= v) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The keys of a[0..n) below v (a sorted ascending).
__device__ __forceinline__ int64_t keys_below(const uint64_t* a, int64_t n,
                                              uint64_t v) {
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

// Ascending sort of s[0..m) (m a power of two) by the block: a bitonic
// network, a barrier a step.
__device__ __forceinline__ void bitonic(uint64_t* s, int m) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = s[i], y = s[ixj];
          if ((x > y) == ((i & k) == 0)) {
            s[i] = y;
            s[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sort chunk ``j`` of the runs (``keys`` grouped by segment; ``start`` and
// ``chunk_first`` from segment_starts) by the block, in ``s`` (kSortTile
// keys of shared memory). A run of one chunk is final: ``out(place, key)``
// for each of its keys in order; a chunk of a longer run goes into
// ``runs`` at its place, sorted, for merge_runs. Every thread of the block
// calls it.
template <class Out>
__device__ __forceinline__ void sort_chunk(int64_t j, const uint64_t* keys,
                                           uint64_t* runs,
                                           const int32_t* start,
                                           const int32_t* chunk_first,
                                           int64_t B1, uint64_t* s, Out out) {
  if (j >= chunk_first[B1]) return;
  const int64_t b = last_at_most(chunk_first, B1, j);
  const int64_t s0 = start[b], m = start[b + 1] - s0;
  const int64_t c = j - chunk_first[b];
  const int64_t lo = s0 + c * kSortTile;
  const int len = static_cast<int>(m - c * kSortTile < kSortTile
                                       ? m - c * kSortTile : kSortTile);
  int p2 = 1;
  while (p2 < len) p2 <<= 1;
  for (int k = threadIdx.x; k < p2; k += blockDim.x) {
    s[k] = k < len ? keys[lo + k] : kNoKey;
  }
  __syncthreads();
  bitonic(s, p2);
  if (m <= kSortTile) {
    for (int k = threadIdx.x; k < len; k += blockDim.x) out(lo + k, s[k]);
  } else {
    for (int k = threadIdx.x; k < len; k += blockDim.x) runs[lo + k] = s[k];
  }
}

// Row ``q`` of a run longer than kSortTile (its chunks sorted by
// sort_chunk): ``out(place, key)`` at its place in the run. Rows of
// shorter runs return.
template <class Out>
__device__ __forceinline__ void merge_runs(int64_t q, const uint64_t* runs,
                                           const int32_t* start, int64_t B1,
                                           Out out) {
  const int64_t b = last_at_most(start, B1, q);
  const int64_t s0 = start[b], m = start[b + 1] - s0;
  if (m <= kSortTile) return;
  const uint64_t key = runs[q];
  const int64_t c = (q - s0) / kSortTile;
  int64_t place = q - s0 - c * kSortTile;
  const int64_t chunks = (m + kSortTile - 1) / kSortTile;
  for (int64_t c2 = 0; c2 < chunks; ++c2) {
    if (c2 == c) continue;
    const int64_t lo = c2 * kSortTile;
    const int64_t len = m - lo < kSortTile ? m - lo : kSortTile;
    place += keys_below(runs + s0 + lo, len, key);
  }
  out(s0 + place, key);
}

// ---------------------------------------------------------------------------
// _segment_cum_before's scans (KP's, shared)
// ---------------------------------------------------------------------------

// The levels of scan16 over n values kept a chunk of kChunk slots: level 0
// in 16-blocks, level 1 and 2 within the chunk, the chunks' totals and
// their scan.
struct Levels {
  float* loc0;                 // [n]
  float* loc1;                 // [ceil(n / 16)]
  float* loc2;                 // [ceil(n / 256)]
  float* t3;                   // [chunks]
  float* out3;                 // [chunks] the totals' scan16
};

__device__ __forceinline__ int chunk_slots(int64_t n, int64_t c) {
  const int64_t left = n - c * kChunk;
  return static_cast<int>(left < kChunk ? left : kChunk);
}

// Shared-memory index of a chunk's slot k (a gap every 16: a thread's
// 16-block reads no bank twice).
__device__ __forceinline__ int pad(int k) { return k + (k >> 4); }

// scan16's value at slot i from the chunk-local levels and the chunks'
// scanned totals: XLA's down-sweep, level by level from the top.
__device__ __forceinline__ float cum_at(const Levels& lv, int64_t i) {
  // the four levels' values loaded together (an index out of play reads
  // entry 0, unused), then added from the top
  const int64_t k1 = i / 16 - 1, k2 = k1 / 16 - 1, k3 = k2 / 16 - 1;
  const float v0 = lv.loc0[i];
  float v1 = lv.loc1[k1 < 0 ? 0 : k1];
  float v2 = lv.loc2[k2 < 0 ? 0 : k2];
  const float v3 = lv.out3[k3 < 0 ? 0 : k3];
  if (k2 >= 16) v2 = __fadd_rn(v2, v3);
  if (k1 >= 16) v1 = __fadd_rn(v1, v2);
  return i >= 16 ? __fadd_rn(v0, v1) : v0;
}

// Chunk c's levels of scan16 over the m values in s_x (padded; scanned in
// place): level 0 in 16-blocks into loc0, level 1 into loc1, level 2 into
// loc2, the chunk's total into t3. Every thread of the block calls it.
__device__ __forceinline__ void chunk_scan(const Levels& lv, int64_t c, int m,
                                           float* s_x, float* s_t1,
                                           float* s_t2) {
  const int t = threadIdx.x;
  const int nb0 = (m + 15) / 16;
  if (t < nb0) {
    const int cnt = m - 16 * t < 16 ? m - 16 * t : 16;
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = j < cnt ? s_x[pad(16 * t + j)] : 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < cnt) {
        acc = __fadd_rn(acc, v[j]);
        s_x[pad(16 * t + j)] = acc;
      }
    }
    s_t1[t] = acc;
  }
  __syncthreads();
  const int64_t i0 = c * kChunk;
  for (int k = t; k < m; k += blockDim.x) lv.loc0[i0 + k] = s_x[pad(k)];
  const int nb1 = (nb0 + 15) / 16;
  if (t < nb1) {
    float acc = 0.0f;
    const int hi = 16 * t + 16 < nb0 ? 16 * t + 16 : nb0;
    for (int k = 16 * t; k < hi; ++k) {
      acc = __fadd_rn(acc, s_t1[k]);
      s_t1[k] = acc;
    }
    s_t2[t] = acc;
  }
  __syncthreads();
  for (int k = t; k < nb0; k += blockDim.x) {
    lv.loc1[c * (kChunk / 16) + k] = s_t1[k];
  }
  if (t == 0) {
    float acc = 0.0f;
    for (int k = 0; k < nb1; ++k) {
      acc = __fadd_rn(acc, s_t2[k]);
      lv.loc2[c * (kChunk / 256) + k] = acc;
    }
    lv.t3[c] = acc;
  }
}

// scan16 of x[0..n) into out[0..n) by the block: staged through shared
// memory (one memory round trip in, one out) where n fits, else over
// global memory with ``scr`` (scan_scratch(n) floats) as its levels.
__device__ __forceinline__ void staged_scan16(const float* x, float* out,
                                              int64_t n, float* scr,
                                              float* s_in, float* s_out,
                                              float* s_scr) {
  const ordered::Block blk{};
  if (n > kStage) {
    ordered::scan16(blk, [&](int64_t i) { return x[i]; }, out, n, scr);
    return;
  }
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) s_in[i] = x[i];
  __syncthreads();
  ordered::scan16(blk, [&](int64_t i) { return s_in[i]; }, s_out, n, s_scr);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = s_out[i];
  __syncthreads();
}

// The in-order sum of x[lo..hi) (KB's order: one segment's rows), from
// 0.0, by one warp streaming the rows through ``ring`` (kRing chunks of 32
// floats of shared memory, 16-byte aligned) and ``ring_n`` (kRing ints);
// every lane returns it.
template <int kRing>
__device__ __forceinline__ float run_sum(const float* x, int64_t lo,
                                         int64_t hi, float* ring,
                                         int* ring_n) {
  int64_t at = lo;
  float acc = 0.0f;
  ordered::stream_rows<1, kRing>(
      x, ring, ring_n,
      [&](int64_t& row0) {
        row0 = at;
        const int64_t n = hi - at < 32 ? hi - at : 32;
        at += n;
        return static_cast<int>(n);
      },
      [&](float v) { acc = __fadd_rn(acc, v); });
  return acc;
}

}  // namespace drain
