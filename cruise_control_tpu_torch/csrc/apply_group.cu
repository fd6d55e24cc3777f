// KM: apply one partition-disjoint group of candidate actions to the
// search state, out of place or into buffers the caller owns (in place).
//
// Replaces cruise_control_tpu/analyzer/state.py:apply_group (:420-532),
// which the goal pass runs once a drain round and once an apply round
// (analyzer/engine.py:PassSegments.drain and .round). In plain torch it is
// about 60 launches (100 with the topic tables): gathers, wheres, three
// index_puts a plane, KB for the float aggregates, index_adds.
//
// For candidates i < N with do[i] (their partition rows p, and p2 of a
// swap, distinct), as the reference computes them:
//  - slot writes into rb / pos / offline [P, R]: slot (p, r), then slot
//    (p, 0), then a swap's counterpart (p2, r2), in that precedence;
//  - the float aggregates util [B1, 4], potential NW_OUT and leader NW_IN
//    [B1]: per broker the base, then every candidate's source row in
//    candidate order, then every destination row (KB's order; rows of
//    candidates that do not apply add +-0.0, as the reference's masked
//    scatter-adds do); no float atomics;
//  - replica and leader counts [B1] (int32, added per broker in the same
//    walk) and the [T, B1] topic and topic-leader tables (int32 atomics,
//    exact in any order; a topic outside [0, T) adds nothing);
//  - moves_applied + the count of do, and that count.
//
// A candidate that does not apply adds +-0.0 (and integer zeros), which
// changes no bit of a sum that is not -0.0; a sum starting from any other
// base never becomes -0.0 (x + y is -0.0 only for two -0.0). So a broker
// chain adds only the applied rows -- KB's sequence exactly -- and takes
// the others too only where its base holds a -0.0.
//
// Bound on the card: the longest broker chain. A float32 sum in KB's row
// order cannot be split without changing its bits, so a broker whose rows
// are many (a drain round's drained broker: ~11,500 rows at N 16,384)
// costs that many dependent adds; everything else is a few microseconds
// of bytes. The design is two launches:
//  1. bucket: the 2N rows (every candidate's source row, then every
//     destination row) in tiles of 32 or 128-4,096 rows (the least power
//     of two that makes at most 32 tiles: the more blocks, the more SMs
//     sort; past 131,072 rows, tiles of 4,096, as many as it takes; any
//     N), a block a tile: the tile's included rows sorted by (broker,
//     row) in shared memory -- a warp's bitonic network for 32 rows (an
//     apply round's 1,024 rows: 32 blocks, no block barrier; the radix
//     sort's least tile, 128 rows in 8 blocks, took the launch 0.0100 ms
//     there against 0.0038 on an H100), else an LSD
//     radix sort by a quarter as many threads, 4 bits a pass -- so each
//     broker's rows of the tile form one run in row order; each row's
//     eight terms (util x 4, potential, leader NW_IN, replica and leader
//     count deltas)
//     written at its sorted place, and each run's (start, length) into a
//     [tiles, B1] table (zero: no rows). Blocks past the tiles copy the
//     placement planes and topic tables where the output is not the
//     input; block 0 sets moves_applied and zeroes the count;
//  2. apply: a warp a broker walks its runs tile by tile (reading its
//     column of the run table 32 tiles at a time) -- its rows in
//     row order, contiguous 32-byte records -- 32 rows a chunk, copied by
//     cp.async into a ring of eight chunks in shared memory, seven in
//     flight while one is added (ordered::stream_rows); lane l reads term
//     l & 7 of the next chunk's rows into registers while it adds the
//     current one's, lanes 0-5 chaining the float terms, one dependent add
//     a row, lanes 6-7 the integer ones. Blocks past the brokers take a
//     thread a candidate for the slot writes, the topic-table atomics and
//     the count.
// In place (an output that is its input) is safe: a group is
// partition-disjoint, so each slot is read and written by its own
// candidate's thread; each broker's aggregate row by its own warp; the
// topic tables take atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"

namespace {

constexpr int64_t kMove = 0;   // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;   // MOVE_LEADERSHIP
constexpr int64_t kSwap = 2;   // MOVE_SWAP
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;      // brokers a block
constexpr int kKeysPer = 4;                // a bucket thread's sort keys
constexpr int kMinTile = 32;               // rows a tile (a power of two)
constexpr int kWarpTile = 32;              // a tile one warp sorts alone
constexpr int kMinRadixTile = 128;         // the least tile sorted by radix
constexpr int kMaxTile = 4096;
constexpr int kSortThreads = kMaxTile / kKeysPer;
constexpr int kDigit = 4;                  // bits a radix-sort pass
constexpr int kMaxTiles = 32;              // a group of tiles: a lane each
constexpr int kLenBits = 14;               // a run: start << 14 | length
constexpr int kTerms = 8;
constexpr int kRing = 8;                   // a warp's ring of chunks
constexpr int kChunkFloats = 32 * 8;       // 32 rows of 8 terms (1 KB)
constexpr uint32_t kNone = 0xffffffffu;    // the sort key of an excluded row
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Pointers and sizes of one call (passed by the host by address; the
// kernels take a copy by value). An output may be its input (in place).
struct ApplyArgs {
  const int64_t* rb;        // [P, R]
  const int64_t* pos;       // [P, R]
  const uint8_t* off;       // [P, R]
  const float* util;        // [B1, 4]
  const float* pot;         // [B1]
  const float* lni;         // [B1]
  const int32_t* cnt;       // [B1]
  const int32_t* lead;      // [B1]
  const int32_t* tc;        // [T, B1] or null
  const int32_t* tlc;       // [T, B1] or null
  const int64_t* moves;     // []
  const int32_t* topic;     // [P] partition topic
  const int64_t* p;         // candidates [N]
  const int64_t* r;
  const int64_t* p2;
  const int64_t* r2;
  const int64_t* src;
  const int64_t* dst;
  const int64_t* kind;
  const float* d_util_src;  // [N, 4]
  const float* d_util_dst;  // [N, 4]
  const int32_t* d_cnt;
  const int32_t* d_lead;
  const float* d_pot;
  const float* d_lni;
  const uint8_t* do_;       // [N]
  int64_t* rb_out;
  int64_t* pos_out;
  uint8_t* off_out;
  float* util_out;
  float* pot_out;
  float* lni_out;
  int32_t* cnt_out;
  int32_t* lead_out;
  int32_t* tc_out;
  int32_t* tlc_out;
  int64_t* moves_out;       // []
  int64_t* count_out;       // []
  int32_t* runs;            // [tiles, B1] scratch: start << 14 | length
  float* terms;             // [2N, 8] scratch: the rows' terms, each tile
                            // in (broker, row) order
  int64_t P, R, B1, T, N;
};

namespace {

// The eight terms candidate i adds to its source (side 0) or destination
// (side 1) broker: util x 4, potential, leader NW_IN (floats), then the
// replica and leader count deltas (int32 bits).
__device__ __forceinline__ void row_terms(const ApplyArgs& a, int64_t i,
                                          int side, float* t) {
  // every field loaded, then selected (no load waits on another)
  const bool d = a.do_[i] != 0;
  const int64_t k = a.kind[i];
  const float4 du = reinterpret_cast<const float4*>(
      side == 0 ? a.d_util_src : a.d_util_dst)[i];
  const float d_pot = a.d_pot[i], d_lni = a.d_lni[i];
  const int32_t d_cnt = a.d_cnt[i], d_lead = a.d_lead[i];
  const bool mv = d && (k == kMove || k == kSwap);
  const bool move = d && k == kMove;
  t[0] = d ? du.x : 0.0f;
  t[1] = d ? du.y : 0.0f;
  t[2] = d ? du.z : 0.0f;
  t[3] = d ? du.w : 0.0f;
  const float pot = mv ? d_pot : 0.0f;
  const float lni = d ? d_lni : 0.0f;
  const int32_t cnt = move ? d_cnt : 0;
  const int32_t lead = d ? d_lead : 0;
  t[4] = side == 0 ? -pot : pot;
  t[5] = side == 0 ? -lni : lni;
  t[6] = __int_as_float(side == 0 ? -cnt : cnt);
  t[7] = __int_as_float(side == 0 ? -lead : lead);
}

__device__ __forceinline__ bool is_neg_zero(float x) {
  return __float_as_uint(x) == 0x80000000u;
}

// Whether broker b's base holds a -0.0 in a float aggregate.
__device__ __forceinline__ bool base_neg_zero(const ApplyArgs& a,
                                              int64_t b) {
  const float4 u = reinterpret_cast<const float4*>(a.util)[b];
  const float pot = a.pot[b], lni = a.lni[b];
  return is_neg_zero(u.x) | is_neg_zero(u.y) | is_neg_zero(u.z)
         | is_neg_zero(u.w) | is_neg_zero(pot) | is_neg_zero(lni);
}

// Stable sort of the kKeysPer x blockDim.x keys in ``keys`` by their bits
// [lo, lo + nbits): an LSD radix sort, kDigit bits a pass. Thread t holds
// the kKeysPer keys from t x kKeysPer on, so thread order then a thread's
// own order is the keys' order; a pass counts each digit per thread
// (16-bit counters, two digits a word), scans the counts over the block
// (warp shuffles, then the warps' totals), and scatters the keys into
// ``tmp``. Returns the buffer that holds the sorted keys. Every thread of
// the block calls it.
__device__ uint32_t* radix_sort(uint32_t* keys, uint32_t* tmp, int lo,
                                int nbits) {
  __shared__ uint32_t s_warp[kSortThreads / 32][8];
  __shared__ uint32_t s_base[16];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  for (int shift = lo; shift < lo + nbits; shift += kDigit) {
    uint32_t key[kKeysPer];
    uint32_t cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < kKeysPer; ++u) {
      key[u] = keys[t * kKeysPer + u];
      const int d = (key[u] >> shift) & 15;
      cnt[d >> 1] += 1u << ((d & 1) * 16);
    }
    // the counts of the threads before this one, digit by digit
    uint32_t incl[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      incl[w] = cnt[w];
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t v = __shfl_up_sync(kFull, incl[w], o);
        if (lane >= o) incl[w] += v;
      }
      if (lane == 31) s_warp[warp][w] = incl[w];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint32_t mine = lane < warps ? s_warp[lane][w] : 0u;
        uint32_t v = mine;
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += u;
        }
        if (lane < warps) s_warp[lane][w] = v - mine;   // warps before
        if (lane == 31) {
          // digit totals 2w and 2w + 1 into the digits' exclusive bases
          s_base[2 * w] = v & 0xffffu;
          s_base[2 * w + 1] = v >> 16;
        }
      }
      __syncwarp();
      if (lane == 0) {
        uint32_t acc = 0;
        for (int d = 0; d < 16; ++d) {
          const uint32_t c = s_base[d];
          s_base[d] = acc;
          acc += c;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kKeysPer; ++u) {
      const int d = (key[u] >> shift) & 15;
      const uint32_t before = incl[d >> 1] - cnt[d >> 1]
                              + s_warp[warp][d >> 1];
      const uint32_t pos = s_base[d] + ((before >> ((d & 1) * 16))
                                        & 0xffffu);
      tmp[pos] = key[u];
      cnt[d >> 1] -= 1u << ((d & 1) * 16);     // the next key of d: one on
    }
    __syncthreads();
    uint32_t* swap = keys;
    keys = tmp;
    tmp = swap;
  }
  return keys;
}

// Ascending sort of the 32 keys in ``keys`` by one warp (a bitonic
// network over the lanes' registers, no barrier); returns ``keys``.
__device__ uint32_t* warp_sort(uint32_t* keys) {
  const int lane = threadIdx.x & 31;
  uint32_t k = keys[lane];
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t other = __shfl_xor_sync(kFull, k, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      k = (low == up) ? min(k, other) : max(k, other);
    }
  }
  keys[lane] = k;
  __syncwarp();
  return keys;
}

template <class T>
__device__ void copy_plane(T* out, const T* in, int64_t n, int64_t tid,
                           int64_t stride) {
  if (out == nullptr || in == nullptr || out == in) return;
  for (int64_t i = tid; i < n; i += stride) out[i] = in[i];
}

__global__ void __launch_bounds__(kSortThreads) apply_bucket_kernel(
    const ApplyArgs a, int tiles, int tile, int bits, int broker_bits) {
  __shared__ uint32_t s_key[kMaxTile];
  __shared__ uint32_t s_tmp[kMaxTile];
  if (blockIdx.x >= tiles) {
    // ---- the planes and topic tables into outputs that are not inputs
    const int64_t tid = static_cast<int64_t>(blockIdx.x - tiles) * blockDim.x
                        + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x - tiles)
                           * blockDim.x;
    copy_plane(a.rb_out, a.rb, a.P * a.R, tid, stride);
    copy_plane(a.pos_out, a.pos, a.P * a.R, tid, stride);
    copy_plane(a.off_out, a.off, a.P * a.R, tid, stride);
    copy_plane(a.tc_out, a.tc, a.T * a.B1, tid, stride);
    copy_plane(a.tlc_out, a.tlc, a.T * a.B1, tid, stride);
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.moves_out[0] = a.moves[0];
    a.count_out[0] = 0;
  }
  const int t = blockIdx.x;
  const int64_t j0 = static_cast<int64_t>(t) * tile;
  const int64_t rows2 = 2 * a.N;
  const int rows = static_cast<int>(rows2 - j0 < tile ? rows2 - j0 : tile);
  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    uint32_t key = kNone;
    if (k < rows) {
      const int64_t j = j0 + k;
      const int side = j < a.N ? 0 : 1;
      const int64_t i = j - side * a.N;
      const int64_t b = side == 0 ? a.src[i] : a.dst[i];
      const bool applies = a.do_[i] != 0;
      if (b >= 0 && b < a.B1 && (applies || base_neg_zero(a, b))) {
        key = (static_cast<uint32_t>(b) << bits) | static_cast<uint32_t>(k);
      }
    }
    s_key[k] = key;
  }
  int32_t* runs = a.runs + static_cast<int64_t>(t) * a.B1;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) runs[b] = 0;
  __syncthreads();
  // by broker, stably: the broker field's low bits sort an excluded row
  // (all ones) after every broker below 2^broker_bits > B1 - 1
  const uint32_t* sorted = tile == kWarpTile
      ? warp_sort(s_key) : radix_sort(s_key, s_tmp, bits, broker_bits);
  const uint32_t local = (1u << bits) - 1u;
  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    const uint32_t key = sorted[k];
    if (key == kNone) continue;
    const int64_t j = j0 + (key & local);
    const int side = j < a.N ? 0 : 1;
    float tm[kTerms];
    row_terms(a, j - side * a.N, side, tm);
    float4* out = reinterpret_cast<float4*>(a.terms + (j0 + k) * kTerms);
    out[0] = make_float4(tm[0], tm[1], tm[2], tm[3]);
    out[1] = make_float4(tm[4], tm[5], tm[6], tm[7]);
    const uint32_t b = key >> bits;
    if (k + 1 < tile && (sorted[k + 1] >> bits) == b) continue;
    // the run's last row: its first is the first key of broker b
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if ((sorted[mid] >> bits) < b) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    runs[b] = (lo << kLenBits) | (k - lo + 1);
  }
}

// A warp's walk over its broker's runs, 32 rows a chunk. The broker's
// column of the [tiles, B1] run table is read 32 tiles at a time, a lane a
// tile (``entry``; ``mask`` the lanes whose tile has rows), in tile order,
// which is row order; ``group`` is the first of those 32 tiles. Only with
// kGroups (more than 32 tiles) does the walk step from one group to the
// next: that step in the ring's loop, ballot and all, slowed the apply
// launch on a hot broker (11,594 rows) from 0.090 to 0.102 ms on an H100
// where one group holds every tile.
template <bool kGroups>
struct RunCursor {
  const int32_t* col;   // the broker's entry of tile 0
  int64_t stride;       // B1: from one tile's entry to the next's
  int tiles;
  int group;
  int32_t entry;
  unsigned mask;
  int seg;
  int off;

  __device__ void load(int g) {
    group = g;
    const int t = g + (threadIdx.x & 31);
    entry = t < tiles ? col[static_cast<int64_t>(t) * stride] : 0;
    mask = __ballot_sync(kFull, entry != 0);
    seg = mask ? __ffs(mask) - 1 : -1;
    off = 0;
  }

  // The next chunk's first row and its row count (0: the walk is done).
  __device__ int next(int tile, int64_t& row0) {
    if (kGroups) {
      while (seg < 0 && group + 32 < tiles) load(group + 32);
    }
    const int32_t e = __shfl_sync(kFull, entry, seg < 0 ? 0 : seg);
    if (seg < 0) return 0;
    const int start = e >> kLenBits;
    const int len = e & ((1 << kLenBits) - 1);
    row0 = static_cast<int64_t>(kGroups ? group + seg : seg) * tile + start
           + off;
    const int n = len - off < 32 ? len - off : 32;
    off += 32;
    if (off >= len) {
      const unsigned rest = mask & ~((2u << seg) - 1u);
      seg = rest ? __ffs(rest) - 1 : -1;
      off = 0;
    }
    return n;
  }
};

__device__ __forceinline__ void topic_add(int32_t* table, int64_t topic,
                                          int64_t broker, int64_t T,
                                          int64_t B1, int32_t d) {
  if (d == 0 || topic < 0 || topic >= T) return;
  const int64_t cell = topic * B1 + broker;
  if (cell >= 0 && cell < T * B1) atomicAdd(table + cell, d);
}

template <bool kGroups>
__global__ void __launch_bounds__(kThreads) apply_group_kernel(
    const ApplyArgs a, int64_t broker_blocks, int tiles, int tile) {
  __shared__ __align__(16) float s_ring[kWarps][kRing][kChunkFloats];
  __shared__ int s_n[kWarps][kRing];
  if (blockIdx.x < broker_blocks) {
    // ---- the per-broker aggregates: one warp a broker
    const int lane = threadIdx.x & 31;
    const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps
                      + (threadIdx.x >> 5);
    if (b >= a.B1) return;
    float acc = 0.0f;
    int32_t iacc = 0;
    if (lane < 4) acc = a.util[b * 4 + lane];
    if (lane == 4) acc = a.pot[b];
    if (lane == 5) acc = a.lni[b];
    if (lane == 6) iacc = a.cnt[b];
    if (lane == 7) iacc = a.lead[b];
    // the broker's rows, run after run, through a ring in shared memory
    const int warp = threadIdx.x >> 5;
    RunCursor<kGroups> cur{a.runs + b, a.B1, tiles};
    cur.load(0);
    ordered::stream_rows<kTerms, kRing>(
        a.terms, s_ring[warp][0], s_n[warp],
        [&](int64_t& row0) { return cur.next(tile, row0); },
        [&](float v) {
          acc = __fadd_rn(acc, v);
          iacc += __float_as_int(v);
        });
    if (lane < 4) a.util_out[b * 4 + lane] = acc;
    if (lane == 4) a.pot_out[b] = acc;
    if (lane == 5) a.lni_out[b] = acc;
    if (lane == 6) a.cnt_out[b] = iacc;
    if (lane == 7) a.lead_out[b] = iacc;
    return;
  }
  // ---- the slot writes, topic tables and count: a thread a candidate
  const int64_t i = (static_cast<int64_t>(blockIdx.x) - broker_blocks)
                    * blockDim.x + threadIdx.x;
  const bool applies = i < a.N && a.do_[i] != 0;
  const int block_count = __syncthreads_count(applies);
  if (threadIdx.x == 0 && block_count > 0) {
    const auto c = static_cast<unsigned long long>(block_count);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.count_out), c);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.moves_out), c);
  }
  if (!applies) return;
  const int64_t k = a.kind[i];
  const bool lead = k == kLead;
  const bool swap = k == kSwap;
  const bool mv = k == kMove || swap;
  const int64_t p = a.p[i], r = a.r[i], p2 = a.p2[i], r2 = a.r2[i];
  const int64_t src = a.src[i], dst = a.dst[i];
  if (p >= 0 && p < a.P && r >= 0 && r < a.R) {
    const int64_t row = p * a.R;
    const int64_t cur_slot = a.rb[row + r], cur0 = a.rb[row];
    const int64_t pos_r = a.pos[row + r], pos_0 = a.pos[row];
    const bool off_r = a.off[row + r] != 0, off_0 = a.off[row] != 0;
    a.rb_out[row + r] = mv ? dst : cur0;
    a.rb_out[row] = lead ? cur_slot : ((mv && r == 0) ? dst : cur0);
    a.pos_out[row + r] = lead ? pos_0 : pos_r;
    a.pos_out[row] = lead ? pos_r : pos_0;
    a.off_out[row + r] = !mv && (lead ? off_0 : off_r);
    a.off_out[row] = lead ? off_r : (!(mv && r == 0) && off_0);
  }
  if (swap && p2 >= 0 && p2 < a.P && r2 >= 0 && r2 < a.R) {
    a.rb_out[p2 * a.R + r2] = src;
    a.off_out[p2 * a.R + r2] = 0;
  }
  if (a.tc_out == nullptr && a.tlc_out == nullptr) return;
  const int64_t t1 = (p >= 0 && p < a.P) ? a.topic[p] : -1;
  const int64_t t2 = (p2 >= 0 && p2 < a.P) ? a.topic[p2] : -1;
  if (a.tc_out != nullptr) {
    // the swap counterpart's topic travels the other way
    const int32_t d = mv ? 1 : 0, d2 = swap ? 1 : 0;
    topic_add(a.tc_out, t1, src, a.T, a.B1, -d);
    topic_add(a.tc_out, t1, dst, a.T, a.B1, d);
    topic_add(a.tc_out, t2, dst, a.T, a.B1, -d2);
    topic_add(a.tc_out, t2, src, a.T, a.B1, d2);
  }
  if (a.tlc_out != nullptr) {
    // leadership of p lands on dst for transfers and leader-slot moves;
    // a swap counterpart in slot 0 hauls p2's leadership to src
    const int32_t d = (lead || (mv && r == 0)) ? 1 : 0;
    const int32_t d2 = (swap && r2 == 0) ? 1 : 0;
    topic_add(a.tlc_out, t1, src, a.T, a.B1, -d);
    topic_add(a.tlc_out, t1, dst, a.T, a.B1, d);
    topic_add(a.tlc_out, t2, dst, a.T, a.B1, -d2);
    topic_add(a.tlc_out, t2, src, a.T, a.B1, d2);
  }
}

// The tile of 2N rows: at least kMinTile, and large enough that at most
// kMaxTiles tiles cover them, up to kMaxTile (past 32 x 4,096 rows the
// tiles are 4,096 rows, as many as it takes).
int64_t tile_rows(int64_t n) {
  int64_t tile = kMinTile;
  while (tile * kMaxTiles < 2 * n && tile < kMaxTile) tile *= 2;
  if (tile > kWarpTile && tile < kMinRadixTile) tile = kMinRadixTile;
  return tile;
}

// Bits of a sort key's broker field at B1 brokers: the least with 2^bits
// > B1, so an excluded row's all-ones field sorts after every broker id.
int broker_key_bits(int64_t b1) {
  int bits = 1;
  while ((int64_t{1} << bits) <= b1) ++bits;
  return bits;
}

// Bits of a sort key's row field: a row of a tile.
int row_key_bits(int64_t tile) {
  int bits = 0;
  while ((int64_t{1} << bits) < tile) ++bits;
  return bits;
}

}  // namespace

// Int32 words of KM's run table at N candidates and B1 brokers (-1: a
// sort key of (broker, row in the tile) does not fit 32 bits, B1 past
// about a million).
extern "C" int64_t cc_apply_runs_size(int64_t n, int64_t b1) {
  const int64_t tile = tile_rows(n);
  if (row_key_bits(tile) + broker_key_bits(b1) > 32) return -1;
  return ((2 * n + tile - 1) / tile) * b1;
}

// KM's two launches on ``stream``; returns cudaGetLastError().
extern "C" int cc_apply_group(const ApplyArgs* args, void* stream) {
  const ApplyArgs a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tile = tile_rows(a.N);
  const int bits = row_key_bits(tile);
  const int broker_bits = broker_key_bits(a.B1);
  if (a.N < 1 || bits + broker_bits > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (2 * a.N + tile - 1) / tile;
  const int threads = static_cast<int>(
      tile == kWarpTile ? kWarpTile : tile / kKeysPer);
  const bool copies = (a.rb_out != a.rb) || (a.pos_out != a.pos)
                      || (a.off_out != a.off) || (a.tc_out != a.tc)
                      || (a.tlc_out != a.tlc);
  int64_t work = a.P * a.R > a.T * a.B1 ? a.P * a.R : a.T * a.B1;
  int64_t copy_blocks = copies ? (work + threads - 1) / threads : 0;
  copy_blocks = copy_blocks > 2048 ? 2048 : copy_blocks;
  apply_bucket_kernel<<<static_cast<unsigned>(tiles + copy_blocks), threads,
                        0, s>>>(a, static_cast<int>(tiles),
                                static_cast<int>(tile), bits, broker_bits);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t broker_blocks = (a.B1 + kWarps - 1) / kWarps;
  const int64_t cand_blocks = (a.N + kThreads - 1) / kThreads;
  const auto apply = tiles > kMaxTiles ? apply_group_kernel<true>
                                       : apply_group_kernel<false>;
  apply<<<static_cast<unsigned>(broker_blocks + cand_blocks), kThreads, 0,
          s>>>(a, broker_blocks, static_cast<int>(tiles),
               static_cast<int>(tile));
  return static_cast<int>(cudaGetLastError());
}

// sizeof(ApplyArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_apply_args_size() { return sizeof(ApplyArgs); }
