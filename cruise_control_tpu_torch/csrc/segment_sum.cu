// KB: ordered segment sum of float32 rows, with an optional batch axis.
//
// For each batch item b and segment s < S:
//   out[b, s, c] = base[b, s, c] (or 0) + values[b, i0, c] + values[b, i1, c]
//                  + ...
// over the rows i0 < i1 < ... of item b whose segment id is s, added one at
// a time in ascending row order. That is the order XLA's CPU scatter-add
// applies its updates in, so the port's broker aggregates are reproducible
// from the seed, run after run — CUDA's float atomics (index_add_) are not.
// Rows whose segment id lies outside [0, S) are dropped.
//
// Replaces the scatter-adds into broker aggregates of
// cruise_control_tpu/analyzer/state.py:init_state (:119-177) and
// apply_group (:420-532), model/flat.py's reductions (:160-254) and
// goals.py:_segment_cum_before's segment_sum (:68-76); the port's
// fixed-order tree sums also reduce through it (the range form below).
//
// What bounds it. The work is a few adds a row, so the bound is bytes
// (each value and id read once, each output written once); but each
// segment's adds form one dependent chain, which may not be split into
// partial sums, and the rows of a segment lie anywhere among the item's
// rows. The first design sorted the ids globally (cub's radix sort, about
// five launches) and gave each (segment, column) chain one thread walking
// `perm[k]` then `values[perm[k]]`: two dependent, uncoalesced global loads
// per add, 420 threads at the main shape.
//
// This design groups the rows on chip, without a global sort and without
// a host sync, for any S. Its time on the H100 is bound by memory latency:
// a block waits on a few dependent round trips (ids, values, counts) and on
// its longest chain, so the forms below keep both few.
//
// The tiled form (S <= 1,024 segments an item, up to 128 columns; every
// shape the port runs): two launches.
// - Group: one block of 256 threads a tile of 1,024 rows of one item. Its
//   warps read their slices' ids coalesced and group the lanes of each
//   slice by segment with one ballot a bit of the id (a lane's rank is the
//   count of earlier lanes with its id plus the id's earlier rows in the
//   warp); one exclusive scan over the (segment, warp) counts places every
//   row. The tile's rows land in shared memory grouped by segment, each
//   segment's rows in ascending row order, and go out to the tile's own
//   slots of a scratch buffer in coalesced stores, with each segment's
//   start in the tile.
// - Chain: one block of 128 threads a (item, segment). It reads the
//   segment's start and count in every tile, gathers the runs in tile order
//   into shared memory (every thread's loads issue at once), and one thread
//   a column adds them in order: registers hold the next 16 rows while the
//   current 16 are added, so only the adds wait on each other.
// The chains are the dependency: they wait for every tile, so the grouping
// is its own launch; both launches capture in a CUDA graph.
//
// The wide form (more segments an item): one launch. A block owns G
// consecutive segments of one item and up to four columns and scans the
// item's rows in rounds of up to 7,680: its scan warps group each round's
// rows into shared memory as above (G chosen from the shapes so that the
// blocks fill the card once), while its chain warps, one thread a
// (segment, column) chain, add the previous round's rows.
//
// In every form no add reads global memory, no chain is split, and no
// atomics touch a float: the result is bit-exact against the sequential
// twin.
//
// The range form (`cc_ordered_range_sum`) takes segments that are already
// contiguous runs of rows (the fixed-window tree sums): one warp per run
// loads 32 rows at a time coalesced and adds them in order from registers
// (each add takes its row by shuffle; the shuffles do not wait on the
// chain, so they pipeline).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlices = 16;                        // slices a warp, a round
constexpr int kCols = 4;                           // columns a block
constexpr int kMaxChains = 256;                    // chain threads a block
constexpr int kBatch = 16;                         // rows a chain loads ahead
// the most rows a round groups: every warp but one chain warp scanning
constexpr int kRoundMax = (kWarps - 1) * 32 * kSlices;
constexpr unsigned kFull = 0xffffffffu;
// the tiled form
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileSlices = 4;                     // slices a warp, a tile
constexpr int kTileRows = kTileThreads * kTileSlices;
constexpr int kTileMaxSegs = 1024;                 // counts fit 32 KB
constexpr int kChainThreads = 128;
constexpr int kTileChunk = 256;                    // tiles a chain pass
constexpr int kCopy = 8;                           // rows a thread copies
constexpr int kListBytes = 16 * 1024;              // the chain's list
constexpr int64_t kTargetBlocks = 132;             // one an H100 SM

// The lanes of a warp whose `v` equals this lane's, for v in [0, 2^bits):
// one ballot a bit.
__device__ __forceinline__ unsigned match_peers(int v, int bits) {
  unsigned peers = kFull;
  for (int b = 0; b < bits; ++b) {
    const bool one = (v >> b) & 1;
    const unsigned m = __ballot_sync(kFull, one);
    peers &= one ? m : ~m;
  }
  return peers;
}

// Bits that hold the values 0..n.
__device__ __forceinline__ int bits_for(int n) { return 32 - __clz(n); }

// Exclusive scan of cnt[0, n) in place; returns the total. Every thread of
// the block (Threads of them) must call it; warp_sums holds Threads / 32.
template <int Threads>
__device__ int block_exclusive_scan(int* cnt, int n, int* warp_sums) {
  constexpr int warps = Threads / 32;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n + Threads - 1) / Threads;
  const int lo = min(t * per, n);
  const int hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += cnt[i];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += up;
    }
    if (lane < warps) warp_sums[lane] = w;         // inclusive
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = cnt[i];
    cnt[i] = run;
    run += c;
  }
  const int total = warp_sums[warps - 1];
  __syncthreads();
  return total;
}

// --- The tiled form (S <= kTileMaxSegs): group, then chain. -------------

// Pass 1: one block groups one tile of kTileRows rows of one item by
// segment, stably (warp slices by match_peers, then one scan over
// the (segment, warp) counts), and writes the tile's rows to `sorted`
// (its own kTileRows slots) and each segment's start in the tile to
// `table[item][tile][0..S]` (entry S: the tile's rows in range).
template <typename Id>
__global__ void __launch_bounds__(kTileThreads)
tile_group_kernel(const float* __restrict__ values, const Id* __restrict__ ids,
                  float* __restrict__ sorted, int* __restrict__ table,
                  int64_t n_rows, int64_t n_segs, int64_t n_cols,
                  int64_t n_tiles) {
  extern __shared__ int shared[];
  int* cnt = shared;                               // [S][kTileWarps]
  int* warp_sums = cnt + n_segs * kTileWarps;      // [kTileWarps]
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t item = blockIdx.x / n_tiles;
  const int64_t r0 = (blockIdx.x % n_tiles) * kTileRows;
  const int nseg = static_cast<int>(n_segs);
  const Id* item_ids = ids + item * n_rows;

  Id id[kTileSlices];
  const int64_t warp_row0 = r0 + warp * 32 * kTileSlices;
#pragma unroll
  for (int j = 0; j < kTileSlices; ++j) {
    const int64_t row = warp_row0 + j * 32 + lane;
    id[j] = row < n_rows ? item_ids[row] : static_cast<Id>(-1);
  }
  for (int i = t; i < nseg * kTileWarps; i += kTileThreads) cnt[i] = 0;
  __syncthreads();
  int slot[kTileSlices];                           // rank, or -1
  int seg[kTileSlices];
  const int seg_bits = bits_for(nseg);
#pragma unroll
  for (int j = 0; j < kTileSlices; ++j) {
    const int64_t row = warp_row0 + j * 32 + lane;
    const int ls = (row < n_rows && id[j] >= 0 && id[j] < n_segs)
                       ? static_cast<int>(id[j]) : -1;
    // out-of-range rows all match the value S, and are never placed
    const unsigned peers = match_peers(ls >= 0 ? ls : nseg, seg_bits);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (ls >= 0 && lane == leader) {
      before = cnt[ls * kTileWarps + warp];
      cnt[ls * kTileWarps + warp] = before + __popc(peers);
    }
    before = __shfl_sync(kFull, before, leader);
    slot[j] = ls >= 0 ? before + __popc(peers & lanes_below) : -1;
    seg[j] = ls;
    __syncwarp();
  }
  __syncthreads();
  const int total = block_exclusive_scan<kTileThreads>(
      cnt, nseg * kTileWarps, warp_sums);
  int* tile_table = table + blockIdx.x * (n_segs + 1);
  for (int s = t; s < nseg; s += kTileThreads)
    tile_table[s] = cnt[s * kTileWarps];
  if (t == 0) tile_table[nseg] = total;
  const float* item_vals = values + item * n_rows * n_cols;
  float* tile_sorted = sorted + (item * n_rows + r0) * n_cols;
  int pos[kTileSlices];
#pragma unroll
  for (int j = 0; j < kTileSlices; ++j)
    pos[j] = slot[j] >= 0 ? cnt[seg[j] * kTileWarps + warp] + slot[j] : -1;
  __syncthreads();                     // the counts' space becomes the stage
  // Four columns at a time: the rows land in shared memory in their
  // grouped order, then go out to the tile's slots in coalesced stores.
  float* stage = reinterpret_cast<float*>(shared);      // [kTileRows][4]
  for (int64_t c0 = 0; c0 < n_cols; c0 += 4) {
    const int cw = static_cast<int>(min(static_cast<int64_t>(4),
                                        n_cols - c0));
    float v[kTileSlices][4];
#pragma unroll
    for (int j = 0; j < kTileSlices; ++j) {
      const int64_t row = warp_row0 + j * 32 + lane;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[j][c] = pos[j] >= 0 && c < cw ? item_vals[row * n_cols + c0 + c]
                                        : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kTileSlices; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (pos[j] >= 0) stage[pos[j] * 4 + c] = v[j][c];
    }
    __syncthreads();
    for (int k = t; k < total * cw; k += kTileThreads) {
      const int r = k / cw;
      const int c = k - r * cw;
      tile_sorted[static_cast<int64_t>(r) * n_cols + c0 + c] =
          stage[r * 4 + c];
    }
    __syncthreads();
  }
}

// Pass 2: one block a (item, segment). It gathers the segment's rows from
// every tile, in tile order, into shared memory (each thread finds its
// row's tile by a binary search over the tiles' prefix counts, so all its
// loads issue at once), and one thread a column adds them in order. A
// segment of more rows than the list holds goes in several passes. A
// chain of n rows is n dependent adds: the block's floor.

// acc plus list rows [0, n) (stride `cols`) in order: a batch of rows is
// loaded into registers while the one before it is added, so only the adds
// wait on each other; the rest one at a time.
__device__ __forceinline__ void add_rows(float& acc, const float* list,
                                         int n, int cols) {
  float now[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) now[j] = list[j * cols];
  int p = 0;
  for (; p + kBatch <= n; p += kBatch) {
    float next[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) next[j] = list[(p + kBatch + j) * cols];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc = __fadd_rn(acc, now[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) now[j] = next[j];
  }
  for (; p < n; ++p) acc = __fadd_rn(acc, list[p * cols]);
}

__global__ void __launch_bounds__(kChainThreads)
tile_chain_kernel(const float* __restrict__ sorted,
                  const int* __restrict__ table,
                  const float* __restrict__ base, float* __restrict__ out,
                  int64_t n_rows, int64_t n_segs, int64_t n_cols,
                  int64_t n_tiles, int list_rows) {
  extern __shared__ int shared[];
  int* start = shared;                             // [kTileChunk]
  int* prefix = start + kTileChunk;                // [kTileChunk]
  int* warp_sums = prefix + kTileChunk;            // [kChainThreads / 32]
  float* list = reinterpret_cast<float*>(warp_sums + kChainThreads / 32);
  const int t = threadIdx.x;
  const int64_t item = blockIdx.x / n_segs;
  const int64_t s = blockIdx.x % n_segs;
  const bool chain = t < n_cols;
  float acc = 0.0f;
  if (chain && base != nullptr)
    acc = base[(item * n_segs + s) * n_cols + t];

  for (int64_t k0 = 0; k0 < n_tiles; k0 += kTileChunk) {
    const int tiles = static_cast<int>(min(static_cast<int64_t>(kTileChunk),
                                           n_tiles - k0));
    for (int k = t; k < tiles; k += kChainThreads) {
      const int* row = table + ((item * n_tiles) + k0 + k) * (n_segs + 1);
      start[k] = row[s];
      prefix[k] = row[s + 1] - row[s];
    }
    __syncthreads();
    const int rows = block_exclusive_scan<kChainThreads>(prefix, tiles,
                                                         warp_sums);
    for (int q0 = 0; q0 < rows; q0 += list_rows) {
      const int n = min(list_rows, rows - q0);
      for (int qb = 0; qb < n; qb += kCopy * kChainThreads) {
        int64_t src[kCopy];
#pragma unroll
        for (int r = 0; r < kCopy; ++r) {
          const int q = qb + r * kChainThreads + t;
          // the last tile whose prefix is at most q0 + q
          int lo = 0;
#pragma unroll
          for (int step = kTileChunk / 2; step > 0; step >>= 1)
            if (lo + step < tiles && prefix[lo + step] <= q0 + q) lo += step;
          src[r] = q < n ? item * n_rows + (k0 + lo) * kTileRows + start[lo]
                               + (q0 + q - prefix[lo])
                         : -1;
        }
        for (int64_t c0 = 0; c0 < n_cols; c0 += 4) {
          float v[kCopy][4];
#pragma unroll
          for (int r = 0; r < kCopy; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[r][c] = src[r] >= 0 && c0 + c < n_cols
                            ? sorted[src[r] * n_cols + c0 + c] : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < kCopy; ++r) {
            const int q = qb + r * kChainThreads + t;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (src[r] >= 0 && c0 + c < n_cols)
                list[q * n_cols + c0 + c] = v[r][c];
          }
        }
      }
      __syncthreads();
      if (chain) add_rows(acc, list + t, n, static_cast<int>(n_cols));
      __syncthreads();
    }
  }
  if (chain) out[(item * n_segs + s) * n_cols + t] = acc;
}

// --- The wide form (S > kTileMaxSegs): one launch, blocks of segments. ---

template <typename Id>
__global__ void __launch_bounds__(kThreads)
ordered_segment_sum_kernel(const float* __restrict__ values,
                           const Id* __restrict__ ids,
                           const float* __restrict__ base,
                           float* __restrict__ out, int64_t n_rows,
                           int64_t n_segs, int64_t n_cols, int64_t group,
                           int64_t blocks_per_item) {
  extern __shared__ int shared[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  const int64_t item = blockIdx.x / blocks_per_item;
  const int64_t s0 = (blockIdx.x % blocks_per_item) * group;
  const int g_here = static_cast<int>(min(group, n_segs - s0));
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int cg =
      static_cast<int>(min(static_cast<int64_t>(kCols), n_cols - c0));
  if (g_here <= 0) return;

  // The last warps run the chains, the others group the rows.
  const int chain_warps = (g_here * cg + 31) / 32;
  const int scan_warps = kWarps - chain_warps;
  const bool chain_warp = warp >= scan_warps;
  const int64_t round_rows = static_cast<int64_t>(scan_warps) * 32 * kSlices;

  const int counts = static_cast<int>(group) * kWarps;
  int* cnt = shared;                         // [2][group * kWarps]
  int* warp_sums = cnt + 2 * counts;         // [kWarps]
  float* list = reinterpret_cast<float*>(warp_sums + kWarps);

  const Id* item_ids = ids + item * n_rows;
  const float* item_vals = values + item * n_rows * n_cols;

  // this thread's chain: segment s0 + chain_g, column c0 + chain_c
  const int ct = t - scan_warps * 32;
  const bool chain = chain_warp && ct < g_here * cg;
  const int chain_g = chain ? ct / cg : 0;
  const int chain_c = chain ? ct % cg : 0;
  float acc = 0.0f;
  if (chain && base != nullptr)
    acc = base[((item * n_segs) + s0 + chain_g) * n_cols + c0 + chain_c];
  int from = 0, to = 0;              // the chain's rows of the last round

  // A scan warp holds its next slices' ids while the block places the
  // current round, so their loads wait behind the round's other work.
  Id id[kSlices];
  auto load_ids = [&](int64_t r0) {
    const int64_t row0 = r0 + static_cast<int64_t>(warp) * 32 * kSlices;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const int64_t row = row0 + j * 32 + lane;
      id[j] = row < n_rows ? item_ids[row] : static_cast<Id>(-1);
    }
  };
  if (!chain_warp) load_ids(0);
  for (int i = t; i < g_here * kWarps; i += kThreads) cnt[i] = 0;
  __syncthreads();
  for (int64_t r0 = 0, buf = 0;; r0 += round_rows, buf ^= 1) {
    const bool more = r0 < n_rows;
    int* c_now = cnt + buf * counts;
    int* c_next = cnt + (buf ^ 1) * counts;
    int slot[kSlices];               // rank << 8 | local segment, or -1
    const int64_t warp_row0 = r0 + static_cast<int64_t>(warp) * 32 * kSlices;
    if (!chain_warp) {
      if (more) {
        // Group this warp's 32 x kSlices rows: each slice's lanes by local
        // segment, ranked after the same segment's earlier rows.
        const int group_bits = bits_for(g_here);
#pragma unroll
        for (int j = 0; j < kSlices; ++j) {
          const int64_t row = warp_row0 + j * 32 + lane;
          const int64_t d = static_cast<int64_t>(id[j]) - s0;
          const int ls = (row < n_rows && d >= 0 && d < g_here)
                             ? static_cast<int>(d) : -1;
          const unsigned peers = match_peers(ls >= 0 ? ls : g_here,
                                             group_bits);
          const int leader = __ffs(peers) - 1;
          int before = 0;
          if (ls >= 0 && lane == leader) {
            before = c_now[ls * kWarps + warp];
            c_now[ls * kWarps + warp] = before + __popc(peers);
          }
          before = __shfl_sync(kFull, before, leader);
          slot[j] = ls >= 0
              ? (before + __popc(peers & lanes_below)) << 8 | ls : -1;
          __syncwarp();
        }
        if (r0 + round_rows < n_rows) load_ids(r0 + round_rows);
      }
    } else if (chain) {
      // The previous round's rows of this chain, in order, while the other
      // warps group this round's. Loads run a batch ahead of the adds.
      const float* mine = list + chain_c;
      int p = from;
      float now[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) now[k] = mine[(p + k) * kCols];
      for (; p + kBatch <= to; p += kBatch) {
        float next[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          next[k] = mine[(p + kBatch + k) * kCols];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc = __fadd_rn(acc, now[k]);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) now[k] = next[k];
      }
      for (; p < to; ++p) acc = __fadd_rn(acc, mine[p * kCols]);
    }
    if (!more) break;
    __syncthreads();
    const int total = block_exclusive_scan<kThreads>(c_now, g_here * kWarps,
                                                     warp_sums);
    if (chain) {
      from = c_now[chain_g * kWarps];
      to = chain_g + 1 < g_here ? c_now[(chain_g + 1) * kWarps] : total;
    }
    if (!chain_warp) {
      // Each half's values are loaded together, then placed.
#pragma unroll
      for (int half = 0; half < kSlices; half += kSlices / 2) {
        float v[kSlices / 2][kCols];
#pragma unroll
        for (int j = 0; j < kSlices / 2; ++j) {
          const int64_t row = warp_row0 + (half + j) * 32 + lane;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            v[j][c] = slot[half + j] >= 0 && c < cg
                          ? item_vals[row * n_cols + c0 + c] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kSlices / 2; ++j) {
          const int sl = slot[half + j];
          if (sl >= 0) {
            const int pos = c_now[(sl & 255) * kWarps + warp] + (sl >> 8);
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (c < cg) list[pos * kCols + c] = v[j][c];
          }
        }
      }
    }
    for (int i = t; i < g_here * kWarps; i += kThreads) c_next[i] = 0;
    __syncthreads();
  }
  if (chain)
    out[((item * n_segs) + s0 + chain_g) * n_cols + c0 + chain_c] = acc;
}

__global__ void ordered_range_sum_kernel(const float* __restrict__ values,
                                         const int64_t* __restrict__ offsets,
                                         float* __restrict__ out,
                                         int64_t n_runs, int64_t n_cols) {
  const int lane = threadIdx.x & 31;
  const int64_t run = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32)
                      + (threadIdx.x >> 5);
  if (run >= n_runs) return;                       // whole warps leave
  const int64_t a = offsets[run];
  const int64_t b = offsets[run + 1];
  for (int64_t c = 0; c < n_cols; ++c) {
    float acc = 0.0f;
    for (int64_t p = a; p < b; p += 32) {
      const int n = static_cast<int>(min(static_cast<int64_t>(32), b - p));
      const float mine = lane < n ? values[(p + lane) * n_cols + c] : 0.0f;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float x = __shfl_sync(kFull, mine, k);
        if (k < n) acc = __fadd_rn(acc, x);
      }
    }
    if (lane == 0) out[run * n_cols + c] = acc;
  }
}

size_t segment_sum_shared_bytes(int64_t group) {
  // the chains load a batch past their last row: two batches of slack
  return (2 * group * kWarps + kWarps) * sizeof(int)
         + static_cast<size_t>(kRoundMax + 2 * kBatch) * kCols
               * sizeof(float);
}

template <typename Id>
int launch_segment_sum(const void* values, const void* ids, const void* base,
                       void* out, int64_t items, int64_t n_rows,
                       int64_t n_segs, int64_t n_cols, int64_t group,
                       cudaStream_t stream) {
  const size_t shared = segment_sum_shared_bytes(group);
  static size_t granted = 48 * 1024;
  if (shared > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ordered_segment_sum_kernel<Id>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = shared;
  }
  const int64_t blocks_per_item = (n_segs + group - 1) / group;
  const dim3 grid(static_cast<unsigned>(items * blocks_per_item),
                  static_cast<unsigned>((n_cols + kCols - 1) / kCols));
  ordered_segment_sum_kernel<Id><<<grid, kThreads, shared, stream>>>(
      static_cast<const float*>(values), static_cast<const Id*>(ids),
      static_cast<const float*>(base), static_cast<float*>(out), n_rows,
      n_segs, n_cols, group, blocks_per_item);
  return static_cast<int>(cudaGetLastError());
}

template <typename Id>
int launch_tiled(const void* values, const void* ids, const void* base,
                 void* out, int64_t items, int64_t n_rows, int64_t n_segs,
                 int64_t n_cols, void* sorted, void* table,
                 cudaStream_t stream) {
  const int64_t n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  if (n_tiles > 0) {
    const size_t counts = (n_segs + 1) * kTileWarps * sizeof(int);
    const size_t stage = kTileRows * 4 * sizeof(float);
    const size_t shared = counts > stage ? counts : stage;
    tile_group_kernel<Id><<<static_cast<unsigned>(items * n_tiles),
                            kTileThreads, shared, stream>>>(
        static_cast<const float*>(values), static_cast<const Id*>(ids),
        static_cast<float*>(sorted), static_cast<int*>(table), n_rows,
        n_segs, n_cols, n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the list, less the chains' two batches of read-ahead slack
  const int list_rows =
      static_cast<int>(kListBytes / (n_cols * sizeof(float))) - 2 * kBatch;
  const size_t shared = (2 * kTileChunk + kChainThreads / 32) * sizeof(int)
                        + static_cast<size_t>(list_rows + 2 * kBatch)
                              * n_cols * sizeof(float);
  tile_chain_kernel<<<static_cast<unsigned>(items * n_segs), kChainThreads,
                      shared, stream>>>(
      static_cast<const float*>(sorted), static_cast<const int*>(table),
      static_cast<const float*>(base), static_cast<float*>(out), n_rows,
      n_segs, n_cols, n_tiles, list_rows);
  return static_cast<int>(cudaGetLastError());
}

bool tiled(int64_t n_segs, int64_t n_cols) {
  return n_segs <= kTileMaxSegs && n_cols <= kChainThreads;
}

// Segments a block owns: at most `most` (its chain threads' limit), and
// few enough that items x blocks fill the card's 132 SMs once where the
// batch is small. A block's time is about its item's rows and its
// longest chain, so splitting an item further gains nothing.
int64_t pick_group(int64_t items, int64_t n_segs, int64_t most,
                   int64_t col_groups) {
  const int64_t fill = (kTargetBlocks + items * col_groups - 1)
                       / (items * col_groups);
  int64_t blocks = (n_segs + most - 1) / most;
  if (fill > blocks) blocks = fill;
  if (blocks > n_segs) blocks = n_segs;
  return (n_segs + blocks - 1) / blocks;
}

}  // namespace

// The scratch a call needs: `sizes[0]` floats (the grouped rows) and
// `sizes[1]` ints (each tile's segment starts); 0 and 0 for the wide form.
extern "C" void cc_ordered_segment_sum_scratch(int64_t items, int64_t n_rows,
                                               int64_t n_segs,
                                               int64_t n_cols,
                                               int64_t* sizes) {
  const bool tile = tiled(n_segs, n_cols);
  sizes[0] = tile ? items * n_rows * n_cols : 0;
  sizes[1] = tile ? items * ((n_rows + kTileRows - 1) / kTileRows)
                        * (n_segs + 1)
                  : 0;
}

// Segments with ids outside [0, n_segs) drop. Up to kTileMaxSegs segments
// and 16 columns the tiled form runs (two launches; `sorted` and `table` of
// the sizes above); beyond, the wide form (one launch). `ids64` selects
// int64 ids, else int32.
extern "C" int cc_ordered_segment_sum(const void* values, const void* ids,
                                      int ids64, const void* base, void* out,
                                      int64_t items, int64_t n_rows,
                                      int64_t n_segs, int64_t n_cols,
                                      void* sorted, void* table,
                                      void* stream) {
  if (items <= 0 || n_segs <= 0 || n_cols <= 0)
    return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (tiled(n_segs, n_cols)) {
    if (n_rows > 0 && (sorted == nullptr || table == nullptr))
      return cudaErrorInvalidValue;
    return ids64 ? launch_tiled<int64_t>(values, ids, base, out, items,
                                         n_rows, n_segs, n_cols, sorted,
                                         table, s)
                 : launch_tiled<int32_t>(values, ids, base, out, items,
                                         n_rows, n_segs, n_cols, sorted,
                                         table, s);
  }
  const int64_t cols = n_cols < kCols ? n_cols : kCols;
  const int64_t group = pick_group(items, n_segs, kMaxChains / cols,
                                   (n_cols + kCols - 1) / kCols);
  return ids64 ? launch_segment_sum<int64_t>(values, ids, base, out, items,
                                             n_rows, n_segs, n_cols, group, s)
               : launch_segment_sum<int32_t>(values, ids, base, out, items,
                                             n_rows, n_segs, n_cols, group, s);
}

extern "C" int cc_ordered_range_sum(const void* values, const void* offsets,
                                    void* out, int64_t n_runs,
                                    int64_t n_cols, void* stream) {
  if (n_runs > 0 && n_cols > 0) {
    const int threads = 256;
    const int64_t runs_a_block = threads / 32;
    const int64_t blocks = (n_runs + runs_a_block - 1) / runs_a_block;
    ordered_range_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values),
        static_cast<const int64_t*>(offsets), static_cast<float*>(out),
        n_runs, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}
