// KZ: a replica drain round up to its fill -- the shed quota, every slot's
// weight, candidacy and tie-break noise, and the slots' order by (broker,
// must-move first, weight descending with noise), in five launches after a
// memset. KP (drain_fill.cu) takes the order from there.
//
// Replaces cruise_control_tpu/analyzer/goals.py:_replica_bulk_drain up to
// its lexsort (:486-548): the broker planes and the quota (:500-525), the
// weights and candidates (:527-538), the noise drawn from the round's key
// (:542) and jnp.lexsort((-sort_w, ~must, broker)) (:548). In plain torch
// (the twin, kernels.drain_order_plain) about 40 launches: the planes, four
// tree sums of two launches each, the noise (KA) and three stable
// torch.sorts.
//
// Over the n = P x R slots, as the reference computes them:
//  - quota (drain.cuh:shed_quota, one block): the metric, its bounds, the
//    excess and deficit, and the shed quota a broker;
//  - a slot's weight w (1 for a count goal, else the leader's or the
//    follower's load column by slot), cand = movable & (w > 0 | offline) &
//    (quota[broker] > 0 | offline), must = offline & cand, the noise 1 +
//    0.01 u with u threefry's uniform at the slot's counter under the
//    round's key (KA's draw, csrc/threefry.cuh: the float64 product and
//    sum rounded once, bit for bit _random.affine), sort_w = cand ? w x
//    noise : -1;
//  - the order: a stable sort by broker, then must-moves first, then
//    -sort_w ascending (-0.0 equal to +0.0, NaN last), then the slot's
//    index -- drain.cuh's segmented sort over the unique 64-bit key
//    (not must) | sort_image(-sort_w) | slot, each broker a segment.
//
// The launches: L1 the quota (block 0) and the slots a broker (the other
// blocks; a warp's slots of one broker take one integer atomic); L2 one
// block: where each broker's run starts; L3 a thread a slot: its fields,
// its key into its broker's run; L4 a block a run (a chunk of 4,096 keys
// of a longer run) sorting it in shared memory, writing the order; L5 a
// thread a slot of a longer run: its place across the run's chunks. What
// bounds it: the launches and the longest run's sort (a bitonic network of
// 78 barrier steps at 4,096 keys); the bytes (~40 a slot) are a few
// microseconds at the scale cell.

#include <cstdint>
#include <cuda_runtime.h>

#include "bounds.cuh"
#include "drain.cuh"
#include "ordered.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrepBlocks = 64;            // blocks counting the slots

}  // namespace

struct OrderArgs {
  // the goal's row and the broker planes it reads (KY's)
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const float* cap;            // [B1, 4]
  const uint8_t* bvalid;       // [B1]
  const uint8_t* balive;       // [B1]
  const ViolRow* rows;         // [1] on the card: the goal's interval row
  // the slots
  const int64_t* rb;           // [P, R] brokers
  const uint8_t* off;          // [P, R] offline
  const uint8_t* movable;      // [P, R]
  const float* leader_load;    // [P, 4]
  const float* follower_load;  // [P, 4]
  const int64_t* key;          // the round's root key, int64[2]
  // outputs
  float* planes;               // [6, B1]: values, up, deficit, quota, and
                               // the excess and pool the sums read
  float* w;                    // [n] the slots' drain weights
  uint8_t* cand;               // [n]
  uint8_t* must;               // [n]
  int64_t* order;              // [n]
  // scratch
  int32_t* counts;             // [2, B1] slots a broker, slots placed
                               // (zeroed by the launcher)
  int32_t* start;              // [B1 + 1] where a broker's run starts
  int32_t* chunk_first;        // [B1 + 1] a run's first sort chunk
  uint64_t* keys;              // [n] the slots' keys, grouped by broker
  uint64_t* runs;              // [n] the sorted chunks of longer runs
  float* scratch;              // tree_scratch(B1) floats
  int64_t P, R, B1;
  int32_t weight;              // -1: every slot weighs 1, else a load column
};

namespace {

__device__ __forceinline__ int32_t broker_of(const OrderArgs& a, int64_t i) {
  const int64_t b = a.rb[i];
  return static_cast<int32_t>(ordered::clamp_index(b, a.B1));
}

__global__ void __launch_bounds__(kThreads) order_prep_kernel(
    const OrderArgs a) {
  __shared__ long long red[kThreads / 32];
  const int64_t n = a.P * a.R;
  if (blockIdx.x == 0) {
    const ViolRow row = a.rows[0];
    const int64_t B1 = a.B1;
    const bounds::Brokers br{a.util, a.cnt, a.lead, a.pot, a.lni, a.cap,
                             a.bvalid, a.balive};
    const drain::QuotaOut o{a.planes, a.planes + B1, a.planes + 4 * B1,
                            a.planes + 2 * B1, a.planes + 5 * B1,
                            a.planes + 3 * B1, nullptr};
    drain::shed_quota(row, br, B1, nullptr, o, a.scratch, red);
    return;
  }
  // the slots a broker (a block's base is the same on every lane, so the
  // warps stay converged for the atomics)
  const int64_t stride = static_cast<int64_t>(gridDim.x - 1) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x - 1) * blockDim.x;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    drain::claim(a.counts, i < n ? broker_of(a, i) : -1);
  }
}

__global__ void __launch_bounds__(1024) order_starts_kernel(
    const OrderArgs a) {
  drain::segment_starts(a.counts, a.B1, a.start, a.chunk_first);
}

__global__ void __launch_bounds__(kThreads) order_keys_kernel(
    const OrderArgs a, const DrawPath path) {
  const int64_t n = a.P * a.R;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  int32_t b = -1;
  uint64_t key = 0;
  if (i < n) {
    b = broker_of(a, i);
    const int64_t p = i / a.R, r = i % a.R;
    const bool off = a.off[i] != 0;
    const float w = a.weight < 0
        ? 1.0f
        : (r == 0 ? a.leader_load : a.follower_load)[p * 4 + a.weight];
    const float quota = a.planes[3 * a.B1 + b];
    const bool cand = a.movable[i] != 0 && (w > 0.0f || off)
                      && (quota > 0.0f || off);
    const bool must = off && cand;
    uint32_t k0, k1;
    threefry::derive(a.key, path, k0, k1);
    const float noise = threefry::affine(
        threefry::bits_at(k0, k1, static_cast<uint64_t>(i)), 0.01f, 1.0f);
    const float sort_w = cand ? __fmul_rn(w, noise) : -1.0f;
    a.w[i] = w;
    a.cand[i] = cand;
    a.must[i] = must;
    key = (static_cast<uint64_t>(!must) << 63)
          | (static_cast<uint64_t>(drain::sort_image(-sort_w)) << 31)
          | static_cast<uint64_t>(i);
  }
  const int32_t place = drain::claim(a.counts + a.B1, b);
  if (i < n) a.keys[a.start[b] + place] = key;
}

__global__ void __launch_bounds__(drain::kSortThreads) order_chunk_kernel(
    const OrderArgs a) {
  __shared__ uint64_t s[drain::kSortTile];
  int64_t* order = a.order;
  drain::sort_chunk(blockIdx.x, a.keys, a.runs, a.start, a.chunk_first,
                    a.B1, s, [=](int64_t at, uint64_t k) {
                      order[at] = static_cast<int64_t>(k & 0x7fffffffu);
                    });
}

__global__ void __launch_bounds__(kThreads) order_merge_kernel(
    const OrderArgs a) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (q >= a.P * a.R) return;
  int64_t* order = a.order;
  drain::merge_runs(q, a.runs, a.start, a.B1, [=](int64_t at, uint64_t k) {
    order[at] = static_cast<int64_t>(k & 0x7fffffffu);
  });
}

}  // namespace

// Floats of KZ's scratch at B1 brokers.
extern "C" int64_t cc_drain_order_scratch(int64_t b1) {
  return ordered::tree_scratch(b1) + 1;
}

// KZ's memset and five launches on ``stream``; returns cudaGetLastError().
extern "C" int cc_drain_order(const OrderArgs* args, DrawPath path,
                              void* stream) {
  const OrderArgs& a = *args;
  const int64_t n = a.P * a.R;
  if (n <= 0 || a.B1 <= 0 || a.R <= 0 || n >= (int64_t{1} << 31)
      || a.B1 >= (int64_t{1} << 30) || a.rows == nullptr || path.n < 0
      || path.n > threefry::kMaxPath || a.weight > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.counts, 0, 2 * a.B1 * sizeof(int32_t),
                                  s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t slot_blocks = (n + kThreads - 1) / kThreads;
  const int64_t count_blocks = slot_blocks < kPrepBlocks ? slot_blocks
                                                         : kPrepBlocks;
  int err;
  order_prep_kernel<<<static_cast<unsigned>(1 + count_blocks), kThreads, 0,
                      s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  order_starts_kernel<<<1, 1024, 0, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  order_keys_kernel<<<static_cast<unsigned>(slot_blocks), kThreads, 0, s>>>(
      a, path);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  order_chunk_kernel<<<static_cast<unsigned>(
                          a.B1 + (n + drain::kSortTile - 1) / drain::kSortTile),
                      drain::kSortThreads, 0, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  order_merge_kernel<<<static_cast<unsigned>(slot_blocks), kThreads, 0, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(OrderArgs), which the host's ctypes struct must equal
extern "C" int64_t cc_order_args_size() { return sizeof(OrderArgs); }
