// KS: the destination side of the goals' candidate generators.
//
// Replaces, in cruise_control_tpu/analyzer/goals.py:
// - _top_replica_dest_grid's destination short-list (:96-195): the
//   priority where(dest_allowed, plane, -inf) plus its noise, then the top
//   D, descending, the lower index first among ties (lax.top_k's order),
//   the plane _count_replicas_norm or MinTopicLeadersPerBrokerGoal's
//   _norm01(deficit.sum(0)) (:1489-1508), formed here;
// - TopicReplicaDistributionGoal's per-candidate destination (:1221-1324
//   through _legal_dest_argmax): fma(noise, scale, 2 * norm01(deficit[t_k])
//   + count_norm) over the [K, B1] grid, the norm ranging over the whole
//   gathered grid (so after the top-k), the partition's hosts (the
//   sentinel column B included) and barred brokers at -inf, the first
//   maximum;
// - its swap's light partner and destination: a broker's light partner is
//   the highest slot among the ties of the maximum of a uniform draw over
//   its light slots ((-inf, INT32_MIN) with no slot; the sentinel column a
//   broker like any), and each heavy replica's destination the first
//   maximum of _plus_noise(_norm01(-tc)[t1]) (the norm over all [T, B1]
//   cells) where a partner, the raw destination filter and no host of
//   the partition allow it; partner = best_slot[dst].
// In plain torch these were 20-40 launches a call.
//
// Forms (kernels.DEST_FORMS):
// - shortlist: one block. Each broker's (priority, index) is one 64-bit
//   key (select.cuh:total_key: the priority's bits in IEEE total order,
//   +0.0 above -0.0, then the index inverted), so D rounds of a block
//   maximum take the D best in lax.top_k's order; the keys live in a
//   global buffer (one block reads it from L1). The candidates' argmaxes
//   below take -0.0 equal to +0.0, as jnp.argmax does (order_bits).
// - topic_move_dest: two launches -- a warp a candidate writes its topic
//   row's deficit range, then each block folds those K ranges and the
//   count plane's, and a warp a candidate scores its [B1] row with the
//   noise (KA's threefry, threefry.cuh) and takes the first maximum by the
//   same 64-bit keys.
// - topic_swap_dest: after a memset, a launch over the [P, R] slots folds
//   each broker's best light slot into a 64-bit atomicMax ((draw bits,
//   slot + 1); a slot that is not light marks its broker with the bits of
//   -inf; shared memory first where B1 is small) and the [T, B1] counts'
//   range into two more; then a warp a heavy replica as above.
//
// Bound on the card: bytes at these shapes (the [T, B1] counts and the
// [P, R] slots read once); what a call costs is a few dependent launches
// at a launch's floor each, and the hashes of the [K, B1] noise (54,000
// at the main path's K 512 x B1 105).

#include <cstdint>
#include <cuda_runtime.h>

#include "ordered.cuh"
#include "select.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kShortThreads = 1024;
constexpr int kMaxBlocks = 132 * 8;
constexpr float kTiny = 1e-12f;        // _unit01's smallest span
// brokers whose light-partner keys a block stages in shared memory
constexpr int64_t kSharedBrokers = 4096;
constexpr unsigned kFull = 0xffffffffu;

// kernels.DEST_FORMS
enum Form : int32_t { kShortlist = 0, kTopicMove = 1, kTopicSwap = 2 };
// kernels.SHORTLIST_PLANES
enum Plane : int32_t { kCountPlane = 0, kTopicLeadersPlane = 1 };

}  // namespace

struct DestArgs {
  const uint8_t* dest;          // [B1] dest_allowed (raw for the swap)
  const int32_t* cnt;           // [B1] replica counts
  const int32_t* cells;         // [T, B1] topic (leader) counts
  const uint8_t* interested;    // [T]
  const uint8_t* alive;         // [B1]
  const int32_t* topic;         // [P] partition topics
  const int64_t* rb;            // [P, R]
  const uint8_t* movable;       // [P, R]
  const uint8_t* off;           // [P, R]
  const float* bounds;          // [2, T] the topics' (lower, upper), KR's
  const int64_t* idx;           // [K] top-k flat [P, R] indices
  const int64_t* key;           // int64[2] root of the noise's key paths
  float* vals_out;              // [D] shortlist
  int64_t* idx_out;             // [D]
  int64_t* dst_out;             // [K] topic_move_dest
  uint8_t* ok_out;              // [K]
  int64_t* partner_out;         // [K] topic_swap_dest
  float* rowrange;              // [K, 2] topic_move_dest's row ranges
  unsigned long long* best;     // [B1] keys (shortlist, light partners)
  uint32_t* scratch;            // [2] the counts' range (topic_swap_dest)
  int64_t P, R, B1, T, K, D;
  int32_t form, plane, min_count;
  float noise_scale;
  DrawPath path[2];
};

namespace {

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// The order-preserving unsigned image of a float (-0.0 taken as +0.0, as
// jnp.argmax compares).
__device__ __forceinline__ uint32_t order_bits(float x) {
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The key of (value, index) whose maximum is the greatest value, the
// lowest index among equals (-0.0 equal to +0.0).
__device__ __forceinline__ unsigned long long rank_key(float v, int64_t i) {
  return (static_cast<unsigned long long>(order_bits(v)) << 32)
         | (0xffffffffull - static_cast<unsigned long long>(i));
}

__device__ __forceinline__ int64_t key_index(unsigned long long k) {
  return static_cast<int64_t>(0xffffffffull - (k & 0xffffffffull));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ float span_of(float lo, float hi) {
  const float d = __fsub_rn(hi, lo);
  return d < kTiny ? kTiny : d;
}

// _norm01 of a finite x in a range: q * 0.99.
__device__ __forceinline__ float norm01(float x, float lo, float span) {
  return finite(x) ? __fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), 0.99f)
                   : 0.0f;
}

__device__ __forceinline__ int64_t jax_index(int64_t i, int64_t n) {
  return ordered::clamp_index(i < 0 ? i + n : i, n);
}

// uniform(key) at counter c: jax.random.uniform's float of the bits.
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint64_t c) {
  return threefry::affine(threefry::bits_at(k0, k1, c), 1.0f, 0.0f);
}

// Block min and max of (lo, hi) a thread; every thread gets them.
__device__ void block_range(float& lo, float& hi, float* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (lane == 0) {
    s[warp] = lo;
    s[32 + warp] = hi;
  }
  __syncthreads();
  lo = s[0];
  hi = s[32];
  for (int w = 1; w < warps; ++w) {
    lo = fminf(lo, s[w]);
    hi = fmaxf(hi, s[32 + w]);
  }
  __syncthreads();
}

// The range of the count plane -replica_count over every broker.
__device__ void count_range(const DestArgs& a, float& lo, float& hi,
                            float* s) {
  lo = INFINITY;
  hi = -INFINITY;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    const float x = -static_cast<float>(a.cnt[b]);
    lo = fminf(lo, x);
    hi = fmaxf(hi, x);
  }
  block_range(lo, hi, s);
}

// A key's derivation by the first warp into shared memory (k0, k1 a path).
__device__ void derive_keys(const DestArgs& a, int paths, uint32_t* s_key) {
  if (threadIdx.x < 32) {
    for (int j = 0; j < paths; ++j) {
      uint32_t k0, k1;
      threefry::derive(a.key, a.path[j], k0, k1);
      if (threadIdx.x == 0) {
        s_key[2 * j] = k0;
        s_key[2 * j + 1] = k1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// shortlist
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kShortThreads)
shortlist_kernel(const DestArgs a) {
  __shared__ float s_red[64];
  __shared__ uint32_t s_key[2];
  __shared__ unsigned long long s_best[kShortThreads / 32];
  derive_keys(a, 1, s_key);
  // the plane: -replica_count, or the missing leaders a broker
  float lo = INFINITY, hi = -INFINITY;
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    float x;
    if (a.plane == kCountPlane) {
      x = -static_cast<float>(a.cnt[b]);
    } else {
      long long miss = 0;
      if (a.alive[b]) {
        for (int64_t t = 0; t < a.T; ++t) {
          const int32_t d = a.min_count - a.cells[t * a.B1 + b];
          miss += a.interested[t] && d > 0 ? d : 0;
        }
      }
      x = static_cast<float>(miss);
    }
    reinterpret_cast<float*>(a.best)[2 * b] = x;
    lo = fminf(lo, x);
    hi = fmaxf(hi, x);
  }
  block_range(lo, hi, s_red);
  const float span = span_of(lo, hi);
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
    const float x = reinterpret_cast<float*>(a.best)[2 * b];
    float dp = a.dest[b] ? norm01(x, lo, span) : -INFINITY;
    dp = __fadd_rn(dp, finite(dp) ? threefry::affine(
                                        threefry::bits_at(k0, k1, b),
                                        a.noise_scale, 0.0f)
                                  : 0.0f);
    a.best[b] = kselect::total_key(dp, b);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int64_t d = 0; d < a.D; ++d) {
    unsigned long long m = 0ull;
    for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
      const unsigned long long k = a.best[b];
      m = k > m ? k : m;
    }
    m = warp_max(m);
    if (lane == 0) s_best[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < warps; ++w) m = s_best[w] > m ? s_best[w] : m;
      const int64_t b = key_index(m);
      const unsigned long long k = a.best[b];
      const uint32_t e = static_cast<uint32_t>(k >> 32);
      const uint32_t bits = (e & 0x80000000u) ? (e & 0x7fffffffu) : ~e;
      a.vals_out[d] = __uint_as_float(bits);
      a.idx_out[d] = b;
      a.best[b] = 0ull;                  // taken
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// topic_move_dest
// ---------------------------------------------------------------------------

// TopicReplicaDistributionGoal's deficit cell: where(alive, clamp(lower[t]
// - tc, min=0), 0).
__device__ __forceinline__ float deficit_cell(const DestArgs& a, int64_t t,
                                              int64_t b) {
  return a.alive[b] ? ordered::clamp0(__fsub_rn(
                          a.bounds[t],
                          static_cast<float>(a.cells[t * a.B1 + b])))
                    : 0.0f;
}

// A warp a candidate: its topic row's deficit range.
__global__ void __launch_bounds__(kThreads)
move_rows_kernel(const DestArgs a) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * warps
                   + (threadIdx.x >> 5);
       k < a.K; k += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t t = jax_index(a.topic[a.idx[k] / a.R], a.T);
    float lo = INFINITY, hi = -INFINITY;
    for (int64_t b = lane; b < a.B1; b += 32) {
      const float x = deficit_cell(a, t, b);
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (lane == 0) {
      a.rowrange[2 * k] = lo;
      a.rowrange[2 * k + 1] = hi;
    }
  }
}

// Whether broker b hosts a replica of partition row p (the sentinel B
// included).
__device__ __forceinline__ bool hosts(const DestArgs& a, int64_t p,
                                      int64_t b) {
  bool h = false;
  for (int64_t j = 0; j < a.R; ++j) h |= a.rb[p * a.R + j] == b;
  return h;
}

__global__ void __launch_bounds__(kThreads)
move_dest_kernel(const DestArgs a) {
  __shared__ float s_red[64];
  __shared__ uint32_t s_key[2];
  derive_keys(a, 1, s_key);
  float dlo = INFINITY, dhi = -INFINITY;
  for (int64_t k = threadIdx.x; k < a.K; k += blockDim.x) {
    dlo = fminf(dlo, a.rowrange[2 * k]);
    dhi = fmaxf(dhi, a.rowrange[2 * k + 1]);
  }
  block_range(dlo, dhi, s_red);
  float clo, chi;
  count_range(a, clo, chi, s_red);
  const float dspan = span_of(dlo, dhi), cspan = span_of(clo, chi);
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * warps
                   + (threadIdx.x >> 5);
       k < a.K; k += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t p = a.idx[k] / a.R;
    const int64_t t = jax_index(a.topic[p], a.T);
    unsigned long long m = 0ull;
    for (int64_t b = lane; b < a.B1; b += 32) {
      const float cn = norm01(-static_cast<float>(a.cnt[b]), clo, cspan);
      const float base = __fadd_rn(
          __fmul_rn(2.0f, norm01(deficit_cell(a, t, b), dlo, dspan)), cn);
      const float u = uniform(k0, k1, static_cast<uint64_t>(k * a.B1 + b));
      float score = __fmaf_rn(a.noise_scale, u, base);
      if (!a.dest[b] || hosts(a, p, b)) score = -INFINITY;
      const unsigned long long key = rank_key(score, b);
      m = key > m ? key : m;
    }
    m = warp_max(m);
    if (lane == 0) {
      a.dst_out[k] = key_index(m);
      a.ok_out[k] = static_cast<uint32_t>(m >> 32) != order_bits(-INFINITY);
    }
  }
}

// ---------------------------------------------------------------------------
// topic_swap_dest
// ---------------------------------------------------------------------------

// A broker's light-partner word: 0 no slot, the bits of -inf (then 0) a
// slot but none light, else (the draw's bits, the highest slot among the
// ties + 1).
__device__ __forceinline__ int64_t partner_of(unsigned long long w) {
  if (w == 0ull) return -(int64_t{1} << 31);
  if (static_cast<uint32_t>(w >> 32) == order_bits(-INFINITY)) return -1;
  return static_cast<int64_t>(w & 0xffffffffull) - 1;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
light_kernel(const DestArgs a) {
  extern __shared__ unsigned long long s_best[];
  __shared__ uint32_t s_key[2];
  derive_keys(a, 1, s_key);
  if (kShared) {
    for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) s_best[b] = 0ull;
  }
  __syncthreads();
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  const int64_t n = a.P * a.R, cells = a.T * a.B1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int32_t cmin = 0x7fffffff, cmax = -0x7fffffff - 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < (n > cells ? n : cells); i += stride) {
    if (i < cells) {
      const int32_t c = a.cells[i];
      cmin = c < cmin ? c : cmin;
      cmax = c > cmax ? c : cmax;
    }
    if (i < n) {
      const int64_t p = i / a.R;
      const int64_t t = jax_index(a.topic[p], a.T);
      const int64_t b = a.rb[i];
      const float over = ordered::clamp0(__fsub_rn(
          static_cast<float>(a.cells[t * a.B1 + b]), a.bounds[a.T + t]));
      const bool light = a.movable[i] && !a.off[i] && a.dest[b]
                         && over <= 0.0f;
      const unsigned long long w =
          light ? (static_cast<unsigned long long>(
                       order_bits(uniform(k0, k1, i))) << 32)
                      | static_cast<unsigned long long>(i + 1)
                : static_cast<unsigned long long>(order_bits(-INFINITY))
                      << 32;
      atomicMax(kShared ? s_best + b : a.best + b, w);
    }
  }
  // the counts' range: min as the max of the complement of the biased
  // value, max as the max of the biased value (both words start at 0)
  for (int o = 16; o > 0; o >>= 1) {
    const int32_t x = __shfl_xor_sync(kFull, cmin, o);
    const int32_t y = __shfl_xor_sync(kFull, cmax, o);
    cmin = x < cmin ? x : cmin;
    cmax = y > cmax ? y : cmax;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(a.scratch, ~(static_cast<uint32_t>(cmin) ^ 0x80000000u));
    atomicMax(a.scratch + 1, static_cast<uint32_t>(cmax) ^ 0x80000000u);
  }
  if (kShared) {
    __syncthreads();
    for (int64_t b = threadIdx.x; b < a.B1; b += blockDim.x) {
      if (s_best[b] != 0ull) atomicMax(a.best + b, s_best[b]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
swap_dest_kernel(const DestArgs a) {
  __shared__ uint32_t s_key[2];
  derive_keys(a, 1, s_key);
  __syncthreads();
  // -tc's range over every cell: (-max, -min)
  const int32_t cmin = static_cast<int32_t>(~__ldcg(a.scratch) ^ 0x80000000u);
  const int32_t cmax = static_cast<int32_t>(__ldcg(a.scratch + 1)
                                            ^ 0x80000000u);
  const float lo = -static_cast<float>(cmax), hi = -static_cast<float>(cmin);
  const float span = span_of(lo, hi);
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * warps
                   + (threadIdx.x >> 5);
       k < a.K; k += static_cast<int64_t>(gridDim.x) * warps) {
    const int64_t p = a.idx[k] / a.R;
    const int64_t t = jax_index(a.topic[p], a.T);
    unsigned long long m = 0ull;
    for (int64_t b = lane; b < a.B1; b += 32) {
      const float scar = norm01(-static_cast<float>(a.cells[t * a.B1 + b]),
                                lo, span);
      const float u = uniform(k0, k1, static_cast<uint64_t>(k * a.B1 + b));
      float score = __fmaf_rn(a.noise_scale, u, scar);
      if (partner_of(__ldcg(a.best + b)) < 0 || !a.dest[b] || hosts(a, p, b)) {
        score = -INFINITY;
      }
      const unsigned long long key = rank_key(score, b);
      m = key > m ? key : m;
    }
    m = warp_max(m);
    if (lane == 0) {
      a.ok_out[k] = static_cast<uint32_t>(m >> 32) != order_bits(-INFINITY);
      a.partner_out[k] = partner_of(__ldcg(a.best + key_index(m)));
    }
  }
}

}  // namespace

extern "C" int cc_dest_select(const DestArgs* args, void* stream) {
  DestArgs a = *args;
  if (a.form < kShortlist || a.form > kTopicSwap || a.B1 < 1 || a.R < 1
      || a.B1 >= (int64_t{1} << 31) || a.P * a.R >= (int64_t{1} << 31) - 1
      || a.path[0].n < 0 || a.path[0].n > threefry::kMaxPath
      || a.path[1].n < 0 || a.path[1].n > threefry::kMaxPath) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.form == kShortlist) {
    if (a.D < 1 || a.D > a.B1 || a.best == nullptr
        || (a.plane == kTopicLeadersPlane && a.T < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int threads = 64;
    while (threads < kShortThreads && threads < a.B1) threads <<= 1;
    shortlist_kernel<<<1, threads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.T < 1 || a.K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.K == 0) return static_cast<int>(cudaGetLastError());
  int64_t kb = (a.K + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned kblocks = static_cast<unsigned>(kb < kMaxBlocks ? kb
                                                                 : kMaxBlocks);
  if (a.form == kTopicMove) {
    move_rows_kernel<<<kblocks, kThreads, 0, s>>>(a);
    move_dest_kernel<<<kblocks, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t e = cudaMemsetAsync(a.best, 0, a.B1 * sizeof(unsigned long long),
                                  s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(a.scratch, 0, 2 * sizeof(uint32_t), s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = a.P * a.R, cells = a.T * a.B1;
  int64_t lb = ((n > cells ? n : cells) + kThreads - 1) / kThreads;
  const unsigned lblocks = static_cast<unsigned>(lb < kMaxBlocks ? lb
                                                                 : kMaxBlocks);
  if (a.B1 <= kSharedBrokers) {
    light_kernel<true><<<lblocks, kThreads, a.B1 * sizeof(unsigned long long),
                         s>>>(a);
  } else {
    light_kernel<false><<<lblocks, kThreads, 0, s>>>(a);
  }
  // the score's key path is path[1]: swap it into place for the second
  // launch
  DestArgs b = a;
  b.path[0] = a.path[1];
  b.path[1] = a.path[0];
  swap_dest_kernel<<<kblocks, kThreads, 0, s>>>(b);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument struct, which the host's ctypes struct must equal
extern "C" int64_t cc_dest_args_size() { return sizeof(DestArgs); }
