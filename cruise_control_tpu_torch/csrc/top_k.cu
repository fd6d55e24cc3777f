// KU: lax.top_k on the card -- the K largest of each float32 row of an
// [S, N] batch and their indices, in lax.top_k's order: IEEE total order,
// descending, the lower index first among equal bits.
//
// Replaces the goals' jax.lax.top_k over the [P, R] priority planes in
// cruise_control_tpu/analyzer/goals.py (:140, :165, :823, :927-928, :1246,
// :1289), which the port ran as a full stable radix sort of up to 40,192
// keys (a copy, six memsets, an index fill and four sort kernels) to keep
// 512 or 128 of them.
//
// Each element is one unique 64-bit key (select.cuh: the value's
// total-order image above its inverted index), so a plain maximum is
// lax.top_k's first and no two keys tie. One launch, a row cut into C
// chunks (blockIdx.x; the rows blockIdx.y): each block copies its chunk's
// images into shared memory where they fit, finds the chunk's K-th
// largest key by a radix select of 8-bit digits (select.cuh:kth_key, at
// most eight histogram passes, usually four) and gathers the keys at or
// above it. A row of one chunk is sorted there; otherwise each block
// writes its keys to ``cand`` and takes a ticket, and the row's last block
// selects the top K of the C x K keys the same way. The K kept are sorted
// by a bitonic network, a key a thread (shuffles below a stride of 32),
// or in shared memory past 1,024 keys. The chunk (``cc_top_k_chunk``,
// about sqrt(N K)) balances the chunks' selects against the last block's.
// The tickets are the library's own (one a row), each reset by the last
// block that takes it.
//
// Bound on the card: bytes (each row read once, K pairs written); what a
// call costs is the blocks' passes over their chunks and the last
// block's select and sort.

#include <cstdint>
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int64_t kMaxK = 4096;
constexpr int64_t kMaxRows = 65535;
// dynamic shared memory a block may take (the card's 227 KB less the
// static state: kselect::Shared's 9 KB of histograms)
constexpr int64_t kMaxShared = 227 * 1024 - 12 * 1024;

// a row's chunks that have written their keys (reset to 0 by the last)
__device__ unsigned int g_tickets[kMaxRows];

}  // namespace

struct RowSelectArgs {
  const float* x;              // [S, N], rows ld apart
  float* vals;                 // [S, K]
  int64_t* idx;                // [S, K]
  unsigned long long* cand;    // [S, C, K] the chunks' keys (C > 1)
  int64_t S, N, K, ld, chunk;
};

namespace {

using kselect::Key;

struct FloatKeys {
  const float* x;
  int64_t base;
  __device__ Key operator()(int64_t i) const {
    return kselect::total_key(x[i], base + i);
  }
};

struct ImageKeys {
  const uint32_t* img;
  int64_t base;
  __device__ Key operator()(int64_t i) const {
    return kselect::key_of(img[i], base + i);
  }
};

struct WordKeys {
  const Key* k;
  __device__ Key operator()(int64_t i) const { return k[i]; }
};

struct GlobalWordKeys {
  const Key* k;
  __device__ Key operator()(int64_t i) const { return __ldcg(k + i); }
};

// keys the sort takes: a power of two, at least a warp
__host__ __device__ int64_t sort_slots(int64_t k) {
  const int64_t p = kselect::pow2_at_least(k);
  return p < 32 ? 32 : p;
}

// A launch's dynamic shared memory and whether a chunk's images and the
// last block's C x K keys are staged in it. Its layout: the kept keys,
// then a chunk's images or (past two slots of the sort's) the C x K keys.
struct Plan {
  int64_t bytes;
  bool stage_chunk, stage_merge;
};

__host__ __device__ Plan plan_of(int64_t n, int64_t k, int64_t chunk) {
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t sort = 2 * sort_slots(k) * sizeof(Key);
  Plan p{sort, false, false};
  const int64_t a = sort_slots(k) * sizeof(Key) + chunk * sizeof(uint32_t);
  if (a <= kMaxShared) {
    p.stage_chunk = true;
    p.bytes = a > p.bytes ? a : p.bytes;
  }
  if (chunks > 1) {
    const int64_t b = sort + chunks * k * sizeof(Key);
    if (b <= kMaxShared) {
      p.stage_merge = true;
      p.bytes = b > p.bytes ? b : p.bytes;
    }
  }
  return p;
}

// The ``need`` keys in keys[0..) sorted descending into row ``prob``'s
// outputs, in place (2 * sort_slots(K) keys of room from ``keys``).
__device__ void sort_out(const RowSelectArgs& a, Key* keys, int need,
                         int64_t prob) {
  const int pad = static_cast<int>(sort_slots(a.K));
  if (pad <= static_cast<int>(blockDim.x)) {
    const int t = threadIdx.x;
    Key v = t < need ? keys[t] : 0ull;
    __syncthreads();                    // every key read before reuse
    v = kselect::sort_desc_held(v, pad, keys);
    if (t < a.K) {
      a.vals[prob * a.K + t] = kselect::key_value(v);
      a.idx[prob * a.K + t] = kselect::key_index(v);
    }
    return;
  }
  for (int i = need + threadIdx.x; i < pad; i += blockDim.x) keys[i] = 0ull;
  __syncthreads();
  kselect::sort_desc(keys, pad);
  for (int64_t i = threadIdx.x; i < a.K; i += blockDim.x) {
    a.vals[prob * a.K + i] = kselect::key_value(keys[i]);
    a.idx[prob * a.K + i] = kselect::key_index(keys[i]);
  }
}

template <class Keys>
__device__ void select_into(const Keys& key, int64_t n, int need, Key* out,
                            kselect::Shared& s) {
  const Key thr = kselect::kth_key(key, n, need, s);
  kselect::take_from(key, n, thr, out, s);
}

__global__ void __launch_bounds__(kThreads)
top_k_kernel(const RowSelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ kselect::Shared s;
  __shared__ int s_last;
  const int64_t chunks = gridDim.x;
  const Plan plan = plan_of(a.N, a.K, a.chunk);
  const int64_t prob = blockIdx.y, c = blockIdx.x;
  const int64_t base = c * a.chunk;
  const int64_t n = a.N - base < a.chunk ? a.N - base : a.chunk;
  const int need = static_cast<int>(n < a.K ? n : a.K);
  Key* keys = reinterpret_cast<Key*>(smem);
  const float* x = a.x + prob * a.ld + base;
  if (plan.stage_chunk) {
    uint32_t* img = reinterpret_cast<uint32_t*>(keys + sort_slots(a.K));
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      img[i] = kselect::total_bits(x[i]);
    }
    __syncthreads();
    select_into(ImageKeys{img, base}, n, need, keys, s);
  } else {
    select_into(FloatKeys{x, base}, n, need, keys, s);
  }
  if (chunks == 1) {
    sort_out(a, keys, need, prob);
    return;
  }
  Key* out = a.cand + (prob * chunks + c) * a.K;
  for (int64_t k = threadIdx.x; k < a.K; k += blockDim.x) {
    out[k] = k < need ? keys[k] : 0ull;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&g_tickets[prob], 1u) == chunks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the row's last block: the top K of the C x K keys
  const int64_t n2 = chunks * a.K;
  const Key* row = a.cand + prob * n2;
  if (plan.stage_merge) {
    Key* staged = keys + 2 * sort_slots(a.K);
    for (int64_t i = threadIdx.x; i < n2; i += blockDim.x) {
      staged[i] = __ldcg(row + i);
    }
    __syncthreads();
    select_into(WordKeys{staged}, n2, static_cast<int>(a.K), keys, s);
  } else {
    select_into(GlobalWordKeys{row}, n2, static_cast<int>(a.K), keys, s);
  }
  if (threadIdx.x == 0) g_tickets[prob] = 0u;
  sort_out(a, keys, static_cast<int>(a.K), prob);
}

}  // namespace

// The chunk a block takes of a row of n elements keeping k: about
// sqrt(n k), a power of two from 2,048 to 32,768 and at least k's sort;
// n itself where that is no larger.
extern "C" int64_t cc_top_k_chunk(int64_t n, int64_t k) {
  int64_t c = 2048;
  while (c < 32768 && c * c < n * k) c <<= 1;
  if (c < sort_slots(k)) c = sort_slots(k);
  return n <= c ? n : c;
}

extern "C" int cc_top_k(const RowSelectArgs* args, void* stream) {
  const RowSelectArgs a = *args;
  if (a.S < 1 || a.S > kMaxRows || a.K < 1 || a.K > kMaxK || a.K > a.N
      || a.N >= (int64_t{1} << 32) || a.ld < a.N || a.chunk < 1
      || (a.chunk < a.N && a.chunk < sort_slots(a.K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = (a.N + a.chunk - 1) / a.chunk;
  if (chunks > 1 && a.cand == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = plan_of(a.N, a.K, a.chunk);
  if (plan.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        top_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(a.S));
  top_k_kernel<<<grid, kThreads, plan.bytes,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument struct, which the host's ctypes struct must equal
extern "C" int64_t cc_top_k_args_size() { return sizeof(RowSelectArgs); }
