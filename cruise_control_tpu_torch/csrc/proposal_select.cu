// KW: a goal pass's proposal selection -- the body of the reference's
// apply_batch up to its apply rounds (cruise_control_tpu/analyzer/
// engine.py:130-150): each candidate's score
//     where(elig, where(must, -1e30, clamp(delta, -1e29, 1e29)), inf),
// the top M of -score (lax.top_k's order), the M winners' Candidates
// fields gathered, pending = isfinite(-score of the winner), the loop
// flag pending.any(), and the [M, M] structural conflicts
//     conflict_earlier[i, j] = j < i && (p_i, p2_i) meets (p_j, p2_j),
// which KQ (round_guards.cu) reads. In plain torch this was the top-k's
// radix sort and about 60 more launches of scores, gathers and [M, M]
// masks a proposal.
//
// Two launches:
//  - proposal_select_kernel, one block: the score's total-order images
//    staged in shared memory (or recomputed from global memory past what
//    fits), the M-th largest key by select.cuh's radix select, the M keys
//    gathered and sorted (bitonic, a key a thread up to 1,024), then the
//    winners' indices, pending and the flag;
//  - proposal_gather_kernel, over the card: a block stages the winners'
//    (p, p2) in shared memory, gathers its rows' fields and writes its rows of
//    the conflict mask, four bytes a thread a step.
// The outputs go to buffers the caller owns (the goal loop's carry), so
// a CUDA graph replays them in place. No float arithmetic but the clamp
// and the negation: bit-exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kSelectThreads = 1024;
constexpr int kGatherThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int64_t kMaxM = 4096;
constexpr int64_t kMaxShared = 227 * 1024 - 12 * 1024;

}  // namespace

struct SelectArgs {
  // the proposal's candidates [N]
  const int64_t* p;
  const int64_t* r;
  const int64_t* p2;
  const int64_t* r2;
  const int64_t* src;
  const int64_t* dst;
  const int64_t* kind;
  const uint8_t* valid;
  const uint8_t* must;
  const float* d_util_src;     // [N, 4]
  const float* d_util_dst;     // [N, 4]
  const int32_t* d_cnt;
  const int32_t* d_lead;
  const float* d_pot;
  const float* d_lni;
  const uint8_t* elig;         // [N] KN's verdict
  const float* delta;          // [N] KN's delta
  // the M winners' fields, in score order
  int64_t* p_out;
  int64_t* r_out;
  int64_t* p2_out;
  int64_t* r2_out;
  int64_t* src_out;
  int64_t* dst_out;
  int64_t* kind_out;
  uint8_t* valid_out;
  uint8_t* must_out;
  float* d_util_src_out;       // [M, 4]
  float* d_util_dst_out;       // [M, 4]
  int32_t* d_cnt_out;
  int32_t* d_lead_out;
  float* d_pot_out;
  float* d_lni_out;
  uint8_t* conflict;           // [M, M]
  uint8_t* pending;            // [M]
  int64_t* flag;               // scalar pending.any(), or null
  int64_t* order;              // [M] scratch: the winners' rows
  int64_t N, M;
};

namespace {

using kselect::Key;

// keys the sort takes: a power of two, at least a warp
__host__ __device__ int64_t sort_slots(int64_t m) {
  const int64_t p = kselect::pow2_at_least(m);
  return p < 32 ? 32 : p;
}

// -score: a mandatory move 1e30, an eligible one -clamp(delta, -1e29,
// 1e29) (NaN kept), an ineligible one -inf.
__device__ __forceinline__ float neg_score(const SelectArgs& a, int64_t i) {
  if (!a.elig[i]) return -INFINITY;
  if (a.must[i]) return 1e30f;
  const float d = a.delta[i];
  const float c = d < -1e29f ? -1e29f : (d > 1e29f ? 1e29f : d);
  return -c;
}

struct ScoreKeys {
  const SelectArgs* a;
  __device__ Key operator()(int64_t i) const {
    return kselect::total_key(neg_score(*a, i), i);
  }
};

struct ImageKeys {
  const uint32_t* img;
  __device__ Key operator()(int64_t i) const {
    return kselect::key_of(img[i], i);
  }
};

template <bool kStaged>
__global__ void __launch_bounds__(kSelectThreads)
proposal_select_kernel(const SelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ kselect::Shared s;
  const int pad = static_cast<int>(sort_slots(a.M));
  Key* keys = reinterpret_cast<Key*>(smem);
  const int need = static_cast<int>(a.M);
  if (kStaged) {
    uint32_t* img = reinterpret_cast<uint32_t*>(keys + pad);
    for (int64_t i = threadIdx.x; i < a.N; i += blockDim.x) {
      img[i] = kselect::total_bits(neg_score(a, i));
    }
    __syncthreads();
    const ImageKeys key{img};
    const Key thr = kselect::kth_key(key, a.N, need, s);
    kselect::take_from(key, a.N, thr, keys, s);
  } else {
    const ScoreKeys key{&a};
    const Key thr = kselect::kth_key(key, a.N, need, s);
    kselect::take_from(key, a.N, thr, keys, s);
  }
  bool any = false;
  if (pad <= static_cast<int>(blockDim.x)) {
    // a key a thread, sorted in place (the staged images are read)
    const int t = threadIdx.x;
    Key v = t < need ? keys[t] : 0ull;
    __syncthreads();
    v = kselect::sort_desc_held(v, pad, keys);
    if (t < a.M) {
      any = isfinite(kselect::key_value(v));
      a.order[t] = kselect::key_index(v);
      a.pending[t] = any;
    }
  } else {
    for (int i = need + threadIdx.x; i < pad; i += blockDim.x) keys[i] = 0;
    __syncthreads();
    kselect::sort_desc(keys, pad);
    for (int64_t m = threadIdx.x; m < a.M; m += blockDim.x) {
      const bool pend = isfinite(kselect::key_value(keys[m]));
      a.order[m] = kselect::key_index(keys[m]);
      a.pending[m] = pend;
      any = any || pend;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0 && a.flag != nullptr) *a.flag = any;
}

__global__ void __launch_bounds__(kGatherThreads)
proposal_gather_kernel(const SelectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sp = reinterpret_cast<int64_t*>(smem);
  int64_t* sp2 = sp + a.M;
  for (int64_t j = threadIdx.x; j < a.M; j += blockDim.x) {
    const int64_t o = a.order[j];
    sp[j] = a.p[o];
    sp2[j] = a.p2[o];
  }
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t rows = a.M - first < kRowsPerBlock ? a.M - first
                                                   : kRowsPerBlock;
  // the block's rows' fields, a thread a row
  if (threadIdx.x < rows) {
    const int64_t m = first + threadIdx.x;
    const int64_t o = a.order[m];
    a.p_out[m] = sp[m];
    a.r_out[m] = a.r[o];
    a.p2_out[m] = sp2[m];
    a.r2_out[m] = a.r2[o];
    a.src_out[m] = a.src[o];
    a.dst_out[m] = a.dst[o];
    a.kind_out[m] = a.kind[o];
    a.valid_out[m] = a.valid[o];
    a.must_out[m] = a.must[o];
    reinterpret_cast<float4*>(a.d_util_src_out)[m] =
        reinterpret_cast<const float4*>(a.d_util_src)[o];
    reinterpret_cast<float4*>(a.d_util_dst_out)[m] =
        reinterpret_cast<const float4*>(a.d_util_dst)[o];
    a.d_cnt_out[m] = a.d_cnt[o];
    a.d_lead_out[m] = a.d_lead[o];
    a.d_pot_out[m] = a.d_pot[o];
    a.d_lni_out[m] = a.d_lni[o];
  }
  // the rows of the conflict mask, four columns a thread a step (one
  // 4-byte store where the row's bytes are aligned)
  const int64_t words = (a.M + 3) / 4;
  for (int64_t t = threadIdx.x; t < rows * words; t += blockDim.x) {
    const int64_t i = first + t / words;
    const int64_t j0 = (t % words) * 4;
    const int64_t pi = sp[i], p2i = sp2[i];
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t j = j0 + q;
      const int64_t jj = j < a.M ? j : 0;
      const int64_t pj = sp[jj], p2j = sp2[jj];
      const bool hit = j < i && (pi == pj || pi == p2j || p2i == pj
                                 || p2i == p2j);
      word |= static_cast<uint32_t>(hit) << (8 * q);
    }
    uint8_t* row = a.conflict + i * a.M + j0;
    if (j0 + 4 <= a.M && (reinterpret_cast<uintptr_t>(row) & 3u) == 0) {
      *reinterpret_cast<uint32_t*>(row) = word;
    } else {
      for (int q = 0; q < 4 && j0 + q < a.M; ++q) {
        row[q] = static_cast<uint8_t>(word >> (8 * q));
      }
    }
  }
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int cc_proposal_select(const SelectArgs* args, void* stream) {
  const SelectArgs a = *args;
  if (a.M < 1 || a.M > kMaxM || a.M > a.N || a.N >= (int64_t{1} << 32)
      || a.order == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the kept keys, then the staged images; the sort's two slots of keys
  // over both once the images are read
  const int64_t slots = sort_slots(a.M) * sizeof(Key);
  const int64_t sort = 2 * slots;
  int64_t staged = slots + a.N * sizeof(uint32_t);
  staged = staged > sort ? staged : sort;
  cudaError_t e;
  if (staged <= kMaxShared) {
    e = allow_shared(proposal_select_kernel<true>, staged);
    if (e != cudaSuccess) return static_cast<int>(e);
    proposal_select_kernel<true><<<1, kSelectThreads, staged, s>>>(a);
  } else {
    e = allow_shared(proposal_select_kernel<false>, sort);
    if (e != cudaSuccess) return static_cast<int>(e);
    proposal_select_kernel<false><<<1, kSelectThreads, sort, s>>>(a);
  }
  const int64_t pairs = 2 * a.M * sizeof(int64_t);
  e = allow_shared(proposal_gather_kernel, pairs);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((a.M + kRowsPerBlock - 1)
                                                / kRowsPerBlock);
  proposal_gather_kernel<<<blocks, kGatherThreads, pairs, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument struct, which the host's ctypes struct must equal
extern "C" int64_t cc_select_args_size() { return sizeof(SelectArgs); }
