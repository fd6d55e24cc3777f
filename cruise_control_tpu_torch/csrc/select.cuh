// lax.top_k's order on the card, for KU (top_k.cu), KW
// (proposal_select.cu) and KS's short-list (dest_select.cu):
//  - total_bits: a float's order-preserving unsigned image in IEEE total
//    order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN), which
//    is the order lax.top_k sorts by;
//  - total_key: one unique 64-bit key a (value, index) pair, the image
//    above the inverted index, so the larger key is the larger value, the
//    lower index among equal bits: a plain maximum is lax.top_k's first;
//  - kth_key: the need-th largest of n unique keys by a radix select of
//    8-bit digits from the top (a 256-bin histogram in shared memory a
//    pass, counted into kSubs sub-histograms by shared-memory atomics),
//    which stops at the first digit whose bin holds exactly the keys still
//    needed: the keys at or above the returned threshold are the top
//    need, whatever their order;
//  - take_from: those keys gathered into shared memory (in no order);
//  - sort_desc_held: a bitonic sort of up to blockDim.x keys held one a
//    thread, descending (shuffles below a stride of 32, shared memory
//    above); sort_desc: the same network over keys in shared memory, for
//    more keys than threads.
// Integer arithmetic only: the result is bit-exact.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kselect {

using Key = unsigned long long;

constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t total_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_total_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ Key key_of(uint32_t image, int64_t i) {
  return (static_cast<Key>(image) << 32)
         | (0xffffffffull - static_cast<Key>(i));
}

__device__ __forceinline__ Key total_key(float v, int64_t i) {
  return key_of(total_bits(v), i);
}

__device__ __forceinline__ int64_t key_index(Key k) {
  return static_cast<int64_t>(0xffffffffull - (k & 0xffffffffull));
}

__device__ __forceinline__ float key_value(Key k) {
  return from_total_bits(static_cast<uint32_t>(k >> 32));
}

// sub-histograms a pass counts into (warp w into w % kSubs), so that no
// more than blockDim.x / 32 / kSubs warps share a bin's counter
constexpr int kSubs = 8;

// A block's shared state for kth_key and take_from.
struct Shared {
  unsigned sub[kSubs][kBins];
  unsigned hist[kBins];
  Key prefix;
  int need;
  int done;
  unsigned count;
};

// The need-th largest of the unique keys key(0..n) (1 <= need <= n),
// returned to every thread of the block (blockDim.x a multiple of 32).
template <class Keys>
__device__ Key kth_key(const Keys& key, int64_t n, int need, Shared& s) {
  const int lane = threadIdx.x & 31;
  unsigned* sub = &s.sub[(threadIdx.x >> 5) % kSubs][0];
  if (threadIdx.x == 0) {
    s.prefix = 0;
    s.need = need;
    s.done = 0;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < kSubs * kBins; b += blockDim.x) {
      (&s.sub[0][0])[b] = 0;
    }
    __syncthreads();
    const Key prefix = s.prefix;
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const Key k = key(i);
      if (shift == 56 || (k >> (shift + 8)) == (prefix >> (shift + 8))) {
        atomicAdd(sub + (static_cast<unsigned>(k >> shift) & 0xffu), 1u);
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
      unsigned c = 0;
#pragma unroll
      for (int w = 0; w < kSubs; ++w) c += s.sub[w][b];
      s.hist[b] = c;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      unsigned c[8];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned want = static_cast<unsigned>(s.need);
      const unsigned excl = incl - sum;
      if (excl < want && want <= incl) {
        unsigned above = excl;
        int j = 0;
        while (above + c[j] < want) above += c[j++];
        const unsigned digit = 255u - 8u * lane - j;
        s.prefix = prefix | (static_cast<Key>(digit) << shift);
        s.need = static_cast<int>(want - above);
        s.done = c[j] == want - above;
      }
    }
    __syncthreads();
    if (s.done) break;
  }
  const Key t = s.prefix;
  __syncthreads();
  return t;
}

// Every key(0..n) at or above ``thr`` into out[0..), in no order; their
// count is left in s.count. Ends with the block's barrier.
template <class Keys>
__device__ void take_from(const Keys& key, int64_t n, Key thr, Key* out,
                          Shared& s) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  const int64_t trips = (n + blockDim.x - 1) / blockDim.x * blockDim.x;
  for (int64_t i = threadIdx.x; i < trips; i += blockDim.x) {
    const bool in = i < n;
    const Key k = in ? key(i) : 0ull;
    const bool take = in && k >= thr;
    const unsigned who = __ballot_sync(kFull, take);
    if (who == 0) continue;
    unsigned base = 0;
    if (lane == __ffs(who) - 1) base = atomicAdd(&s.count, __popc(who));
    base = __shfl_sync(kFull, base, __ffs(who) - 1);
    if (take) out[base + __popc(who & ((1u << lane) - 1u))] = k;
  }
  __syncthreads();
}

// keys[0..pad) sorted descending (pad a power of two). Ends with the
// block's barrier.
__device__ inline void sort_desc(Key* keys, int pad) {
  for (int size = 2; size <= pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < pad / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const Key a = keys[i], b = keys[j];
        if ((a < b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The keys held one a thread (thread t the key at position t < pad, pad a
// power of two of at least 32 and at most blockDim.x; the other threads
// hold anything) sorted descending by a bitonic network: strides below
// 32 exchange by shuffles, the others through ``buf`` (2 * pad keys of
// shared memory, used in turn) a barrier apart. Every thread of the
// block calls it; thread t < pad returns the key at position t.
__device__ inline Key sort_desc_held(Key v, int pad, Key* buf) {
  const int t = threadIdx.x;
  int flip = 0;
  for (int size = 2; size <= pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key p;
      if (stride >= 32) {
        Key* b = buf + flip * pad;
        flip ^= 1;
        if (t < pad) b[t] = v;
        __syncthreads();
        p = t < pad ? b[t ^ stride] : 0ull;
      } else {
        p = __shfl_xor_sync(kFull, v, stride);
      }
      const bool keep_max = ((t & stride) == 0) == ((t & size) == 0);
      v = keep_max ? (v > p ? v : p) : (v < p ? v : p);
    }
  }
  return v;
}

__host__ __device__ inline int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace kselect
