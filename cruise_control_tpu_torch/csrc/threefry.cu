// KA: threefry2x32 draws, bit-identical to jax.random under
// jax_threefry_partitionable=True, with the key derivation and the output
// form fused into the one launch.
//
// Replaces the XLA program JAX compiles for jax.random on the search path
// (cruise_control_tpu/analyzer/goals.py:_noise and the bulk-drain noise,
// engine.py's fold_in calls, optimizer.py's PRNGKey).
//
// A draw names its key as a root key and a path of up to kMaxPath 32-bit
// words: fold_in(key, d) and split(key, n)[i] both hash the counter
// (0, word) under the key and keep both output words, so a path of fold_ins
// and splits is a list of words. A word is an immediate or an int64 scalar
// on the device, read here (the host never reads it). Every thread derives
// the key itself (a handful of hashes, uniform across the warp), so no
// launch goes to a key that is only drawn from. Then thread i hashes
// counter i (or base + i, or counters[i]) and writes one element of the
// form:
//  - kKeys:    the pair (x0, x1) as int64 [n, 2] (split / fold_in keys);
//  - kBits:    the word x0 ^ x1 as int32 (uint32 bits);
//  - kAffine:  float32 a * u + b, u = jax.random.uniform's float in
//              [0, 1) (the top 23 bits as a mantissa in [1, 2), minus one,
//              clamped at 0), the product and sum in float64 and rounded
//              once to float32: a = 1, b = 0 is the uniform itself, b = 0
//              the search's scale * uniform noise (the float64 product of
//              two float32 is exact, so it rounds as the float32 multiply),
//              a = 0.01, b = 1 the bulk drain's contracted noise, as the
//              plain twin (utils/ordered.py:fma) computes it;
//  - kRandint: jax.random.randint for int32 as int64: the words of the
//              path's two subkeys (split(key)[0] high, [1] low) combined
//              modulo the span.
//
// Bound on the card: bytes (4 B an element written, 16 B a key) over the
// key's derivation latency — a few dependent 20-round hashes, far below
// the integer rate. Design: one thread an element, the output written
// directly in its final form (no counter tensor, no eager conversions).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPath = 8;

enum Form : int32_t { kKeys = 0, kBits = 1, kAffine = 2, kRandint = 3 };

}  // namespace

// The derivation path, passed by value: word j is *ptrs[j] (low 32 bits)
// where ptrs[j] is set, else words[j].
struct DrawPath {
  uint32_t words[kMaxPath];
  const int64_t* ptrs[kMaxPath];
  int32_t n;
};

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, uint32_t d) {
  return (x << d) | (x >> (32u - d));
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1,
                                       uint32_t r0, uint32_t r1,
                                       uint32_t r2, uint32_t r3) {
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;
}

// threefry2x32 of the pair (x0, x1) under key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

// The key one fold_in / split index further down: hash (0, word).
__device__ __forceinline__ void fold(uint32_t& k0, uint32_t& k1,
                                     uint32_t word) {
  uint32_t x0 = 0u, x1 = word;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// Random bits of 64-bit counter c under (k0, k1): x0 ^ x1 of its hash.
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__global__ void threefry_draw_kernel(
    const int64_t* __restrict__ key, DrawPath path,
    const int64_t* __restrict__ counters, int64_t base, int64_t n,
    int32_t form, float a, float b, int64_t minval, uint32_t span,
    uint32_t multiplier, void* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  uint32_t k0 = static_cast<uint32_t>(key[0]);
  uint32_t k1 = static_cast<uint32_t>(key[1]);
  // unrolled, so the path stays in the parameter space (a loop indexed
  // at run time would copy it to the stack)
#pragma unroll
  for (int32_t j = 0; j < kMaxPath; ++j) {
    if (j < path.n) {
      const uint32_t w = path.ptrs[j] != nullptr
                             ? static_cast<uint32_t>(*path.ptrs[j])
                             : path.words[j];
      fold(k0, k1, w);
    }
  }
  const uint64_t c = counters != nullptr
                         ? static_cast<uint64_t>(counters[i])
                         : static_cast<uint64_t>(base + i);
  if (form == kKeys) {
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry(k0, k1, x0, x1);
    int64_t* o = static_cast<int64_t*>(out) + 2 * i;
    o[0] = static_cast<int64_t>(x0);
    o[1] = static_cast<int64_t>(x1);
  } else if (form == kBits) {
    static_cast<int32_t*>(out)[i] =
        static_cast<int32_t>(bits_at(k0, k1, c));
  } else if (form == kAffine) {
    const uint32_t w = bits_at(k0, k1, c);
    const float u = fmaxf(__int_as_float(static_cast<int32_t>(
                              (w >> 9) | 0x3F800000u)) - 1.0f, 0.0f);
    const double v = __dadd_rn(__dmul_rn(static_cast<double>(a),
                                         static_cast<double>(u)),
                               static_cast<double>(b));
    static_cast<float*>(out)[i] = __double2float_rn(v);
  } else {  // kRandint
    uint32_t h0 = k0, h1 = k1, l0 = k0, l1 = k1;
    fold(h0, h1, 0u);
    fold(l0, l1, 1u);
    const uint32_t hi = bits_at(h0, h1, c);
    const uint32_t lo = bits_at(l0, l1, c);
    uint32_t off = (hi % span) * multiplier + lo % span;
    off %= span;
    static_cast<int64_t*>(out)[i] = minval + static_cast<int64_t>(off);
  }
}

}  // namespace

// A draw of n elements (see above); counters may be null (the iota
// base + i). The kernel reads nothing the host wrote after the call.
extern "C" int cc_threefry_draw(const void* key, DrawPath path,
                                const void* counters, int64_t base,
                                int64_t n, int32_t form, float a, float b,
                                int64_t minval, uint32_t span,
                                uint32_t multiplier, void* out,
                                void* stream) {
  if (path.n < 0 || path.n > kMaxPath) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    threefry_draw_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(key), path,
        static_cast<const int64_t*>(counters), base, n, form, a, b, minval,
        span, multiplier, out);
  }
  return static_cast<int>(cudaGetLastError());
}
