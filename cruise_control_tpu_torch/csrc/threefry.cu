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

#include "threefry.cuh"

namespace {

enum Form : int32_t { kKeys = 0, kBits = 1, kAffine = 2, kRandint = 3 };

__global__ void threefry_draw_kernel(
    const int64_t* __restrict__ key, DrawPath path,
    const int64_t* __restrict__ counters, int64_t base, int64_t n,
    int32_t form, float a, float b, int64_t minval, uint32_t span,
    uint32_t multiplier, void* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= n) return;
  uint32_t k0, k1;
  threefry::derive(key, path, k0, k1);
  const uint64_t c = counters != nullptr
                         ? static_cast<uint64_t>(counters[i])
                         : static_cast<uint64_t>(base + i);
  if (form == kKeys) {
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry::hash(k0, k1, x0, x1);
    int64_t* o = static_cast<int64_t*>(out) + 2 * i;
    o[0] = static_cast<int64_t>(x0);
    o[1] = static_cast<int64_t>(x1);
  } else if (form == kBits) {
    static_cast<int32_t*>(out)[i] =
        static_cast<int32_t>(threefry::bits_at(k0, k1, c));
  } else if (form == kAffine) {
    static_cast<float*>(out)[i] =
        threefry::affine(threefry::bits_at(k0, k1, c), a, b);
  } else {  // kRandint
    uint32_t h0 = k0, h1 = k1, l0 = k0, l1 = k1;
    threefry::fold(h0, h1, 0u);
    threefry::fold(l0, l1, 1u);
    const uint32_t hi = threefry::bits_at(h0, h1, c);
    const uint32_t lo = threefry::bits_at(l0, l1, c);
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
  if (path.n < 0 || path.n > threefry::kMaxPath) {
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
