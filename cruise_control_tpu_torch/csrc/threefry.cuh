// KA's device code: threefry2x32 as jax.random computes it (with
// jax_threefry_partitionable=True), the key's derivation along a path of
// fold_in / split words, and the float conversions of a draw. KA's own
// kernel (threefry.cu) and the kernels that draw their noise inside their
// own launch (flow_candidates.cu) include it, so every draw is KA's bit for
// bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace threefry {

constexpr int kMaxPath = 8;

}  // namespace threefry

// A draw's derivation path, passed by value: word j is *ptrs[j] (low 32
// bits) where ptrs[j] is set, else words[j].
struct DrawPath {
  uint32_t words[threefry::kMaxPath];
  const int64_t* ptrs[threefry::kMaxPath];
  int32_t n;
};

namespace threefry {

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
__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1,
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
  hash(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The key at the end of ``path`` from the root ``key`` (int64[2]).
// Unrolled, so the path stays in the parameter space (a loop indexed at
// run time would copy it to the stack).
__device__ __forceinline__ void derive(const int64_t* __restrict__ key,
                                       const DrawPath& path, uint32_t& k0,
                                       uint32_t& k1) {
  k0 = static_cast<uint32_t>(key[0]);
  k1 = static_cast<uint32_t>(key[1]);
#pragma unroll
  for (int32_t j = 0; j < kMaxPath; ++j) {
    if (j < path.n) {
      const uint32_t w = path.ptrs[j] != nullptr
                             ? static_cast<uint32_t>(*path.ptrs[j])
                             : path.words[j];
      fold(k0, k1, w);
    }
  }
}

// Random bits of 64-bit counter c under (k0, k1): x0 ^ x1 of its hash.
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  hash(k0, k1, x0, x1);
  return x0 ^ x1;
}

// float32 a * u + b of jax.random.uniform's u from the bits w (the top 23
// bits as a mantissa in [1, 2), minus one, clamped at 0), the product and
// sum in float64 and rounded once: b = 0 is the float32 product a * u (the
// float64 product of two float32 is exact).
__device__ __forceinline__ float affine(uint32_t w, float a, float b) {
  const float u = fmaxf(__int_as_float(static_cast<int32_t>(
                            (w >> 9) | 0x3F800000u)) - 1.0f, 0.0f);
  const double v = __dadd_rn(__dmul_rn(static_cast<double>(a),
                                       static_cast<double>(u)),
                             static_cast<double>(b));
  return __double2float_rn(v);
}

}  // namespace threefry
