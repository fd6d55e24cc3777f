// KC: pessimistic net broker flow of earlier candidates (collective guard).
//
// For candidate i, over every j with earlier[i, j]:
//   net_dst_hi[i] = sum max(d_dst[j], 0) [dst j == dst i]
//                 + sum max(d_src[j], 0) [src j == dst i]
//   net_src_lo[i] = sum min(d_src[j], 0) [src j == src i]
//                 + sum min(d_dst[j], 0) [dst j == src i]
//   net_src_hi[i] = sum max(d_src[j], 0) [src j == src i]
//                 + sum max(d_dst[j], 0) [dst j == src i]
// Each of the six partial sums adds its terms in ascending j; the pairs are
// added last. (The reference's dot products add in XLA's own order; the
// guard verdicts agree, see tests/test_torch_goals.py.)
//
// Replaces the four [M, M] float mask products of
// cruise_control_tpu/analyzer/goals.py:_net_broker_flow (:254-281) and
// _net_src_hi (:284-293), which every chain goal evaluates in every apply
// round. Eager PyTorch would materialise each [M, M] mask in device memory;
// this kernel never builds one.
//
// What bounds it: bytes (the [M, M] bool mask read once, 4 M-vectors in, 3
// out), about 0.1 us at M = 512. A thread a row (the first design) falls far
// short of it:
// neighbouring threads read bytes M apart (no load coalesced) and every
// thread re-read the candidate vectors from global memory for every j.
//
// This design gives each row one warp. A block stages the candidate
// vectors in shared memory once (ids as int32; 16 KB at M = 1,024, in
// chunks of 1,024 beyond that). A warp reads its mask row in 16-byte
// vector loads (byte loads when M is not a multiple of 16) into shared
// memory, then walks it 32 columns at a time: lane l tests column
// j = j0 + l, and one ballot per match kind (dst == dst, src == dst,
// src == src, dst == src) marks the lanes with a term. The set lanes are
// taken in ascending order and each term is shuffled to every lane and
// added, so each partial sum adds exactly the first design's non-zero
// terms in its order. (A skipped term is +0.0 or -0.0; from +0.0 an
// accumulator never becomes -0.0, so skipping it changes no bit.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 1024;                 // candidates staged a pass
constexpr int kRowBytes = 512;               // mask bytes a warp stages
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
net_broker_flow_kernel(const int64_t* __restrict__ src,
                       const int64_t* __restrict__ dst,
                       const uint8_t* __restrict__ earlier,
                       const float* __restrict__ d_src,
                       const float* __restrict__ d_dst,
                       float* __restrict__ net_src_lo,
                       float* __restrict__ net_dst_hi,
                       float* __restrict__ net_src_hi, int64_t m,
                       int vector_rows) {
  __shared__ int s_src[kChunk];
  __shared__ int s_dst[kChunk];
  __shared__ float s_a[kChunk];
  __shared__ float s_b[kChunk];
  __shared__ __align__(16) uint8_t s_row[kWarps][kRowBytes];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = i < m;
  const int si = live ? static_cast<int>(src[i]) : 0;
  const int di = live ? static_cast<int>(dst[i]) : 0;
  const uint8_t* row = earlier + (live ? i : 0) * m;
  float dd = 0.0f, ds = 0.0f;          // -> net_dst_hi
  float ss_lo = 0.0f, sd_lo = 0.0f;    // -> net_src_lo
  float ss_hi = 0.0f, sd_hi = 0.0f;    // -> net_src_hi

  for (int64_t j0 = 0; j0 < m; j0 += kChunk) {
    const int n = static_cast<int>(m - j0 < kChunk ? m - j0 : kChunk);
    __syncthreads();                   // the previous chunk is consumed
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      s_src[k] = static_cast<int>(src[j0 + k]);
      s_dst[k] = static_cast<int>(dst[j0 + k]);
      s_a[k] = d_src[j0 + k];
      s_b[k] = d_dst[j0 + k];
    }
    __syncthreads();
    if (!live) continue;               // whole warps; no block sync inside
    for (int q0 = 0; q0 < n; q0 += kRowBytes) {
      const int span = n - q0 < kRowBytes ? n - q0 : kRowBytes;
      const uint8_t* part = row + j0 + q0;
      if (vector_rows) {               // span and address multiples of 16
        if (lane * 16 < span)
          *reinterpret_cast<uint4*>(&s_row[warp][lane * 16]) =
              *reinterpret_cast<const uint4*>(part + lane * 16);
      } else {
        for (int k = lane; k < span; k += 32) s_row[warp][k] = part[k];
      }
      __syncwarp();
      for (int k0 = 0; k0 < span; k0 += 32) {
        const int k = k0 + lane;
        const bool e = k < span && s_row[warp][k] != 0;
        const int jl = q0 + k;
        const int sj = e ? s_src[jl] : -1;
        const int dj = e ? s_dst[jl] : -1;
        const float a = e ? s_a[jl] : 0.0f;
        const float b = e ? s_b[jl] : 0.0f;
        unsigned hit = __ballot_sync(kFull, e && dj == di);
        while (hit) {
          const int l = __ffs(hit) - 1;
          hit &= hit - 1;
          dd = __fadd_rn(dd, fmaxf(__shfl_sync(kFull, b, l), 0.0f));
        }
        hit = __ballot_sync(kFull, e && sj == di);
        while (hit) {
          const int l = __ffs(hit) - 1;
          hit &= hit - 1;
          ds = __fadd_rn(ds, fmaxf(__shfl_sync(kFull, a, l), 0.0f));
        }
        hit = __ballot_sync(kFull, e && sj == si);
        while (hit) {
          const int l = __ffs(hit) - 1;
          hit &= hit - 1;
          const float x = __shfl_sync(kFull, a, l);
          ss_lo = __fadd_rn(ss_lo, fminf(x, 0.0f));
          ss_hi = __fadd_rn(ss_hi, fmaxf(x, 0.0f));
        }
        hit = __ballot_sync(kFull, e && dj == si);
        while (hit) {
          const int l = __ffs(hit) - 1;
          hit &= hit - 1;
          const float x = __shfl_sync(kFull, b, l);
          sd_lo = __fadd_rn(sd_lo, fminf(x, 0.0f));
          sd_hi = __fadd_rn(sd_hi, fmaxf(x, 0.0f));
        }
      }
      __syncwarp();                    // s_row is rewritten next pass
    }
  }
  if (live && lane == 0) {
    net_dst_hi[i] = __fadd_rn(dd, ds);
    net_src_lo[i] = __fadd_rn(ss_lo, sd_lo);
    net_src_hi[i] = __fadd_rn(ss_hi, sd_hi);
  }
}

}  // namespace

extern "C" int cc_net_broker_flow(const void* src, const void* dst,
                                  const void* earlier, const void* d_src,
                                  const void* d_dst, void* net_src_lo,
                                  void* net_dst_hi, void* net_src_hi,
                                  int64_t m, void* stream) {
  if (m > 0) {
    const int64_t blocks = (m + kWarps - 1) / kWarps;
    const int vector_rows =
        m % 16 == 0 && reinterpret_cast<uintptr_t>(earlier) % 16 == 0;
    net_broker_flow_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(src), static_cast<const int64_t*>(dst),
        static_cast<const uint8_t*>(earlier),
        static_cast<const float*>(d_src), static_cast<const float*>(d_dst),
        static_cast<float*>(net_src_lo), static_cast<float*>(net_dst_hi),
        static_cast<float*>(net_src_hi), m, vector_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
