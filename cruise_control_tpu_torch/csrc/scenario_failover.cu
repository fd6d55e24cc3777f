// KD: per-scenario placement edit and leadership failover.
//
// For every (scenario s, partition p) row of a what-if batch, the edit and
// failover of failover_row.cuh (a partition the scenario does not enable
// routes its slots to the sentinel B; the electable replica with the lowest
// preferred position leads; replicas on dead or invalid brokers go
// offline). Outputs rb, pref, off [S, P, R] and has_alive [S, P] (some slot
// was electable).
//
// Replaces the placement half of cruise_control_tpu/whatif/engine.py:
// scenario_transform (:606-647), vmapped over the scenario axis.
//
// The placement inputs are the template's [P, R] arrays shared by every
// scenario (in_stride 0) or one [S, P, R] placement per scenario
// (in_stride P*R: the move scheduler's batch-boundary placements).
//
// Bound on the card: bytes — each input read once and each output written
// once; the work per row is a few compares over R slots. One thread owns
// one row.

#include <cstdint>
#include <cuda_runtime.h>

#include "failover_row.cuh"

namespace {

__global__ void scenario_failover_kernel(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, int64_t in_stride,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ dead, const uint8_t* __restrict__ add,
    const uint8_t* __restrict__ pvalid, int32_t* __restrict__ rb_out,
    int32_t* __restrict__ pref_out, uint8_t* __restrict__ off_out,
    uint8_t* __restrict__ has_alive_out, int64_t S, int64_t P, int32_t R,
    int32_t B) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (t >= S * P) return;
  const int64_t s = t / P;
  const int64_t p = t - s * P;
  const int64_t in_row = s * in_stride + p * R;
  failover::failover_row(rb_in + in_row, off_in + in_row, pref_in + in_row,
                         pvalid[t] != 0, valid, alive, dead + s * B,
                         add + s * B, R, B, rb_out + t * R, pref_out + t * R,
                         off_out + t * R, has_alive_out + t);
}

}  // namespace

extern "C" int cc_scenario_failover(
    const void* rb, const void* off, const void* pref, int64_t in_stride,
    const void* valid, const void* alive, const void* dead, const void* add,
    const void* pvalid, void* rb_out, void* pref_out, void* off_out,
    void* has_alive_out, int64_t S, int64_t P, int64_t R, int64_t B,
    void* stream) {
  const int64_t rows = S * P;
  if (rows > 0) {
    const int threads = 256;
    const int64_t blocks = (rows + threads - 1) / threads;
    scenario_failover_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rb), static_cast<const uint8_t*>(off),
        static_cast<const int32_t*>(pref), in_stride,
        static_cast<const uint8_t*>(valid),
        static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(dead),
        static_cast<const uint8_t*>(add), static_cast<const uint8_t*>(pvalid),
        static_cast<int32_t*>(rb_out), static_cast<int32_t*>(pref_out),
        static_cast<uint8_t*>(off_out), static_cast<uint8_t*>(has_alive_out),
        S, P, static_cast<int32_t>(R), static_cast<int32_t>(B));
  }
  return static_cast<int>(cudaGetLastError());
}
