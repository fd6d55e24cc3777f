// KJ: placement edit and leadership failover over a fleet's [C, S] grid.
//
// For every (cluster c, scenario s, partition p) row of a fleet sweep, the
// edit and failover of failover_row.cuh (KD's row) against cluster c's own
// masks: a partition cluster c does not hold (pvalid[c, p] false) routes
// its slots to the sentinel B; the electable replica with the lowest
// preferred position leads; replicas on dead or invalid brokers go offline.
//
// Inputs: each cluster's own placement rb/off/pref [C, P, R], its broker
// masks valid/alive [C, B] and partition mask pvalid [C, P], and the
// scenarios' dead/add masks [C, S, B]. Outputs rb, pref, off [C, S, P, R]
// and has_alive [C, S, P]. The placement is read from its [C, P, R]
// tensors by every scenario's thread: it is never replicated S times.
//
// Replaces the transform half of cruise_control_tpu/fleet/engine.py's
// fleet sweep programs (:780 N-1, :959 trajectories), which run
// whatif/engine.py:scenario_transform under vmap over S inside lax.map
// over C.
//
// Bound on the card: bytes — the outputs are S times the inputs; the work
// per row is a few compares over R slots. One thread owns one row.

#include <cstdint>
#include <cuda_runtime.h>

#include "failover_row.cuh"

namespace {

__global__ void fleet_failover_kernel(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ dead,
    const uint8_t* __restrict__ add, const uint8_t* __restrict__ pvalid,
    int32_t* __restrict__ rb_out, int32_t* __restrict__ pref_out,
    uint8_t* __restrict__ off_out, uint8_t* __restrict__ has_alive_out,
    int64_t C, int64_t S, int64_t P, int32_t R, int32_t B) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (t >= C * S * P) return;
  const int64_t cs = t / P;             // c * S + s
  const int64_t p = t - cs * P;
  const int64_t c = cs / S;
  const int64_t in_row = (c * P + p) * R;
  failover::failover_row(rb_in + in_row, off_in + in_row, pref_in + in_row,
                         pvalid[c * P + p] != 0, valid + c * B, alive + c * B,
                         dead + cs * B, add + cs * B, R, B, rb_out + t * R,
                         pref_out + t * R, off_out + t * R,
                         has_alive_out + t);
}

}  // namespace

extern "C" int cc_fleet_scenario_failover(
    const void* rb, const void* off, const void* pref, const void* valid,
    const void* alive, const void* dead, const void* add, const void* pvalid,
    void* rb_out, void* pref_out, void* off_out, void* has_alive_out,
    int64_t C, int64_t S, int64_t P, int64_t R, int64_t B, void* stream) {
  const int64_t rows = C * S * P;
  if (rows > 0) {
    const int threads = 256;
    const int64_t blocks = (rows + threads - 1) / threads;
    fleet_failover_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rb), static_cast<const uint8_t*>(off),
        static_cast<const int32_t*>(pref), static_cast<const uint8_t*>(valid),
        static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(dead),
        static_cast<const uint8_t*>(add), static_cast<const uint8_t*>(pvalid),
        static_cast<int32_t*>(rb_out), static_cast<int32_t*>(pref_out),
        static_cast<uint8_t*>(off_out), static_cast<uint8_t*>(has_alive_out),
        C, S, P, static_cast<int32_t>(R), static_cast<int32_t>(B));
  }
  return static_cast<int>(cudaGetLastError());
}
