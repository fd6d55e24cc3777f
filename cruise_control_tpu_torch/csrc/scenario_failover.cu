// KD: per-scenario placement edit and leadership failover.
//
// For every (scenario s, partition p) row of a what-if batch:
//  - a partition the scenario does not enable routes its slots to the
//    sentinel B and clears its offline flags;
//  - the slot holding the electable replica with the lowest preferred
//    position (electable: the slot holds a broker that is valid and alive
//    in this scenario, and the replica is not offline; ties go to the
//    lowest slot, as jnp.argmin breaks them) becomes the leader when slot 0
//    is not electable: broker, preferred position and offline flag swap
//    with slot 0 together;
//  - every replica left on a dead or invalid broker is marked offline.
// Outputs rb, pref, off [S, P, R] and has_alive [S, P] (some slot was
// electable). A broker is valid in scenario s when the template says so or
// s adds it, alive when (alive or added) and not killed by s.
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
// one row and walks its R slots twice (find the leader, then write the
// swapped row), so each output byte is written once, without scratch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool broker_up(int32_t b, int32_t B,
                                          const uint8_t* __restrict__ valid,
                                          const uint8_t* __restrict__ alive,
                                          const uint8_t* __restrict__ dead_s,
                                          const uint8_t* __restrict__ add_s) {
  if (b < 0 || b >= B) return false;
  const bool added = add_s[b] != 0;
  return (valid[b] != 0 || added) && (alive[b] != 0 || added)
         && dead_s[b] == 0;
}

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
  const bool pv = pvalid[t] != 0;
  const uint8_t* dead_s = dead + s * B;
  const uint8_t* add_s = add + s * B;

  int32_t best = 0;
  int32_t best_score = 0;
  bool any = false;
  bool first_electable = false;
  for (int32_t r = 0; r < R; ++r) {
    const int32_t b = pv ? rb_in[in_row + r] : B;
    const bool o = pv && off_in[in_row + r] != 0;
    const bool el = b < B && !o
                    && broker_up(b, B, valid, alive, dead_s, add_s);
    const int32_t score = el ? pref_in[in_row + r] : R + 1;
    if (r == 0 || score < best_score) {
      best_score = score;
      best = r;
    }
    any = any || el;
    if (r == 0) first_electable = el;
  }
  const bool need = any && !first_electable && pv;
  has_alive_out[t] = any ? 1 : 0;

  const int64_t out_row = t * R;
  for (int32_t r = 0; r < R; ++r) {
    int32_t src = r;
    if (need) {
      if (r == 0) src = best;
      else if (r == best) src = 0;
    }
    const int32_t b = pv ? rb_in[in_row + src] : B;
    bool o = pv && off_in[in_row + src] != 0;
    o = o || (b < B && !broker_up(b, B, valid, alive, dead_s, add_s));
    rb_out[out_row + r] = b;
    pref_out[out_row + r] = pref_in[in_row + src];
    off_out[out_row + r] = o ? 1 : 0;
  }
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
