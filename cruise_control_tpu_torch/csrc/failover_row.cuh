// One row of a scenario's placement edit and leadership failover, shared
// by KD (scenario_failover.cu, [S, P] rows) and KJ (fleet_failover.cu,
// [C, S, P] rows). Each kernel hands this function its row's base
// pointers.
//
// For one partition p of one scenario s:
//  - a partition the scenario does not hold (pv false) routes its slots to
//    the sentinel B and clears its offline flags;
//  - the slot holding the electable replica with the lowest preferred
//    position (electable: the slot holds a broker that is valid and alive
//    in this scenario, and the replica is not offline; ties go to the
//    lowest slot, as jnp.argmin breaks them) becomes the leader when slot 0
//    is not electable: broker, preferred position and offline flag swap
//    with slot 0 together;
//  - every replica left on a dead or invalid broker is marked offline.
// A broker is valid in s when the template says so or s adds it, alive
// when (alive or added) and not killed by s. A broker index outside [0, B)
// is never up (the reference reads the clamped sentinel row, which is
// down).
//
// The row walks its R slots twice (find the leader, then write the swapped
// row), so each output byte is written once, without scratch.

#pragma once

#include <cstdint>

namespace failover {

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

// rb_in/off_in/pref_in: the partition's R input slots; valid/alive: the
// cluster's [B] masks; dead_s/add_s: the scenario's [B] masks; the outputs
// are the row's R slots and its has_alive flag.
__device__ __forceinline__ void failover_row(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, bool pv,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ dead_s, const uint8_t* __restrict__ add_s,
    int32_t R, int32_t B, int32_t* __restrict__ rb_out,
    int32_t* __restrict__ pref_out, uint8_t* __restrict__ off_out,
    uint8_t* __restrict__ has_alive_out) {
  int32_t best = 0;
  int32_t best_score = 0;
  bool any = false;
  bool first_electable = false;
  for (int32_t r = 0; r < R; ++r) {
    const int32_t b = pv ? rb_in[r] : B;
    const bool o = pv && off_in[r] != 0;
    const bool el = b < B && !o
                    && broker_up(b, B, valid, alive, dead_s, add_s);
    const int32_t score = el ? pref_in[r] : R + 1;
    if (r == 0 || score < best_score) {
      best_score = score;
      best = r;
    }
    any = any || el;
    if (r == 0) first_electable = el;
  }
  const bool need = any && !first_electable && pv;
  *has_alive_out = any ? 1 : 0;

  for (int32_t r = 0; r < R; ++r) {
    int32_t src = r;
    if (need) {
      if (r == 0) src = best;
      else if (r == best) src = 0;
    }
    const int32_t b = pv ? rb_in[src] : B;
    bool o = pv && off_in[src] != 0;
    o = o || (b < B && !broker_up(b, B, valid, alive, dead_s, add_s));
    rb_out[r] = b;
    pref_out[r] = pref_in[src];
    off_out[r] = o ? 1 : 0;
  }
}

}  // namespace failover
