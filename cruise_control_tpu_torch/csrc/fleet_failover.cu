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
// and has_alive [C, S, P].
//
// Replaces the transform half of cruise_control_tpu/fleet/engine.py's
// fleet sweep programs (:780 N-1, :959 trajectories), which run
// whatif/engine.py:scenario_transform under vmap over S inside lax.map
// over C.
//
// Bound on the card: bytes — the outputs are S times the inputs (617 MB at
// the fleet N-1 sweep's 16 x 100 x 20,096 x 2). A thread a row (four byte
// loads a slot twice, narrow strided stores) is bound by the loads and
// stores it issues, not by bytes. This design:
//  - a block serves one cluster, a tile of kTile partitions and a chunk of
//    scenarios; it first builds each scenario's broker "up" mask
//    ((valid | add) & (alive | add) & ~dead) as bits in shared memory, one
//    warp ballot a 32-broker word, so a slot costs one shared-memory word
//    test;
//  - a thread holds kV consecutive partitions' slots and pvalid in
//    registers, read once with all that does not depend on the scenario,
//    and loops over the chunk's scenarios;
//  - its rb and pref leave as 16-byte stores, its off bytes and has_alive
//    flags packed into 4-, 8- or 16-byte stores (where P % kV == 0 and the
//    tensors are 16-byte aligned; else one store an element), marked
//    streaming;
//  - scenario chunks are cut so the grid fills the SMs kBlocksPerSm times
//    and the chunk's masks fit kMaxMaskWords words of shared memory, and
//    the registers are capped so kMinBlocks blocks stay resident: more
//    stores in flight (scripts/probe_draw_failover.py times the
//    alternatives; a write-only fill of the same bytes still takes about
//    half the time).
// R of 1-4 is compiled in. Another R, or a broker count whose one-scenario
// mask passes kMaxMaskWords, runs the row kernel (failover_row.cuh, masks
// read from global memory).

#include <cstdint>
#include <cuda_runtime.h>

#include "failover_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;                   // partitions a thread
constexpr int kTile = kThreads * kV;    // partitions a block
constexpr int kMaxMaskWords = 12288;    // 48 KB of mask words a block
constexpr int kMinBlocks = 4;           // resident blocks an SM, at least
constexpr int kBlocksPerSm = 16;        // grid target, in blocks an SM

// A vector store of the outputs, marked streaming (read by the next
// kernel, not by this one).
template <typename T>
__device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }

// bytes[0..4N) as N little-endian words.
template <int N>
__device__ __forceinline__ void pack_bytes(const uint8_t* bytes,
                                           uint32_t (&words)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    words[k] = bytes[4 * k] | (bytes[4 * k + 1] << 8)
               | (bytes[4 * k + 2] << 16)
               | (static_cast<uint32_t>(bytes[4 * k + 3]) << 24);
  }
}

// N words to a 4N-byte-aligned address: 16 bytes at a time where N is a
// multiple of 4, 8 where it is even, else 4.
template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      store(reinterpret_cast<uint4*>(dst + k),
            make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]));
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      store(reinterpret_cast<uint2*>(dst + k), make_uint2(w[k], w[k + 1]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) store(dst + k, w[k]);
  }
}

// arr[idx] of a small register array, as a chain of selects.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&arr)[N], int idx) {
  T v = arr[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = idx == k ? arr[k] : v;
  return v;
}

template <int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fleet_failover_tiled_kernel(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ dead,
    const uint8_t* __restrict__ add, const uint8_t* __restrict__ pvalid,
    int32_t* __restrict__ rb_out, int32_t* __restrict__ pref_out,
    uint8_t* __restrict__ off_out, uint8_t* __restrict__ has_alive_out,
    int64_t S, int64_t P, int32_t B, int32_t W, int32_t s_chunk,
    int64_t tiles, int64_t chunks, bool vec) {
  extern __shared__ uint32_t up_mask[];             // [s_chunk][W + 1]
  const int64_t ch = blockIdx.x % chunks;
  const int64_t tile = (blockIdx.x / chunks) % tiles;
  const int64_t c = blockIdx.x / (chunks * tiles);
  const int64_t s0 = ch * s_chunk;
  const int ns = static_cast<int>(S - s0 < s_chunk ? S - s0 : s_chunk);

  // Each scenario's up mask, a ballot a 32-broker word, then a zero word.
  const int lane = threadIdx.x & 31;
  for (int idx = threadIdx.x >> 5; idx < ns * (W + 1);
       idx += kThreads / 32) {
    const int s = idx / (W + 1);
    const int32_t b = (idx - s * (W + 1)) * 32 + lane;
    bool u = false;
    if (b < B) {
      const int64_t cs = c * S + s0 + s;
      const bool ad = add[cs * B + b] != 0;
      u = (valid[c * B + b] != 0 || ad) && (alive[c * B + b] != 0 || ad)
          && dead[cs * B + b] == 0;
    }
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, u);
    if (lane == 0) up_mask[idx] = word;
  }
  __syncthreads();

  const int64_t p0 = tile * kTile + threadIdx.x * kV;
  const int cnt = static_cast<int>(P - p0 < kV ? P - p0 : kV);
  if (cnt <= 0) return;

  // The thread's partitions, read once, with what does not depend on the
  // scenario: each slot's broker (the sentinel B where the cluster does
  // not hold the partition), offline flag, whether it may be marked
  // offline (an id below B), and where its up bit sits in a scenario's
  // mask ((word << 5) | bit; an id outside [0, B) reads the zero word W).
  int32_t bk[kV][R], pref[kV][R];
  uint32_t at[kV][R];
  bool off[kV][R], low[kV][R], pv[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int64_t in = (c * P + p0 + v) * R;
    pv[v] = v < cnt && pvalid[c * P + p0 + v] != 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t raw = v < cnt ? rb_in[in + r] : 0;
      const int32_t b = pv[v] ? raw : B;
      bk[v][r] = b;
      pref[v][r] = v < cnt ? pref_in[in + r] : 0;
      off[v][r] = pv[v] && off_in[in + r] != 0;
      low[v][r] = b < B;
      at[v][r] = b >= 0 && b < B ? static_cast<uint32_t>(b)
                                 : static_cast<uint32_t>(W) << 5;
    }
  }

  for (int s = 0; s < ns; ++s) {
    const uint32_t* mask = up_mask + s * (W + 1);
    int32_t ob[kV][R], op[kV][R];
    uint8_t oo[kV][R], ha[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      bool u[R];
      int best = 0;
      int32_t best_score = 0;
      bool any = false, first_el = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        u[r] = ((mask[at[v][r] >> 5] >> (at[v][r] & 31)) & 1u) != 0;
        const bool el = u[r] && !off[v][r];
        const int32_t score = el ? pref[v][r] : R + 1;
        if (r == 0 || score < best_score) {
          best_score = score;
          best = r;
        }
        any = any || el;
        if (r == 0) first_el = el;
      }
      const bool need = any && !first_el && pv[v];
      ha[v] = any ? 1 : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int src = r;
        if (need) {
          if (r == 0) src = best;
          else if (r == best) src = 0;
        }
        ob[v][r] = pick(bk[v], src);
        op[v][r] = pick(pref[v], src);
        oo[v][r] = (pick(off[v], src) || (pick(low[v], src)
                                          && !pick(u, src))) ? 1 : 0;
      }
    }

    const int64_t row = (c * S + s0 + s) * P + p0;   // first row's index
    if (vec && cnt == kV) {
      // kV * R slots of rb and pref as 16-byte words; kV * R off bytes and
      // kV has_alive bytes packed little-endian into 32-bit words, stored
      // 16, 8 or 4 bytes at a time
      constexpr int kSlots = kV * R;
      const int32_t* fb = &ob[0][0];
      const int32_t* fp = &op[0][0];
      int4* rb4 = reinterpret_cast<int4*>(rb_out + row * R);
      int4* pref4 = reinterpret_cast<int4*>(pref_out + row * R);
#pragma unroll
      for (int k = 0; k < kSlots / 4; ++k) {
        store(rb4 + k, make_int4(fb[4 * k], fb[4 * k + 1], fb[4 * k + 2],
                                 fb[4 * k + 3]));
        store(pref4 + k, make_int4(fp[4 * k], fp[4 * k + 1], fp[4 * k + 2],
                                   fp[4 * k + 3]));
      }
      uint32_t words[kSlots / 4];
      pack_bytes(&oo[0][0], words);
      store_words(reinterpret_cast<uint32_t*>(off_out + row * R), words);
      uint32_t flags[kV / 4];
      pack_bytes(ha, flags);
      store_words(reinterpret_cast<uint32_t*>(has_alive_out + row), flags);
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        if (v < cnt) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            rb_out[(row + v) * R + r] = ob[v][r];
            pref_out[(row + v) * R + r] = op[v][r];
            off_out[(row + v) * R + r] = oo[v][r];
          }
          has_alive_out[row + v] = ha[v];
        }
      }
    }
  }
}

// Any R: one thread a row, the masks read from global memory (for the
// shapes the tiled kernel does not take).
__global__ void fleet_failover_rows_kernel(
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

template <int R>
int launch_tiled(const void* rb, const void* off, const void* pref,
                 const void* valid, const void* alive, const void* dead,
                 const void* add, const void* pvalid, void* rb_out,
                 void* pref_out, void* off_out, void* has_alive_out,
                 int64_t C, int64_t S, int64_t P, int32_t B, int32_t W,
                 int32_t s_chunk, bool vec, cudaStream_t stream) {
  const int64_t tiles = (P + kTile - 1) / kTile;
  const int64_t chunks = (S + s_chunk - 1) / s_chunk;
  const size_t shared = sizeof(uint32_t) * s_chunk * (W + 1);
  fleet_failover_tiled_kernel<R>
      <<<static_cast<unsigned>(C * tiles * chunks), kThreads, shared,
         stream>>>(
          static_cast<const int32_t*>(rb), static_cast<const uint8_t*>(off),
          static_cast<const int32_t*>(pref),
          static_cast<const uint8_t*>(valid),
          static_cast<const uint8_t*>(alive),
          static_cast<const uint8_t*>(dead), static_cast<const uint8_t*>(add),
          static_cast<const uint8_t*>(pvalid), static_cast<int32_t*>(rb_out),
          static_cast<int32_t*>(pref_out), static_cast<uint8_t*>(off_out),
          static_cast<uint8_t*>(has_alive_out), S, P, B, W, s_chunk, tiles,
          chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Scenarios a block of the tiled kernel serves at this shape (0: the row
// kernel runs).
extern "C" int64_t cc_fleet_failover_chunk(int64_t C, int64_t S, int64_t P,
                                           int64_t R, int64_t B) {
  const int64_t W1 = (B + 31) / 32 + 1;       // a scenario's mask words
  if (R < 1 || R > 4 || W1 > kMaxMaskWords || C * S * P == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = (P + kTile - 1) / kTile;
  const int64_t want = static_cast<int64_t>(kBlocksPerSm) * sms;
  int64_t splits = (want + C * tiles - 1) / (C * tiles);
  splits = splits < 1 ? 1 : (splits > S ? S : splits);
  int64_t s_chunk = (S + splits - 1) / splits;
  if (s_chunk > kMaxMaskWords / W1) s_chunk = kMaxMaskWords / W1;
  return s_chunk;
}

extern "C" int cc_fleet_scenario_failover(
    const void* rb, const void* off, const void* pref, const void* valid,
    const void* alive, const void* dead, const void* add, const void* pvalid,
    void* rb_out, void* pref_out, void* off_out, void* has_alive_out,
    int64_t C, int64_t S, int64_t P, int64_t R, int64_t B, void* stream) {
  const int64_t rows = C * S * P;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t s_chunk = cc_fleet_failover_chunk(C, S, P, R, B);
  if (s_chunk > 0) {
    const int32_t W = static_cast<int32_t>((B + 31) / 32);
    const bool vec = P % kV == 0 && aligned16(rb_out) && aligned16(pref_out)
                     && aligned16(off_out) && aligned16(has_alive_out);
    const int32_t b32 = static_cast<int32_t>(B);
    const int32_t sc = static_cast<int32_t>(s_chunk);
    switch (R) {
      case 1:
        return launch_tiled<1>(rb, off, pref, valid, alive, dead, add,
                               pvalid, rb_out, pref_out, off_out,
                               has_alive_out, C, S, P, b32, W, sc, vec, st);
      case 2:
        return launch_tiled<2>(rb, off, pref, valid, alive, dead, add,
                               pvalid, rb_out, pref_out, off_out,
                               has_alive_out, C, S, P, b32, W, sc, vec, st);
      case 3:
        return launch_tiled<3>(rb, off, pref, valid, alive, dead, add,
                               pvalid, rb_out, pref_out, off_out,
                               has_alive_out, C, S, P, b32, W, sc, vec, st);
      default:
        return launch_tiled<4>(rb, off, pref, valid, alive, dead, add,
                               pvalid, rb_out, pref_out, off_out,
                               has_alive_out, C, S, P, b32, W, sc, vec, st);
    }
  }
  const int threads = 256;
  const int64_t blocks = (rows + threads - 1) / threads;
  fleet_failover_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               st>>>(
      static_cast<const int32_t*>(rb), static_cast<const uint8_t*>(off),
      static_cast<const int32_t*>(pref), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(dead),
      static_cast<const uint8_t*>(add), static_cast<const uint8_t*>(pvalid),
      static_cast<int32_t*>(rb_out), static_cast<int32_t*>(pref_out),
      static_cast<uint8_t*>(off_out), static_cast<uint8_t*>(has_alive_out),
      C, S, P, static_cast<int32_t>(R), static_cast<int32_t>(B));
  return static_cast<int>(cudaGetLastError());
}
