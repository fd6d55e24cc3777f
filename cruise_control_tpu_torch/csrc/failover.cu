// KD and KJ: placement edit and leadership failover over a [C, S] grid of
// (cluster, scenario) rows, in one tiled kernel.
//
// For every (cluster c, scenario s, partition p) row:
//  - a partition the row does not hold (pvalid false) routes its slots to
//    the sentinel B and clears its offline flags;
//  - the slot holding the electable replica with the lowest preferred
//    position (electable: the slot holds a broker that is up in this
//    scenario, and the replica is not offline; ties go to the lowest slot,
//    as jnp.argmin breaks them) becomes the leader when slot 0 is not
//    electable: broker, preferred position and offline flag swap with
//    slot 0 together;
//  - every replica left on a broker that is down is marked offline.
// A broker is up in (c, s) when (valid | add) & (alive | add) & ~dead; a
// broker index outside [0, B) is never up (the reference reads the clamped
// sentinel row, which is down).
//
// Inputs: the placement rb/off/pref, [C, P, R] shared by every scenario of
// a cluster or [C, S, P, R] one per scenario (kInPerS); pvalid, [C, P] or
// [C, S, P] (kPvPerS); the broker masks valid/alive [C, B] and the
// scenarios' dead/add [C, S, B]. Outputs rb, pref, off [C, S, P, R] and
// has_alive [C, S, P] (some slot was electable).
//
// Replaces the placement half of cruise_control_tpu/whatif/engine.py:
// scenario_transform (:606-647), vmapped over the scenario axis (KD: C = 1,
// the placement shared, or per scenario as the move scheduler's
// batch-boundary audit passes it; pvalid per scenario), and the transform
// of cruise_control_tpu/fleet/engine.py's fleet sweeps (:780 N-1, :959
// trajectories), which run it under lax.map over the clusters (KJ).
//
// Bound on the card: bytes — the outputs are S times the placement. A
// thread a row (four byte loads a slot, twice, and narrow strided stores)
// is bound by the loads and stores it issues. The tiled kernel:
//  - a block serves one cluster, a tile of kTile partitions and a chunk of
//    scenarios; it first builds each scenario's broker "up" mask as bits in
//    shared memory, one warp ballot a 32-broker word (then a zero word for
//    ids outside [0, B)), so a slot costs one shared-memory word test;
//  - a thread holds kV consecutive partitions; a shared placement is read
//    once and kept in registers across the chunk; a placement or pvalid per
//    scenario is read for each scenario with 16- and 4-byte loads;
//  - its rb and pref leave as 16-byte stores, its off bytes and has_alive
//    flags packed into 4-, 8- or 16-byte stores (where P % kV == 0 and the
//    tensors are 16-byte aligned; else one access an element), marked
//    streaming;
//  - scenario chunks are cut from shapes alone (cc_failover_chunk) so the
//    grid fills the SMs kBlocksPerSm times and the chunk's masks fit
//    kMaxMaskWords words of shared memory; the registers are capped so
//    kMinBlocks blocks stay resident. scripts/probe_draw_failover.py times
//    the alternatives.
// R of 1-4 is compiled in. Another R, or a broker count whose one-scenario
// mask passes kMaxMaskWords, runs the row kernel (masks read from global
// memory).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;                   // partitions a thread
constexpr int kTile = kThreads * kV;    // partitions a block
constexpr int kMaxMaskWords = 12288;    // 48 KB of mask words a block
constexpr int kMinBlocks = 4;           // resident blocks an SM, at least
constexpr int kBlocksPerSm = 64;        // grid target, in blocks an SM

// Where a (cluster, scenario) row's inputs start.
struct Rows {
  bool in_per_s, pv_per_s;
  int64_t S, P, R, B;
  __device__ int64_t slots(int64_t c, int64_t s) const {
    return (in_per_s ? c * S + s : c) * P * R;
  }
  __device__ int64_t pvalid(int64_t c, int64_t s) const {
    return (pv_per_s ? c * S + s : c) * P;
  }
};

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

// A thread's kV partitions of one placement row: each slot's broker id,
// preferred position and offline byte.
template <int R>
struct Slots {
  int32_t rb[kV][R], pref[kV][R];
  uint8_t off[kV][R];

  __device__ __forceinline__ void load(const int32_t* __restrict__ rb_in,
                                       const uint8_t* __restrict__ off_in,
                                       const int32_t* __restrict__ pref_in,
                                       int cnt, bool vec) {
    if (vec && cnt == kV) {
      // kV * R slots: R 16-byte words of rb and of pref, R 4-byte words
      // of off
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int4 a = reinterpret_cast<const int4*>(rb_in)[k];
        const int4 b = reinterpret_cast<const int4*>(pref_in)[k];
        const uint32_t o = reinterpret_cast<const uint32_t*>(off_in)[k];
        const int32_t av[4] = {a.x, a.y, a.z, a.w};
        const int32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rb[(4 * k + e) / R][(4 * k + e) % R] = av[e];
          pref[(4 * k + e) / R][(4 * k + e) % R] = bv[e];
          off[(4 * k + e) / R][(4 * k + e) % R] = (o >> (8 * e)) & 0xFFu;
        }
      }
      return;
    }
#pragma unroll
    for (int v = 0; v < kV; ++v) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rb[v][r] = v < cnt ? rb_in[v * R + r] : 0;
        pref[v][r] = v < cnt ? pref_in[v * R + r] : 0;
        off[v][r] = v < cnt ? off_in[v * R + r] : 0;
      }
    }
  }
};

// A thread's kV pvalid bytes (one 4-byte load where vec).
__device__ __forceinline__ void load_pvalid(const uint8_t* __restrict__ pvalid,
                                            int cnt, bool vec,
                                            bool (&pv)[kV]) {
  if (vec && cnt == kV) {
    const uint32_t p4 = *reinterpret_cast<const uint32_t*>(pvalid);
#pragma unroll
    for (int v = 0; v < kV; ++v) pv[v] = ((p4 >> (8 * v)) & 0xFFu) != 0;
    return;
  }
#pragma unroll
  for (int v = 0; v < kV; ++v) pv[v] = v < cnt && pvalid[v] != 0;
}

// One scenario's rows of a thread's partitions, written from their slots,
// pvalid and the scenario's up mask (an id outside [0, B) reads the zero
// word W).
template <int R>
__device__ __forceinline__ void write_rows(
    const Slots<R>& in, const bool (&pv)[kV], const uint32_t* mask,
    int32_t B, int32_t W, int64_t row, int cnt, bool vec,
    int32_t* __restrict__ rb_out, int32_t* __restrict__ pref_out,
    uint8_t* __restrict__ off_out, uint8_t* __restrict__ has_alive_out) {
  int32_t ob[kV][R], op[kV][R];
  uint8_t oo[kV][R], ha[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    int32_t bk[R];
    bool u[R], of[R];
    int best = 0;
    int32_t best_score = 0;
    bool any = false, first_el = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bk[r] = pv[v] ? in.rb[v][r] : B;
      of[r] = pv[v] && in.off[v][r] != 0;
      const uint32_t at = bk[r] >= 0 && bk[r] < B
                              ? static_cast<uint32_t>(bk[r])
                              : static_cast<uint32_t>(W) << 5;
      u[r] = ((mask[at >> 5] >> (at & 31)) & 1u) != 0;
      const bool el = u[r] && !of[r];
      const int32_t score = el ? in.pref[v][r] : R + 1;
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
      const int32_t b = pick(bk, src);
      ob[v][r] = b;
      op[v][r] = pick(in.pref[v], src);
      oo[v][r] = (pick(of, src) || (b < B && !pick(u, src))) ? 1 : 0;
    }
  }

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

// kInPerS: a placement per scenario (read for each scenario) or shared by
// a cluster's scenarios (read once, kept in registers); kPvPerS: likewise
// for pvalid.
template <int R, bool kInPerS, bool kPvPerS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
failover_tiled_kernel(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ dead,
    const uint8_t* __restrict__ add, const uint8_t* __restrict__ pvalid,
    int32_t* __restrict__ rb_out, int32_t* __restrict__ pref_out,
    uint8_t* __restrict__ off_out, uint8_t* __restrict__ has_alive_out,
    int64_t S, int64_t P, int32_t B, int32_t W, int32_t s_chunk,
    int64_t tiles, int64_t chunks, bool vec) {
  extern __shared__ uint32_t up_mask[];             // [s_chunk][W + 1]
  const Rows rows{kInPerS, kPvPerS, S, P, R, B};
  const int64_t ch = blockIdx.x % chunks;
  const int64_t tile = (blockIdx.x / chunks) % tiles;
  const int64_t c = blockIdx.x / (chunks * tiles);
  const int64_t s0 = ch * s_chunk;
  const int ns = static_cast<int>(S - s0 < s_chunk ? S - s0 : s_chunk);

  // The chunk's first slots and pvalid: where both are shared by the
  // chunk's scenarios (KJ), read before the masks are built so that their
  // loads overlap the ballots; else after them (faster for KD's forms,
  // scripts/probe_draw_failover.py).
  constexpr bool kEarly = !kInPerS && !kPvPerS;
  const int64_t p0 = tile * kTile + threadIdx.x * kV;
  const int cnt = static_cast<int>(P - p0 < kV ? P - p0 : kV);
  Slots<R> in;
  bool pv[kV];
  auto load_first = [&] {
    const int64_t at = rows.slots(c, s0) + p0 * R;
    in.load(rb_in + at, off_in + at, pref_in + at, cnt, vec);
    load_pvalid(pvalid + rows.pvalid(c, s0) + p0, cnt, vec, pv);
  };
  if (kEarly && cnt > 0) load_first();

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

  if (cnt <= 0) return;
  if (!kEarly) load_first();

  for (int s = 0; s < ns; ++s) {
    if (s > 0) {
      if constexpr (kInPerS) {
        const int64_t at = rows.slots(c, s0 + s) + p0 * R;
        in.load(rb_in + at, off_in + at, pref_in + at, cnt, vec);
      }
      if constexpr (kPvPerS) {
        load_pvalid(pvalid + rows.pvalid(c, s0 + s) + p0, cnt, vec, pv);
      }
    }
    write_rows<R>(in, pv, up_mask + s * (W + 1), B, W,
                  (c * S + s0 + s) * P + p0, cnt, vec, rb_out, pref_out,
                  off_out, has_alive_out);
  }
}

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

// Any R: one thread a row, the masks read from global memory (for the
// shapes the tiled kernel does not take). The row walks its R slots twice
// (find the leader, then write the swapped row).
__global__ void failover_rows_kernel(
    const int32_t* __restrict__ rb_in, const uint8_t* __restrict__ off_in,
    const int32_t* __restrict__ pref_in, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ alive, const uint8_t* __restrict__ dead,
    const uint8_t* __restrict__ add, const uint8_t* __restrict__ pvalid,
    int32_t* __restrict__ rb_out, int32_t* __restrict__ pref_out,
    uint8_t* __restrict__ off_out, uint8_t* __restrict__ has_alive_out,
    Rows rows, int64_t C) {
  const int64_t S = rows.S, P = rows.P;
  const int32_t R = static_cast<int32_t>(rows.R);
  const int32_t B = static_cast<int32_t>(rows.B);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (t >= C * S * P) return;
  const int64_t cs = t / P;             // c * S + s
  const int64_t p = t - cs * P;
  const int64_t c = cs / S;
  const int64_t in = rows.slots(c, cs - c * S) + p * R;
  const bool pv = pvalid[rows.pvalid(c, cs - c * S) + p] != 0;
  const uint8_t* va = valid + c * B;
  const uint8_t* al = alive + c * B;
  const uint8_t* de = dead + cs * B;
  const uint8_t* ad = add + cs * B;

  int32_t best = 0;
  int32_t best_score = 0;
  bool any = false;
  bool first_electable = false;
  for (int32_t r = 0; r < R; ++r) {
    const int32_t b = pv ? rb_in[in + r] : B;
    const bool o = pv && off_in[in + r] != 0;
    const bool el = b < B && !o && broker_up(b, B, va, al, de, ad);
    const int32_t score = el ? pref_in[in + r] : R + 1;
    if (r == 0 || score < best_score) {
      best_score = score;
      best = r;
    }
    any = any || el;
    if (r == 0) first_electable = el;
  }
  const bool need = any && !first_electable && pv;
  has_alive_out[t] = any ? 1 : 0;
  for (int32_t r = 0; r < R; ++r) {
    int32_t src = r;
    if (need) {
      if (r == 0) src = best;
      else if (r == best) src = 0;
    }
    const int32_t b = pv ? rb_in[in + src] : B;
    bool o = pv && off_in[in + src] != 0;
    o = o || (b < B && !broker_up(b, B, va, al, de, ad));
    rb_out[t * R + r] = b;
    pref_out[t * R + r] = pref_in[in + src];
    off_out[t * R + r] = o ? 1 : 0;
  }
}

template <int R, bool kInPerS, bool kPvPerS>
int launch_tiled(const void* const* in, void* const* out, int64_t C,
                 int64_t S, int64_t P, int32_t B, int32_t W, int32_t s_chunk,
                 bool vec, cudaStream_t stream) {
  const int64_t tiles = (P + kTile - 1) / kTile;
  const int64_t chunks = (S + s_chunk - 1) / s_chunk;
  const size_t shared = sizeof(uint32_t) * s_chunk * (W + 1);
  failover_tiled_kernel<R, kInPerS, kPvPerS>
      <<<static_cast<unsigned>(C * tiles * chunks), kThreads, shared,
         stream>>>(
          static_cast<const int32_t*>(in[0]),
          static_cast<const uint8_t*>(in[1]),
          static_cast<const int32_t*>(in[2]),
          static_cast<const uint8_t*>(in[3]),
          static_cast<const uint8_t*>(in[4]),
          static_cast<const uint8_t*>(in[5]),
          static_cast<const uint8_t*>(in[6]),
          static_cast<const uint8_t*>(in[7]), static_cast<int32_t*>(out[0]),
          static_cast<int32_t*>(out[1]), static_cast<uint8_t*>(out[2]),
          static_cast<uint8_t*>(out[3]), S, P, B, W, s_chunk, tiles, chunks,
          vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInPerS, bool kPvPerS>
int launch_r(int64_t R, const void* const* in, void* const* out, int64_t C,
             int64_t S, int64_t P, int32_t B, int32_t W, int32_t s_chunk,
             bool vec, cudaStream_t st) {
  switch (R) {
    case 1:
      return launch_tiled<1, kInPerS, kPvPerS>(in, out, C, S, P, B, W,
                                               s_chunk, vec, st);
    case 2:
      return launch_tiled<2, kInPerS, kPvPerS>(in, out, C, S, P, B, W,
                                               s_chunk, vec, st);
    case 3:
      return launch_tiled<3, kInPerS, kPvPerS>(in, out, C, S, P, B, W,
                                               s_chunk, vec, st);
    default:
      return launch_tiled<4, kInPerS, kPvPerS>(in, out, C, S, P, B, W,
                                               s_chunk, vec, st);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Scenarios a block of the tiled kernel serves at this shape (0: the row
// kernel runs): enough chunks for kBlocksPerSm blocks an SM, at most the
// scenarios whose masks fit kMaxMaskWords.
extern "C" int64_t cc_failover_chunk(int64_t C, int64_t S, int64_t P,
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

// The whole [C, S, P] grid of rows. in_per_s / pv_per_s: the placement /
// pvalid carries a scenario axis. s_chunk < 0 takes cc_failover_chunk's
// chunk, 0 the row kernel, more a chunk of that many scenarios (a probe's
// choice; at most what the shared memory holds).
extern "C" int cc_failover(
    const void* rb, const void* off, const void* pref, const void* valid,
    const void* alive, const void* dead, const void* add, const void* pvalid,
    void* rb_out, void* pref_out, void* off_out, void* has_alive_out,
    int64_t C, int64_t S, int64_t P, int64_t R, int64_t B, int64_t in_per_s,
    int64_t pv_per_s, int64_t s_chunk, void* stream) {
  const int64_t n = C * S * P;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  if (s_chunk < 0) s_chunk = cc_failover_chunk(C, S, P, R, B);
  if (s_chunk > 0 && R >= 1 && R <= 4) {
    const void* in[8] = {rb, off, pref, valid, alive, dead, add, pvalid};
    void* out[4] = {rb_out, pref_out, off_out, has_alive_out};
    const int32_t W = static_cast<int32_t>((B + 31) / 32);
    if (s_chunk > kMaxMaskWords / (W + 1)) s_chunk = kMaxMaskWords / (W + 1);
    if (s_chunk > S) s_chunk = S;
    const void* vectors[8] = {rb, off, pref, pvalid, rb_out, pref_out,
                              off_out, has_alive_out};
    bool vec = P % kV == 0;
    for (const void* p : vectors) vec = vec && aligned16(p);
    const int32_t b32 = static_cast<int32_t>(B);
    const int32_t sc = static_cast<int32_t>(s_chunk);
    if (in_per_s) {
      return pv_per_s ? launch_r<true, true>(R, in, out, C, S, P, b32, W,
                                             sc, vec, st)
                      : launch_r<true, false>(R, in, out, C, S, P, b32, W,
                                              sc, vec, st);
    }
    return pv_per_s ? launch_r<false, true>(R, in, out, C, S, P, b32, W, sc,
                                            vec, st)
                    : launch_r<false, false>(R, in, out, C, S, P, b32, W, sc,
                                             vec, st);
  }
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  failover_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const int32_t*>(rb), static_cast<const uint8_t*>(off),
      static_cast<const int32_t*>(pref), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(dead),
      static_cast<const uint8_t*>(add), static_cast<const uint8_t*>(pvalid),
      static_cast<int32_t*>(rb_out), static_cast<int32_t*>(pref_out),
      static_cast<uint8_t*>(off_out), static_cast<uint8_t*>(has_alive_out),
      Rows{in_per_s != 0, pv_per_s != 0, S, P, R, B}, C);
  return static_cast<int>(cudaGetLastError());
}
