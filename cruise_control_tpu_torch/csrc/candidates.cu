// KT: a goal's proposal assembled from its parts in one launch -- every
// Candidates field of every part's rows, each part at its offset.
//
// Replaces, on the card, the candidate construction of the reference's
// proposals: state.py:make_move_candidates, make_leadership_candidates,
// make_swap_candidates and concat_candidates
// (cruise_control_tpu/analyzer/state.py:277-353), the grid's K x D cross
// (goals.py:_top_replica_dest_grid), an interval goal's swap pairing with
// its random roll (IntervalGoal._swap_candidates) and the idx // R, idx % R
// splits of the top-k lists. In plain torch a proposal of three parts was
// some 60 launches of gathers, wheres and concatenations.
//
// A part (kernels.Part) is its index and value lists as top_k, KO's match
// and KS leave them:
// - move: the first replica as (p, r) or a flat [P, R] index, its
//   destination, validity from the priority (finite) and/or a flag;
// - grid: the top-K replicas x the top-D destinations (row k * D + d);
// - leadership: slot r of partition p becoming its leader;
// - swap: the k-th heaviest replica with the ((k - shift) mod K)-th
//   lightest, shift = jax.random.randint(key, (), 0, K) drawn here from
//   the part's key path (KA's threefry and randint, threefry.cuh);
// - topic_swap: the heavy replica with its partner slot (KS); a negative
//   partner's row is the one the reference's gathers read (floor division
//   and modulo, the row counted from the end and clamped).
//
// Bound on the card: bytes -- each row reads a few indices, two partition
// rows of loads and a slot of the placement, and writes 100 bytes; at the
// main path's shapes (a few thousand rows) a launch's floor. A thread a
// row, every load of a row made before its stores; no arithmetic but a
// subtraction a field of a swap or a leadership transfer (load1 - load2,
// pot1 - pot2, lni1 - lni2, leader - follower) and negations, each rounded
// on its own (-fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 4;           // kernels.MAX_PARTS
constexpr int64_t kMove = 0;           // model/flat.py:MOVE_INTER_BROKER
constexpr int64_t kLead = 1;           // MOVE_LEADERSHIP
constexpr int64_t kSwap = 2;           // MOVE_SWAP

// kernels.PART_KINDS
enum PartKind : int32_t {
  kPartMove = 0, kPartGrid = 1, kPartLeadership = 2, kPartSwap = 3,
  kPartTopicSwap = 4
};

}  // namespace

struct PartDesc {
  int32_t kind;
  int64_t n;                    // rows (K * D for the grid)
  int64_t offset;               // the part's first row of the output
  int64_t K;                    // entries of the first replica's lists
  int64_t D;                    // the grid's destinations
  const int64_t* p;             // [K] partition rows, or null: idx
  const int64_t* r;             // [K] slots
  const int64_t* idx;           // [K] flat [P, R] indices
  const float* vals;            // [K] priorities (valid where finite), or null
  const uint8_t* ok;            // [K] flags, or null
  const int64_t* dst;           // [K] a move's destinations
  const int64_t* didx;          // [D] the grid's destinations
  const float* dvals;           // [D] their priorities
  const int64_t* idx2;          // [K] an interval swap's light list
  const float* vals2;           // [K] its priorities
  const int64_t* partner;       // [K] a topic swap's partner slot
  DrawPath shift;               // an interval swap's roll (key path)
};

struct CandArgs {
  const int64_t* rb;            // [P, R]
  const uint8_t* off;           // [P, R]
  const float* leader_load;     // [P, 4], 16-byte aligned
  const float* follower_load;   // [P, 4], 16-byte aligned
  const int64_t* key;           // int64[2] root of the swap roll's key path
  // the outputs: kernels.CANDIDATE_FIELDS, N rows each
  int64_t* p;
  int64_t* r;
  int64_t* p2;
  int64_t* r2;
  int64_t* src;
  int64_t* dst;
  int64_t* kind;
  uint8_t* valid;
  uint8_t* must;
  float* d_util_src;            // [N, 4]
  float* d_util_dst;            // [N, 4]
  int32_t* d_cnt;
  int32_t* d_lead;
  float* d_pot;
  float* d_lni;
  int64_t P, R, N;
  int32_t n_parts;
  PartDesc parts[kMaxParts];
};

namespace {

// jax.random.randint(key, (), 0, span) for int32 (threefry.cu's kRandint
// at counter 0): the words of two folded keys combined modulo the span.
__device__ int64_t randint0(uint32_t k0, uint32_t k1, uint32_t span) {
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  uint32_t h0 = k0, h1 = k1, l0 = k0, l1 = k1;
  threefry::fold(h0, h1, 0u);
  threefry::fold(l0, l1, 1u);
  const uint32_t hi = threefry::bits_at(h0, h1, 0u);
  const uint32_t lo = threefry::bits_at(l0, l1, 0u);
  uint32_t off = (hi % span) * mult + lo % span;
  return static_cast<int64_t>(off % span);
}

// floor division and modulo of a partition slot by R (torch's // and % on
// a negative partner)
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float4 neg4(float4 v) {
  return make_float4(-v.x, -v.y, -v.z, -v.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const CandArgs a) {
  __shared__ int64_t s_shift[kMaxParts];
  if (threadIdx.x < a.n_parts) {
    const PartDesc& d = a.parts[threadIdx.x];
    int64_t shift = 0;
    if (d.kind == kPartSwap && d.K > 0) {
      uint32_t k0, k1;
      threefry::derive(a.key, d.shift, k0, k1);
      shift = randint0(k0, k1, static_cast<uint32_t>(d.K));
    }
    s_shift[threadIdx.x] = shift;
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= a.N) return;
  int j = 0;
  while (j + 1 < a.n_parts && a.parts[j + 1].offset <= i) ++j;
  const PartDesc& d = a.parts[j];
  const int64_t R = a.R;
  int64_t k = i - d.offset;
  int64_t g = 0;                        // the grid's destination slot
  if (d.kind == kPartGrid) {
    g = k % d.D;
    k /= d.D;
  }
  int64_t p, r;
  if (d.idx != nullptr) {
    const int64_t f = d.idx[k];
    p = f / R;
    r = f - p * R;
  } else {
    p = d.p[k];
    r = d.r[k];
  }
  bool valid = (d.vals == nullptr || isfinite(d.vals[k]))
               && (d.ok == nullptr || d.ok[k] != 0);
  const float4* lead = reinterpret_cast<const float4*>(a.leader_load);
  const float4* foll = reinterpret_cast<const float4*>(a.follower_load);
  const float4 ld = lead[p], fl = foll[p];
  int64_t kind, p2 = p, r2 = r, src, dst;
  float4 du;
  int32_t dcnt, dlead;
  float dpot, dlni;
  bool must = false;
  if (d.kind == kPartMove || d.kind == kPartGrid) {
    if (d.kind == kPartGrid) {
      dst = d.didx[g];
      valid = valid && isfinite(d.dvals[g]);
    } else {
      dst = d.dst[k];
    }
    src = a.rb[p * R + r];
    must = a.off[p * R + r] != 0 && valid;
    kind = kMove;
    du = r == 0 ? ld : fl;
    dcnt = 1;
    dlead = r == 0;
    dpot = ld.z;                        // NW_OUT
    dlni = r == 0 ? ld.y : 0.0f;        // NW_IN
  } else if (d.kind == kPartLeadership) {
    src = a.rb[p * R];
    dst = a.rb[p * R + r];
    kind = kLead;
    du = sub4(ld, fl);
    dcnt = 0;
    dlead = 1;
    dpot = 0.0f;
    dlni = ld.y;
  } else {
    if (d.kind == kPartSwap) {
      int64_t jl = k - s_shift[j];
      if (jl < 0) jl += d.K;
      const int64_t f = d.idx2[jl];
      p2 = f / R;
      r2 = f - p2 * R;
      valid = valid && isfinite(d.vals2[jl]);
    } else {
      const int64_t partner = d.partner[k];
      int64_t q = floor_div(partner, R);
      r2 = partner - q * R;
      q = q < 0 ? q + a.P : q;
      p2 = q < 0 ? 0 : (q >= a.P ? a.P - 1 : q);
      valid = valid && partner >= 0;
    }
    const float4 ld2 = lead[p2], fl2 = foll[p2];
    src = a.rb[p * R + r];
    dst = a.rb[p2 * R + r2];
    kind = kSwap;
    du = sub4(r == 0 ? ld : fl, r2 == 0 ? ld2 : fl2);
    dcnt = 0;
    dlead = static_cast<int32_t>(r == 0) - static_cast<int32_t>(r2 == 0);
    dpot = __fsub_rn(ld.z, ld2.z);
    dlni = __fsub_rn(r == 0 ? ld.y : 0.0f, r2 == 0 ? ld2.y : 0.0f);
  }
  a.p[i] = p;
  a.r[i] = r;
  a.p2[i] = p2;
  a.r2[i] = r2;
  a.src[i] = src;
  a.dst[i] = dst;
  a.kind[i] = kind;
  a.valid[i] = valid;
  a.must[i] = must;
  reinterpret_cast<float4*>(a.d_util_src)[i] = neg4(du);
  reinterpret_cast<float4*>(a.d_util_dst)[i] = du;
  a.d_cnt[i] = dcnt;
  a.d_lead[i] = dlead;
  a.d_pot[i] = dpot;
  a.d_lni[i] = dlni;
}

}  // namespace

extern "C" int cc_assemble_candidates(const CandArgs* args, void* stream) {
  const CandArgs a = *args;
  if (a.n_parts < 1 || a.n_parts > kMaxParts || a.R < 1 || a.N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < a.n_parts; ++j) {
    const PartDesc& d = a.parts[j];
    if (d.kind < kPartMove || d.kind > kPartTopicSwap || d.K < 0
        || (d.kind == kPartGrid && d.D < 1)
        || (d.kind == kPartSwap && (a.key == nullptr || d.K >= (1LL << 32)
                                    || d.shift.n < 0
                                    || d.shift.n > threefry::kMaxPath))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a.N == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((a.N + kThreads - 1)
                                                / kThreads);
  assemble_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the argument struct, which the host's ctypes struct must equal
extern "C" int64_t cc_cand_args_size() { return sizeof(CandArgs); }
