// KX: every goal's residual (and violation scale) of a goal list at one
// state, or at every scenario of a stack of states, in one launch; KY: an
// interval goal's five proposal planes.
//
// KX replaces the goals' violation rows (cruise_control_tpu/analyzer/
// goals.py: IntervalGoal.violation :325-356 and violation_scale :358,
// RackAwareGoal :1130, TopicReplicaDistributionGoal :1215,
// MinTopicLeadersPerBrokerGoal :1484, BrokerSetAwareGoal :1624,
// RackAwareDistributionGoal :1707, PreferredLeaderElectionGoal :1811)
// wherever the port reads a stack of them (analyzer/engine.py:219, :229):
// a pass's converged test and boundary stack, the chain's initial
// readings, the hard-goal audit (analyzer/optimizer.py:492-515), the
// population's and the what-if scorer's stacks. In plain torch one goal's
// violation was ~18 launches (its metric, a tree sum of two range
// launches for the average, the bounds, the penalty, two more range
// launches for the row sum), ~300 a default-chain optimize's passes.
//
// The goals reach the kernel as a table (ViolRow, built once a goal list
// on the host from each goal's violation_row(): KN's row kinds and fields,
// kernels.ROW_KINDS), its loop shapes resolved a width: a row of 9-32
// brokers sums in the vector loop XLA's CPU backend gives its program
// (utils/ordered.py:ROW_LOOPS; ordered.cuh:vector_loop_sum), any other in
// XLA's tree; the topic goal's [T, B1] cells as an eager matrix sum past
// 32 on either axis, else the fused loop's rows or lanes. A block a (row,
// scenario): the block counts the alive brokers, sums an average row's
// total in tree order (bounds.cuh:average), then the penalty row in the
// row's order; a count row (rack duplicates, rack spread, broker sets,
// preferred leaders, topic leader deficits) is an int64 sum over the
// block, exact in any order, rounded to float32 once. The topic rows'
// bounds are a warp a topic into shared memory (bounds.cuh:topic) before
// the cells' sum. The scale of an interval row over a float metric is the
// valid brokers' |value| in tree order (0 for the counts and the other
// kinds).
//
// What bounds it: latency, a block's dependent round trips. Every sum is
// one thread's in-order chain over values in shared memory: an interval
// row's planes are staged first and each summed row (the masked values,
// the penalties, the magnitudes) written there in one parallel pass (a sum
// that evaluated each element inside its window spent ~300 cycles an
// element on the element's own loads: 11-15 us a tree sum at B1 105 in
// %globaltimer stamps); a warp stages each 32 x 32 window of the topic
// cells before its lane 0 adds it; a count row's racks or sets are staged
// and RF 2 placements read a partition's two slots in one 16-byte load.
// The block is 512 threads wide. Every field is read through a scenario
// step (0 for a field the scenarios share), so the what-if stack reads the
// expanded planes in place. Shared memory holds what fits (kMaxShared);
// past it a row reads the planes where they lie. The output goes to
// buffers the caller keeps (a CUDA graph's fixed addresses), and
// ``flag`` (a one-row table) takes the pass's converged test (violation >
// eps, or any replica offline) in the same launch.
//
// KY replaces IntervalGoal.propose_planes (the proposal's values, bounds,
// excess over the upper bound and deficit under the lower one; the
// reference computes the same excess at goals.py:510, :648 and :740): one
// block, the average row's bounds as KX forms them, a thread a broker
// writing the five planes (rows of a [5, W] buffer, W = B1 rounded up to
// 4, each row 16-byte aligned).

#include <cstdint>
#include <cuda_runtime.h>

#include "bounds.cuh"
#include "ordered.cuh"

namespace {

using bounds::Brokers;
using bounds::IntervalBounds;
using bounds::View;
using bounds::block_sum;
using bounds::interval_bounds;
using bounds::kAverage;
using bounds::kCapacity;
using bounds::kCount;
using bounds::kLeaders;
using bounds::staged_sum;
using bounds::stage_interval;

constexpr int kThreads = 512;
constexpr int kPlanesThreads = 256;
constexpr int64_t kMaxShared = 227 * 1024;

// kernels.ROW_KINDS
enum Kind : int32_t {
  kInterval = 0, kHardCap = 1, kRackAware = 2, kRackSpread = 3,
  kTopicReplica = 4, kTopicLeaders = 5, kBrokerSet = 6,
  kPreferredLeader = 7, kNothing = 8
};
// a topic row's sum (kernels.TOPIC_SUM_FORMS)
enum TopicSum : int32_t { kMatrix = 0, kRows = 1, kLanes = 2 };

}  // namespace


// A field and its step between scenarios, in elements (0: shared).
struct Plane {
  const void* p;
  int64_t s;
};

struct ViolArgs {
  Plane rb;                    // int64 [S?, P, R]
  Plane pos;                   // int64 [S?, P, R]
  Plane off;                   // uint8 [S?, P, R]
  Plane util;                  // float [S?, B1, 4]
  Plane cnt;                   // int32 [S?, B1]
  Plane lead;                  // int32 [S?, B1]
  Plane pot;                   // float [S?, B1]
  Plane lni;                   // float [S?, B1]
  Plane cap;                   // float [S?, B1, 4]
  Plane bvalid;                // uint8 [S?, B1]
  Plane balive;                // uint8 [S?, B1]
  Plane rack;                  // int32 [S?, B1]
  Plane bset;                  // int32 [S?, B1]
  Plane pvalid;                // uint8 [S?, P]
  Plane ptopic;                // int32 [S?, P]
  Plane tc;                    // int32 [S?, T, B1] or null
  Plane tlc;                   // int32 [S?, T, B1] or null
  const ViolRow* rows;         // [n_rows] on the card
  float* viol;                 // [S, n_rows] or null (with flag)
  float* scale;                // [S, n_rows] or null
  int64_t* flag;               // null, or (viol > eps) | any offline
  int64_t S, P, R, B1, T;
  int32_t n_rows;
  float eps;
  // 1 where a row of the table sums topic cells (their windows staged a
  // warp each); the launcher clears it, and stages no broker plane, where
  // shared memory cannot hold them
  int32_t windows;
  int32_t staged;              // set by the launcher: broker planes staged
};

struct PlanesArgs {
  const float* util;           // [B1, 4]
  const int32_t* cnt;          // [B1]
  const int32_t* lead;         // [B1]
  const float* pot;            // [B1]
  const float* lni;            // [B1]
  const float* cap;            // [B1, 4]
  const uint8_t* bvalid;       // [B1]
  const uint8_t* balive;       // [B1]
  const ViolRow* rows;         // [1] on the card: an interval row
  float* out;                  // [5, W]: values, lo, up, excess, deficit
  int64_t B1;
};

namespace {

template <class T>
__device__ __forceinline__ const T* at(const Plane& f, int64_t s) {
  return static_cast<const T*>(f.p) + s * f.s;
}

// The row's violation and scale (thread 0 holds them).
__device__ __forceinline__ void interval_row(const ViolRow& row,
                                             const Brokers& br, int64_t B1,
                                             float* scratch, float* planes,
                                             long long* red, float& viol,
                                             float& scale) {
  View view;
  const float n_alive = stage_interval(row, br, B1, planes, red, view);
  float* work = planes != nullptr ? planes + 2 * B1 : nullptr;
  const IntervalBounds ib =
      interval_bounds(row, view, n_alive, B1, scratch, work);
  const bool upper_only = row.upper_only != 0;
  auto pen = [=](int64_t b) -> float {
    const float v = view.value(b);
    const float over = ordered::clamp0(ib.minus_upper(view, v, b));
    const float under = upper_only
                            ? 0.0f
                            : ordered::clamp0(__fsub_rn(ib.lower(), v));
    return view.alive(b) ? __fadd_rn(over, under) : 0.0f;
  };
  viol = staged_sum(pen, B1, work, scratch, row.vf, row.ic, row.epi,
                    row.tail);
  scale = 0.0f;
  if (row.metric != kCount && row.metric != kLeaders) {
    scale = staged_sum(
        [=](int64_t b) {
          const float v = fabsf(view.value(b));
          return view.valid(b) ? v : 0.0f;
        },
        B1, work, scratch);
  }
}

// The row a JAX gather reads for index i along an axis of n: a negative
// index counts from the end, then clamped (goals._jax_index).
__device__ __forceinline__ int64_t jax_index(int64_t i, int64_t n) {
  return ordered::clamp_index(i < 0 ? i + n : i, n);
}

// Shared memory of a KX block, as offsets in floats: the topic bounds [2,
// T], the alive racks' bits, the sums' scratch, the staged broker planes
// [4, B1] (-1: not staged) and the topic cells' windows, 32 x 32 a warp
// (-1: none).
struct Layout {
  int64_t bits, scratch, planes, windows, total;
};

__host__ __device__ inline Layout layout(int64_t B1, int64_t T, bool planes,
                                         bool windows) {
  Layout l;
  l.bits = 2 * T;
  l.scratch = l.bits + (B1 + 31) / 32;
  const int64_t tree = ordered::tree_scratch(B1);
  const int64_t matrix = T > 0 ? ordered::matrix_scratch(T, B1) : 0;
  l.planes = l.scratch + (tree > matrix ? tree : matrix);
  l.windows = l.planes + (planes ? 4 * B1 : 0);
  l.total = l.windows + (windows ? (kThreads / 32) * 1024 : 0);
  if (!planes) l.planes = -1;
  if (!windows) l.windows = -1;
  return l;
}

__global__ void __launch_bounds__(kThreads) violation_kernel(
    const ViolArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long red[kThreads / 32];
  const int g = blockIdx.x;
  const int64_t s = blockIdx.y;
  const ViolRow row = a.rows[g];
  const int64_t P = a.P, R = a.R, B1 = a.B1, T = a.T, B = B1 - 1;
  const Brokers br{at<float>(a.util, s),   at<int32_t>(a.cnt, s),
                   at<int32_t>(a.lead, s), at<float>(a.pot, s),
                   at<float>(a.lni, s),    at<float>(a.cap, s),
                   at<uint8_t>(a.bvalid, s), at<uint8_t>(a.balive, s)};
  const Layout l = layout(B1, T, a.staged != 0, a.windows != 0);
  float* t_lo = smem;
  float* t_up = smem + T;
  uint32_t* rack_bits = reinterpret_cast<uint32_t*>(smem + l.bits);
  float* scratch = smem + l.scratch;
  float* planes = l.planes >= 0 ? smem + l.planes : nullptr;
  float* windows = l.windows >= 0 ? smem + l.windows : nullptr;
  const int64_t* rb = at<int64_t>(a.rb, s);
  // a broker's rack (or set), staged in shared memory where it fits
  auto stage_ids = [&](const int32_t* ids) -> const int32_t* {
    if (planes == nullptr) return ids;
    int32_t* staged = reinterpret_cast<int32_t*>(planes);
    for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
      staged[b] = ids[b];
    }
    __syncthreads();
    return staged;
  };

  float viol = 0.0f, scale = 0.0f;
  long long count = 0;
  bool counted = false;
  switch (row.kind) {
    case kInterval:
    case kHardCap:
      interval_row(row, br, B1, scratch, planes, red, viol, scale);
      break;
    case kRackAware: {
      // replicas sharing a rack with a lower slot's, both valid
      const int32_t* rack = stage_ids(at<int32_t>(a.rack, s));
      if (R == 2 && reinterpret_cast<uintptr_t>(rb) % 16 == 0) {
        // RF 2 (the common layout): a partition's two slots in one load
        const longlong2* rows = reinterpret_cast<const longlong2*>(rb);
#pragma unroll 4
        for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
          const longlong2 x = rows[p];
          const int32_t k0 = rack[ordered::clamp_index(x.x, B1)];
          const int32_t k1 = rack[ordered::clamp_index(x.y, B1)];
          count += x.x < B && x.y < B && k0 == k1;
        }
        counted = true;
        break;
      }
#pragma unroll 4
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
        for (int64_t r = 1; r < R; ++r) {
          const int64_t br_r = rb[p * R + r];
          const int32_t k = rack[ordered::clamp_index(br_r, B1)];
          bool dup = false;
          for (int64_t q = 0; q < r; ++q) {
            const int64_t br_q = rb[p * R + q];
            dup = dup || (br_q < B
                          && rack[ordered::clamp_index(br_q, B1)] == k);
          }
          count += br_r < B && dup;
        }
      }
      counted = true;
      break;
    }
    case kRackSpread: {
      // the alive racks (ids clamped into [0, B1)), then each partition's
      // racks holding more of its replicas than ceil(RF / racks)
      const int32_t* rack_g = at<int32_t>(a.rack, s);
      const int32_t* rack = stage_ids(rack_g);
      for (int64_t w = threadIdx.x; w < (B1 + 31) / 32; w += blockDim.x) {
        rack_bits[w] = 0u;
      }
      __syncthreads();
      for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
        const int32_t k = rack[b];
        if (br.balive[b] && k >= 0) {
          const int64_t c = k < B1 ? k : B1 - 1;
          atomicOr(rack_bits + c / 32, 1u << (c % 32));
        }
      }
      __syncthreads();
      long long racks = 0;
      for (int64_t w = threadIdx.x; w < (B1 + 31) / 32; w += blockDim.x) {
        racks += __popc(rack_bits[w]);
      }
      racks = block_sum(racks, red);
      const float n_racks = static_cast<float>(racks < 1 ? 1 : racks);
#pragma unroll 2
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
        int64_t rf = 0;
        for (int64_t r = 0; r < R; ++r) rf += rb[p * R + r] < B;
        const int64_t limit = static_cast<int64_t>(
            ceilf(__fdiv_rn(static_cast<float>(rf), n_racks)));
        for (int64_t r = 0; r < R; ++r) {
          const int64_t br_r = rb[p * R + r];
          const int32_t k = rack[ordered::clamp_index(br_r, B1)];
          int64_t n = 0;
          bool first = true;
          for (int64_t q = 0; q < R; ++q) {
            const int64_t br_q = rb[p * R + q];
            const bool same = br_q < B
                              && rack[ordered::clamp_index(br_q, B1)] == k;
            n += same;
            first = first && !(same && q < r);
          }
          if (br_r < B && first && n > limit) count += n - limit;
        }
      }
      counted = true;
      break;
    }
    case kTopicReplica: {
      // the valid brokers' mask staged (one byte a broker), then a warp a
      // topic sums its valid cells: every load issued, then selected
      const int32_t* tc = at<int32_t>(a.tc, s);
      const uint8_t* valid = br.bvalid;
      long long alive = 0;
      if (planes != nullptr) {
        uint8_t* staged = reinterpret_cast<uint8_t*>(planes);
        for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
          staged[b] = br.bvalid[b];
          alive += br.balive[b] != 0;
        }
        valid = staged;
      } else {
        for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
          alive += br.balive[b] != 0;
        }
      }
      alive = block_sum(alive, red);
      const float n_alive = static_cast<float>(alive < 1 ? 1 : alive);
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int warps = blockDim.x >> 5;
      for (int64_t tp = warp; tp < T; tp += warps) {
        long long total = 0;
#pragma unroll 4
        for (int64_t b = lane; b < B1; b += 32) {
          const int32_t c = tc[tp * B1 + b];
          total += valid[b] ? c : 0;
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          total += __shfl_xor_sync(0xffffffffu, total, d);
        }
        if (lane == 0) {
          bounds::topic(total, n_alive, row.t, row.lower, row.hi, t_lo[tp],
                        t_up[tp]);
        }
      }
      __syncthreads();
      const uint8_t* balive = br.balive;
      auto cell = [=](int64_t tp, int64_t b) -> float {
        const float c = static_cast<float>(tc[tp * B1 + b]);
        const float pen = __fadd_rn(ordered::clamp0(__fsub_rn(c, t_up[tp])),
                                    ordered::clamp0(__fsub_rn(t_lo[tp], c)));
        return balive[b] ? pen : 0.0f;
      };
      if (row.sum == kMatrix) {
        viol = ordered::matrix_sum(cell, T, B1, scratch, windows);
      } else {
        // within 32 x 32: the cells staged by the block, then one thread's
        // fused loop over them
        const float* cells = windows;
        if (cells != nullptr) {
          for (int64_t i = threadIdx.x; i < T * B1; i += blockDim.x) {
            windows[i] = cell(i / B1, i % B1);
          }
          __syncthreads();
        }
        auto get = [=](int tp, int b) -> float {
          return cells != nullptr ? cells[tp * B1 + b] : cell(tp, b);
        };
        if (threadIdx.x == 0) {
          viol = row.sum == kRows
                     ? ordered::topic_rows_sum(get, static_cast<int>(T),
                                               static_cast<int>(B1), row.vf,
                                               row.ic, row.epi, row.tail)
                     : ordered::topic_lanes_sum(get, static_cast<int>(T),
                                                static_cast<int>(B1),
                                                row.vf);
        }
      }
      break;
    }
    case kTopicLeaders: {
      // each alive broker's missing leaders of each interested topic
      const int32_t* tlc = at<int32_t>(a.tlc, s);
      const uint8_t* interested = static_cast<const uint8_t*>(row.aux);
      for (int64_t i = threadIdx.x; i < T * B1; i += blockDim.x) {
        const int64_t tp = i / B1, b = i % B1;
        const long long d = static_cast<long long>(row.param) - tlc[i];
        const bool in = br.balive[b] && interested[tp];
        count += (in && d > 0) ? d : 0;
      }
      counted = true;
      break;
    }
    case kBrokerSet: {
      // replicas outside their topic's broker set
      const int32_t* bset = stage_ids(at<int32_t>(a.bset, s));
      const int32_t* ptopic = at<int32_t>(a.ptopic, s);
      const int32_t* sets = static_cast<const int32_t*>(row.aux);
#pragma unroll 4
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
        const int32_t want = sets[jax_index(ptopic[p], row.param)];
        for (int64_t r = 0; r < R; ++r) {
          const int64_t br_r = rb[p * R + r];
          const int32_t have = bset[ordered::clamp_index(br_r, B1)];
          count += br_r < B && want >= 0 && have >= 0 && have != want;
        }
      }
      counted = true;
      break;
    }
    case kPreferredLeader: {
      const uint8_t* pvalid = at<uint8_t>(a.pvalid, s);
      const int64_t* pos = at<int64_t>(a.pos, s);
      for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
        const bool valid = pvalid[p] != 0;
        const int64_t head = pos[p * R];
        count += valid && head != 0;
      }
      counted = true;
      break;
    }
    default:
      break;
  }
  if (counted) {
    viol = static_cast<float>(block_sum(count, red));
  }
  if (a.flag != nullptr) {
    // the pass's converged test: any replica offline, 16 bytes a load
    const uint8_t* off = at<uint8_t>(a.off, s);
    const int64_t n = P * R;
    const int64_t head = (16 - (reinterpret_cast<uintptr_t>(off) & 15)) & 15;
    const int64_t lead = head < n ? head : n;
    bool any = false;
    for (int64_t i = threadIdx.x; i < lead; i += blockDim.x) {
      any = any || off[i] != 0;
    }
    const uint4* vec = reinterpret_cast<const uint4*>(off + lead);
    const int64_t words = (n - lead) / 16;
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x) {
      const uint4 w = vec[i];
      any = any || (w.x | w.y | w.z | w.w) != 0u;
    }
    for (int64_t i = lead + words * 16 + threadIdx.x; i < n;
         i += blockDim.x) {
      any = any || off[i] != 0;
    }
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) *a.flag = (viol > a.eps) || any;
  }
  if (threadIdx.x == 0) {
    if (a.viol != nullptr) a.viol[s * a.n_rows + g] = viol;
    if (a.scale != nullptr) a.scale[s * a.n_rows + g] = scale;
  }
}

__global__ void __launch_bounds__(kPlanesThreads) interval_planes_kernel(
    const PlanesArgs a) {
  __shared__ float scratch[1024];
  __shared__ long long red[kPlanesThreads / 32];
  const ViolRow row = a.rows[0];
  const int64_t B1 = a.B1, W = (B1 + 3) / 4 * 4;
  const Brokers br{a.util, a.cnt, a.lead, a.pot, a.lni, a.cap, a.bvalid,
                   a.balive};
  View view;
  const float n_alive = stage_interval(row, br, B1, nullptr, red, view);
  const IntervalBounds ib =
      interval_bounds(row, view, n_alive, B1, scratch, nullptr);
  for (int64_t b = threadIdx.x; b < B1; b += blockDim.x) {
    const float v = view.value(b);
    const float lo = ib.lower(), up = ib.upper(view, b);
    const bool alive = view.alive(b);
    const float excess = ib.excess(view, v, b);
    const float deficit =
        (row.upper_only || !alive || !isfinite(lo))
            ? 0.0f
            : ordered::clamp0(__fsub_rn(lo, v));
    a.out[b] = v;
    a.out[W + b] = lo;
    a.out[2 * W + b] = up;
    a.out[3 * W + b] = excess;
    a.out[4 * W + b] = deficit;
  }
}

}  // namespace

extern "C" int cc_violation_rows(const ViolArgs* args, void* stream) {
  ViolArgs a = *args;
  if (a.n_rows < 1 || a.S < 1 || a.S > 65535 || a.B1 < 1 || a.P < 0
      || a.R < 1 || a.T < 0 || a.rows == nullptr
      || (a.viol == nullptr && a.flag == nullptr)
      || (a.flag != nullptr && (a.n_rows != 1 || a.S != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // stage what fits: the windows, then the broker planes
  bool windows = a.windows != 0, planes = true;
  while (layout(a.B1, a.T, planes, windows).total * 4 > kMaxShared
         && (planes || windows)) {
    if (windows) {
      windows = false;
    } else {
      planes = false;
    }
  }
  const int64_t bytes = layout(a.B1, a.T, planes, windows).total * 4;
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  a.windows = windows;
  a.staged = planes;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        violation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a.n_rows),
                  static_cast<unsigned>(a.S));
  violation_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_interval_planes(const PlanesArgs* args, void* stream) {
  const PlanesArgs a = *args;
  // the average's tree levels live in the block's 1,024 floats
  if (a.B1 < 1 || ordered::tree_scratch(a.B1) > 1024 || a.rows == nullptr
      || a.out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interval_planes_kernel<<<1, kPlanesThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the structs the host's ctypes structs must equal
extern "C" int64_t cc_viol_args_size() { return sizeof(ViolArgs); }
extern "C" int64_t cc_viol_row_size() { return sizeof(ViolRow); }
extern "C" int64_t cc_planes_args_size() { return sizeof(PlanesArgs); }
