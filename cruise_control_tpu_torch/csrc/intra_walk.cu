// KH: the intra-broker disk walk, every iteration in one launch.
//
// Each iteration, every broker b computes its disks' utilization util[d]
// (the sizes of the replicas on disk d, added in flat replica order), the
// mean over its live disks (valid, capacity > 0), the pressure of each
// disk (+inf for a draining disk that still holds data, util - mean for a
// live disk, -inf otherwise), src = the first disk of greatest pressure,
// dst = the first live disk of least utilization, gap = util[src] -
// util[dst], and moves its heaviest movable replica on src to dst — a
// replica fits when its size is at most gap * 0.5 or src drains, and a
// zero-size replica moves only off a draining disk; among equal sizes the
// lowest flat index wins. The walk stops when no broker moves or after
// max_iters iterations.
//
// Replaces cruise_control_tpu/analyzer/intra.py:optimize_intra_broker
// (:182-249), a lax.while_loop over the whole cluster.
//
// Logdir moves never leave their broker and every quantity above depends
// only on the broker's own replicas, so the brokers walk independently: a
// broker that makes no move sees the same inputs in the next iteration and
// never moves again. One warp per broker loops until it stops; broker b's
// moves m_b reproduce the reference's, and the reference's iteration count
// is min(max_iters, max_b m_b + 1), the max taken with atomicMax (an
// integer, so exact in any order).
//
// Bound on the card: the chain of dependent steps, not bytes. The design:
//
// - Per-disk lists. The broker's replicas are kept grouped by disk (one
//   segment a disk, seg[d]..seg[d+1]), each segment in flat-index order,
//   with each element's size, flat index and running prefix (the disk's
//   sum up to and including it). util[d] is the segment's last prefix.
//   XLA's scatter-add is a left fold in flat order, and a prefix is that
//   fold's partial, so resuming from the prefix before a changed position
//   gives the bits a fold from zero gives.
// - A move touches only src and dst: the element leaves src's segment and
//   enters dst's at its flat-order position (a warp-parallel shift of the
//   elements between), then src's and dst's prefixes are re-folded from
//   the changed position on, one lane each, concurrently.
// - The candidate scan covers src's segment only, a lane per 32nd element,
//   with a shuffle reduction. The mean sums its 32-disk windows a lane each
//   in XLA's tree order, and argmax/argmin are warp shuffles.
// - One warp a broker: no block barrier, only __syncwarp.
// - D comes from the launch; the per-disk arrays live in dynamic shared
//   memory. A broker's lists live in shared memory when they fit the
//   launch's allotment, else in a global scratch copy (decided per block;
//   the walk is inlined twice, so the shared copy compiles to shared
//   loads and stores).
//
// Every float operation is rounded on its own (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

// (value, index) extremes with the first one winning ties and NaN
// counting as extreme (jnp.argmax / jnp.argmin); index kNone is empty.
__device__ bool beats(float a, int ia, float b, int ib, bool want_max) {
  if (ia == kNone) return false;
  if (ib == kNone) return true;
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  if (a != b) return want_max ? a > b : a < b;
  return ia < ib;
}

// Re-fold one segment's prefixes from local position `from` on; returns
// the segment's sum (util). The adds are one dependent chain; the sizes
// come in blocks of kAhead, the next block's loads issued before this
// block's adds, so the chain waits on the adds alone.
constexpr int kAhead = 16;

__device__ __forceinline__ float refold(const float* sz, float* pre,
                                        int seg_lo, int seg_hi, int from) {
  int j = seg_lo + from;
  float acc = from == 0 ? 0.0f : pre[j - 1];
  float v[kAhead], next[kAhead];
#pragma unroll
  for (int e = 0; e < kAhead; ++e) v[e] = j + e < seg_hi ? sz[j + e] : 0.0f;
  for (; j + kAhead <= seg_hi; j += kAhead) {
#pragma unroll
    for (int e = 0; e < kAhead; ++e) {
      next[e] = j + kAhead + e < seg_hi ? sz[j + kAhead + e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kAhead; ++e) {
      acc = __fadd_rn(acc, v[e]);
      pre[j + e] = acc;
    }
#pragma unroll
    for (int e = 0; e < kAhead; ++e) v[e] = next[e];
  }
#pragma unroll
  for (int e = 0; e < kAhead; ++e) {
    if (j + e < seg_hi) {
      acc = __fadd_rn(acc, v[e]);
      pre[j + e] = acc;
    }
  }
  return acc;
}

// Both extremes of step 2 in one shuffle tree: (bp, ip) the first greatest
// pressure, (bu, iu) the first least utilization.
__device__ void warp_extremes(float& bp, int& ip, float& bu, int& iu) {
  for (int off = 16; off > 0; off /= 2) {
    const float op = __shfl_xor_sync(kFull, bp, off);
    const int oip = __shfl_xor_sync(kFull, ip, off);
    const float ou = __shfl_xor_sync(kFull, bu, off);
    const int oiu = __shfl_xor_sync(kFull, iu, off);
    if (beats(op, oip, bp, ip, true)) {
      bp = op;
      ip = oip;
    }
    if (beats(ou, oiu, bu, iu, false)) {
      bu = ou;
      iu = oiu;
    }
  }
}

// One broker's walk (the block's): builds its lists in sz/ix/pre, walks,
// writes its disks back to rd; returns its moves.
__device__ __forceinline__ int32_t walk(
    float* sz, int32_t* ix, float* pre, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ rows, const float* __restrict__ size,
    int32_t* __restrict__ rd, const float* __restrict__ capacity,
    const uint8_t* __restrict__ valid, int32_t D, int32_t max_iters,
    float* util, float* capv, float* win, int32_t* seg,
    int32_t* cnt, uint8_t* live) {
  const int W = (D + 31) / 32;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t start = offsets[b];
  const int n = static_cast<int>(offsets[b + 1] - start);
  // Disks, then the lists: count, scan, a stable placement by disk in
  // flat order, and each disk's prefixes folded from zero.
  for (int d = lane; d < D; d += 32) {
    const float c = capacity[static_cast<int64_t>(b) * D + d];
    const bool ok = valid[static_cast<int64_t>(b) * D + d] != 0;
    capv[d] = c;
    live[d] = static_cast<uint8_t>((ok ? 2 : 0) | (ok && c > 0.0f ? 1 : 0));
    cnt[d] = 0;
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int d = rd[rows[start + i]];
    if (d >= 0 && d < D) atomicAdd(&cnt[d], 1);
  }
  __syncwarp();
  if (lane == 0) {
    int run = 0;
    for (int d = 0; d < D; ++d) {
      seg[d] = run;
      run += cnt[d];
      cnt[d] = seg[d];                       // the placement cursor
    }
    seg[D] = run;
  }
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    int64_t flat = 0;
    int d = -1;
    if (i < n) {
      flat = rows[start + i];
      d = rd[flat];
      if (d >= D) d = -1;
    }
    const unsigned group = __match_any_sync(kFull, d);
    int pos = 0;
    if (d >= 0) pos = cnt[d] + __popc(group & below);
    __syncwarp();
    if (d >= 0) {
      sz[pos] = size[flat];
      ix[pos] = static_cast<int32_t>(flat);
      if ((group & below) == 0) cnt[d] += __popc(group);
    }
    __syncwarp();
  }
  for (int d = lane; d < D; d += 32) {
    util[d] = refold(sz, pre, seg[d], seg[d + 1], 0);
  }
  __syncwarp();

  int32_t moves = 0;
  const int front = (W * 32 - D) / 2;
  int n_live = 0;                            // the live disks never change
  for (int d = lane; d < D; d += 32) n_live += live[d] & 1;
  n_live = __reduce_add_sync(kFull, n_live);
  const float live_count = static_cast<float>(n_live > 1 ? n_live : 1);
  for (int32_t it = 0; it < max_iters; ++it) {
    // 1. The mean over the live disks in XLA's tree order: windows of 32
    //    (padding split evenly in front and behind) summed in order, a lane
    //    a window; more than 32 windows reduce the same way again (lane 0,
    //    in place); the last at most 32 sums add in order.
    for (int v = lane; v < W; v += 32) {
      float part = 0.0f;
      const int lo = max(v * 32 - front, 0);
      const int hi = min((v + 1) * 32 - front, D);
      for (int d = lo; d < hi; ++d) {
        part = __fadd_rn(part, (live[d] & 1) ? util[d] : 0.0f);
      }
      win[v] = part;
    }
    __syncwarp();
    float total = 0.0f;
    if (lane == 0) {
      int m = W;
      while (m > 32) {
        const int nw = (m + 31) / 32;
        const int fr = (nw * 32 - m) / 2;
        for (int v = 0; v < nw; ++v) {
          float part = 0.0f;
          const int hi = min((v + 1) * 32 - fr, m);
          for (int e = max(v * 32 - fr, 0); e < hi; ++e) {
            part = __fadd_rn(part, win[e]);
          }
          win[v] = part;
        }
        m = nw;
      }
      for (int v = 0; v < m; ++v) total = __fadd_rn(total, win[v]);
    }
    total = __shfl_sync(kFull, total, 0);
    const float avg = __fdiv_rn(total, live_count);

    // 2. src = argmax pressure, dst = argmin live utilization.
    float bp = 0.0f, bu = 0.0f;
    int ip = kNone, iu = kNone;
    for (int d = lane; d < D; d += 32) {
      const bool lv = live[d] & 1;
      const float u = util[d];
      const float p = ((live[d] & 2) && capv[d] <= 0.0f && u > 0.0f)
                          ? INFINITY
                          : (lv ? __fsub_rn(u, avg) : -INFINITY);
      const float q = lv ? u : INFINITY;
      if (beats(p, d, bp, ip, true)) {
        bp = p;
        ip = d;
      }
      if (beats(q, d, bu, iu, false)) {
        bu = q;
        iu = d;
      }
    }
    warp_extremes(bp, ip, bu, iu);
    const int src = ip;
    const int dst = iu;
    const float half = __fmul_rn(__fsub_rn(util[src], util[dst]), 0.5f);
    const bool drain = capv[src] <= 0.0f;

    // 3. The heaviest movable replica on src (lowest position on ties).
    const int s_lo = seg[src];
    const int s_hi = seg[src + 1];
    float best = -INFINITY;
    int at = kNone;
    bool poison = false;
    for (int j0 = s_lo + lane; j0 < s_hi; j0 += 128) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = j0 + 32 * e < s_hi ? sz[j0 + 32 * e] : -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a lane's positions rise, so a strictly greater size keeps the
        // first of equal ones; a movable NaN or +inf poisons the broker
        const float x = v[e];
        const bool movable = (x <= half || drain) && (x > 0.0f || drain) &&
                             x != -INFINITY;
        const bool bad = isnan(x) || x == INFINITY;
        poison |= movable && bad;
        if (movable && !bad && x > best) {
          best = x;
          at = j0 + 32 * e;
        }
      }
    }
    poison = __any_sync(kFull, poison);
    for (int off = 16; off > 0; off /= 2) {
      const float os = __shfl_xor_sync(kFull, best, off);
      const int oa = __shfl_xor_sync(kFull, at, off);
      if (os > best || (os == best && oa < at)) {
        best = os;
        at = oa;
      }
    }
    if (at == kNone || dst == src || poison) break;

    // 4. Move it: out of src's segment, into dst's at its flat position.
    const float m_sz = sz[at];
    const int32_t m_ix = ix[at];
    const int d_lo = seg[dst];
    const int d_hi = seg[dst + 1];
    int q = 0;
    for (int j0 = d_lo + lane; j0 < d_hi; j0 += 128) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q += j0 + 32 * e < d_hi && ix[j0 + 32 * e] < m_ix;
      }
    }
    q = __reduce_add_sync(kFull, q);
    const int gq = d_lo + q;
    int target;
    __syncwarp();
    if (src < dst) {
      // [at + 1, gq) shifts left by one, 64 elements a round upwards
      for (int base = at; base < gq - 1; base += 64) {
        float vs[2], vp[2];
        int32_t vi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = base + lane + 32 * e;
          if (j < gq - 1) {
            vs[e] = sz[j + 1];
            vi[e] = ix[j + 1];
            vp[e] = pre[j + 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = base + lane + 32 * e;
          if (j < gq - 1) {
            sz[j] = vs[e];
            ix[j] = vi[e];
            pre[j] = vp[e];
          }
        }
        __syncwarp();
      }
      target = gq - 1;
      for (int d = src + 1 + lane; d <= dst; d += 32) seg[d] -= 1;
    } else {
      // [gq, at) shifts right by one, 64 elements a round downwards
      for (int top = at; top > gq; top -= 64) {
        float vs[2], vp[2];
        int32_t vi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = top - 1 - lane - 32 * e;
          if (j >= gq) {
            vs[e] = sz[j];
            vi[e] = ix[j];
            vp[e] = pre[j];
          }
        }
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = top - 1 - lane - 32 * e;
          if (j >= gq) {
            sz[j + 1] = vs[e];
            ix[j + 1] = vi[e];
            pre[j + 1] = vp[e];
          }
        }
        __syncwarp();
      }
      target = gq;
      for (int d = dst + 1 + lane; d <= src; d += 32) seg[d] += 1;
    }
    if (lane == 0) {
      sz[target] = m_sz;
      ix[target] = m_ix;
    }
    __syncwarp();
    // 5. Re-fold src from the removed position, dst from the inserted one.
    if (lane < 2) {
      const int d = lane == 0 ? src : dst;
      const int from = lane == 0 ? at - s_lo : q;
      util[d] = refold(sz, pre, seg[d], seg[d + 1], from);
    }
    ++moves;
    __syncwarp();
  }

  for (int d = 0; d < D; ++d) {
    for (int j = seg[d] + lane; j < seg[d + 1]; j += 32) rd[ix[j]] = d;
  }
  return moves;
}

__global__ void intra_walk_kernel(
    const int64_t* __restrict__ offsets, const int64_t* __restrict__ rows,
    const float* __restrict__ size, int32_t* __restrict__ rd,
    const float* __restrict__ capacity, const uint8_t* __restrict__ valid,
    float* __restrict__ scratch_sz, int32_t* __restrict__ scratch_ix,
    float* __restrict__ scratch_pre, int32_t D, int32_t max_iters,
    int32_t list_capacity, int32_t* __restrict__ moves_out,
    int32_t* __restrict__ max_moves) {
  extern __shared__ float smem[];
  const int W = (D + 31) / 32;               // 32-disk windows
  float* util = smem;                        // [D]
  float* capv = util + D;                    // [D]
  float* win = capv + D;                     // [W]
  int32_t* seg = reinterpret_cast<int32_t*>(win + W);   // [D + 1]
  int32_t* cnt = seg + D + 1;                // [D]
  uint8_t* live = reinterpret_cast<uint8_t*>(cnt + D);  // [D]: 1 live, 2 ok
  float* lists = smem + 4 * D + W + 1 + ((D + 3) / 4);  // list arrays

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t start = offsets[b];
  const int n = static_cast<int>(offsets[b + 1] - start);
  // Two inlined copies of the walk: with the lists in shared memory the
  // compiler sees shared pointers (LDS/STS, no ordering against global
  // stores); a broker too large for them walks its global scratch copy.
  const int32_t moves =
      n <= list_capacity
          ? walk(lists, reinterpret_cast<int32_t*>(lists + list_capacity),
                 lists + 2 * list_capacity, offsets, rows, size, rd,
                 capacity, valid, D, max_iters, util, capv, win,
                 seg, cnt, live)
          : walk(scratch_sz + start, scratch_ix + start, scratch_pre + start,
                 offsets, rows, size, rd, capacity, valid, D, max_iters,
                 util, capv, win, seg, cnt, live);
  if (lane == 0) {
    moves_out[b] = moves;
    atomicMax(max_moves, moves);
  }
}

}  // namespace

// Bytes of a block's per-disk arrays (see the kernel's layout).
static size_t disk_bytes(int64_t D) {
  const int64_t W = (D + 31) / 32;
  return static_cast<size_t>(4 * D + W + 1 + (D + 3) / 4) * sizeof(float);
}

extern "C" int64_t cc_intra_broker_walk_shared(int64_t D, int64_t rows) {
  // The dynamic shared memory a launch asks for: the per-disk arrays and
  // lists for `rows` replicas, capped at the device's opt-in limit; -1
  // when the per-disk arrays alone do not fit.
  int device = 0;
  int optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const size_t fixed = disk_bytes(D);
  if (fixed > static_cast<size_t>(optin)) return -1;
  const size_t want = fixed + static_cast<size_t>(rows) * 12;
  return static_cast<int64_t>(want < static_cast<size_t>(optin)
                                  ? want
                                  : static_cast<size_t>(optin));
}

extern "C" int cc_intra_broker_walk(
    const void* offsets, const void* rows, const void* size, void* rd,
    const void* capacity, const void* valid, void* scratch_sz,
    void* scratch_ix, void* scratch_pre, int64_t B, int64_t D,
    int64_t max_iters, int64_t shared, void* moves_out,
    void* max_moves, void* stream) {
  const size_t fixed = disk_bytes(D);
  if (shared < static_cast<int64_t>(fixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t list_capacity =
      static_cast<int32_t>((static_cast<size_t>(shared) - fixed) / 12);
  // raised once to the largest size asked for (not again while a CUDA
  // graph captures the launch)
  static int64_t allowed = 48 * 1024;
  if (shared > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        intra_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = shared;
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  intra_walk_kernel<<<static_cast<unsigned>(B), 32,
                      static_cast<size_t>(shared),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(rows),
      static_cast<const float*>(size), static_cast<int32_t*>(rd),
      static_cast<const float*>(capacity),
      static_cast<const uint8_t*>(valid), static_cast<float*>(scratch_sz),
      static_cast<int32_t*>(scratch_ix), static_cast<float*>(scratch_pre),
      static_cast<int32_t>(D), static_cast<int32_t>(max_iters),
      list_capacity,
      static_cast<int32_t*>(moves_out), static_cast<int32_t*>(max_moves));
  return static_cast<int>(cudaGetLastError());
}
