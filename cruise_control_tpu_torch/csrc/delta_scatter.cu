// KF: a delta cycle's changed rows written into fresh copies of the
// resident load planes, out of place.
//
//   lead_out = lead, foll_out = foll, then for each payload row k < K with
//   0 <= idx[k] < P:  lead_out[idx[k], :] = lead_rows[k, :],
//                     foll_out[idx[k], :] = foll_rows[k, :].
// Rows whose index lies outside [0, P) are dropped, as the reference's
// `.at[idx].set(rows, mode="drop")` drops its padding rows (index P). The
// input planes are never written: a model served earlier keeps its loads.
//
// Replaces cruise_control_tpu/model/resident.py:_delta_scatter (:75-81),
// the jitted delta-ingest program (:141) that the resident state runs on
// every metric-only monitor cycle and on every replicated delta. Its output
// buffers are fresh, so XLA writes the copy and the rows in one program;
// this kernel does the same in one launch.
//
// The payload is one buffer of 4-byte words, uploaded in one copy:
// lead_rows [K, C] float32, foll_rows [K, C] float32, then idx [K] int32,
// sorted ascending by the host packer (kernels.pack_delta_rows). Rows come
// first, so at C = 4 each row is one aligned 16-byte word.
//
// A block owns a tile of 256 plane rows: it copies them into both outputs
// (one 16-byte load and store per row per plane at C = 4, a scalar loop for
// any other C), finds its payload entries by a search of the sorted idx
// that the whole block runs (a step a dependent load, 256 probes at once:
// two steps up to 65,536 entries), and after a barrier writes them over
// its copy. Indices outside [0, P) fall in no tile.
//
// Bound on the card: bytes (both planes read and written once, the
// payload read once): 1.3 MB at 20K partitions, 0.4 us at 3.35 TB/s, below
// a launch's cost.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 256;

// Payload positions [begin, end) of the rows in [t0, t1): the entries of
// the sorted idx below t0 and below t1, counted by a search of the whole
// block in lockstep. Each step, every thread probes one entry of each
// range (evenly spaced), and a block count of the probes below the bound
// narrows the range to one gap between probes: two dependent loads find a
// bound among 65,536 entries, where a binary search takes 16.
__device__ void block_bounds(const int32_t* idx, int64_t K, int64_t t0,
                             int64_t t1, int64_t& begin, int64_t& end) {
  int64_t lo[2] = {0, 0}, hi[2] = {K, K};
  const int64_t bound[2] = {t0, t1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {   // the same in every thread
    int64_t stride[2];
    int below[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      stride[b] = (hi[b] - lo[b] + kTileRows - 1) / kTileRows;
      const int64_t k = lo[b] + threadIdx.x * stride[b];
      below[b] = lo[b] < hi[b] && k < hi[b] && idx[k] < bound[b];
    }
    const int64_t count[2] = {__syncthreads_count(below[0]),
                              __syncthreads_count(below[1])};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (lo[b] >= hi[b]) continue;
      if (stride[b] == 1 || count[b] == 0) {
        // the probes below the bound are a prefix: the bound's position
        // is the first probe not below it
        lo[b] += count[b] * stride[b];
        hi[b] = lo[b];
      } else {
        const int64_t last_below = lo[b] + (count[b] - 1) * stride[b];
        const int64_t first_not = last_below + stride[b];
        lo[b] = last_below + 1;
        if (first_not < hi[b]) hi[b] = first_not;
      }
    }
  }
  begin = lo[0];
  end = lo[1];
}

template <bool kRow16>
__global__ void __launch_bounds__(kTileRows)
    delta_row_scatter_kernel(const float* __restrict__ lead,
                             const float* __restrict__ foll,
                             const float* __restrict__ payload,
                             float* __restrict__ lead_out,
                             float* __restrict__ foll_out, int64_t num_rows,
                             int64_t num_cols, int64_t num_partitions) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t t1 = t0 + kTileRows < num_partitions ? t0 + kTileRows
                                                     : num_partitions;
  const int64_t K = num_rows;
  const float* lead_rows = payload;
  const float* foll_rows = payload + K * num_cols;
  const int32_t* idx =
      reinterpret_cast<const int32_t*>(payload + 2 * K * num_cols);
  int64_t begin, end;
  if (kRow16) {
    // the tile's rows are loaded before the search and stored after it,
    // so the two round trips overlap
    const int64_t r = t0 + threadIdx.x;
    float4 l, f;
    if (r < t1) {
      l = reinterpret_cast<const float4*>(lead)[r];
      f = reinterpret_cast<const float4*>(foll)[r];
    }
    block_bounds(idx, K, t0, t1, begin, end);
    if (r < t1) {
      reinterpret_cast<float4*>(lead_out)[r] = l;
      reinterpret_cast<float4*>(foll_out)[r] = f;
    }
  } else {
    for (int64_t e = t0 * num_cols + threadIdx.x; e < t1 * num_cols;
         e += kTileRows) {
      lead_out[e] = lead[e];
      foll_out[e] = foll[e];
    }
    block_bounds(idx, K, t0, t1, begin, end);
  }
  __syncthreads();            // the copy lands before the rows over it
  for (int64_t k = begin + threadIdx.x; k < end; k += kTileRows) {
    const int64_t r = idx[k];
    if (kRow16) {
      reinterpret_cast<float4*>(lead_out)[r] =
          reinterpret_cast<const float4*>(lead_rows)[k];
      reinterpret_cast<float4*>(foll_out)[r] =
          reinterpret_cast<const float4*>(foll_rows)[k];
    } else {
      for (int64_t c = 0; c < num_cols; ++c) {
        lead_out[r * num_cols + c] = lead_rows[k * num_cols + c];
        foll_out[r * num_cols + c] = foll_rows[k * num_cols + c];
      }
    }
  }
}

}  // namespace

extern "C" int cc_delta_row_scatter(const void* lead, const void* foll,
                                    const void* payload, void* lead_out,
                                    void* foll_out, int64_t num_rows,
                                    int64_t num_cols, int64_t num_partitions,
                                    int row16, void* stream) {
  if (num_partitions > 0) {
    const int64_t blocks = (num_partitions + kTileRows - 1) / kTileRows;
    const auto kernel = row16 ? delta_row_scatter_kernel<true>
                              : delta_row_scatter_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), kTileRows, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lead), static_cast<const float*>(foll),
        static_cast<const float*>(payload), static_cast<float*>(lead_out),
        static_cast<float*>(foll_out), num_rows, num_cols, num_partitions);
  }
  return static_cast<int>(cudaGetLastError());
}
