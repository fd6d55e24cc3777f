// KF: delta row scatter into the resident load planes.
//
// For each changed partition row k < K with 0 <= idx[k] < P:
//   lead[idx[k], c] = lead_rows[k, c]
//   foll[idx[k], c] = foll_rows[k, c]        for every column c < C,
// written in place. Rows whose index lies outside [0, P) are dropped, as
// the reference's `.at[idx].set(rows, mode="drop")` drops its padding rows
// (index P). The reference's indices are unique, so no two threads write
// one cell and the result does not depend on thread order.
//
// Replaces cruise_control_tpu/model/resident.py:_delta_scatter (:75-81),
// the jitted delta-ingest program (:141) that the resident state runs on
// every metric-only monitor cycle and on every replicated delta.
//
// One thread per (row, column) writes that cell of both planes. The
// payload holds exactly the changed rows: a kernel takes any K, so the
// reference's power-of-two row buckets (there only to bound XLA's
// compiled variants) are gone.
//
// Bound on the card: bytes (K indices and 2 K C floats read, 2 K C floats
// written). At a few hundred rows the launch costs far more than the
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void delta_row_scatter_kernel(float* __restrict__ lead,
                                         float* __restrict__ foll,
                                         const int32_t* __restrict__ idx,
                                         const float* __restrict__ lead_rows,
                                         const float* __restrict__ foll_rows,
                                         int64_t num_rows, int64_t num_cols,
                                         int64_t num_partitions) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (t >= num_rows * num_cols) return;
  const int64_t k = t / num_cols;
  const int64_t c = t - k * num_cols;
  const int64_t row = idx[k];
  if (row < 0 || row >= num_partitions) return;
  lead[row * num_cols + c] = lead_rows[t];
  foll[row * num_cols + c] = foll_rows[t];
}

}  // namespace

extern "C" int cc_delta_row_scatter(void* lead, void* foll, const void* idx,
                                    const void* lead_rows,
                                    const void* foll_rows, int64_t num_rows,
                                    int64_t num_cols, int64_t num_partitions,
                                    void* stream) {
  const int64_t cells = num_rows * num_cols;
  if (cells > 0) {
    const int threads = 128;
    const int64_t blocks = (cells + threads - 1) / threads;
    delta_row_scatter_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(lead), static_cast<float*>(foll),
        static_cast<const int32_t*>(idx),
        static_cast<const float*>(lead_rows),
        static_cast<const float*>(foll_rows), num_rows, num_cols,
        num_partitions);
  }
  return static_cast<int>(cudaGetLastError());
}
