// An empty kernel: one block of one warp that does nothing. It replaces no
// TPU program. Timed in the same CUDA-graph replay as the port's kernels,
// it gives the floor a launch costs on the card, which the kernels whose
// work takes less than a launch (KF, KG, KI at small shapes) are read
// against.
//
// Beside it, the dependent-add probe, which replaces no TPU program
// either: n float32 adds, each on the result of the one before, the floor
// of a chain that must add in a fixed order (KB's per-broker sums in KM
// and KP). Form 0: one thread, from registers; form 1: one thread, one
// load a step (x[i], independent of the sum).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void dependent_add_kernel(const float* x, int64_t n, int form,
                                     float* out) {
  float acc = 0.0f;
  if (form == 0) {
    const float v = x[0];
    for (int64_t i = 0; i < n; ++i) acc = __fadd_rn(acc, v);
  } else {
    for (int64_t i = 0; i < n; ++i) acc = __fadd_rn(acc, x[i]);
  }
  out[0] = acc;
}

}  // namespace

extern "C" int cc_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The probe on ``stream``: ``x`` holds n floats for form 1, one for form 0.
extern "C" int cc_dependent_add(const float* x, int64_t n, int form,
                                float* out, void* stream) {
  if (n < 0 || form < 0 || form > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dependent_add_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, form, out);
  return static_cast<int>(cudaGetLastError());
}
