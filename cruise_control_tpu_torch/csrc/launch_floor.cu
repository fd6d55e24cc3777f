// An empty kernel: one block of one warp that does nothing. It replaces no
// TPU program. Timed in the same CUDA-graph replay as the port's kernels,
// it gives the floor a launch costs on the card, which the kernels whose
// work takes less than a launch (KF, KG, KI at small shapes) are read
// against.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int cc_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
