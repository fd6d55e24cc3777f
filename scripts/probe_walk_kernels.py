"""Time the two walk kernels on the card at the smoke's shapes, each held
to its twin first, with the time a dependent step:

- KE (``kernels.first_fit``) at phase 8's two schedules (the seed-1
  proposals of the main path, without and with the 300 MB budget), and at
  a frontier near K = 1,024;
- KH (``kernels.intra_broker_walk``) at phase 11's disk state: iteration
  count and time an iteration;
- the chain bound of each walk: its dependent steps times the card's
  latency of one dependent shared-memory load (the state a step reads was
  written by the step before), measured here by a pointer chase through
  shared memory (one thread, 1,024 loads in a row; a small kernel built
  with nvcc into ``build/``). KE's steps are its valid moves; KH's are 4 an
  iteration (the mean, the extremes, the candidate and the move each wait
  on the last).

Each time is a CUDA graph of the launches replayed between two events
(``chip_smoke.time_ms``). Run from the repository root on a machine with
one CUDA card:

    python3 scripts/probe_walk_kernels.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


CHASE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void chase(int32_t start, int32_t steps, int64_t* out,
                      int32_t* sink) {
  __shared__ int32_t next[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    next[i] = (i * 37 + 11) & 1023;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t at = start;
  uint64_t g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const int64_t t0 = clock64();
  for (int32_t s = 0; s < steps; ++s) at = next[at];
  const int64_t t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = t1 - t0;
  out[1] = static_cast<int64_t>(g1 - g0);
  sink[0] = at;
}
extern "C" int run_chase(int32_t steps, void* out, void* sink) {
  chase<<<1, 32>>>(0, steps, static_cast<int64_t*>(out),
                   static_cast<int32_t*>(sink));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def shared_load_ns():
    """ns of one dependent shared-memory load on this card: a pointer
    chase of 65,536 loads through 1,024 shared words, timed by the SM's
    cycle counter and the global nanosecond timer."""
    import torch
    from cruise_control_tpu_torch import kernels
    build = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "chase.cu")
    lib = os.path.join(build, "libchase.so")
    with open(src, "w") as f:
        f.write(CHASE)
    subprocess.run([kernels._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    chase = ctypes.CDLL(lib)
    chase.run_chase.argtypes = [ctypes.c_int32, ctypes.c_void_p,
                                ctypes.c_void_p]
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    steps = 65_536
    best = None
    for _ in range(3):
        if chase.run_chase(steps, out.data_ptr(), sink.data_ptr()):
            raise RuntimeError("the pointer chase failed to run")
        cyc, ns = (int(x) for x in out.cpu())
        if best is None or ns < best[1]:
            best = (cyc, ns)
    cyc, ns = best[0] / steps, best[1] / steps
    print(f"dependent shared-memory load: {cyc:.1f} cycles, {ns:.2f} ns "
          f"({cyc / ns:.3f} GHz)", flush=True)
    return ns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_walk_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import build_disk_state
    from cruise_control_tpu_torch.executor import (
        ConcurrencyConfig, DeviceMoveScheduler, ExecutionConcurrencyManager)
    from cruise_control_tpu_torch.executor.schedule import first_fit_inputs
    from cruise_control_tpu_torch.model.spec import flatten_spec
    cs.phase_environment()
    cs.phase_build()
    load_ns = shared_load_ns()
    spec = cs.build_spec()
    model, md = flatten_spec(spec, device="cuda")
    res, _wall, _syncs = cs._optimize(cs.main_path_optimizer(), model, md, 1)
    proposals = res.proposals
    ctx = cs.schedule_context(model, md, proposals)
    order = DeviceMoveScheduler(device="cuda")._strategy_order(
        proposals, None, ctx)
    for tag, bandwidth, _throttle in cs.SCHEDULE_RUNS:
        inp = first_fit_inputs(order, proposals, ExecutionConcurrencyManager(
            ConcurrencyConfig()), md, ctx, bandwidth)
        tensors = [torch.from_numpy(inp[k]).cuda()
                   for k in ("rows", "dest_rows", "size_mb", "valid",
                             "caps")]
        extra = (inp["cluster_cap"], inp["budget"], inp["num_batches"])
        want = kernels.first_fit_plain(*tensors, *extra)
        n = int(inp["valid"].sum())
        a = want.cpu().numpy()
        print(f"KE {tag}: M={len(a)} valid {n} K={extra[2]} frontier "
              f"{int(a[a < extra[2]].max(initial=-1)) + 1}; chain bound "
              f"{n * load_ns * 1e-6:.4f} ms ({n} steps)", flush=True)
        if not torch.equal(kernels.first_fit(*tensors, *extra), want):
            raise RuntimeError(f"KE differs from its twin ({tag})")
        ms = cs.time_ms(lambda: kernels.first_fit(*tensors, *extra),
                        graph=True)
        print(f"  {ms:.4f} ms, {ms * 1e3 / n:.3f} us a move", flush=True)
    gen = np.random.default_rng(1024)
    Mk, K, B1, W = 1030, 1024, 101, 4
    rk = gen.integers(0, B1 - 1, (Mk, W)).astype(np.int32)
    rk[:, 0] = 0
    dk = np.where(gen.random((Mk, W)) < 0.5, rk, B1 - 1).astype(np.int32)
    caps = np.full(B1, 1 << 20, np.int32)
    caps[0] = 1
    caps[B1 - 1] = 1 << 30
    tensors = [torch.from_numpy(x).cuda() for x in (
        rk, dk, (gen.random(Mk) * 500).astype(np.float32),
        np.ones(Mk, bool), caps)]
    want = kernels.first_fit_plain(*tensors, 1 << 20, 300.0, K)
    print(f"KE frontier near K: M={Mk} K={K}", flush=True)
    if not torch.equal(kernels.first_fit(*tensors, 1 << 20, 300.0, K), want):
        raise RuntimeError("KE differs from its twin (near K)")
    ms = cs.time_ms(lambda: kernels.first_fit(*tensors, 1 << 20, 300.0, K),
                    graph=True)
    print(f"  {ms:.4f} ms, {ms * 1e3 / Mk:.3f} us a move "
          f"({kernels.first_fit_shared_slots(W, K, B1)} slots in shared "
          f"memory)", flush=True)

    state, _ = build_disk_state(*cs.intra_setup(cs.port_search_package(),
                                                spec))
    args = (state.replica_disk, state.replica_size, state.replica_broker,
            state.disk_capacity, state.disk_valid)
    rd, it = kernels.intra_broker_walk(*args, 512)
    want_rd, want_it = kernels.intra_broker_walk_plain(*args, 512)
    if not torch.equal(rd, want_rd) or int(it) != int(want_it):
        raise RuntimeError("KH differs from its twin at phase 11's shape")
    print(f"KH phase 11: {int(it)} iterations; chain bound "
          f"{int(it) * 4 * load_ns * 1e-6:.4f} ms ({int(it) * 4} steps)",
          flush=True)
    ms = cs.time_ms(lambda: kernels.intra_broker_walk(*args, 512), graph=True)
    print(f"  {ms:.4f} ms, {ms * 1e3 / int(it):.2f} us an iteration",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
