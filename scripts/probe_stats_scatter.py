#!/usr/bin/env python3
"""Time design variants of KG (``csrc/cluster_stats.cu``) and KF
(``csrc/delta_scatter.cu``) against the kept kernels on one CUDA card,
beside an empty kernel (a launch's floor).

Each variant is the kept source with a few lines replaced (``VARIANTS``
below), compiled by ``nvcc`` into a library of its own (all at once, as
``scripts/probe_draw_failover.py`` does) and called through the same C
entry as the kept kernel, timed by replaying a CUDA graph of 200 launches
between two events. A variant marked "timing only" computes less than the
kernel (its output is not compared); every other variant's output must
equal the twin's bit for bit. Shapes:

- KG at the main path's brokers (104, counts over 20,096 x 2 replica
  slots), the scale cell's (1,000 brokers, 200,064 x 2) and 20,000 random
  brokers over the main path's masks; the kept kernel also with both mask
  counts skipped (zero-length masks: timing only), and with clock64()
  stamps at its phase boundaries (cycles from its start, block 0's thread
  0);
- KF at phase 3's shape, 200 payload rows (one dropped) into fresh
  [20,096, 4] planes, and with a row for every partition.

Prints the card's name and power limit, then one line a variant:

    python3 scripts/probe_stats_scatter.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from probe_draw_failover import build, graph_ms  # noqa: E402

#: the kept KG with thread 0 writing clock64() at its phase boundaries
#: into the scratch pointer (unused while the levels fit in shared memory)
STAMPED = "KG with clock stamps (timing only)"
#: stamp index -> the point of the kernel it marks (pass 0: 0-6, pass 1:
#: 12-16, the end: 30)
STAMPS = {0: "start", 1: "set up", 2: "staged", 3: "level 1",
          4: "barrier", 5: "max/min", 6: "upper levels", 12: "pass 1 staged",
          13: "pass 1 level 1", 14: "pass 1 barrier", 15: "pass 1 max/min",
          16: "pass 1 upper levels", 29: "statistics", 30: "counts (end)"}
#: a binary search by one thread (KF's first search)
LOWER_BOUND = """
__device__ int64_t lower_bound(const int32_t* idx, int64_t n, int64_t value) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (idx[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

"""
#: name -> (source, [(kept text, variant text), ...])
VARIANTS = {
    "KG kept": ("cluster_stats.cu", []),
    "KG 512 threads": ("cluster_stats.cu", [(
        "constexpr int kThreads = 1024;", "constexpr int kThreads = 512;")]),
    "KG windows unrolled by 4": ("cluster_stats.cu", [(
        "constexpr int kWindowUnroll = 32;",
        "constexpr int kWindowUnroll = 4;")]),
    "KG eight mask loads in flight": ("cluster_stats.cu", [(
        "  constexpr int kInFlight = 4;", "  constexpr int kInFlight = 8;")]),
    "KG the first pass alone (timing only)": ("cluster_stats.cu", [(
        "for (int pass = 0; pass < 2; ++pass) {",
        "for (int pass = 0; pass < 1; ++pass) {")]),
    STAMPED: ("cluster_stats.cu", [
        ("  const int warp = threadIdx.x / kWindow;\n",
         "  const int warp = threadIdx.x / kWindow;\n"
         "  long long* stamps = reinterpret_cast<long long*>(a.scratch);\n"
         "#define STAMP(i) \\\n"
         "  if (threadIdx.x == 0 && blockIdx.x == 0) stamps[i] = clock64();\n"
         "  STAMP(0)\n"),
        ("  const int64_t chunks =\n",
         "  STAMP(1)\n  const int64_t chunks =\n"),
        ("        stage(a, sv, sm, w0, cw);\n        __syncthreads();\n      }\n",
         "        stage(a, sv, sm, w0, cw);\n        __syncthreads();\n      }\n"
         "      STAMP(pass * 10 + 2)\n"),
        ("    __syncthreads();\n    if (pass == 0 && warp >= 1",
         "    STAMP(pass * 10 + 3)\n    __syncthreads();\n"
         "    STAMP(pass * 10 + 4)\n    if (pass == 0 && warp >= 1"),
        ("    reduce_levels(level_a,", "    STAMP(pass * 10 + 5)\n"
         "    reduce_levels(level_a,"),
        ("                  plan.windows, total);\n",
         "                  plan.windows, total);\n    STAMP(pass * 10 + 6)\n"),
        ("  // the counting blocks' totals, waited for last",
         "  STAMP(29)\n  // the counting blocks' totals, waited for last"),
        ("        static_cast<int32_t>(slots);\n  }\n}\n",
         "        static_cast<int32_t>(slots);\n  }\n  STAMP(30)\n}\n")]),
    "KF kept": ("delta_scatter.cu", []),
    "KF two threads' binary search": ("delta_scatter.cu", [
        ("template <bool kRow16>\n", LOWER_BOUND + "template <bool kRow16>\n"),
        ("block_bounds(idx, K, t0, t1, begin, end);",
         "__shared__ int64_t entries[2];\n"
         "    if (threadIdx.x < 2) {\n"
         "      entries[threadIdx.x] =\n"
         "          lower_bound(idx, K, threadIdx.x == 0 ? t0 : t1);\n"
         "    }\n"
         "    __syncthreads();\n"
         "    begin = entries[0];\n"
         "    end = entries[1];")]),
    "KF tiles of 64 rows": ("delta_scatter.cu", [(
        "constexpr int kTileRows = 256;", "constexpr int kTileRows = 64;")]),
    "KF tiles of 128 rows": ("delta_scatter.cu", [(
        "constexpr int kTileRows = 256;", "constexpr int kTileRows = 128;")]),
    "KF tiles of 512 rows": ("delta_scatter.cu", [(
        "constexpr int kTileRows = 256;", "constexpr int kTileRows = 512;")]),
}


def kg_call(lib, args, out, skip_counts=False, scratch=None):
    """One ``cc_cluster_stats`` launch of ``lib`` over KG's inputs
    (``scratch``: the buffer passed as its scratch pointer)."""
    import torch
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cc_cluster_stats.argtypes = [p, p, p, p, p, p, i64, p, i64, p, p,
                                     i64, p]
    lib.cc_cluster_stats.restype = ctypes.c_int
    lib.cc_cluster_stats_scratch.argtypes = [i64]
    lib.cc_cluster_stats_scratch.restype = i64
    util, replicas, leaders, potential, alive, rvalid, pvalid = args
    B = alive.shape[0]
    nbytes = lib.cc_cluster_stats_scratch(B)
    if scratch is None and nbytes:
        scratch = torch.empty(nbytes // 4, dtype=torch.float32,
                              device=util.device)

    def call():
        rc = lib.cc_cluster_stats(
            util.data_ptr(), replicas.data_ptr(), leaders.data_ptr(),
            potential.data_ptr(), alive.data_ptr(), rvalid.data_ptr(),
            0 if skip_counts else rvalid.numel(), pvalid.data_ptr(),
            0 if skip_counts else pvalid.numel(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
    return call


def kf_call(lib, lead, foll, payload, outs):
    import torch
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cc_delta_row_scatter.argtypes = [p, p, p, p, p, i64, i64, i64,
                                         ctypes.c_int, p]
    lib.cc_delta_row_scatter.restype = ctypes.c_int
    P, C = lead.shape

    def call():
        rc = lib.cc_delta_row_scatter(
            lead.data_ptr(), foll.data_ptr(), payload.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(),
            payload.numel() // (2 * C + 1), C, P, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
    return call


def kg_shapes(model, dev):
    """(tag, KG's inputs on the card) at the three shapes."""
    import torch
    import chip_smoke
    scale, _ = chip_smoke.build_flat_direct(1000, 200_000, 2, seed=42)
    rng = np.random.default_rng(0)
    B = 20_000

    def put(a):
        return torch.from_numpy(a).to(dev)
    wide = (put((rng.random((B, 4)) * [100.0, 1e4, 1e4, 1e6])
                .astype(np.float32)),
            put(rng.integers(0, 500, B).astype(np.int32)),
            put(rng.integers(0, 250, B).astype(np.int32)),
            put((rng.random(B) * 1e4).astype(np.float32)),
            put(rng.random(B) < 0.9), model.replica_valid,
            model.partition_valid)
    return (("main path", chip_smoke._kg_inputs(model)),
            ("scale cell", chip_smoke._kg_inputs(scale)),
            ("20,000 brokers", wide))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_stats_scatter: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from cruise_control_tpu_torch import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="variants-", dir=kernels.BUILD_DIR)
    try:
        libs = build(tmp, VARIANTS)
        print(f"launch floor (an empty kernel): "
              f"{graph_ms(kernels.empty_launch, 200):.5f} ms", flush=True)
        from cruise_control_tpu_torch.model.spec import flatten_spec
        model, _ = flatten_spec(chip_smoke.build_spec(), device=dev)
        shapes = kg_shapes(model, dev)
        twins = [kernels.cluster_stats_plain(*(t.cpu() for t in args))
                 for _tag, args in shapes]
        lead, foll = model.leader_load, model.follower_load
        rng = np.random.default_rng(1)
        P, C = lead.shape
        payloads = []
        for K in (chip_smoke.SERVED_CHURN_ROWS, P):
            idx = np.concatenate([rng.choice(P, K - 1, replace=False),
                                  [P]]).astype(np.int32)
            payload = torch.from_numpy(kernels.pack_delta_rows(
                idx, rng.random((K, C)).astype(np.float32),
                rng.random((K, C)).astype(np.float32))).to(dev)
            payloads.append((K, payload, kernels.delta_row_scatter_plain(
                lead, foll, payload)))
        names = list(VARIANTS) + ["KG kept", "KF kept"]
        for name in names:
            lib = libs[name]
            line = [name + ":"]
            if name.startswith("KG"):
                runs = [(tag, args, twin, False)
                        for (tag, args), twin in zip(shapes, twins)]
                if name == "KG kept":
                    runs += [(tag + ", counts skipped", args, None, True)
                             for tag, args in shapes]
                for tag, args, twin, skip in runs:
                    out = torch.empty(31, dtype=torch.float32, device=dev)
                    call = kg_call(lib, args, out, skip)
                    if name == STAMPED:
                        stamps = torch.zeros(32, dtype=torch.int64,
                                             device=dev)
                        call = kg_call(lib, args, out, skip, stamps)
                        call()
                        call()
                        torch.cuda.synchronize()
                        t = stamps.cpu().tolist()
                        line.append(f"{tag}: " + ", ".join(
                            f"{STAMPS[i]} +{t[i] - t[0]}" for i in STAMPS
                            if t[i]) + " cycles;")
                        continue
                    call()
                    check = ("" if twin is None or "timing only" in name
                             else " (equal to the twin)"
                             if torch.equal(out.cpu(), twin)
                             else " (DIFFERS from the twin)")
                    line.append(f"{tag} {graph_ms(call, 200):.5f} ms{check}")
            else:
                for K, payload, twin in payloads:
                    outs = (torch.empty_like(lead), torch.empty_like(foll))
                    call = kf_call(lib, lead, foll, payload, outs)
                    call()
                    same = all(torch.equal(o, w) for o, w in zip(outs, twin))
                    line.append(f"K {K} into [{P}, {C}] x2 "
                                f"{graph_ms(call, 200):.5f} ms "
                                f"({'equal to' if same else 'DIFFERS from'} "
                                f"the twin)")
            print(" ".join(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
