"""Where KQ's time goes inside one launch, on the card: each warp's
``%globaltimer`` stamps at its start, after the first chunk's staging
barrier, after its walk and after its verdicts, with its count of matched
(column, kind) pairs, at ``chip_smoke.KQ_SHAPES``' real apply rounds.

The stamps are not in the kernel the package builds: this script copies
``csrc/`` into ``build/kq_stamps/`` (git-ignored), writes the stamps into
that copy of ``round_guards.cu`` (each insertion anchored on a line of the
source; a missing anchor stops the script), builds the copy by pointing
``kernels.CSRC`` and ``kernels.BUILD_DIR`` at it, and runs each round once
after timing it (``chip_smoke.time_ms``) with the unstamped form's
arguments. It prints, per shape, the kernel's span, the staging, walk and
verdict times (median and maximum over the eligible rows), the walk's ns
a matched pair, and the slowest rows. Run from the repository root on a
machine with one CUDA card:

    python3 scripts/probe_round_guards.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: (anchor line of round_guards.cu, text inserted after it)
STAMPS = (
    ("namespace {\n\n__device__ __forceinline__ float metric_value(",
     None),
    ("  const int warp = threadIdx.x >> 5;\n",
     "  unsigned long long* st = g_stamps + (blockIdx.x * 8 + warp) * 8;\n"
     "  unsigned long long t_first = 0, n_match = 0;\n"
     "  if (lane == 0) st[0] = gtime();\n"),
    ("    if (!elig_i) continue;             // whole warps; no block sync "
     "inside\n",
     None),
    ("      shared_broker |= (m_ss | m_dd) != 0;\n",
     "      n_match += __popc(m_dd) + __popc(m_ds) + __popc(m_ss)"
     " + __popc(m_sd);\n"),
    ("  bool do_i = false;\n",
     "  if (lane == 0) { st[1] = t_first; st[2] = gtime(); st[5] = n_match;"
     " st[6] = elig_i; }\n"),
    ("    do_i = !blocked && __all_sync(kFull, ok);\n  }\n",
     "  if (lane == 0) st[3] = gtime();\n"),
)
PREAMBLE = """__device__ unsigned long long g_stamps[8192 * 8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int cc_kq_stamps(void* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, n * 8);
}

"""


def stamped_source(src: str) -> str:
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"round_guards.cu: anchor not found once: "
                             f"{anchor!r}")
        if anchor.startswith("namespace {\n\n__device__"):
            src = src.replace(anchor, PREAMBLE + anchor)
        elif anchor.startswith("    if (!elig_i) continue;"):
            src = src.replace(anchor, "    if (lane == 0 && t_first == 0) "
                              "t_first = gtime();\n" + anchor)
        else:
            src = src.replace(anchor, anchor + text)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_round_guards: CUDA is not available", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import default_goals, goals_by_name
    work = ROOT / "build" / "kq_stamps"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kernels.CSRC, work / "csrc")
    rg = work / "csrc" / "round_guards.cu"
    rg.write_text(stamped_source(rg.read_text()))
    kernels.CSRC, kernels.BUILD_DIR = work / "csrc", work / "lib"
    lib = kernels.load_library()
    lib.cc_kq_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    print(cs.phase_environment())
    models = {"main": cs.build_flat_direct(100, 20_000, 2),
              "scale": cs.build_flat_direct(1000, 200_000, 2)}
    for shape, (m, md) in models.items():
        state, ctx = cs.pass_state(m, md, dead=(3,))
        chains = {"main": goals_by_name(cs.GOALS),
                  "default": [g.bind(md) for g in default_goals()]}
        for chain, pos, search, q in cs.KQ_SHAPES[shape]:
            seg, c, ce, pend, elig, bounds = cs.kq_round(
                state, ctx, chains[chain], pos, search, q)
            args = (state, ctx, c, ce, pend, elig, seg.guards, bounds)
            ms = cs.time_ms(lambda: kernels.round_guards(*args), graph=True)
            kernels.round_guards(*args)
            torch.cuda.synchronize()
            M = ce.shape[0]
            W = (M + 7) // 8 * 8
            buf = (ctypes.c_uint64 * (W * 8))()
            if lib.cc_kq_stamps(buf, W * 8) != 0:
                raise SystemExit("reading the stamps failed")
            s = np.frombuffer(buf, dtype=np.uint64).reshape(W, 8)[:M]
            s = s.astype(np.int64)
            t0 = s[:, 0].min()
            start, staged, walked, judged = (s[:, k] - t0 for k in range(4))
            matches, live = s[:, 5], s[:, 6] == 1
            walk, verdict = walked - staged, judged - walked
            print(f"== {shape} M {M}, {chain} chain position {pos}: "
                  f"{ms:.5f} ms (graph replay), {int(live.sum())} eligible "
                  f"rows; span to the last verdict {int(judged.max())} ns")
            print(f"  first staging barrier passed: median "
                  f"{int(np.median(staged))} ns, max {int(staged.max())}")
            print(f"  walk: median {int(np.median(walk[live]))} ns, max "
                  f"{int(walk[live].max())}; matched pairs a row: median "
                  f"{int(np.median(matches[live]))}, max "
                  f"{int(matches[live].max())}")
            dense = live & (matches > 50)
            if dense.any():
                print(f"  walk ns a matched pair (rows past 50): "
                      f"{float(np.median(walk[dense] / matches[dense])):.1f}")
            print(f"  verdicts: median {int(np.median(verdict[live]))} ns, "
                  f"max {int(verdict[live].max())}")
            for i in np.argsort(-judged)[:3]:
                print(f"  row {i}: staged {staged[i]}, walked {walked[i]}, "
                      f"judged {judged[i]} ns; {matches[i]} matched pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
