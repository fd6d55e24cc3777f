#!/usr/bin/env python3
"""Time design variants of KA (``csrc/threefry.cu``) and KJ
(``csrc/fleet_failover.cu``) against the kept kernels, on one CUDA card.

Each variant is the kept source with a few lines replaced (``VARIANTS``
below), compiled by ``nvcc`` into a library of its own (all at once) and
called through the same C entry as the kept kernel. Every variant's
outputs must equal the kept kernel's bit for bit; the script then times
each, kept first and last, by replaying a CUDA graph of launches between
two events:

- KJ at the fleet N-1 sweep's shape (16 clusters x 100 scenarios x
  20,096 partitions x 2 replicas, 104 brokers), beside ``zero_()`` of as
  many bytes (what one write-only launch takes on this card);
- KA's scaled-noise draw of 40,192 elements through a three-word path
  (the main path's candidate noise) and a fold-in key (one element, one
  word).

Prints the card's name and power limit, then one line a variant:

    python3 scripts/probe_draw_failover.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: name -> (source, [(kept text, variant text), ...])
VARIANTS = {
    "KJ kept": ("fleet_failover.cu", []),
    "KJ the row kernel (a thread a row)": ("fleet_failover.cu", [(
        "  if (s_chunk > 0) {", "  if (false) {")]),
    "KJ cached stores": ("fleet_failover.cu", [(
        "void store(T* p, T v) { __stcs(p, v); }",
        "void store(T* p, T v) { *p = v; }")]),
    "KJ registers uncapped": ("fleet_failover.cu", [(
        "__launch_bounds__(kThreads, kMinBlocks)",
        "__launch_bounds__(kThreads)")]),
    "KJ grid of 8 blocks an SM": ("fleet_failover.cu", [(
        "kBlocksPerSm = 16;", "kBlocksPerSm = 8;")]),
    "KJ cached stores, registers uncapped, grid of 8 (first tiled design)": (
        "fleet_failover.cu", [
            ("void store(T* p, T v) { __stcs(p, v); }",
             "void store(T* p, T v) { *p = v; }"),
            ("__launch_bounds__(kThreads, kMinBlocks)",
             "__launch_bounds__(kThreads)"),
            ("kBlocksPerSm = 16;", "kBlocksPerSm = 8;")]),
    "KJ stores only (no failover: each input slot written back)": (
        "fleet_failover.cu", [(re.compile(
            r"#pragma unroll\n    for \(int v = 0; v < kV; \+\+v\) \{\n"
            r"      bool u\[R\];.*?(?=    const int64_t row = )", re.S),
            """#pragma unroll
    for (int v = 0; v < kV; ++v) {
      ha[v] = pv[v] ? 1 : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ob[v][r] = bk[v][r] + s;
        op[v][r] = pref[v][r];
        oo[v][r] = off[v][r] ? 1 : 0;
      }
    }

""")]),
    "KJ rows laid out block by block (a layout probe: wrong outputs)": (
        "fleet_failover.cu", [("    const int64_t row = (c * S + s0 + s) * P + p0;   // first row's index\n",
         """    const int64_t row = (static_cast<int64_t>(blockIdx.x) * s_chunk + s)
                        * kTile + threadIdx.x * kV;
    if (row + kV > (gridDim.x / (chunks * tiles)) * S * P) continue;
""")]),
    "KJ stores only, rows laid out block by block (a layout probe)": (
        "fleet_failover.cu", [(re.compile(
            r"#pragma unroll\n    for \(int v = 0; v < kV; \+\+v\) \{\n"
            r"      bool u\[R\];.*?(?=    const int64_t row = )", re.S),
            """#pragma unroll
    for (int v = 0; v < kV; ++v) {
      ha[v] = pv[v] ? 1 : 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ob[v][r] = bk[v][r] + s;
        op[v][r] = pref[v][r];
        oo[v][r] = off[v][r] ? 1 : 0;
      }
    }

"""), ("    const int64_t row = (c * S + s0 + s) * P + p0;   // first row's index\n",
         """    const int64_t row = (static_cast<int64_t>(blockIdx.x) * s_chunk + s)
                        * kTile + threadIdx.x * kV;
    if (row + kV > (gridDim.x / (chunks * tiles)) * S * P) continue;
""")]),
    "KJ 8 partitions a thread": ("fleet_failover.cu", [(
        "constexpr int kV = 4;", "constexpr int kV = 8;")]),
    "KA kept": ("threefry.cu", []),
    "KA key derived by warp 0 a block": ("threefry.cu", [(
        """  if (i >= n) return;
  uint32_t k0 = static_cast<uint32_t>(key[0]);
  uint32_t k1 = static_cast<uint32_t>(key[1]);""",
        """  __shared__ uint32_t derived[2];
  uint32_t k0 = static_cast<uint32_t>(key[0]);
  uint32_t k1 = static_cast<uint32_t>(key[1]);
  if (threadIdx.x < 32) {"""), (
        """      fold(k0, k1, w);
    }
  }
""",
        """      fold(k0, k1, w);
    }
  }
  if (threadIdx.x == 0) { derived[0] = k0; derived[1] = k1; }
  }
  __syncthreads();
  k0 = derived[0];
  k1 = derived[1];
  if (i >= n) return;
""")]),
}


def build(tmp: str) -> dict:
    """name -> loaded library of each variant (nvcc, all at once)."""
    from cruise_control_tpu_torch import kernels
    nvcc = kernels._nvcc()
    procs = {}
    for name, (source, subs) in VARIANTS.items():
        text = open(os.path.join(kernels.CSRC, source)).read()
        for old, new in subs:
            if isinstance(old, re.Pattern):
                text, count = old.subn(new, text)
            else:
                count = text.count(old)
                text = text.replace(old, new)
            if not count:
                raise RuntimeError(f"{name}: {old!r} is not in {source}")
        tag = "".join(c if c.isalnum() else "_" for c in name)
        src = os.path.join(tmp, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        for header in kernels.HEADERS:
            shutil.copy(os.path.join(kernels.CSRC, header), tmp)
        lib = os.path.join(tmp, f"lib{tag}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def graph_ms(fn, launches: int) -> float:
    """Median ms of one call: a CUDA graph of ``launches`` calls replayed
    between two events, five times."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def kj_call(lib, args, outs):
    import torch
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.cc_fleet_scenario_failover
    fn.argtypes = [p] * 12 + [i64] * 5 + [p]
    fn.restype = ctypes.c_int
    C, S, B = args[5].shape
    P, R = args[0].shape[1:]

    def call():
        rc = fn(*(t.data_ptr() for t in args + outs), C, S, P, R, B,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
    return call


def ka_call(lib, key, words, n, form, a, b, out):
    import torch
    from cruise_control_tpu_torch import kernels
    fn = lib.cc_threefry_draw
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, kernels._DrawPath, p, i64, i64, ctypes.c_int32,
                   ctypes.c_float, ctypes.c_float, i64, ctypes.c_uint32,
                   ctypes.c_uint32, p, p]
    fn.restype = ctypes.c_int
    path = kernels._DrawPath(n=len(words))
    for j, w in enumerate(words):
        path.words[j] = w

    def call():
        rc = fn(key.data_ptr(), path, None, 0, n, kernels.DRAW_FORMS[form],
                a, b, 0, 1, 0, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
    return call


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_draw_failover: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from cruise_control_tpu_torch import _random
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    from cruise_control_tpu_torch import kernels
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="variants-", dir=kernels.BUILD_DIR)
    try:
        libs = build(tmp)
        kj_args = chip_smoke.kj_case(16, 100, 20_096, 2, 104, seed=1,
                                     device=dev)
        C, S, B = kj_args[5].shape
        P, R = kj_args[0].shape[1:]
        key = _random.PRNGKey(0, device=dev)
        results, want = [], {}
        names = list(VARIANTS) + ["KJ kept", "KA kept"]
        for name in names:
            lib = libs[name]
            if name.startswith("KJ"):
                outs = (torch.empty((C, S, P, R), dtype=torch.int32,
                                    device=dev),
                        torch.empty((C, S, P, R), dtype=torch.int32,
                                    device=dev),
                        torch.empty((C, S, P, R), dtype=torch.bool,
                                    device=dev),
                        torch.empty((C, S, P), dtype=torch.bool, device=dev))
                call = kj_call(lib, kj_args, outs)
                call()
                got = [o.clone() for o in outs]
                ref = want.setdefault("KJ", got)
                same = all(torch.equal(g, r) for g, r in zip(got, ref))
                ms = graph_ms(call, 20)
                results.append(f"{name}: {ms:.4f} ms at C {C} S {S} P {P} "
                               f"R {R} B {B}, equal to the kept: {same}")
                if name == "KJ kept" and "fill" not in want:
                    # a yardstick: writing as many bytes with one fill
                    buf = torch.empty(sum(o.numel() * o.element_size()
                                          for o in outs), dtype=torch.uint8,
                                      device=dev)
                    want["fill"] = graph_ms(buf.zero_, 20)
                    print(f"  zero_() of the same {buf.numel()} bytes: "
                          f"{want['fill']:.4f} ms", flush=True)
                    del buf
                del got, outs
            else:
                line = [name + ":"]
                for tag, words, n, form, a in (
                        ("noise", (2, 17, 0), 40_192, "affine", 1e-3),
                        ("fold-in key", (2,), 1, "keys", 1.0)):
                    out = torch.empty(n * (2 if form == "keys" else 1),
                                      dtype=torch.int64 if form == "keys"
                                      else torch.float32, device=dev)
                    call = ka_call(lib, key, words, n, form, a, 0.0, out)
                    call()
                    ref = want.setdefault(("KA", tag), out.clone())
                    same = torch.equal(out, ref)
                    ms = graph_ms(call, 200)
                    line.append(f"{tag} {ms * 1e3:.3f} us (equal to the "
                                f"kept: {same})")
                results.append(" ".join(line))
            print(results[-1], flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
