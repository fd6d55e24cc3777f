#!/usr/bin/env python3
"""Time design variants of KA (``csrc/threefry.cu``) and of KD and KJ's
shared failover kernel (``csrc/failover.cu``) against the kept kernels,
and the failover kernel's scenario chunks, on one CUDA card.

Each variant is the kept source with a few lines replaced (``VARIANTS``
below), compiled by ``nvcc`` into a library of its own (all at once) and
called through the same C entry as the kept kernel. Every variant's
outputs must equal the kept kernel's (the failover's: its twin's) bit for
bit; the script then times each, kept first and last, by replaying a CUDA
graph of launches between two events:

- the failover at KD's N-1 shape (phase 7: the template's placement,
  pvalid per scenario, 100 x 20,096 x 2, 104 brokers), KD's boundary-audit
  shape (phase 8: 174 placements, pvalid shared) and KJ's fleet N-1 shape
  (16 clusters x 100 scenarios x 20,096 partitions x 2 replicas), beside
  ``zero_()`` of KJ's bytes (what one write-only launch takes on this
  card);
- KA's scaled-noise draw of 40,192 elements through a three-word path
  (the main path's candidate noise) and a fold-in key (one element, one
  word);
- the kept failover kernel with every scenario chunk in ``CHUNKS`` (0 is
  the row kernel, -1 ``cc_failover_chunk``'s rule) at the three shapes.

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
    "KD/KJ kept": ("failover.cu", []),
    "KD/KJ cached stores": ("failover.cu", [(
        "void store(T* p, T v) { __stcs(p, v); }",
        "void store(T* p, T v) { *p = v; }")]),
    "KD/KJ registers uncapped": ("failover.cu", [(
        "__launch_bounds__(kThreads, kMinBlocks)",
        "__launch_bounds__(kThreads)")]),
    "KD/KJ grid of 16 blocks an SM (the earlier rule)": ("failover.cu", [(
        "kBlocksPerSm = 64;", "kBlocksPerSm = 16;")]),
    "KD/KJ first loads before the masks at every form": ("failover.cu", [(
        "constexpr bool kEarly = !kInPerS && !kPvPerS;",
        "constexpr bool kEarly = true;")]),
    "KD/KJ first loads after the masks at every form": ("failover.cu", [(
        "constexpr bool kEarly = !kInPerS && !kPvPerS;",
        "constexpr bool kEarly = false;")]),
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


def build(tmp: str, variants=None) -> dict:
    """name -> loaded library of each variant (nvcc, all at once);
    ``variants`` defaults to :data:`VARIANTS`."""
    from cruise_control_tpu_torch import kernels
    nvcc = kernels._nvcc()
    procs = {}
    for name, (source, subs) in (variants or VARIANTS).items():
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


#: scenario chunks timed at each failover shape (0: the row kernel, -1:
#: the rule of ``cc_failover_chunk``)
CHUNKS = (-1, 0, 1, 2, 4, 8, 16, 32)


def failover_call(lib, args, outs, in_per_s, pv_per_s, s_chunk=-1):
    """One ``cc_failover`` launch over ``dead [C, S, B]``'s rows."""
    import torch
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.cc_failover
    fn.argtypes = [p] * 12 + [i64] * 8 + [p]
    fn.restype = ctypes.c_int
    C, S, B = args[5].shape
    P, R = args[0].shape[-2:]

    def call():
        rc = fn(*(t.data_ptr() for t in args + outs), C, S, P, R, B,
                in_per_s, pv_per_s, s_chunk,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
    return call


def _outs(C, S, P, R, dev):
    import torch
    return (torch.empty((C, S, P, R), dtype=torch.int32, device=dev),
            torch.empty((C, S, P, R), dtype=torch.int32, device=dev),
            torch.empty((C, S, P, R), dtype=torch.bool, device=dev),
            torch.empty((C, S, P), dtype=torch.bool, device=dev))


def failover_shapes(dev):
    """(tag, C-axis inputs of cc_failover, in_per_s, pv_per_s, twin's
    outputs [C, S, ...]) of KD's two shapes and KJ's."""
    import torch
    import chip_smoke
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, _ = flatten_spec(chip_smoke.build_spec(), device=dev)
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape
    S = chip_smoke.NUM_BROKERS
    dead = torch.zeros((S, B), dtype=torch.bool, device=dev)
    dead[torch.arange(S), torch.arange(S)] = True
    n1 = (model.replica_broker, model.replica_offline,
          model.replica_pref_pos, model.broker_valid, model.broker_alive,
          dead, torch.zeros_like(dead),
          model.partition_valid.expand(S, P).contiguous())
    audit = chip_smoke.kd_boundary_case(model, seed=8)
    out = []
    for tag, a, per_s, pv_s in (("KD N-1", n1, False, True),
                                ("KD boundary audit", audit, True, False)):
        want = kernels.scenario_failover_plain(*(t.cpu() for t in a))
        pv = a[7] if pv_s else a[7][0]
        grid = (a[0].contiguous(), a[1].contiguous(), a[2].contiguous(),
                a[3][None], a[4][None], a[5][None], a[6][None],
                pv.contiguous())
        out.append((tag, grid, per_s, pv_s, [w[None] for w in want]))
    kj = chip_smoke.kj_case(16, 100, 20_096, 2, 104, seed=1, device=dev)
    want = kernels.fleet_scenario_failover_plain(*(t.cpu() for t in kj))
    out.append(("KJ fleet N-1", kj, False, False, list(want)))
    return out


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
        shapes = failover_shapes(dev)
        key = _random.PRNGKey(0, device=dev)
        results, want = [], {}
        names = list(VARIANTS) + ["KD/KJ kept", "KA kept"]
        for name in names:
            lib = libs[name]
            if name.startswith("KD/KJ"):
                line = [name + ":"]
                for tag, args, per_s, pv_s, twin in shapes:
                    C, S, B = args[5].shape
                    P, R = args[0].shape[-2:]
                    outs = list(_outs(C, S, P, R, dev))
                    call = failover_call(lib, list(args), outs, int(per_s),
                                         int(pv_s))
                    call()
                    same = all(torch.equal(o.cpu(), w)
                               for o, w in zip(outs, twin))
                    ms = graph_ms(call, 20 if C > 1 else 200)
                    line.append(f"{tag} {ms:.5f} ms"
                                f"{'' if same else ' (DIFFERS from the twin)'}")
                    if C > 1 and "fill" not in want:
                        # a yardstick: writing as many bytes with one fill
                        buf = torch.empty(sum(o.numel() * o.element_size()
                                              for o in outs),
                                          dtype=torch.uint8, device=dev)
                        want["fill"] = graph_ms(buf.zero_, 20)
                        print(f"  zero_() of KJ's {buf.numel()} bytes: "
                              f"{want['fill']:.4f} ms", flush=True)
                        del buf
                    del outs
                results.append(", ".join(line))
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
        lib = libs["KD/KJ kept"]
        for tag, args, per_s, pv_s, want in shapes:
            C, S, B = args[5].shape
            P, R = args[0].shape[-2:]
            outs = list(_outs(C, S, P, R, dev))
            line = [f"{tag} (C {C} S {S} P {P} R {R} B {B}, rule "
                    f"{kernels.failover_chunk(C, S, P, R, B)}):"]
            for chunk in CHUNKS:
                call = failover_call(lib, list(args), outs, int(per_s),
                                     int(pv_s), chunk)
                call()
                same = all(torch.equal(o.cpu(), w)
                           for o, w in zip(outs, want))
                ms = graph_ms(call, 20 if C > 1 else 200)
                line.append(f"chunk {chunk} {ms:.5f} ms"
                            f"{'' if same else ' (DIFFERS from the twin)'}")
            print(" ".join(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
