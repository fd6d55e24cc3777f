#!/usr/bin/env python3
"""The main path's warm optimize in two checkouts of the port, in turns,
on one CUDA card: wall, KA launches and device launches per optimize.

For each checkout root given (for instance the parent commit unpacked by
``git archive`` beside this one) the script starts one process that
imports ``cruise_control_tpu_torch`` and ``chip_smoke`` from that root,
builds the main-path cluster (100 brokers x 20K partitions), runs one cold
optimize (seed 0), then ``--warm`` optimizes of seed 1 timed by the host
clock around a device synchronize, then one more under ``torch.profiler``
counting the kernels and copies it ran on the card. Each process prints
one JSON line; the script prints them, then the median warm wall of each
root over its turns. Pass the roots in the order to run them (A B B A):

    python3 scripts/ab_main_path.py PARENT_ROOT . . PARENT_ROOT

With ``--served N`` each process instead drives phase 9's served monitor
cycle (``chip_smoke.served_setup``: the main-path cluster as a simulated
Kafka cluster feeding a resident ``LoadMonitor``): a cold full upload,
``warmup``, then N 1%-churn metric-only cycles, recording each cycle's
``resident.update`` span (the diff, the upload and KF, host clock), then
one more under ``torch.profiler`` naming the kernels and copies it ran on
the card; the summary is the median span of each root.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def child(root: str, warm: int) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(chip_smoke.build_spec(), device="cuda")
    opt = chip_smoke.main_path_optimizer()

    def once(seed):
        torch.cuda.synchronize()
        ka = kernels.LAUNCHES["threefry2x32"]
        t0 = time.monotonic()
        res = opt.optimize(model, md, chip_smoke.main_path_options(seed))
        torch.cuda.synchronize()
        return (time.monotonic() - t0, res,
                kernels.LAUNCHES["threefry2x32"] - ka)
    cold, _, _ = once(0)
    walls, ka_launches, moves = [], set(), set()
    for _ in range(warm):
        wall, res, ka = once(1)
        walls.append(wall)
        ka_launches.add(ka)
        moves.add((res.num_moves, len(res.proposals)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once(1)
    device = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dict(root=root, card=torch.cuda.get_device_name(0),
                cold_s=cold, warm_s=walls, ka_launches=sorted(ka_launches),
                device_launches=device, moves_proposals=sorted(moves))


def served_child(root: str, cycles: int) -> dict:
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    pkg = chip_smoke.port_package()
    _sim, monitor, keys, vals, ingest, now_ms = chip_smoke.served_setup(
        pkg, chip_smoke.build_spec())
    ingest(vals, chip_smoke.SERVED_WINDOWS + 1)
    monitor.cluster_model(now_ms())
    monitor.resident.warmup()

    def cycle(c):
        nonlocal vals
        vals = vals.copy()
        vals[:len(keys) // 100] += 1.0 + c
        ingest(vals, 2)
        mark = max((sp.span_id for sp in pkg.tracer.spans()), default=0)
        monitor.cluster_model(now_ms())
        torch.cuda.synchronize()
        if monitor.resident.last_update != "delta":
            raise RuntimeError(f"cycle {c} was {monitor.resident.last_update}")
        return sum(sp.duration_s for sp in pkg.tracer.spans()
                   if sp.span_id > mark and sp.name == "resident.update")
    spans = [cycle(c) for c in range(cycles)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cycle(cycles)
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(root=root, card=torch.cuda.get_device_name(0),
                update_s=spans, device_ops=len(ops), ops=ops)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], int(argv[2]))), flush=True)
        return 0
    if argv[:1] == ["--served-child"]:
        print(json.dumps(served_child(argv[1], int(argv[2]))), flush=True)
        return 0
    warm, mode, key = 5, "--child", "warm_s"
    if argv[:1] == ["--warm"]:
        warm, argv = int(argv[1]), argv[2:]
    elif argv[:1] == ["--served"]:
        warm, argv = int(argv[1]), argv[2:]
        mode, key = "--served-child", "update_s"
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    walls: dict[str, list[float]] = {}
    for root in argv:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, os.path.join(here,
                                                           "ab_main_path.py"),
                              mode, root, str(warm)], cwd=root,
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        walls.setdefault(root, []).extend(json.loads(line)[key])
    for root, w in walls.items():
        print(f"{root}: median {key} {statistics.median(w):.6f} s over "
              f"{len(w)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
