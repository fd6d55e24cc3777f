#!/usr/bin/env python3
"""Goal passes as CUDA graphs (``analyzer/graph_loop.py``, KL) against the
host-driven loop on one card, stage by stage (each stage reports its error
and the next one runs):

1. environment: torch, the CUDA runtime and installed versions, ``nvcc``;
2. the mechanism: a captured segment inside nested WHILE nodes under an IF,
   KL writing the tests; a hidden ``.item()`` refused at capture; KL's
   eager step against its twin;
3. the main path (``chip_smoke.py`` phase 4's cluster, chain and search):
   a cold and two warm fused optimizes through the graphs, one through the
   host loop, outcomes compared; walls, host syncs, captures, capture time
   and graph memory;
4. the default chain (phase 13 (a)'s seed), fused and per goal: graphs
   against the host loop.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/probe_goal_loop.py [--stages 1,2,3,4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def stage_environment():
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import graph_loop
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f}s")
    for entry in kernels.BUILD_LOG:
        if entry.startswith("[goal_loop.cu]"):
            print(entry.strip())
    print(f"CUDA (installed, runtime): {graph_loop.cuda_versions()}")
    torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph  # noqa: B018


def stage_mechanism():
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import graph_loop as gl
    S = gl.SLOT
    dev = "cuda"
    ctr = torch.zeros(len(S), dtype=torch.int64, device=dev)
    y = torch.zeros((), dtype=torch.int64, device=dev)
    z = torch.zeros((), dtype=torch.int64, device=dev)
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()

    def act():
        ctr[S["flag"]].fill_(1)

    def prop():
        y.add_(1)
        ctr[S["flag"]].fill_(1)

    def rnd():
        t = z + 1
        z.copy_(t)
        ctr[S["applied"]].add_(1)
        ctr[S["flag"]].copy_(z < 1000)

    segs = {n: gl.Segment(n, f, pool, stream)
            for n, f in (("act", act), ("prop", prop), ("rnd", rnd))}
    pg = gl.ParentGraph()
    root = pg.root
    pg.child(root, segs["act"])
    h = pg.handle(root)
    pg.loop(root, ctr, "active", handle=h)
    body = pg.cond(root, h, loop=False)
    hf = pg.handle(body)
    pg.loop(body, ctr, "fine_enter", 2, 5, handle=hf)
    fine = pg.cond(body, hf, loop=True)
    pg.child(fine, segs["prop"])
    hr = pg.handle(fine)
    pg.loop(fine, ctr, "rounds_enter", 3, handle=hr)
    rounds = pg.cond(fine, hr, loop=True)
    pg.child(rounds, segs["rnd"])
    pg.loop(rounds, ctr, "rounds_step", 3, handle=hr)
    pg.loop(fine, ctr, "fine_step", 2, 5, handle=hf)
    t0 = time.perf_counter()
    pg.instantiate()
    torch.cuda.synchronize()
    print(f"instantiate {1e3 * (time.perf_counter() - t0):.2f} ms")
    pg.launch()
    torch.cuda.synchronize()
    print(f"nested loops: y {int(y)} (want 5) z {int(z)} (want 15) "
          f"counters {ctr.tolist()}")
    assert int(y) == 5 and int(z) == 15
    for n in (1, 100):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(n):
            pg.launch()
        e1.record()
        e1.synchronize()
        print(f"{n} launches: {e0.elapsed_time(e1) / n:.4f} ms a launch "
              f"(5 fine iterations x 3 rounds, 41 nodes run)")

    def bad():
        y.add_(int(y.item()))
    try:
        gl.Segment("hidden-item", bad, pool, stream)
        print("BAD: a segment with .item() was captured")
    except Exception as err:                 # noqa: BLE001
        print(f"hidden .item() refused at capture: {type(err).__name__}: "
              f"{str(err)[:160]}")
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    for op in kernels.GOAL_LOOP_OPS:
        c = torch.randint(0, 4, (len(S),), generator=gen, dtype=torch.int64)
        d = c.to(dev)
        want = kernels.goal_loop_step_plain(c, op, 3, 2)
        got = kernels.goal_loop_step(d, op, 3, 2)
        print(f"KL {op}: test {bool(got) == bool(want)}, counters "
              f"{torch.equal(c, d.cpu())}")


def _outcome(res):
    return (res.num_moves, len(res.proposals),
            [(g.name, g.iterations, g.accepted, g.violation_after)
             for g in res.goal_results],
            [p.to_json() for p in res.proposals])


def _timed(opt, model, md, options):
    import torch
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.core.runtime_obs import default_collector
    torch.cuda.synchronize()
    s0, c0 = engine.HOST_SYNCS, default_collector().capture_count()
    t0 = time.perf_counter()
    res = opt.optimize(model, md, options)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, engine.HOST_SYNCS - s0,
            default_collector().capture_count() - c0)


def stage_main_path():
    import torch
    import chip_smoke as smoke
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(smoke.build_spec(), device="cuda")

    def optimizer(loop):
        return TorchGoalOptimizer(goals=goals_by_name(smoke.GOALS),
                                  config=SearchConfig(**smoke.MAIN_SEARCH),
                                  device="cuda", goal_loop=loop)
    graph, host = optimizer("auto"), optimizer("host")
    mem0 = torch.cuda.memory_allocated()
    outs = {}
    for tag, opt, seed in (("graph cold seed 0", graph, 0),
                           ("graph warm seed 1", graph, 1),
                           ("graph warm seed 1 again", graph, 1),
                           ("host seed 1", host, 1),
                           ("host seed 1 again", host, 1)):
        kernels.reset_launch_counts()
        res, wall, syncs, caps = _timed(opt, model, md,
                                        smoke.main_path_options(seed))
        outs[tag] = _outcome(res)
        print(f"{tag}: wall {wall:.4f}s host syncs {syncs} captures {caps} "
              f"moves {res.num_moves} proposals {len(res.proposals)} "
              f"iters {[g.iterations for g in res.goal_results]} launches "
              f"{ {k: v for k, v in kernels.LAUNCHES.items() if v} }")
        if tag == "graph cold seed 0":
            gl = next(iter(next(iter(graph._chains.values()))._graphs
                           .values()))
            print(f"  capture {gl.capture_s:.3f}s, carry "
                  f"{gl.carry_bytes / 2**20:.2f} MiB, capture pool "
                  f"{gl.pool_bytes / 2**20:.1f} MiB, allocated since start "
                  f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB")
    same = outs["graph warm seed 1"] == outs["host seed 1"]
    print(f"graph == host on seed 1: {same}; graph runs equal: "
          f"{outs['graph warm seed 1'] == outs['graph warm seed 1 again']}")
    if not same:
        g, h = outs["graph warm seed 1"], outs["host seed 1"]
        print("graph", g[:3])
        print("host ", h[:3])


def stage_default_chain():
    import chip_smoke as smoke
    from cruise_control_tpu_torch.analyzer import (OptimizationFailureError,
                                                   OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer)
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(smoke.build_spec(), device="cuda")
    for fused in (True, False):
        outs = {}
        search = dict(smoke.MAIN_SEARCH, fused_chain=fused)
        for loop in ("auto", "auto", "host"):
            opt = TorchGoalOptimizer(config=SearchConfig(**search),
                                     device="cuda", goal_loop=loop)
            try:
                res, wall, syncs, caps = _timed(opt, model, md,
                                                OptimizationOptions(seed=1))
            except OptimizationFailureError as err:
                print(f"  failure: {err}")
                continue
            outs.setdefault(loop, _outcome(res))
            print(f"default chain fused={fused} {loop}: wall {wall:.4f}s "
                  f"host syncs {syncs} captures {caps} moves "
                  f"{res.num_moves} proposals {len(res.proposals)} iters "
                  f"{[g.iterations for g in res.goal_results]}")
        print(f"default chain fused={fused} graph == host: "
              f"{outs.get('auto') == outs.get('host')}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_goal_loop: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="1,2,3,4")
    args = ap.parse_args()
    stages = {"1": stage_environment, "2": stage_mechanism,
              "3": stage_main_path, "4": stage_default_chain}
    failed = []
    for s in args.stages.split(","):
        print(f"== stage {s}: {stages[s].__name__}", flush=True)
        try:
            stages[s]()
        except Exception:                    # noqa: BLE001
            traceback.print_exc(file=sys.stdout)
            failed.append(s)
            torch.cuda.synchronize()
        sys.stdout.flush()
    print(f"failed stages: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
