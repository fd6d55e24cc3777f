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

With ``--kernels`` each process instead times KM (``kernels.apply_group``),
KP (``kernels.bulk_drain_fill``), KO and KN at the shapes of
``chip_smoke.py`` phase 3: KM at ``chip_smoke.KM_SHAPES``
(``chip_smoke.km_cases``, this checkout's builders run against the root's
package) out of place and, where the root's KM has the form, in place
(``out=``, checked once against the call out of place), KP at the main
path's drain (N 16,384) and the scale cell's (N 25,000), KO's range
launch where the root has it, KO's two launches for a util goal and a
count goal, KN at ``chip_smoke.KN_SHAPES``, KQ at ``chip_smoke.KQ_SHAPES``
where the root has it (``chip_smoke.kq_round``'s real apply rounds), each
a CUDA graph of up to
200 launches replayed between two events (``chip_smoke.time_ms``), and
the dependent-add probe where the root has it; the summary is each
shape's median per root. With
``--kernels --launches`` each shape's call also runs ten times under
``torch.profiler``, and the line gives the mean device time of each of
its launches by kernel name (which phase of a multi-launch kernel costs
what):

    python3 scripts/ab_main_path.py --kernels --launches PARENT_ROOT . . \
        PARENT_ROOT

With ``--kb-shapes`` (this checkout only) it lists KB's launches on the
main path by shape, each timed (see ``kb_shapes``).
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def launch_times(fn, calls=10) -> dict:
    """Mean device time (ms) a call of each kernel ``fn`` launches, by
    name, over ``calls`` calls under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:40]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls
    return {k: round(v, 5) for k, v in out.items()}


def _time_ko_kn(cs, kernels, timed, shape, m, md, state, ctx):
    """KO (its range launch where the root has it, then the priorities and
    the match of a util goal and a count goal), KN (``chip_smoke.
    KN_SHAPES``, each chain at its positions there) and KQ where the root
    has it (``chip_smoke.KQ_SHAPES``) at phase 3's shapes."""
    from cruise_control_tpu_torch import _random
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   default_goals,
                                                   goals_by_name)
    from cruise_control_tpu_torch.utils.ordered import top_k
    cfg = SearchConfig(**cs.MAIN_SEARCH)
    goals = goals_by_name(cs.GOALS)
    P, R = state.rb.shape
    if hasattr(kernels, "replica_weight_range"):
        timed(f"KO range {shape}", lambda: kernels.replica_weight_range(
            ctx.leader_load, ctx.follower_load, R))
    K = cfg.num_replica_candidates if shape == "main" else 1_024
    for goal in (goals[1], goals[0]):
        planes = goal.propose_planes(state, ctx)
        krep, kdst = _random.subkeys(_random.PRNGKey(5, device=m.device))
        timed(f"KO priority {shape} {goal.name}",
              lambda: kernels.flow_priority(goal, state, ctx, krep, cfg,
                                            *planes))
        prio = kernels.flow_priority(goal, state, ctx, krep, cfg, *planes)
        vals, idx = top_k(prio.reshape(-1), K)
        args = (planes[0], planes[1], planes[2], planes[4], vals, idx)
        timed(f"KO match {shape} {goal.name} K {K}",
              lambda: kernels.flow_match(goal, state, ctx, kdst, cfg, *args))
    default_chain = [g.bind(md) for g in default_goals()]
    for n, chain, positions in cs.KN_SHAPES[shape]:
        if chain == "partb":
            st, cx, chain_goals = cs.partb_pass(m.device)
        else:
            st, cx = state, ctx
            chain_goals = goals if chain == "main" else default_chain
        c = cs.kn_case(st, cx, n, seed=5)
        for i in positions:
            checks = kernels.GoalChecks(chain_goals[i], chain_goals[:i],
                                        cfg.epsilon)
            tag = f"KN {shape} N {n} {chain} position {i}"
            timed(tag, lambda: kernels.candidate_eligibility(st, cx, c,
                                                             checks))
    if not hasattr(kernels, "round_guards"):
        return
    for chain, pos, search, q in cs.KQ_SHAPES[shape]:
        seg, c, ce, pending, elig, bounds = cs.kq_round(
            state, ctx, goals if chain == "main" else default_chain, pos,
            search, q)
        timed(f"KQ {shape} M {ce.shape[0]} {chain} position {pos}",
              lambda: kernels.round_guards(state, ctx, c, ce, pending, elig,
                                           seg.guards, bounds))


def kernels_child(root: str, launches: bool) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from cruise_control_tpu_torch import _random, kernels
    from cruise_control_tpu_torch.analyzer import SearchConfig, goals_by_name
    spec = importlib.util.spec_from_file_location(
        "smoke_here", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    in_place = "out" in inspect.signature(kernels.apply_group).parameters
    times: dict[str, float] = {}
    per_launch: dict[str, dict] = {}

    def timed(name, fn):
        times[name] = cs.time_ms(fn, graph=True)
        if launches:
            per_launch[name] = launch_times(fn)
    models = {"main": cs.build_flat_direct(100, 20_000, 2),
              "scale": cs.build_flat_direct(1000, 200_000, 2)}
    for shape, (m, md) in models.items():
        state, ctx = cs.pass_state(m, md, dead=(3,))
        for tag, (st, cx, c, do) in cs.km_cases(m, md, shape, state, ctx):
            want = kernels.apply_group(st, cx, c, do)
            timed(f"KM {tag}", lambda: kernels.apply_group(st, cx, c, do))
            if in_place:
                carry = cs.clone_fields(st)
                got = kernels.apply_group(carry, cx, c, do, out=carry)
                if cs._max_err(cs._state_fields(got[0]),
                               cs._state_fields(want[0])) != 0.0:
                    raise RuntimeError(f"KM in place differs: {tag}")
                times[f"KM {tag}, in place"] = cs.time_ms(
                    lambda: kernels.apply_group(carry, cx, c, do, out=carry),
                    graph=True)
        goal = goals_by_name(cs.GOALS)[0]
        cfg = SearchConfig(**dict(cs.MAIN_SEARCH, drain_batch=(
            16_384 if shape == "main" else 25_000)))
        args = goal.drain_sort(state, ctx, _random.PRNGKey(11,
                                                           device=m.device))
        timed(f"KP {shape}",
              lambda: kernels.bulk_drain_fill(goal, state, ctx, cfg, *args))
        _time_ko_kn(cs, kernels, timed, shape, m, md, state, ctx)
    if hasattr(kernels, "dependent_add_launch"):
        times["dependent add, ns a step"] = cs.dependent_add_ns(
            np.random.default_rng(0))
    out = dict(root=root, card=torch.cuda.get_device_name(0), ms=times)
    if launches:
        out["launch_ms"] = per_launch
    return out


def kb_shapes() -> dict:
    """KB's launches on the main path by shape: phase 4's three optimizes
    (seeds 0, 1, 1) driven by the host loop (``goal_loop="host"``: the
    graphs' segments run eagerly, so every launch passes its wrapper), each
    call of ``ordered_segment_sum`` / ``ordered_range_sum`` counted by its
    shape, and each shape timed (``chip_smoke.time_ms``, a CUDA graph) on
    its first call's own inputs; beside them, the launch count of the same
    three optimizes through the goal-loop graphs, which must be the
    same."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(cs.build_spec(), device="cuda")

    def three(opt):
        kernels.reset_launch_counts()
        for seed in (0, 1, 1):
            opt.optimize(model, md, cs.main_path_options(seed))
        return cs._launch_counts()["ordered_segment_sum"]
    graphs = three(cs.main_path_optimizer())
    counts: dict[tuple, int] = {}
    first: dict[tuple, tuple] = {}

    def recorded(name, fn):
        def call(*args, **kw):
            key = (name, *(tuple(a.shape) if isinstance(a, torch.Tensor)
                           else a for a in args))
            counts[key] = counts.get(key, 0) + 1
            if key not in first:
                first[key] = (fn, [a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args], kw)
            return fn(*args, **kw)
        return call
    originals = {n: getattr(kernels, n)
                 for n in ("ordered_segment_sum", "ordered_range_sum")}
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("cruise_control_tpu_torch"):
            for n, fn in originals.items():
                if getattr(mod, n, None) is fn:
                    setattr(mod, n, recorded(n, fn))
    host = three(cs.main_path_optimizer(goal_loop="host"))
    shapes = []
    for key, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        fn, args, kw = first[key]
        ms = cs.time_ms(lambda: fn(*args, **kw), graph=True)
        shapes.append(dict(call=key[0], shape=str(key[1:]), launches=n,
                           ms=ms, launches_x_ms=n * ms))
    return dict(card=torch.cuda.get_device_name(0), graph_launches=graphs,
                host_launches=host, recorded=sum(counts.values()),
                shapes=shapes)


def main(argv) -> int:
    if argv[:1] == ["--kb-shapes"]:
        print(json.dumps(kb_shapes(), indent=1), flush=True)
        return 0
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1], int(argv[2]))), flush=True)
        return 0
    if argv[:1] == ["--served-child"]:
        print(json.dumps(served_child(argv[1], int(argv[2]))), flush=True)
        return 0
    if argv[:1] == ["--kernels-child"]:
        print(json.dumps(kernels_child(argv[1], argv[2] == "1")), flush=True)
        return 0
    warm, mode, key = 5, "--child", "warm_s"
    if argv[:1] == ["--warm"]:
        warm, argv = int(argv[1]), argv[2:]
    elif argv[:1] == ["--served"]:
        warm, argv = int(argv[1]), argv[2:]
        mode, key = "--served-child", "update_s"
    elif argv[:1] == ["--kernels"]:
        argv = argv[1:]
        mode, key = "--kernels-child", "ms"
        warm = int(argv[:1] == ["--launches"])
        argv = argv[warm:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    # {series: {root: [values]}}: the walls or spans of each root, or each
    # kernel shape's times
    runs: dict[str, dict[str, list[float]]] = {}
    for root in argv:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              mode, root, str(warm)], cwd=root,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-8000:], file=sys.stderr)
            return out.returncode
        line = [x for x in out.stdout.splitlines() if x.startswith("{")][-1]
        print(line, flush=True)
        got = json.loads(line)[key]
        for series, v in (got.items() if isinstance(got, dict)
                          else [(key, x) for x in got]):
            runs.setdefault(series, {}).setdefault(root, []).append(v)
    for series, by_root in runs.items():
        print(f"median {series}: " + "; ".join(
            f"{os.path.relpath(r, HERE)} {statistics.median(v):.6f} over "
            f"{len(v)}" for r, v in by_root.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
