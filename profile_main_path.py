#!/usr/bin/env python3
"""Where the time goes on the port's paths, on one CUDA card.

Builds the 100-broker x 20K-partition cluster of ``chip_smoke.py`` and its
main-path optimizer, runs one warm-up optimize (seed 0), then profiles with
``torch.profiler``, one after the other:

- one optimize (seed 1), the main path, its goal passes as CUDA graphs
  and then driven by host loops (``goal_loop="host"``), each after a cold
  and three timed warm optimizes; then the default chain (``goals=None``)
  both ways;
- the busy time by call site of the main path and of the default chain:
  one warm host-loop optimize (seed 1) each with a
  ``torch.profiler.record_function`` range around each ``PassSegments``
  segment, each goal's ``accepts``, ``delta``, ``collective_guard``,
  ``propose``, ``bulk_drain`` and ``violation``, and KN's, KQ's and KR's
  to KY's wrappers (the ranges are put on in this script and taken off after; a
  range inside a CUDA graph's capture does not come back at replay, so
  the host loop, which launches the graphs' kernels but KL, is the one
  traced); each device event goes to the innermost range around the host
  call that launched it, and the table sums them by pass x site beside
  the graph path's busy time (``--only main`` or ``--only
  default-chain`` runs just that chain's part; ``--only
  scale-default-chain`` the same two for the default chain on the
  1K x 200K scale cell under bench scale scenario 3's search, seed 0,
  and nothing else);
- one warm what-if N-1 sweep over the 100 brokers (``chip_smoke`` phase 7);
- one schedule of the seed-1 proposals with the hard-goal boundary audit
  (``chip_smoke`` phase 8, the facade's defaults);
- one warm metric-only monitor cycle (``chip_smoke`` phase 9: window
  aggregation and assembly on the host, the 1%-churn delta upload and KF),
  after a cold cycle, the resident state's warmup and one warm cycle;
- one ``stats_summary`` of the resident model (KB aggregates and KG);
- one warm population optimize (``chip_smoke`` phase 10: K = 4, the
  per-goal walk, seed 1; KI at each generation boundary);
- one intra-broker rebalance (``chip_smoke`` phase 11: four logdirs a
  broker; KH walks every broker in one launch);
- one warm fleet propose of ``chip_smoke.FLEET_FORECAST_CLUSTERS`` of
  phase 12's members (their per-goal walks one after another; four, not
  16, keep the trace small), and one warm N-1 sweep of all 16 members
  (``chip_smoke`` phase 12: one KJ launch, KB over 1,600 scenario rows);

and prints for each:

- wall time and kernel launches (for the optimize also the host syncs of
  the engine's loop tests, and its device-to-host copies and KL
  launches);
- device busy time (the union of CUDA kernel and memcpy intervals) and the
  device's idle share of the wall time;
- the top kernels by total device time, with their launch counts;
- the hand-written kernels' share of the device time.

Run from the repository root:

    python3 profile_main_path.py [--trace main_path_trace.json]
        [--only main|default-chain|scale-default-chain]
        [--sites sites.json]

The Chrome trace (of the optimize) runs to several tens of MiB.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


HAND_WRITTEN = ("threefry_draw_kernel", "tile_group_kernel",
                "tile_chain_kernel", "ordered_segment_sum_kernel",
                "ordered_range_sum_kernel", "net_broker_flow_kernel",
                "first_fit_kernel", "delta_row_scatter_kernel",
                "cluster_stats_kernel", "intra_walk_kernel",
                "population_select_kernel", "population_rank_kernel",
                "population_place_kernel", "failover_tiled_kernel",
                "failover_rows_kernel", "cell_net_flow_kernel",
                "goal_loop_kernel", "apply_bucket_kernel",
                "apply_group_kernel", "eligibility_kernel",
                "topic_bounds_kernel",
                "weight_range_kernel", "flow_priority_kernel",
                "flow_match_kernel",
                "drain_gather_kernel", "drain_keys_kernel",
                "drain_scans_kernel", "drain_take_kernel",
                "drain_rank_kernel", "drain_budget_kernel",
                "drain_scatter_kernel", "round_guards_kernel",
                "replica_priority_kernel", "topic_limits_kernel",
                "topic_range_kernel", "shortlist_kernel", "move_rows_kernel",
                "move_dest_kernel", "light_kernel", "swap_dest_kernel",
                "assemble_kernel", "top_k_kernel", "steer_kernel",
                "proposal_select_kernel", "proposal_gather_kernel",
                "violation_kernel", "interval_planes_kernel",
                "order_prep_kernel", "order_starts_kernel",
                "order_keys_kernel", "order_chunk_kernel",
                "order_merge_kernel", "lead_prep_kernel",
                "lead_starts_kernel", "lead_keys_kernel",
                "lead_chunk_kernel", "lead_merge_kernel",
                "lead_levels_kernel", "lead_scans_kernel",
                "lead_take1_kernel", "lead_take2_kernel",
                "lead_scatter_kernel")
#: kernel families summed on one line each: KM's, KP's, KN's, KO's, KQ's,
#: KR's to KAA's launches, KB's range form, and every device-to-device copy
#: (copy kernels and memcpy)
FAMILIES = (("KM apply_group", ("apply_bucket_kernel", "apply_group_kernel")),
            ("KP bulk_drain_fill", ("drain_",)),
            ("KN candidate_eligibility", ("eligibility_kernel",
                                          "topic_bounds_kernel")),
            ("KO flow_priority", ("flow_priority_kernel",)),
            ("KO flow_match", ("flow_match_kernel",)),
            ("KO replica_weight_range", ("weight_range_kernel",)),
            ("KQ round_guards", ("round_guards_kernel",)),
            ("KR replica_priority", ("replica_priority_kernel",
                                     "topic_limits_kernel",
                                     "topic_range_kernel")),
            ("KS dest_select", ("shortlist_kernel", "move_rows_kernel",
                                "move_dest_kernel", "light_kernel",
                                "swap_dest_kernel")),
            ("KT assemble_candidates", ("assemble_kernel",)),
            ("KU top_k", ("top_k_kernel",)),
            ("KV steer_dest", ("steer_kernel",)),
            ("KW proposal_select", ("proposal_select_kernel",
                                    "proposal_gather_kernel")),
            ("KX violation_rows", ("violation_kernel",)),
            ("KY interval_planes", ("interval_planes_kernel",)),
            ("KZ drain_order", ("order_prep_kernel", "order_starts_kernel",
                                "order_keys_kernel", "order_chunk_kernel",
                                "order_merge_kernel")),
            ("KAA leadership_drain", ("lead_prep_kernel",
                                      "lead_starts_kernel",
                                      "lead_keys_kernel",
                                      "lead_chunk_kernel",
                                      "lead_merge_kernel",
                                      "lead_levels_kernel",
                                      "lead_scans_kernel",
                                      "lead_take1_kernel",
                                      "lead_take2_kernel",
                                      "lead_scatter_kernel")),
            ("KB range form", ("ordered_range_sum_kernel",)),
            ("device copies", ("copy", "DtoD")))


#: the host calls the site table times: ``PassSegments``' segments, the
#: goals' methods (on every class of the catalog that defines them) and
#: KN's, KQ's, KR's to KY's wrappers
SEGMENTS = ("active", "drain", "propose", "eligibility", "round", "stack")
GOAL_METHODS = ("accepts", "delta", "collective_guard", "propose",
                "bulk_drain", "violation")


@contextlib.contextmanager
def site_ranges():
    """Put a ``record_function`` range ``cc|<pass goal>|<segment>`` around
    each ``PassSegments`` segment, ``cc||<goal>.<method>`` around each goal
    method of ``GOAL_METHODS``, ``cc||KN wrapper`` around
    ``kernels.candidate_eligibility`` and ``cc||KQ wrapper`` around
    ``kernels.round_guards``, ``cc||KV wrapper`` around
    ``kernels.steer_dest``, ``cc||KW wrapper`` around
    ``kernels.proposal_select`` and ``cc||KX wrapper`` around
    ``kernels.violation_rows`` as the engine calls them (the ``propose``
    segment's rest is its own), and ``cc||KR wrapper``, ``cc||KS
    wrapper``, ``cc||KT wrapper``, ``cc||KU wrapper`` and ``cc||KY
    wrapper`` around ``kernels.replica_priority``, ``dest_select``,
    ``assemble_candidates``, ``top_k`` and ``interval_planes`` as the
    goals call them (a tree from before a kernel has no wrapper of it to
    wrap); take them off on exit."""
    import functools
    from torch.profiler import record_function
    from cruise_control_tpu_torch.analyzer import engine, goals

    patched = []

    def wrap(owner, name, label_of):
        fn = owner.__dict__[name]

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with record_function(label_of(*args)):
                return fn(*args, **kwargs)
        setattr(owner, name, ranged)
        patched.append((owner, name, fn))

    for seg in SEGMENTS:
        wrap(engine.PassSegments, seg,
             lambda self, *a, seg=seg: f"cc|{self.goal.name}|{seg}")
    classes = [goals.GoalKernel]
    for cls in classes:
        classes.extend(cls.__subclasses__())
    for cls in classes:
        for m in GOAL_METHODS:
            if m in cls.__dict__:
                wrap(cls, m, lambda self, *a, m=m: f"cc||{self.name}.{m}")
    wrap(engine, "candidate_eligibility",
         lambda *a: "cc||KN wrapper")
    for name, label in (("round_guards", "KQ"), ("steer_dest", "KV"),
                        ("proposal_select", "KW"),
                        ("violation_rows", "KX")):
        if name in engine.__dict__:
            wrap(engine, name, lambda *a, label=label: f"cc||{label} wrapper")
    for name, label in (("replica_priority", "KR"), ("dest_select", "KS"),
                        ("assemble_candidates", "KT"), ("top_k", "KU"),
                        ("interval_planes", "KY")):
        if name in goals.__dict__:
            wrap(goals, name, lambda *a, label=label: f"cc||{label} wrapper")
    try:
        yield
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


def _op_name(name: str) -> str:
    """A device event's kernel name without its namespaces, template and
    parameters (a copy or memset keeps its own; an elementwise kernel
    keeps its functor or implementation's name)."""
    import re
    name = name.replace("(anonymous namespace)::", "")
    base = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    base = base.removeprefix("void ") or name
    if "elementwise" in base or "reduce_kernel" in base:
        what = [w for w in re.findall(
            r"(\w+(?:Functor|_impl|_kernel_cuda|Ops)\w*)", name)
            if not w.startswith("gpu_kernel")]
        if what:
            base += f" ({what[0]})"
    return base


def site_table(prof):
    """({(pass, site): [device us, device events]}, device events linked
    to no launch, {method: {kernel: [device us, device events]}} of the
    goals' ``propose`` and ``bulk_drain`` sites): every device event's time
    on the innermost
    ``site_ranges`` range open when the host launched it (its runtime
    event: a ``cu*`` call of the same correlation id, whose start is the
    launch), the pass from the outermost segment around that; events
    outside every segment go to ("-", "outside the passes")."""
    import torch
    cpu_type = torch.autograd.DeviceType.CPU
    ranges, runtime, device = [], {}, []
    for e in prof.events():
        if e.device_type != cpu_type:
            device.append(e)
        elif e.name.startswith("cc|"):
            ranges.append((e.time_range.start, e.time_range.end,
                           e.name.split("|")))
        elif e.name.startswith("cu"):
            runtime[e.id] = e.time_range.start
    table: dict = {}
    ops: dict = {"propose": {}, "bulk_drain": {}}
    unlinked = 0
    for d in device:
        t = runtime.get(d.id)
        if t is None:
            unlinked += 1
            continue
        around = sorted((r[0], r[2]) for r in ranges if r[0] <= t < r[1])
        segs = [parts for _, parts in around if parts[1]]
        if not segs:
            key = ("-", "outside the passes")
        else:
            inner = around[-1][1]
            key = (segs[0][1],
                   inner[2] if inner[1] == "" else f"segment {inner[2]}")
        method = ops.get(key[1].rsplit(".", 1)[-1])
        for cell in (table.setdefault(key, [0.0, 0]),
                     [0.0, 0] if method is None or "." not in key[1]
                     else method.setdefault(_op_name(d.name), [0.0, 0])):
            cell[0] += d.time_range.end - d.time_range.start
            cell[1] += 1
    return table, unlinked, ops


def report_sites(label, table, unlinked, ops, graph_busy_ms) -> dict:
    """Print ``label``'s site table by pass x site, by site and by pass,
    its sum beside the graph path's busy time, and the device ops of the
    goals' ``propose`` and ``bulk_drain`` sites by kernel; returns it as a
    JSON object."""
    total = sum(v[0] for v in table.values())
    events = sum(v[1] for v in table.values())
    print(f"== {label} busy time by call site (host loop, seed 1): "
          f"{total / 1e3:.3f} ms in {events} device events ({unlinked} "
          f"linked to no launch), beside the graph path's busy "
          f"{graph_busy_ms:.3f} ms")
    print("by pass x site (ms, device events):")
    for (pas, site), (us, n) in sorted(table.items(), key=lambda kv:
                                       -kv[1][0]):
        print(f"  {us / 1e3:9.3f} ms {n:7d}  {pas} | {site}")
    for label, part in (("site", 1), ("pass", 0)):
        sums: dict = {}
        for key, (us, n) in table.items():
            cell = sums.setdefault(key[part], [0.0, 0])
            cell[0] += us
            cell[1] += n
        print(f"by {label} (ms, device events):")
        for name, (us, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / 1e3:9.3f} ms {n:7d}  {name}")
    for method, by_op in ops.items():
        print(f"the goals' {method} sites by device op (ms, device "
              f"events):")
        for name, (us, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0]):
            print(f"  {us / 1e3:9.3f} ms {n:7d}  {name}")
    return {"total_ms": total / 1e3, "events": events,
            "unlinked_events": unlinked, "graph_busy_ms": graph_busy_ms,
            "sites": [{"pass": p_, "site": s_, "ms": us / 1e3, "events": n}
                      for (p_, s_), (us, n) in table.items()],
            **{f"{method}_ops": [{"op": k, "ms": us / 1e3, "events": n}
                                 for k, (us, n) in by_op.items()]
               for method, by_op in ops.items()}}


def profiled(fn):
    """(result, profiler, wall seconds) of one call that ends in a device
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    return out, prof, wall_s


def report(label, prof, wall_s, top, head):
    """Print one profiled run's breakdown; its device busy ms, or None when
    the profiler saw no device time."""
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import graph_loop
    graph_loop.settle()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    busy_us = _union_us(intervals)
    by_name: dict[str, list[float]] = {}
    for e in device_events:
        by_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    total_us = sum(sum(v) for v in by_name.values())
    print(f"== {label}")
    print(f"wall {wall_s:.4f} s, {head}device events {len(device_events)}, "
          f"hand-written launches {json.dumps(kernels.LAUNCHES)}")
    if not device_events:
        print("torch.profiler recorded no device time on this machine")
        return None
    idle = 1.0 - busy_us / (wall_s * 1e6)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_s * 1e3:.1f} ms "
          f"wall: idle share {idle:.4f}; summed kernel time "
          f"{total_us / 1e3:.3f} ms; mean event "
          f"{total_us / len(device_events):.2f} us")
    d2h = sum(len(v) for n, v in by_name.items() if "DtoH" in n)
    print(f"device-to-host copies {d2h}; KL (graph loop tests) "
          f"{sum(len(v) for n, v in by_name.items() if 'goal_loop' in n)}")
    print("top kernels by device time (ms, launches, mean us):")
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, times in rows[:top]:
        print(f"  {sum(times) / 1e3:9.3f} ms {len(times):7d} "
              f"{sum(times) / len(times):8.2f} us  {name[:90]}")
    for k in HAND_WRITTEN:
        us = sum(sum(v) for n, v in by_name.items() if k in n)
        if us:
            print(f"  hand-written {k}: {us / 1e3:.3f} ms "
                  f"({us / max(total_us, 1e-9):.2%} of kernel time)")
    for family, keys in FAMILIES:
        hits = [v for n, v in by_name.items() if any(k in n for k in keys)]
        us = sum(sum(v) for v in hits)
        print(f"  family {family}: {us / 1e3:.3f} ms, "
              f"{sum(len(v) for v in hits)} launches")
    return busy_us / 1e3


def profile_default_chain(label, model, md, search, seed, top):
    """The default chain (``goals=None``) on ``model`` under ``search``:
    warm walls and one profiled optimize (seed ``seed``) with its goal
    passes as CUDA graphs, then the same driven by host loops with a
    range around every call site; returns the site table (None when the
    profiler saw no device time)."""
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import (OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer, engine)
    graph_busy_ms = None
    for loop in ("auto", "host"):
        name = "CUDA graphs" if loop == "auto" else "host loop"
        dopt = TorchGoalOptimizer(config=SearchConfig(**search),
                                  device="cuda", goal_loop=loop)
        dopt.optimize(model, md, OptimizationOptions(seed=seed))
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            dopt.optimize(model, md, OptimizationOptions(seed=seed))
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        print(f"{label}, {name}: warm walls "
              f"{[round(w, 4) for w in walls]} s")
        kernels.reset_launch_counts()
        syncs0 = engine.HOST_SYNCS
        out, prof, wall_s = profiled(
            lambda: dopt.optimize(model, md, OptimizationOptions(seed=seed)))
        busy = report(f"{label} optimize (seed {seed}), {name}", prof,
                      wall_s, top, f"moves {out.num_moves}, host "
                      f"syncs {engine.HOST_SYNCS - syncs0}, ")
        if busy is None:
            return None
        if loop == "auto":
            graph_busy_ms = busy
            continue
        # the same warm optimize with a range around every call site
        with site_ranges():
            out, prof, wall_s = profiled(
                lambda: dopt.optimize(model, md,
                                      OptimizationOptions(seed=seed)))
        print(f"{label} with site ranges, host loop: wall {wall_s:.4f} s, "
              f"moves {out.num_moves}")
        return report_sites(label, *site_table(prof), graph_busy_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write a Chrome trace to this path")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--only", choices=("all", "main", "default-chain",
                                       "scale-default-chain"),
                    default="all", help="main, default-chain, "
                    "scale-default-chain (1K x 200K under bench scale "
                    "scenario 3's search, seed 0; only with this choice): "
                    "only that chain's optimizes and its site table")
    ap.add_argument("--sites", help="write the site tables as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2

    import chip_smoke
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.model.spec import flatten_spec

    card = chip_smoke.phase_environment()
    # CUPTI traces the nodes of a CUDA graph instantiated after it was
    # started: start it before any goal chain builds its graphs
    chip_smoke.start_profiler()
    model, md = flatten_spec(chip_smoke.build_spec(), device="cuda")
    print(f"card: {card}")
    res = None
    tables = {}
    for loop in ("auto", "host") if args.only in ("all", "main") else ():
        # the goal passes as CUDA graphs ("auto"), then their host-driven
        # twin, in the same process
        name = "CUDA graphs" if loop == "auto" else "host loop"
        opt = chip_smoke.main_path_optimizer(loop)
        t0 = time.monotonic()
        opt.optimize(model, md, chip_smoke.main_path_options(0))
        torch.cuda.synchronize()
        cold_s = time.monotonic() - t0
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            opt.optimize(model, md, chip_smoke.main_path_options(1))
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        print(f"main path, {name}: cold optimize {cold_s:.4f} s, warm "
              f"walls {[round(w, 4) for w in walls]} s")
        kernels.reset_launch_counts()
        syncs0 = engine.HOST_SYNCS
        out, prof, wall_s = profiled(
            lambda: opt.optimize(model, md, chip_smoke.main_path_options(1)))
        res = res or out
        busy = report(f"optimize (seed 1), {name}", prof, wall_s, args.top,
                      f"moves {out.num_moves}, proposals "
                      f"{len(out.proposals)}, host syncs "
                      f"{engine.HOST_SYNCS - syncs0}, ")
        if busy is None:
            return 1
        if args.trace and loop == "auto":
            prof.export_chrome_trace(args.trace)
            print(f"trace written to {args.trace}")
        if loop == "auto":
            main_busy_ms = busy
            continue
        with site_ranges():
            out, prof, wall_s = profiled(
                lambda: opt.optimize(model, md,
                                     chip_smoke.main_path_options(1)))
        print(f"main path with site ranges, host loop: wall {wall_s:.4f} s, "
              f"moves {out.num_moves}")
        tables["main path"] = report_sites("main path", *site_table(prof),
                                           main_busy_ms)

    if args.only in ("all", "default-chain"):
        tables["default chain"] = profile_default_chain(
            "default chain", model, md, chip_smoke.MAIN_SEARCH, 1, args.top)
    if args.only == "scale-default-chain":
        scale_model, scale_md = chip_smoke.build_flat_direct(1000, 200_000, 2,
                                                             seed=42)
        tables["scale default chain"] = profile_default_chain(
            "scale default chain", scale_model, scale_md,
            chip_smoke.SCALE3_SEARCH, 0, args.top)
    if None in tables.values():
        return 1
    if args.sites:
        with open(args.sites, "w") as f:
            json.dump(tables, f, indent=1)
        print(f"site tables written to {args.sites}")
    if args.only != "all":
        return 0
    opt = chip_smoke.main_path_optimizer()
    opt.optimize(model, md, chip_smoke.main_path_options(0))

    from cruise_control_tpu_torch.analyzer import goals_by_name
    from cruise_control_tpu_torch.executor import (
        ConcurrencyConfig, DeviceMoveScheduler, ExecutionConcurrencyManager)
    from cruise_control_tpu_torch.whatif import (WhatIfEngine,
                                                 alive_broker_ids, n1_sweep)
    whatif = WhatIfEngine(goals=goals_by_name(chip_smoke.GOALS),
                          device="cuda")
    scenarios = n1_sweep(alive_broker_ids(model, md))
    whatif.sweep(model, md, scenarios)
    kernels.reset_launch_counts()
    _, prof, wall_s = profiled(lambda: whatif.sweep(model, md, scenarios))
    report(f"warm what-if N-1 sweep (S={len(scenarios)})", prof, wall_s,
           args.top, "")

    goals = opt._audit_goals_for([], md, chip_smoke.main_path_options(1))
    ctx = chip_smoke.schedule_context(model, md, res.proposals)
    scheduler = DeviceMoveScheduler(device="cuda")

    def schedule():
        return scheduler.schedule(
            res.proposals, ExecutionConcurrencyManager(ConcurrencyConfig()),
            model=model, metadata=md, goals=goals,
            capacity_threshold=opt.constraint.capacity_threshold,
            strategy_context=ctx)
    schedule()
    kernels.reset_launch_counts()
    sched, prof, wall_s = profiled(schedule)
    report(f"schedule of the seed-1 proposals ({sched.num_moves} moves, "
           f"{len(sched.batches)} batches)", prof, wall_s, args.top,
           f"first fit {scheduler.last_timings['assign_s']:.4f} s, audit "
           f"{scheduler.last_timings['audit_s']:.4f} s, ")

    from cruise_control_tpu_torch.model.stats import stats_summary
    pkg = chip_smoke.port_package()
    _sim, monitor, keys, vals, ingest, now_ms = chip_smoke.served_setup(
        pkg, chip_smoke.build_spec())
    ingest(vals, chip_smoke.SERVED_WINDOWS + 1)
    monitor.cluster_model(now_ms())
    monitor.resident.warmup()
    for c in range(2):                  # one warm cycle, then the profiled
        vals = vals.copy()
        vals[:len(keys) // 100] += 1.0 + c
        ingest(vals, 2)
        if c == 0:
            monitor.cluster_model(now_ms())
    kernels.reset_launch_counts()
    served, prof, wall_s = profiled(lambda: monitor.cluster_model(now_ms()))
    resident = monitor.resident
    report(f"warm monitor cycle ({resident.last_update}, "
           f"{resident.last_delta_rows} rows, {resident.last_delta_bytes} "
           f"bytes)", prof, wall_s, args.top, "")
    stats_summary(served.model, device="cuda")
    kernels.reset_launch_counts()
    _, prof, wall_s = profiled(
        lambda: stats_summary(served.model, device="cuda"))
    report("stats_summary of the resident model", prof, wall_s, args.top, "")

    search = chip_smoke.port_search_package()
    pop_opt = search.optimizer(population=search.PopulationConfig(
        **chip_smoke.SEARCH_POPULATION))
    search.optimize(pop_opt, model, md)
    kernels.reset_launch_counts()
    syncs0 = engine.HOST_SYNCS
    pop, prof, wall_s = profiled(lambda: search.optimize(pop_opt, model, md))
    report(f"warm population optimize (K="
           f"{chip_smoke.SEARCH_POPULATION['size']}, seed "
           f"{chip_smoke.SEARCH_SEED})", prof, wall_s, args.top,
           f"moves {pop.num_moves}, winner "
           f"{pop.telemetry['population']['winner']}, host syncs "
           f"{engine.HOST_SYNCS - syncs0}, ")

    setup = chip_smoke.intra_setup(search, chip_smoke.build_spec())
    search.intra_broker_rebalance(*setup)
    kernels.reset_launch_counts()
    intra, prof, wall_s = profiled(
        lambda: search.intra_broker_rebalance(*setup))
    report(f"intra-broker rebalance ({len(intra.moves)} moves, "
           f"{intra.iterations} iterations)", prof, wall_s, args.top, "")

    import numpy as np
    fleet_pkg = chip_smoke.port_fleet_package()
    members = [(f"cluster-{c:02d}",
                fleet_pkg.scale_loads(model, np.float32(1.0 + 0.01 * c)), md)
               for c in range(chip_smoke.FLEET_CLUSTERS)]
    fleet = fleet_pkg.stack(members)
    part = fleet_pkg.stack(members[:chip_smoke.FLEET_FORECAST_CLUSTERS])
    fo = fleet_pkg.fleet_optimizer()
    fo.propose(part, fleet_pkg.fleet_options())
    kernels.reset_launch_counts()
    syncs0 = engine.HOST_SYNCS
    out, prof, wall_s = profiled(
        lambda: fo.propose(part, fleet_pkg.fleet_options()))
    report(f"warm fleet propose ({part.num_clusters} members)", prof,
           wall_s, args.top,
           f"moves {[r.num_moves for r in out]}, host syncs "
           f"{engine.HOST_SYNCS - syncs0}, ")
    fo.sweep_n1(fleet)
    kernels.reset_launch_counts()
    _, prof, wall_s = profiled(lambda: fo.sweep_n1(fleet))
    report(f"warm fleet N-1 sweep ({fleet.num_clusters} x "
           f"{chip_smoke.NUM_BROKERS} scenarios)", prof, wall_s, args.top, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
