#!/usr/bin/env python3
"""Where the time goes on the port's paths, on one CUDA card.

Builds the 100-broker x 20K-partition cluster of ``chip_smoke.py`` and its
main-path optimizer, runs one warm-up optimize (seed 0), then profiles with
``torch.profiler``, one after the other:

- one optimize (seed 1), the main path;
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
  the engine's loop tests);
- device busy time (the union of CUDA kernel and memcpy intervals) and the
  device's idle share of the wall time;
- the top kernels by total device time, with their launch counts;
- the hand-written kernels' share of the device time.

Run from the repository root:

    python3 profile_main_path.py [--trace main_path_trace.json]

The Chrome trace (of the optimize) runs to several tens of MiB.
"""

from __future__ import annotations

import argparse
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


HAND_WRITTEN = ("threefry2x32_kernel", "ordered_segment_sum_kernel",
                "net_broker_flow_kernel", "scenario_failover_kernel",
                "first_fit_kernel", "delta_row_scatter_kernel",
                "cluster_stats_kernel", "intra_walk_kernel",
                "population_select_kernel", "fleet_failover_kernel")


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


def report(label, prof, wall_s, top, head) -> bool:
    """Print one profiled run's breakdown; False when the profiler saw no
    device time."""
    import torch
    from cruise_control_tpu_torch import kernels
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
        return False
    idle = 1.0 - busy_us / (wall_s * 1e6)
    print(f"device busy {busy_us / 1e3:.3f} ms of {wall_s * 1e3:.1f} ms "
          f"wall: idle share {idle:.4f}; summed kernel time "
          f"{total_us / 1e3:.3f} ms; mean event "
          f"{total_us / len(device_events):.2f} us")
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
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write a Chrome trace to this path")
    ap.add_argument("--top", type=int, default=15)
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
    model, md = flatten_spec(chip_smoke.build_spec(), device="cuda")
    opt = chip_smoke.main_path_optimizer()
    opt.optimize(model, md, chip_smoke.main_path_options(0))
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    syncs0 = engine.HOST_SYNCS
    res, prof, wall_s = profiled(
        lambda: opt.optimize(model, md, chip_smoke.main_path_options(1)))
    print(f"card: {card}")
    if not report("optimize (seed 1)", prof, wall_s, args.top,
                  f"moves {res.num_moves}, proposals {len(res.proposals)}, "
                  f"host syncs {engine.HOST_SYNCS - syncs0}, "):
        return 1
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")

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
