#!/usr/bin/env python3
"""Compute ``chip_smoke.py``'s ``REFERENCE_SERVED_*`` constants with the JAX
package on the CPU: phase 9's served cycle (``chip_smoke.served_cycle``)
driven through ``cruise_control_tpu``'s monitor, resident state, optimizer
and ``stats_summary`` from the same inputs the smoke gives the port.

    JAX_PLATFORMS=cpu python3 scripts/served_reference.py

Prints the constants as Python assignments to paste into ``chip_smoke.py``
(a few minutes on the CPU: the two optimizes compile the goal chain).
"""

from __future__ import annotations

import json
import pathlib
import sys
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def jax_package(search=chip_smoke.MAIN_SEARCH):
    """``served_cycle``'s view of the JAX package, optimizing with the
    search config ``search``."""
    from cruise_control_tpu.analyzer import (OptimizationOptions,
                                             SearchConfig, TpuGoalOptimizer,
                                             goals_by_name)
    from cruise_control_tpu.config import FixedCapacityResolver
    from cruise_control_tpu.core.metricdef import partition_metric_def
    from cruise_control_tpu.core.resources import Resource
    from cruise_control_tpu.core.runtime_obs import default_collector
    from cruise_control_tpu.core.tracing import default_tracer
    from cruise_control_tpu.executor import SimulatedKafkaCluster
    from cruise_control_tpu.model.stats import stats_summary
    from cruise_control_tpu.monitor import LoadMonitor, MonitorConfig
    opt = TpuGoalOptimizer(goals=goals_by_name(chip_smoke.GOALS),
                           config=SearchConfig(**search))
    return types.SimpleNamespace(
        SimulatedKafkaCluster=SimulatedKafkaCluster, Resource=Resource,
        FixedCapacityResolver=FixedCapacityResolver,
        MonitorConfig=MonitorConfig,
        partition_metric_def=partition_metric_def,
        make_monitor=lambda sim, cfg, **kw: LoadMonitor(sim, cfg, **kw),
        collector=default_collector(), tracer=default_tracer(),
        sync=lambda: None,
        planes=lambda m: (np.asarray(m.leader_load),
                          np.asarray(m.follower_load)),
        replica_broker=lambda m: np.asarray(m.replica_broker),
        stats_summary=stats_summary,
        optimize=lambda m, md, seed: opt.optimize(m, md, OptimizationOptions(
            seed=seed, waived_hard_goals=chip_smoke.WAIVED)))


def main() -> int:
    out = chip_smoke.served_cycle(jax_package(), chip_smoke.build_spec())
    for c in out["cycles"]:
        assert c["update"] == "delta" and c["epoch"] == 1, c
    o, d = out["optimize"], out["drain"]
    print(f"REFERENCE_SERVED_PLANES = "
          f"{[c['planes'] for c in out['cycles']]!r}")
    print(f"REFERENCE_SERVED_STATS = dict("
          f"before={chip_smoke._json_sha(out['stats_before'])!r}, "
          f"after={chip_smoke._json_sha(out['stats_after'])!r})")
    print(f"REFERENCE_SERVED_OPTIMIZE = dict(moves={o['moves']}, "
          f"proposals={o['proposals']}, digest={o['digest']!r})")
    print(f"REFERENCE_SERVED_DRAIN = dict(moves={d['moves']}, "
          f"proposals={d['proposals']}, left={d['left']}, "
          f"audit_ok={d['audit_ok']})")
    print("# upload bytes: full", out["cold"]["bytes"], "delta per cycle",
          [c["bytes"] for c in out["cycles"]])
    print("# stats before:", json.dumps(out["stats_before"]))
    print("# optimize satisfied:", o["satisfied"], "audit ok:",
          o["audit_ok"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
