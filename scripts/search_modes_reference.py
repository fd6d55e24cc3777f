#!/usr/bin/env python3
"""Compute ``chip_smoke.py``'s ``REFERENCE_SEARCH`` and ``REFERENCE_INTRA``
constants with the JAX package on the CPU: phase 10's search modes
(``chip_smoke.search_modes``: the per-goal sequential walk, populations of
1 and 4, four branches) and phase 11's intra-broker rebalances
(``chip_smoke.intra_rebalances``) driven through ``cruise_control_tpu``
from the same inputs the smoke gives the port.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python3 scripts/search_modes_reference.py

The branches need four devices, hence the flag. Prints the constants as
Python assignments to paste into ``chip_smoke.py`` (several minutes on the
CPU: each search mode compiles its own program).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def jax_search_package():
    """``search_modes``' and ``intra_rebalances``' view of the JAX
    package."""
    import jax
    from cruise_control_tpu.analyzer import (OptimizationOptions,
                                             PopulationConfig, SearchConfig,
                                             TpuGoalOptimizer, goals_by_name)
    from cruise_control_tpu.analyzer.intra import intra_broker_rebalance
    from cruise_control_tpu.config import FixedCapacityResolver
    from cruise_control_tpu.core.resources import Resource
    from cruise_control_tpu.executor import SimulatedKafkaCluster
    from cruise_control_tpu.model.spec import flatten_spec
    from cruise_control_tpu.parallel.branches import select_best_audited

    def options():
        return OptimizationOptions(seed=chip_smoke.SEARCH_SEED,
                                   waived_hard_goals=chip_smoke.WAIVED)

    def branch_program(opt, model, md):
        cfg, goals, _chain, ctx, state, audit = opt._prepare(model, md,
                                                             options())
        states, viols = opt._branched_run_for(cfg, goals)(
            state, ctx, jax.random.PRNGKey(chip_smoke.SEARCH_SEED))
        audit_fn = opt._audit_fn_for(audit)
        _, best, _ = select_best_audited(states, viols,
                                         lambda s: audit_fn(s, ctx))
        return np.asarray(viols), int(best)

    return types.SimpleNamespace(
        PopulationConfig=PopulationConfig,
        optimizer=lambda **kw: TpuGoalOptimizer(
            goals=goals_by_name(chip_smoke.GOALS),
            config=SearchConfig(**chip_smoke.SEARCH_MODES), **kw),
        optimize=lambda opt, model, md: opt.optimize(model, md, options()),
        branch_program=branch_program, sync=lambda: None,
        host_syncs=lambda: 0,
        SimulatedKafkaCluster=SimulatedKafkaCluster, Resource=Resource,
        FixedCapacityResolver=FixedCapacityResolver,
        flatten_spec=flatten_spec,
        intra_broker_rebalance=intra_broker_rebalance)


def main() -> int:
    import jax
    if len(jax.devices()) < chip_smoke.SEARCH_BRANCHES:
        print(f"needs {chip_smoke.SEARCH_BRANCHES} devices: set XLA_FLAGS="
              f"--xla_force_host_platform_device_count="
              f"{chip_smoke.SEARCH_BRANCHES}", file=sys.stderr)
        return 2
    pkg = jax_search_package()
    spec = chip_smoke.build_spec()
    t0 = time.monotonic()
    intra = chip_smoke.intra_rebalances(pkg,
                                        chip_smoke.intra_setup(pkg, spec))
    t1 = time.monotonic()
    model, md = pkg.flatten_spec(spec)
    search = chip_smoke.search_modes(pkg, model, md)
    t2 = time.monotonic()
    got = dict(sequential=search["sequential"],
               population=search["population"], branches=search["branches"])
    print(f"REFERENCE_SEARCH = {got!r}")
    print(f"REFERENCE_INTRA = "
          f"{dict(rebalance=intra['rebalance'], drain=intra['drain'])!r}")
    print("# branch stacks:", json.dumps(search["branch_stacks"]))
    print("# K=1 equals the sequential walk:",
          search["k1"]["digest"] == search["sequential"]["digest"],
          "population chain satisfied:", search["population_satisfied"])
    print("# intra goal summaries:", json.dumps(intra["rebalance_summary"]),
          json.dumps(intra["drain_summary"]))
    print(f"# CPU seconds: intra {t1 - t0:.1f}, search modes {t2 - t1:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
