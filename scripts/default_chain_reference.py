#!/usr/bin/env python3
"""Compute ``chip_smoke.py``'s phase-13 constants (``REFERENCE_DEFAULT``,
``REFERENCE_DEFAULT_N1``, ``REFERENCE_PARTB``) with the JAX package on the
CPU: ``chip_smoke.default_chain_main`` and ``default_chain_rest`` driven
through ``cruise_control_tpu`` from the same inputs the smoke gives the
port — the main-path cluster under the reference's default chain (two
seed-1 optimizes, nothing waived), its N-1 sweep with the default goals,
and the cluster in ten broker sets under the catalog's part-B chain and
the kafka-assigner set.

    JAX_PLATFORMS=cpu python3 scripts/default_chain_reference.py

Prints the constants (the two seed-1 optimizes' outcomes must be equal:
``_REFERENCE_DEFAULT_RUN``) as Python assignments to paste into
``chip_smoke.py``, and the CPU seconds each part took (the default chain
compiles sixteen goal passes).
"""

from __future__ import annotations

import os
import pathlib
import sys
import time
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def jax_default_package():
    """Phase 13's view of the JAX package."""
    from cruise_control_tpu.analyzer import (BalancingConstraint,
                                             OptimizationFailureError,
                                             OptimizationOptions,
                                             SearchConfig, TpuGoalOptimizer,
                                             goals_by_name)
    from cruise_control_tpu.analyzer.goals import KAFKA_ASSIGNER_GOALS
    from cruise_control_tpu.model.spec import flatten_spec
    from cruise_control_tpu.whatif import (WhatIfEngine, alive_broker_ids,
                                           n1_sweep)
    return types.SimpleNamespace(
        flatten_spec=flatten_spec,
        optimizer=lambda goals, cst, search: TpuGoalOptimizer(
            goals=goals, constraint=cst, config=SearchConfig(**search)),
        options=lambda seed: OptimizationOptions(seed=seed),
        OptimizationFailureError=OptimizationFailureError,
        BalancingConstraint=BalancingConstraint, goals_by_name=goals_by_name,
        KAFKA_ASSIGNER_GOALS=KAFKA_ASSIGNER_GOALS,
        whatif=WhatIfEngine, n1_sweep=n1_sweep,
        alive_broker_ids=alive_broker_ids, sync=lambda: None,
        measure=lambda fn: fn(), launches=[])


def main() -> int:
    t0 = time.monotonic()
    pkg = jax_default_package()
    model, md = pkg.flatten_spec(chip_smoke.build_spec())
    main_runs = chip_smoke.default_chain_main(pkg, model, md)
    rest = chip_smoke.default_chain_rest(pkg, model, md)
    first = main_runs["a"][0]
    assert all(run == first for run in main_runs["a"])
    print(f"_REFERENCE_DEFAULT_RUN = {first!r}")
    print(f"REFERENCE_DEFAULT_N1 = {rest['c']!r}")
    print(f"REFERENCE_PARTB = {rest['d']!r}")
    walls = rest["walls"]
    print(f"# CPU seconds: optimizes "
          f"{[round(w, 1) for w in main_runs['walls']]}, N-1 "
          f"{walls['n1']:.1f}, part B {walls['partb']:.1f}, kafka-assigner "
          f"{walls['kafka_assigner']:.1f}, all {time.monotonic() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
