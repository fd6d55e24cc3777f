#!/usr/bin/env python3
"""Compute ``chip_smoke.py``'s ``REFERENCE_FLEET`` constants with the JAX
package on the CPU: phase 12's fleet propose of bench scenario 6's 16
members, their N-1 sweep and the trajectory sweep of four of them
(``chip_smoke.fleet_runs``), driven through ``cruise_control_tpu`` from the
same inputs the smoke gives the port, with every cluster on one device
(``max_devices=1``: the port's layout, ``lax.map`` over the clusters).

    JAX_PLATFORMS=cpu python3 scripts/fleet_reference.py

Prints the constants as a Python assignment to paste into
``chip_smoke.py``, then the CPU seconds each step took.
"""

from __future__ import annotations

import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def jax_fleet_package():
    """``fleet_runs``' view of the JAX package."""
    import jax.numpy as jnp
    from cruise_control_tpu.analyzer import (OptimizationOptions,
                                             SearchConfig, TpuGoalOptimizer,
                                             goals_by_name)
    from cruise_control_tpu.core.runtime_obs import default_collector
    from cruise_control_tpu.fleet import FleetModel, FleetOptimizer
    from cruise_control_tpu.whatif import TrajectoryScale

    def scale_loads(model, f):
        f = jnp.float32(f)
        return model.replace(leader_load=model.leader_load * f,
                             follower_load=model.follower_load * f)

    return types.SimpleNamespace(
        scale_loads=scale_loads, stack=FleetModel.stack,
        fleet_optimizer=lambda: FleetOptimizer(TpuGoalOptimizer(
            goals=goals_by_name(chip_smoke.GOALS),
            config=SearchConfig(**chip_smoke.FLEET_SEARCH)), max_devices=1),
        fleet_options=lambda: OptimizationOptions(
            seed=chip_smoke.FLEET_SEED, skip_hard_goal_check=True),
        TrajectoryScale=TrajectoryScale, collector=default_collector(),
        sync=lambda: None, host_syncs=lambda: 0, kj_launches=lambda: 0)


def main() -> int:
    from cruise_control_tpu.model.spec import flatten_spec
    t0 = time.monotonic()
    model, md = flatten_spec(chip_smoke.build_spec())
    out = chip_smoke.fleet_runs(jax_fleet_package(), model, md)
    got = dict(members=out["members"], n1=out["n1"],
               trajectories=out["trajectories"])
    print(f"REFERENCE_FLEET = {got!r}")
    print(f"# N-1 summaries: {out['n1_summaries']!r}")
    print(f"# CPU seconds: propose {out['cold_wall']:.1f}, N-1 sweep "
          f"{out['n1_wall']:.1f}, trajectory sweep {out['traj_wall']:.1f}, "
          f"all {time.monotonic() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
