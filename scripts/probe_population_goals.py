"""Run the whole population program of both packages at G goals and say
whether the port's outputs equal the reference's bit for bit: the walk
boundaries, polish rows, moves, survivor permutations, Pareto ranks and
weighted scores of ``parallel/population.py:run`` (the reference's
compiled program, where the weighted row is fused beside the walks) and
of the port's ``make_population_search`` on the CPU, where KI takes its
plain twin.

The chain repeats DiskCapacityGoal, ReplicaDistributionGoal and
DiskUsageDistributionGoal up to G goals (a user may list a goal more than
once), with a DISK threshold below the mean disk load so that the hard
goal keeps a residual and the weighted scores differ from zero; the
cluster is ``tests/torch_parity_util.build_both(12, 240, seed=3)``, the
population 4 plans. The reference's program takes minutes to compile on
the CPU past 20 goals, so this is a probe and not a tier-1 test. The
port runs first, so a goal count it refuses (23-32) raises at once.
Prints one line an output and the seconds each side took; exits 1 on
any difference:

    JAX_PLATFORMS=cpu python scripts/probe_population_goals.py G [G ...]
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cruise_control_tpu.analyzer as ja  # noqa: E402
import cruise_control_tpu_torch.analyzer as ta  # noqa: E402
from cruise_control_tpu_torch import _random  # noqa: E402
from cruise_control_tpu_torch.parallel import (  # noqa: E402
    make_population_search)
from torch_parity_util import build_both  # noqa: E402

CFG = dict(num_replica_candidates=8, num_dest_candidates=2,
           num_swap_candidates=0, apply_per_iter=4, max_iters_per_goal=1,
           drain_rounds=0, polish_passes=1, stall_patience=1)
BASE = ["DiskCapacityGoal", "ReplicaDistributionGoal",
        "DiskUsageDistributionGoal"]
CONSTRAINT = dict(capacity_threshold=(0.7, 0.8, 0.8, 0.0035))
OPTS = dict(seed=5, skip_hard_goal_check=True)
NAMES = ("iters", "walk_bounds", "polish_rows", "moves", "accepted",
         "perms", "ranks", "weighted")


def probe(G: int, models) -> bool:
    goals = [BASE[i % 3] for i in range(G)]
    (jm, jmd), (tm, tmd) = models
    pop = dict(size=4, objective="weighted")
    jc = ja.BalancingConstraint(**CONSTRAINT)
    tc = ta.BalancingConstraint(**CONSTRAINT)
    jopt = ja.TpuGoalOptimizer(
        goals=ja.goals_by_name(goals, jc), constraint=jc,
        config=ja.SearchConfig(**CFG), population=ja.PopulationConfig(**pop))
    topt = ta.TorchGoalOptimizer(
        goals=ta.goals_by_name(goals, tc), constraint=tc,
        config=ta.SearchConfig(**CFG), population=ta.PopulationConfig(**pop),
        device="cpu")
    t0 = time.perf_counter()
    tcfg, tgoals, tchain, tctx, tstate, _ = topt._prepare(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    got = make_population_search(tchain.passes, tgoals, tcfg,
                                 topt.population)(
        tstate, tctx, _random.PRNGKey(OPTS["seed"], device="cpu"))
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    jcfg, jgoals, jchain, jctx, jstate, _ = jopt._prepare(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    jrun, _, _, K = jopt._population_run_for(jcfg, jgoals, jchain)
    want = jax.block_until_ready(jrun(jstate, jctx,
                                      jax.random.PRNGKey(OPTS["seed"])))
    t_ref = time.perf_counter() - t0
    print(f"G={G} K={K}: reference {t_ref:.1f} s (compile included), "
          f"port {t_port:.1f} s", flush=True)
    same = True
    for name, t, j in zip(NAMES, got[2:], want[2:]):
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        j = np.asarray(j)
        eq = t.shape == j.shape and bool(np.array_equal(t, j,
                                                        equal_nan=True))
        same &= eq
        extra = ""
        if name == "weighted":
            extra = f" {j.tolist()}"
        elif not eq and t.shape == j.shape:
            bad = np.argwhere(~((t == j) | (np.isnan(t) & np.isnan(j))))
            extra = f" {len(bad)} differ, first at {bad[0].tolist()}"
        print(f"  {name}: {'equal' if eq else 'DIFFERS'}{extra}", flush=True)
    return same


def main() -> int:
    torch.set_num_threads(1)
    counts = [int(a) for a in sys.argv[1:]] or [33]
    models = build_both(12, 240, seed=3)
    ok = [probe(G, models) for G in counts]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
