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
port runs first, so a goal count it refuses raises at once. Prints one
line an output and the seconds each side took; exits 1 on any
difference:

    JAX_PLATFORMS=cpu python scripts/probe_population_goals.py \
        [--hard] [--plans K] [--move-weight W] G [G ...]

``--hard`` takes the all-hard chain instead: DiskCapacityGoal,
NetworkInboundCapacityGoal, NetworkOutboundCapacityGoal and
CpuCapacityGoal repeated to G goals, every capacity threshold below the
load, so every goal keeps a residual weighted by ``hard_weight``. With
every weight equal, the weighted row at up to 22 goals may round each
product or contract it into the running sum (an FMA); ``hard_weight``
(1000) is not a power of two, so the two forms can part there. Before the
reference runs, the probe scores the port's run both ways
(:func:`contraction_differs`) and exits 2 if the two forms agree, since
such a run cannot tell which form the reference computes. ``--soft``
takes ReplicaDistributionGoal and DiskUsageDistributionGoal repeated to
G: every weight 1.
"""

from __future__ import annotations

import argparse
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
from cruise_control_tpu_torch.analyzer import engine as teng  # noqa: E402
from cruise_control_tpu_torch.utils.ordered import fma  # noqa: E402
from cruise_control_tpu_torch.parallel import (  # noqa: E402
    make_population_search)
from torch_parity_util import build_both  # noqa: E402

CFG = dict(num_replica_candidates=8, num_dest_candidates=2,
           num_swap_candidates=0, apply_per_iter=4, max_iters_per_goal=1,
           drain_rounds=0, polish_passes=1, stall_patience=1)
BASE = ["DiskCapacityGoal", "ReplicaDistributionGoal",
        "DiskUsageDistributionGoal"]
CONSTRAINT = dict(capacity_threshold=(0.7, 0.8, 0.8, 0.0035))
HARD = ["DiskCapacityGoal", "NetworkInboundCapacityGoal",
        "NetworkOutboundCapacityGoal", "CpuCapacityGoal"]
HARD_CONSTRAINT = dict(capacity_threshold=(0.003, 0.003, 0.003, 0.0035))
SOFT = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
#: chain -> (goals repeated to G, constraint)
CHAINS = {"mixed": (BASE, CONSTRAINT), "hard": (HARD, HARD_CONSTRAINT),
          "soft": (SOFT, CONSTRAINT)}
OPTS = dict(seed=5, skip_hard_goal_check=True)
NAMES = ("iters", "walk_bounds", "polish_rows", "moves", "accepted",
         "perms", "ranks", "weighted")


def contraction_differs(got, hard_weight: float) -> list:
    """The scorings of one port population run (each generation boundary
    and the final scores) where the weighted row in goal order differs
    between its two forms: every product rounded on its own, and every
    product contracted into the running sum. ``got`` is
    ``make_population_search``'s output; an empty list means the run
    cannot tell the forms apart."""
    _states, aux, _iters, wb, polish_rows, *_ = got
    scales = aux[1]
    G = scales.shape[0]
    rows = [("walk end", wb[:, -1, :])] + [
        (f"polish {r}", row) for r, row in enumerate(polish_rows)]
    rows[-1] = ("final", rows[-1][1])
    w = torch.full((G,), hard_weight, dtype=torch.float32)
    differs = []
    for site, row in rows:
        norm = teng.normalized_stacks(torch.as_tensor(row), scales,
                                      contract=True)
        rounded = contracted = norm.new_zeros(norm.shape[0])
        for g in range(G):
            rounded = rounded + norm[:, g] * w[g]
            contracted = fma(norm[:, g], w[g], contracted)
        if not torch.equal(rounded, contracted):
            differs.append(site)
    return differs


def optimizers(G: int, chain: str = "mixed", plans: int = 4,
               move_weight: float = 0.0):
    """(reference, port) optimizers of one of ``CHAINS`` at G goals."""
    base, cst = CHAINS[chain]
    goals = [base[i % len(base)] for i in range(G)]
    pop = dict(size=plans, objective="weighted", move_weight=move_weight)
    jc = ja.BalancingConstraint(**cst)
    tc = ta.BalancingConstraint(**cst)
    jopt = ja.TpuGoalOptimizer(
        goals=ja.goals_by_name(goals, jc), constraint=jc,
        config=ja.SearchConfig(**CFG), population=ja.PopulationConfig(**pop))
    topt = ta.TorchGoalOptimizer(
        goals=ta.goals_by_name(goals, tc), constraint=tc,
        config=ta.SearchConfig(**CFG), population=ta.PopulationConfig(**pop),
        device="cpu")
    return jopt, topt


def run_port(topt, tm, tmd):
    """The port's population program on the CPU (KI's twin)."""
    tcfg, tgoals, tchain, tctx, tstate, _ = topt._prepare(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    return make_population_search(tchain.passes, tgoals, tcfg,
                                  topt.population)(
        tstate, tctx, _random.PRNGKey(OPTS["seed"], device="cpu"))


def run_reference(jopt, jm, jmd):
    """The reference's compiled population program; (outputs, K)."""
    jcfg, jgoals, jchain, jctx, jstate, _ = jopt._prepare(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    jrun, _, _, K = jopt._population_run_for(jcfg, jgoals, jchain)
    return jax.block_until_ready(
        jrun(jstate, jctx, jax.random.PRNGKey(OPTS["seed"]))), K


def probe(G: int, models, chain: str = "mixed", plans: int = 4,
          move_weight: float = 0.0) -> int:
    """0 if every output is equal, 1 if one differs, 2 if an all-hard run
    cannot tell the row's two forms apart."""
    (jm, jmd), (tm, tmd) = models
    jopt, topt = optimizers(G, chain, plans, move_weight)
    hard = chain == "hard"
    t0 = time.perf_counter()
    got = run_port(topt, tm, tmd)
    t_port = time.perf_counter() - t0
    if hard:
        differs = contraction_differs(got, topt.population.hard_weight)
        print(f"G={G}: the rounded and the contracted row differ at "
              f"{differs or 'no scoring'}", flush=True)
        if not differs:
            print("  this run settles nothing: the two forms agree",
                  flush=True)
            return 2
    t0 = time.perf_counter()
    want, K = run_reference(jopt, jm, jmd)
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
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("goals", nargs="*", type=int, default=[33])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--hard", action="store_true")
    kind.add_argument("--soft", action="store_true")
    ap.add_argument("--plans", type=int, default=4)
    ap.add_argument("--move-weight", type=float, default=0.0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    models = build_both(12, 240, seed=3)
    chain = "hard" if args.hard else "soft" if args.soft else "mixed"
    rcs = [probe(G, models, chain, args.plans, args.move_weight)
           for G in args.goals]
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
