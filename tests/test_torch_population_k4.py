"""The population search of the port at K = 4 against every output of the
JAX package's population program (the members' final placements, aux
readings, per-member iterations, walk boundaries, polish rows, moves,
acceptance, survivor permutations, Pareto ranks and weighted scores) and
the optimizer's proposals, goal results, trajectory and ``population``
telemetry, under the weighted and the Pareto objective with a hard goal
left violated and a move weight. Few iterations per pass keep residuals
alive, so members differ and selection matters. The port runs on
``device="cpu"``, where KI takes its plain twin; equal means bit for bit."""

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu_torch.analyzer as ta
from cruise_control_tpu_torch import _random
from cruise_control_tpu_torch.parallel import make_population_search
from torch_parity_util import build_both

torch.set_num_threads(1)

CFG = dict(num_replica_candidates=32, num_dest_candidates=4,
           num_swap_candidates=0, apply_per_iter=8, max_iters_per_goal=2,
           drain_rounds=0, polish_passes=1, stall_patience=1)
GOALS = ["DiskCapacityGoal", "ReplicaDistributionGoal",
         "DiskUsageDistributionGoal"]
#: a DISK threshold below the mean disk load per broker: the hard
#: goal keeps a residual, weighted by ``hard_weight``
CONSTRAINT = dict(capacity_threshold=(0.7, 0.8, 0.8, 0.0035))
OPTS = dict(seed=5, skip_hard_goal_check=True)


@pytest.fixture(scope="module")
def models():
    return build_both(12, 240, seed=3)


def _optimizers(pop):
    jc = ja.BalancingConstraint(**CONSTRAINT)
    tc = ta.BalancingConstraint(**CONSTRAINT)
    jopt = ja.TpuGoalOptimizer(
        goals=ja.goals_by_name(GOALS, jc), constraint=jc,
        config=ja.SearchConfig(**CFG), population=ja.PopulationConfig(**pop))
    topt = ta.TorchGoalOptimizer(
        goals=ta.goals_by_name(GOALS, tc), constraint=tc,
        config=ta.SearchConfig(**CFG), population=ta.PopulationConfig(**pop),
        device="cpu")
    return jopt, topt


@pytest.mark.parametrize("pop", [
    dict(size=4, objective="weighted"),
    dict(size=3, objective="pareto", move_weight=0.01,
         survivor_fraction=0.75),
])
def test_population_k4_matches_every_output_of_the_reference(models, pop):
    (jm, jmd), (tm, tmd) = models
    jopt, topt = _optimizers(pop)
    jres = jopt.optimize(jm, jmd, ja.OptimizationOptions(**OPTS))
    tres = topt.optimize(tm, tmd, ta.OptimizationOptions(**OPTS))

    # The program itself: the reference's compiled run (cached by its
    # optimize above) against the port's, on the same prepared inputs.
    jcfg, jgoals, jchain, jctx, jstate, _ = jopt._prepare(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    jrun, _, _, K = jopt._population_run_for(jcfg, jgoals, jchain)
    import jax
    want = jrun(jstate, jctx, jax.random.PRNGKey(OPTS["seed"]))
    tcfg, tgoals, tchain, tctx, tstate, _ = topt._prepare(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    got = make_population_search(tchain.passes, tgoals, tcfg,
                                 topt.population)(
        tstate, tctx, _random.PRNGKey(OPTS["seed"], device="cpu"))
    assert K == 4 and len(got[0]) == 4
    jstates, jaux, *jrest = want
    tstates, taux, *trest = got
    for m in range(K):
        np.testing.assert_array_equal(tstates[m].rb.numpy(),
                                      np.asarray(jstates.rb[m]))
        np.testing.assert_array_equal(tstates[m].pos.numpy(),
                                      np.asarray(jstates.pos[m]))
    for t, j in zip(taux, jaux):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    names = ("iters", "walk_bounds", "polish_rows", "moves", "accepted",
             "perms", "ranks", "weighted")
    for name, t, j in zip(names, trest, jrest):
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        np.testing.assert_array_equal(t, np.asarray(j), name)
    # members differ, and the hard goal keeps a residual
    moves, weighted, polish_rows = trest[3], trest[7].numpy(), trest[2]
    assert len(set(moves.tolist())) > 1 or len(set(weighted.tolist())) > 1
    assert (polish_rows[-1][:, 0] > 0).all()

    # The optimizer on top.
    assert tres.proposals == jres.proposals
    assert [(g.name, g.violation_before, g.violation_after, g.iterations,
             g.accepted) for g in tres.goal_results] == [
        (g.name, g.violation_before, g.violation_after, g.iterations,
         g.accepted) for g in jres.goal_results]
    assert (tres.telemetry["violationTrajectory"]
            == jres.telemetry["violationTrajectory"])
    tp = dict(tres.telemetry["population"])
    jp = dict(jres.telemetry["population"])
    assert tp.pop("devices") == 1
    jp.pop("devices")
    assert tp == jp
