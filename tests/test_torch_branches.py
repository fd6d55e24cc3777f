"""Best-of-N branches of the port against the JAX package's
(``tests/test_parallel.py``'s branch cases): N = 2 and N = 4 branches — the
reference's on its virtual CPU devices, the port's one after another — give
the same per-branch final placements and violation stacks, the same winner
and the same optimizer result; runs are deterministic; and the audited
selection prefers the branch that passes the hard-goal gate. The port runs
on ``device="cpu"``; equal means bit for bit."""

import jax
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu.parallel.branches as jbr
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.model.spec as tspec
import cruise_control_tpu_torch.parallel.branches as tbr
from cruise_control_tpu_torch import _random
from cruise_control_tpu_torch.model.flat import sanity_check

torch.set_num_threads(1)

#: ``tests/test_parallel.py``'s schedule and chain
CFG = dict(num_replica_candidates=64, num_dest_candidates=8,
           apply_per_iter=32, max_iters_per_goal=64)
GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
OPTS = dict(seed=3, skip_hard_goal_check=True)


@pytest.fixture(scope="module")
def models():
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        parts = [mod.PartitionSpec(topic=f"t{p % 8}", partition=p,
                                   replicas=[p % 2, 2 + p % 2],
                                   leader_load=(1.0, 10.0, 12.0,
                                                80.0 + p % 7))
                 for p in range(256)]
        out.append(mod.flatten_spec(mod.ClusterSpec(
            brokers=[mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}")
                     for i in range(8)], partitions=parts),
            pad_partitions_to=256, **kw))
    return out[0], out[1]


@pytest.mark.parametrize("n", [2, 4])
def test_branched_search_matches_reference(models, n):
    (jm, jmd), (tm, tmd) = models
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(GOALS),
                               config=ja.SearchConfig(**CFG), branches=n)
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(GOALS),
                                 config=ta.SearchConfig(**CFG), branches=n,
                                 device="cpu")
    jres = jopt.optimize(jm, jmd, ja.OptimizationOptions(**OPTS))
    tres = topt.optimize(tm, tmd, ta.OptimizationOptions(**OPTS))
    assert tres.proposals == jres.proposals
    assert tres.num_moves == jres.num_moves > 0
    assert [(g.name, g.violation_before, g.violation_after, g.iterations,
             g.scale) for g in tres.goal_results] == [
        (g.name, g.violation_before, g.violation_after, g.iterations,
         g.scale) for g in jres.goal_results]
    assert tres.telemetry is None and jres.telemetry is None
    assert not any(sanity_check(tres.final_model).values())

    # Every branch, through the reference's compiled program (cached by
    # its optimize above) and the port's.
    jcfg, jgoals, _, jctx, jstate, _ = jopt._prepare(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    jstates, jviols = jopt._branched_run_for(jcfg, jgoals)(
        jstate, jctx, jax.random.PRNGKey(OPTS["seed"]))
    tcfg, tgoals, _, tctx, tstate, _ = topt._prepare(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    run = tbr.make_branched_search(tgoals, tcfg, n)
    key = _random.PRNGKey(OPTS["seed"], device="cpu")
    tstates, tviols = run(tstate, tctx, key)
    assert tviols.shape == (n, len(GOALS))
    np.testing.assert_array_equal(tviols.numpy(), np.asarray(jviols))
    for i in range(n):
        np.testing.assert_array_equal(tstates[i].rb.numpy(),
                                      np.asarray(jstates.rb[i]))
    _, jbest, jv = jbr.select_best(jstates, jviols)
    _, tbest, tv = tbr.select_best(tstates, tviols)
    assert tbest == jbest and tuple(tv) == tuple(jv)
    for i in range(n):
        assert tuple(tv) <= tuple(tviols[i].tolist())

    # Deterministic: the same key gives the same winner and stacks.
    again, viols2 = run(tstate, tctx, key)
    assert torch.equal(viols2, tviols)
    assert tbr.select_best(again, viols2)[1] == tbest


def test_audited_selection_prefers_the_gate_passing_branch():
    states = ["branch0", "branch1"]
    viols = torch.tensor([[0.0, 1.0], [0.0, 2.0]])
    audit = {"branch0": ([5.0], [0.0]), "branch1": ([0.0], [0.0])}

    def audit_eval(state):
        av, sc = audit[state]
        return torch.tensor(av), torch.tensor(sc)

    assert tbr.select_best(states, viols)[1] == 0
    picked, best, v = tbr.select_best_audited(states, viols, audit_eval)
    assert (picked, best, tuple(v.tolist())) == ("branch1", 1, (0.0, 2.0))
    with pytest.raises(RuntimeError, match="NaN violations on members"):
        tbr.select_best(states, torch.tensor([[0.0, np.nan], [0.0, 1.0]]))


def test_audit_verdict_counts_like_the_reference():
    av = np.asarray([0.0, 2e-6, 1.5e-3, 5.0], np.float32)
    scales = np.asarray([0.0, 0.0, 2000.0, 1e6], np.float32)
    want = jbr.audit_violation_count(lambda s: (av, scales), None)
    got = tbr.audit_violation_count(
        lambda s: (torch.from_numpy(av), torch.from_numpy(scales)), None)
    assert got == want == 2
