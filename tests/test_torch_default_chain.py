"""Whole-optimize parity of the reference's default chain: ``TorchGoalOptimizer``
with ``goals=None`` (device="cpu", every kernel on its plain twin) against
``TpuGoalOptimizer`` with ``goals=None``, nothing waived — identical
proposals, moves and per-goal iterations, violations and violation stacks
bit for bit, the same audit verdicts (or the same OptimizationFailureError)
— in the per-goal and the fused walks; the catalog's part-B chain and the
kafka-assigner set on a cluster in broker sets with an active
MinTopicLeadersPerBrokerGoal; and ``WhatIfEngine()``'s N-1 sweep under the
default goals, raw scorer outputs bit for bit, at B1 <= 32 and > 32.

The reference compiles each chain for 80-110 s on the CPU, so every case
of one chain shape shares one JAX optimizer (its compiled passes): the
tiny cluster, a topic-skewed cluster of the same shapes (TopicReplica-
and LeaderReplicaDistribution have work when their turn comes), and the
latter with a dead broker."""

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu.whatif as jw
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.model.spec as tspec
import cruise_control_tpu_torch.whatif as tw
from cruise_control_tpu.analyzer.goals import KAFKA_ASSIGNER_GOALS
from test_torch_whatif import port_scenarios, raw_outputs
from torch_parity_util import (assert_reports_equal, assert_same,
                               build_both, tiny_both)

torch.set_num_threads(1)

SEARCH = dict(num_replica_candidates=96, num_dest_candidates=8,
              num_swap_candidates=48, apply_per_iter=96,
              max_iters_per_goal=24, drain_batch=256)


def topic_skew_both(dead=(), broker_sets=0):
    """8 brokers x 128 partitions (tiny_both's shapes: 8 topics, RF 2): topic
    k on brokers 2(k % 4) and 2(k % 4) + 1, leaders on the even broker —
    broker counts even, every topic crowded onto two brokers, leaders on
    half the brokers. ``broker_sets``: broker i in set s{i % n}."""
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        rng = np.random.default_rng(11)
        brokers = [mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}",
                                  alive=i not in dead,
                                  broker_set=(f"s{i % broker_sets}"
                                              if broker_sets else None))
                   for i in range(8)]
        parts = []
        for p in range(128):
            k = p % 8
            pair = [2 * (k % 4), 2 * (k % 4) + 1]
            load = (0.5 + float(rng.random()), 8.0 + float(rng.random()),
                    12.0 + 4 * float(rng.random()), 100.0 + 50 * float(
                        rng.random()))
            parts.append(mod.PartitionSpec(topic=f"t{k}", partition=p,
                                           replicas=pair, leader_load=load))
        out.append(mod.flatten_spec(mod.ClusterSpec(brokers=brokers,
                                                    partitions=parts),
                                    pad_partitions_to=128, **kw))
    return out[0], out[1]


CASES = {"tiny": tiny_both, "topic_skew": topic_skew_both,
         "topic_skew_dead": lambda: topic_skew_both(dead=(3,))}


def _outcome(opt, mod, model, md, **opts):
    try:
        return opt.optimize(model, md, mod.OptimizationOptions(
            seed=0, **opts)), None
    except mod.OptimizationFailureError as err:
        return err.result, str(err)


def _assert_same_outcome(jout, tout, what):
    (jres, jerr), (tres, terr) = jout, tout
    assert terr == jerr, what
    assert tres.proposals == jres.proposals, what
    assert tres.num_moves == jres.num_moves, what
    for jg, tg in zip(jres.goal_results, tres.goal_results):
        assert ((tg.name, tg.hard, tg.iterations, tg.accepted)
                == (jg.name, jg.hard, jg.iterations, jg.accepted)), what
        for field in ("violation_before", "violation_after", "scale"):
            assert getattr(tg, field) == getattr(jg, field), \
                f"{what}: {jg.name} {field}"
        assert tg.satisfied == jg.satisfied, f"{what}: {jg.name}"
    assert len(tres.goal_results) == len(jres.goal_results)
    assert [(g.name, g.satisfied, g.violation_before, g.violation_after)
            for g in tres.hard_goal_audit] == [
        (g.name, g.satisfied, g.violation_before, g.violation_after)
        for g in jres.hard_goal_audit], what
    jt, tt = jres.telemetry, tres.telemetry
    assert tt["violationTrajectory"] == jt["violationTrajectory"], what
    assert tt["totalMoves"] == jt["totalMoves"], what
    jjson, tjson = jres.to_json(), tres.to_json()
    assert tjson["summary"] == jjson["summary"], what
    assert tjson["violatedGoalsAfter"] == jjson["violatedGoalsAfter"], what


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_goal"])
def test_default_chain_parity(fused):
    """``goals=None``, nothing waived: the three clusters of tiny_both's
    shapes through one JAX optimizer (one compile of the sixteen passes)
    and one port optimizer."""
    cfg = dict(SEARCH, fused_chain=fused)
    jopt = ja.TpuGoalOptimizer(config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(config=ta.SearchConfig(**cfg), device="cpu")
    assert [g.name for g in topt.goals] == [g.name for g in jopt.goals]
    active = set()
    for case, build in CASES.items():
        (jm, jmd), (tm, tmd) = build()
        jout = _outcome(jopt, ja, jm, jmd)
        tout = _outcome(topt, ta, tm, tmd)
        _assert_same_outcome(jout, tout, case)
        active |= {g.name for g in tout[0].goal_results if g.iterations}
    # the cases give the new goals work of their own
    assert {"TopicReplicaDistributionGoal",
            "LeaderReplicaDistributionGoal"} <= active, active
    # the last case's dead broker is drained
    rb = tout[0].final_model.replica_broker
    assert not (rb == tmd.broker_index[3]).any()


def test_part_b_and_kafka_assigner_chains():
    """The catalog's part-B chain (broker sets, an active
    MinTopicLeadersPerBrokerGoal, even rack spread, preferred leaders) and
    the kafka-assigner set on the topic-skewed cluster in three broker
    sets, nothing waived: the same outcome as the reference, failure
    included."""
    (jm, jmd), (tm, tmd) = topic_skew_both(broker_sets=3)
    assert jmd.broker_sets == tmd.broker_sets == ["s0", "s1", "s2"]
    kw = dict(topics_with_min_leaders_per_broker="t1*",
              min_topic_leaders_per_broker=1)
    jcst, tcst = ja.BalancingConstraint(**kw), ta.BalancingConstraint(**kw)
    chains = {"partb": ["BrokerSetAwareGoal", "MinTopicLeadersPerBrokerGoal",
                        "RackAwareDistributionGoal",
                        "PreferredLeaderElectionGoal"],
              "kafka_assigner": KAFKA_ASSIGNER_GOALS}
    for tag, names in chains.items():
        cfg = dict(SEARCH, fused_chain=True)
        jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(names, jcst),
                                   constraint=jcst,
                                   config=ja.SearchConfig(**cfg))
        topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(names, tcst),
                                     constraint=tcst,
                                     config=ta.SearchConfig(**cfg),
                                     device="cpu")
        jout = _outcome(jopt, ja, jm, jmd)
        tout = _outcome(topt, ta, tm, tmd)
        _assert_same_outcome(jout, tout, tag)
        if tag == "partb":
            assert tout[0].goal_results[0].violation_before > 0


@pytest.fixture(scope="module")
def default_engines():
    return jw.WhatIfEngine(), tw.WhatIfEngine(device="cpu")


N1_CASES = {"topic_skew": topic_skew_both,
            "40x300": lambda: build_both(40, 300, seed=4),
            **{f"b{n + 1}": (lambda n=n: build_both(n, 600, seed=40 + n,
                                                    broker_pad_multiple=1))
               for n in (22, 23, 24, 31)}}


@pytest.mark.parametrize("case", sorted(N1_CASES))
def test_default_goals_n1_sweep(default_engines, case):
    """``WhatIfEngine()``'s N-1 sweep under the default goals: topic counts
    over the scenario batch, the raw scorer outputs (every goal's violation
    and scale) bit for bit and the reports, at B1 = 9 and 41 (the topic
    sum's fused loop, and XLA's tree) and at the violation rows' pad widths
    B1 = 23, 24, 25 and 32 (the first eight scenarios)."""
    je, te = default_engines
    (jm, jmd), (tm, tmd) = N1_CASES[case]()
    scenarios = jw.n1_sweep(jw.alive_broker_ids(jm, jmd))
    if case.startswith("b"):
        scenarios = scenarios[:8]
    jraw, traw = raw_outputs(je, te, jm, jmd, tm, tmd, scenarios)
    for name, a, b in zip(("viol", "vscale", "headroom", "hfrac", "pressure",
                           "unavailable", "n_offline"), jraw, traw):
        assert_same(a, b, what=name)
    assert np.asarray(jraw[0]).any()
    assert_reports_equal(je.sweep(jm, jmd, scenarios),
                         te.sweep(tm, tmd, port_scenarios(scenarios, tmd)))
