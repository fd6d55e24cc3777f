"""KN's goal table on the CPU (no card needed): every chain the repo
builds has a row for every goal at every position (``GoalChecks.outside``
empty: no goal's ``accepts`` or ``delta`` is left to torch on the card),
and the host-built constants of the rows outside the interval family are
the goal's own fields. The rows' arithmetic is held to the twin on the
card (``tests/test_torch_eligibility_rows_cuda.py``)."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                               default_goals, goals_by_name)
from cruise_control_tpu_torch.analyzer.goals import (GOAL_REGISTRY,
                                                     KAFKA_ASSIGNER_GOALS)
from cruise_control_tpu_torch.model.spec import flatten_spec

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sets_md():
    """Phase 13 (d)'s cluster shape at 20 brokers x 400 partitions: ten
    broker sets, 200 topics."""
    _model, md = flatten_spec(chip_smoke.build_spec(
        num_brokers=20, num_partitions=400,
        broker_sets=chip_smoke.PARTB_SETS), device="cpu")
    return md


def _chains(md):
    cst = BalancingConstraint(**chip_smoke.PARTB_CONSTRAINT)
    names = sorted(GOAL_REGISTRY)
    return {
        "main": goals_by_name(chip_smoke.GOALS),
        "default": [g.bind(md) for g in default_goals()],
        "partb": [g.bind(md)
                  for g in goals_by_name(chip_smoke.PARTB_CHAIN, cst)],
        "kafka_assigner": goals_by_name(KAFKA_ASSIGNER_GOALS),
        "longer than 48": [g.bind(md)
                           for g in goals_by_name(names * 3, cst)]}


@pytest.mark.parametrize("chain", ["main", "default", "partb",
                                   "kafka_assigner", "longer than 48"])
def test_every_goal_has_a_row(sets_md, chain):
    """At every position: no goal outside KN's table, the pass goal's row
    first, one row an earlier goal but for those that accept every
    candidate (PreferredLeaderElection, an inactive goal)."""
    goals = _chains(sets_md)[chain]
    for i, goal in enumerate(goals):
        checks = kernels.GoalChecks(goal, goals[:i], 1e-6)
        assert checks.outside == [], (chain, i)
        kinds = [kernels.ROW_KINDS[checks.rows[k].kind]
                 for k in range(checks.n)]
        assert kinds[0] == goal.eligibility_row()["kind"]
        earlier = [g.eligibility_row()["kind"] for g in goals[:i]]
        assert kinds[1:] == [k for k in earlier
                             if k not in ("preferred_leader", "nothing")]
    if chain == "longer than 48":
        assert len(goals) == 63 and checks.n > kernels.MAX_GOAL_ROWS


def test_row_constants_are_the_goals_fields(sets_md):
    """The topic gap constants (threshold - 1.0 formed on the host, then
    float32, as the twin's scalar product forms it), min_count, the
    interested topics and the topic sets, as the rows carry them to the
    card (the arrays' pointers on the device they run on)."""
    goals = _chains(sets_md)["longer than 48"]
    cst = BalancingConstraint(**chip_smoke.PARTB_CONSTRAINT)
    checks = kernels.GoalChecks(goals[-1], goals[:-1], 1e-6)
    rows, lengths = checks.rows_on(torch.device("cpu"))
    by_kind: dict = {}
    for k in range(checks.n):
        by_kind.setdefault(kernels.ROW_KINDS[rows[k].kind], []).append(k)
    topic = by_kind["topic_replica"]
    assert checks.topic_gaps == [(
        float(np.float32(cst.topic_replica_balance_threshold - 1.0)),
        float(cst.topic_replica_balance_min_gap),
        float(cst.topic_replica_balance_max_gap))]
    for k in topic:
        assert rows[k].param == 0
        assert rows[k].t == np.float32(
            cst.topic_replica_balance_threshold - 1.0)
        assert (rows[k].lower, rows[k].hi) == checks.topic_gaps[0][1:]
    leaders = next(g for g in goals
                   if g.name == "MinTopicLeadersPerBrokerGoal")
    sets = next(g for g in goals if g.name == "BrokerSetAwareGoal")
    assert leaders.interested_topics is not None
    assert sets.topic_set is not None
    T = len(sets_md.topics)
    for kind, host, dtype in (
            ("topic_leaders", leaders.interested_topics.host, np.bool_),
            ("broker_set", sets.topic_set.host, np.int32)):
        assert by_kind[kind]
        for k in by_kind[kind]:
            assert lengths[k] == T == len(host)
            got = np.ctypeslib.as_array(
                ctypes.cast(rows[k].aux, ctypes.POINTER(
                    ctypes.c_uint8 if dtype is np.bool_
                    else ctypes.c_int32)), (T,)).astype(dtype)
            np.testing.assert_array_equal(got, host)
            if kind == "topic_leaders":
                assert rows[k].param == leaders.min_count == 1
            else:
                assert rows[k].param == len(sets.topic_set.host)
    # the rows built once carry no pointer; each device's copy its own
    assert all(checks.rows[k].aux is None for k in range(checks.n))


def test_a_topic_row_of_other_gaps_takes_a_slot_of_its_own():
    """Two TopicReplicaDistribution goals of different gaps: two slots of
    the launch's topic bounds; the same goal twice shares one."""
    loose = goals_by_name(["TopicReplicaDistributionGoal"])[0]
    tight = goals_by_name(["TopicReplicaDistributionGoal"],
                          BalancingConstraint(
                              topic_replica_balance_threshold=1.1,
                              topic_replica_balance_min_gap=0))[0]
    checks = kernels.GoalChecks(loose, [tight, loose, tight], 1e-6)
    assert [checks.rows[k].param for k in range(checks.n)] == [0, 1, 0, 1]
    assert checks.topic_gaps == [(2.0, 2.0, 40.0),
                                 (float(np.float32(1.1 - 1.0)), 0.0, 40.0)]
