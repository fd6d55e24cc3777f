"""What-if parity: the port's ``WhatIfEngine`` (device="cpu", every kernel on
its plain twin) against ``cruise_control_tpu.whatif.WhatIfEngine`` (JAX on
the CPU) on the same seeded clusters.

Held exactly: the transformed models of every scenario type, the violated
and violated-hard goal lists, unavailable partitions, offline replicas and
the worst broker. Held bit for bit: the raw scorer outputs (violations,
scales, headroom, headroom fractions, pressure) and so risk, capacity
pressure and the headroom report. Also the pieces under the sweep — the
batched tree sum and lane sum against XLA's row reductions, the batched
segment sum against a vmapped scatter-add, and KD's twin against the
reference transform — and the engine's own contracts (batched equals
single-scenario sweeps, unelectable partitions, errors, the report's JSON).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.whatif as jw
import cruise_control_tpu_torch.whatif as tw
from cruise_control_tpu.analyzer.goals import goals_by_name as jgoals
from cruise_control_tpu.whatif.engine import scenario_transform as j_transform
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.goals import goals_by_name as tgoals
from cruise_control_tpu_torch.utils.ordered import (tree_sum_last,
                                                    violation_row_sum)
from cruise_control_tpu_torch.whatif.engine import make_scenario_scorer
from torch_parity_util import (assert_reports_equal, assert_same,
                               build_both, model_arrays, spec_both)

torch.set_num_threads(1)

#: tests/test_whatif.py's chain, and the bench's what-if chain
GOALS = ["NetworkOutboundCapacityGoal", "ReplicaDistributionGoal",
         "DiskUsageDistributionGoal"]
BENCH_GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
               "NetworkInboundUsageDistributionGoal",
               "NetworkOutboundUsageDistributionGoal"]
CHAINS = {"goals3": GOALS, "bench4": BENCH_GOALS}


def port_scenarios(scenarios, md):
    """The port's specs of the same scenarios (their JSON round trip)."""
    return tw.parse_scenarios(
        {"scenarios": [s.to_json() for s in scenarios]}, md.broker_ids)


@pytest.fixture(scope="module")
def engines():
    return {name: (jw.WhatIfEngine(goals=jgoals(chain)),
                   tw.WhatIfEngine(goals=tgoals(chain), device="cpu"))
            for name, chain in CHAINS.items()}


def raw_outputs(je, te, jm, jmd, tm, tmd, scenarios):
    """Both engines' raw scorer outputs (viol, vscale, headroom, hfrac,
    pressure, unavailable, n_offline) as numpy arrays, one row per
    scenario (the reference pads the scenario axis; the port does not)."""
    jb = je._materialize(jm, jmd, scenarios)
    jgoal = [g.bind(jmd) for g in je.goals]
    jout = je._program_for(jb, jgoal, jmd)(*je._place_batch(jb))
    tb = te._materialize(tm, tmd, port_scenarios(scenarios, tmd))
    score = make_scenario_scorer(
        [g.bind(tmd) for g in te.goals], te.constraint.capacity_threshold,
        num_topics=tmd.num_topics + tb.num_staged_topics)
    tout = score(*te._place_batch(tb))
    S = len(scenarios)
    return ([np.asarray(a)[:S] for a in jout], [t.numpy() for t in tout])


# ------------------------------------------------------------ transforms

TRANSFORM_CASES = {
    "loss": [jw.BrokerLoss((2,))],
    "loss_pair": [jw.BrokerLoss((0, 3))],
    "add": [jw.BrokerAdd(2)],
    "add_capacity": [jw.BrokerAdd(1, capacity=(10.0, 20.0, 30.0, 40.0))],
    "add_outgrows_padding": [jw.BrokerAdd(6)],
    "resize": [jw.CapacityResize(0.5, brokers=(1,), resource="disk"),
               jw.CapacityResize(1.5)],
    "load_scale": [jw.LoadScale(1.5), jw.LoadScale(2.0, topics=("t1",))],
    "topic_add": [jw.TopicAdd("proj", partitions=4, rf=2,
                              leader_load=(1.0, 2.0, 3.0, 4.0))],
    "topic_add_outgrows_padding": [jw.TopicAdd(
        "big", partitions=130, rf=3, leader_load=(1.0, 1.0, 1.0, 1.0))],
    "trajectory": [jw.TrajectoryScale(
        horizon_ms=3_600_000, quantile=0.9, factors=(("t0", 2.0),),
        default_factor=1.2)],
    "mixed": [jw.BrokerLoss((1,)), jw.BrokerAdd(1), jw.LoadScale(1.3),
              jw.TopicAdd("p", partitions=3, rf=1,
                          leader_load=(1.0, 1.0, 1.0, 1.0))],
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transformed_models_match_reference(engines, case):
    je, te = engines["goals3"]
    (jm, jmd), (tm, tmd) = spec_both()
    scenarios = TRANSFORM_CASES[case]
    jmodels = je.transformed(jm, jmd, scenarios)
    tmodels = te.transformed(tm, tmd, port_scenarios(scenarios, tmd))
    assert len(tmodels) == len(jmodels) == len(scenarios)
    for i, (j, t) in enumerate(zip(jmodels, tmodels)):
        for name, want in model_arrays(j).items():
            assert_same(getattr(t, name), want, what=f"{case}[{i}] {name}")


# ------------------------------------------------------------ sweeps

MIXED = [jw.BrokerLoss((0,)), jw.BrokerLoss((1,)), jw.LoadScale(1.7),
         jw.CapacityResize(0.6), jw.BrokerLoss((2, 3)),
         jw.LoadScale(3.0, topics=("t0",)), jw.BrokerAdd(1),
         jw.CapacityResize(0.3, brokers=(2,), resource="nwOut"),
         jw.TopicAdd("proj", partitions=5, rf=2,
                     leader_load=(1.0, 5.0, 9.0, 4.0)),
         jw.TrajectoryScale(horizon_ms=60_000, quantile=0.5,
                            factors=(("t1", 4.0),))]


def _spec_mixed():
    return spec_both(nw_out=9.0, nw_out_cap=60.0, partitions=12), MIXED


def _spec_n1_hot():
    both = spec_both(nw_out=15.0, nw_out_cap=100.0, partitions=16)
    return both, jw.n1_sweep(both[0][1].broker_ids) + [jw.LoadScale(1.0)]


def _dead_20x1k_n1():
    both = build_both(20, 1000, seed=10, dead=(4,))
    (jm, jmd) = both[0]
    return both, jw.n1_sweep(jw.alive_broker_ids(jm, jmd))


SWEEPS = {"spec_mixed": _spec_mixed, "spec_n1_hot": _spec_n1_hot,
          "20x1k_dead_n1": _dead_20x1k_n1}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_matches_reference(engines, case, chain):
    """Raw outputs bit for bit, the reports field for field."""
    je, te = engines[chain]
    ((jm, jmd), (tm, tmd)), scenarios = SWEEPS[case]()
    jout, tout = raw_outputs(je, te, jm, jmd, tm, tmd, scenarios)
    names = ("viol", "vscale", "headroom", "hfrac", "pressure",
             "unavailable", "n_offline")
    for name, j, t in zip(names, jout, tout):
        assert_same(t, j, what=f"{case}/{chain} {name}")
    jrep = je.sweep(jm, jmd, scenarios)
    trep = te.sweep(tm, tmd, port_scenarios(scenarios, tmd))
    assert_reports_equal(jrep, trep)


def test_batched_sweep_equals_single_scenario_sweeps(engines):
    """Batch composition cannot leak between scenarios: each scenario of a
    mixed batch scores exactly as it does alone."""
    _, te = engines["goals3"]
    _, (tm, tmd) = spec_both(nw_out=9.0, nw_out_cap=60.0, partitions=12)
    scenarios = port_scenarios(MIXED, tmd)
    batched = te.sweep(tm, tmd, scenarios)
    for scn, got in zip(scenarios, batched.outcomes):
        single = te.sweep(tm, tmd, [scn]).outcomes[0]
        assert got.to_json() == single.to_json(), scn.name
        assert got.risk == single.risk


def test_n1_sweep_on_a_cluster_with_a_dead_broker(engines):
    """Every alive broker's loss on the 20-broker cluster: offline replicas
    are that broker's replicas, nothing becomes unavailable at RF 2 unless
    the partition's other replica sat on the dead broker."""
    _, te = engines["bench4"]
    _, (tm, tmd) = build_both(20, 1000, seed=10, dead=(4,))
    ids = tw.alive_broker_ids(tm, tmd)
    assert 4 not in ids and len(ids) == 19
    rep = te.sweep(tm, tmd, tw.n1_sweep(ids))
    rb = tm.replica_broker.numpy()
    dead_row = tmd.broker_index[4]
    for bid, o in zip(ids, rep.outcomes):
        row = tmd.broker_index[bid]
        on_dead_or_lost = np.isin(rb, [row, dead_row])
        assert o.offline_replicas == int(on_dead_or_lost.sum())
        assert o.unavailable_partitions == int(on_dead_or_lost.all(1).sum())


def test_unelectable_partition_counts_unavailable(engines):
    """An RF-1 partition on the killed broker has no electable replica:
    it is counted unavailable and pushes the risk near the ceiling."""
    je, te = engines["goals3"]
    extra = [dict(topic="t0", partition=99, replicas=[2],
                  leader_load=(1.0, 1.0, 1.0, 1.0))]
    (jm, jmd), (tm, tmd) = spec_both(extra=extra)
    scenarios = [jw.BrokerLoss((2,)), jw.BrokerLoss((3,))]
    trep = te.sweep(tm, tmd, port_scenarios(scenarios, tmd))
    lost2, lost3 = trep.outcomes
    assert lost2.unavailable_partitions == 1
    assert lost3.unavailable_partitions == 0
    assert lost2.risk > lost3.risk and lost2.risk >= 0.9
    assert trep.riskiest() is lost2
    assert_reports_equal(je.sweep(jm, jmd, scenarios), trep)


def test_sweep_rejects_unknown_ids_and_oversize(engines):
    _, te = engines["goals3"]
    _, (tm, tmd) = spec_both()
    with pytest.raises(ValueError, match="unknown broker id"):
        te.sweep(tm, tmd, [tw.BrokerLoss((99,))])
    with pytest.raises(ValueError, match="unknown topic"):
        te.sweep(tm, tmd, [tw.LoadScale(2.0, topics=("absent",))])
    with pytest.raises(ValueError, match="unknown broker id"):
        te.sweep(tm, tmd, [tw.CapacityResize(2.0, brokers=(42,))])
    small = tw.WhatIfEngine(goals=tgoals(GOALS), max_scenarios=2,
                            device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        small.sweep(tm, tmd, [tw.LoadScale(1.0)] * 3)
    with pytest.raises(ValueError, match="at least one"):
        te.sweep(tm, tmd, [])


def test_report_json_round_trip(engines):
    _, te = engines["goals3"]
    _, (tm, tmd) = spec_both()
    rep = te.sweep(tm, tmd, [tw.BrokerLoss((0,)), tw.BrokerAdd(1)])
    out = json.loads(json.dumps(rep.to_json()))
    assert out["numScenarios"] == 2
    assert out["goals"] == GOALS
    assert {s["name"] for s in out["scenarios"]} == {"loss:0", "add:1"}
    for s in out["scenarios"]:
        assert set(s["headroom"]) == {"cpu", "nwIn", "nwOut", "disk"}
        assert 0.0 <= s["risk"] <= 1.0
    assert tw.parse_scenarios(
        {"scenarios": [s["scenario"] for s in out["scenarios"]]},
        tmd.broker_ids) == [tw.BrokerLoss((0,)), tw.BrokerAdd(1)]


def test_parse_scenarios_validation():
    ids = [0, 1, 2]
    assert len(tw.parse_scenarios({"sweep": "n1"}, ids)) == 3
    assert len(tw.parse_scenarios({"sweep": "N2"}, ids)) == 3
    got = tw.parse_scenarios(
        {"scenarios": [{"type": "broker_loss", "brokers": [1]},
                       {"type": "load_scale", "factor": 2},
                       {"type": "topic_add", "partitions": 2, "rf": 1,
                        "leaderLoad": [1, 1, 1, 1]},
                       {"type": "trajectory_scale", "horizonMs": 60000,
                        "quantile": 0.9, "factors": {"t": 2}}]}, ids)
    assert [type(s).__name__ for s in got] == [
        "BrokerLoss", "LoadScale", "TopicAdd", "TrajectoryScale"]
    for bad in ({}, {"sweep": "N1", "scenarios": []},
                {"sweep": "N3"}, {"scenarios": []},
                {"scenarios": [{"type": "nope"}]},
                {"scenarios": [{"type": "forecast", "horizonMs": 1}]},
                {"scenarios": [{"type": "broker_loss", "brokers": []}]},
                {"scenarios": [{"type": "load_scale", "factor": -1}]},
                {"scenarios": [{"type": "capacity_resize", "factor": 2,
                                "resource": "ssd"}]}):
        with pytest.raises(ValueError):
            tw.parse_scenarios(bad, ids)


def test_default_goals_wait_for_part_b():
    with pytest.raises(ValueError, match="not yet ported"):
        tw.WhatIfEngine(device="cpu")


def test_engine_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tw.WhatIfEngine(goals=tgoals(GOALS))


def test_model_on_another_device_is_refused(engines):
    _, te = engines["goals3"]
    _, (tm, tmd) = spec_both()
    other = tw.WhatIfEngine(goals=tgoals(GOALS), device="cpu")
    other.device = torch.device("meta")
    with pytest.raises(ValueError, match="lies on"):
        other.sweep(tm, tmd, [tw.LoadScale(1.0)])


# ------------------------------------------------- pieces under the sweep

@pytest.mark.parametrize("S", [1, 8, 104])
@pytest.mark.parametrize("n", [9, 33, 64, 101, 105, 1001])
def test_batched_tree_sum_matches_vmapped_sum(S, n):
    x = (np.random.default_rng(S * 1000 + n).random((S, n)) * 1000 - 300
         ).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.sum))(x))
    assert_same(tree_sum_last(torch.from_numpy(x)), want)


@pytest.mark.parametrize("S", [1, 8, 104])
@pytest.mark.parametrize("n", [9, 17, 25, 28, 32, 33, 105])
def test_lane_row_sum_matches_fused_penalty_sum(S, n):
    """XLA's CPU row reduction fused with an elementwise penalty over a
    [B1] plane with scalar bounds, vmapped: the ``plane`` program's vector
    loops (``utils/ordered.py:ROW_LOOPS``), the tree order otherwise."""
    rng = np.random.default_rng(S * 7 + n)
    x = (rng.random((S, n)) * 1000 - 300).astype(np.float32)
    alive = rng.random((S, n)) < 0.9

    def penalty(v, a):
        return jnp.where(a, jnp.maximum(v - 3.0, 0.0)
                         + jnp.maximum(1.0 - v, 0.0), 0.0)
    want = np.asarray(jax.jit(jax.vmap(lambda v, a: penalty(v, a).sum()))(
        x, alive))
    pen = torch.from_numpy(np.array(jax.vmap(penalty)(x, alive)))
    assert_same(violation_row_sum(pen, "plane"), want)


@pytest.mark.parametrize("S", [1, 8, 104])
def test_batched_segment_sum_matches_vmapped_scatter_add(S):
    """One segment-sum over ids ``s * B1 + b`` equals a vmapped
    ``zeros(B1, 4).at[idx].add(x)`` bit for bit."""
    rng = np.random.default_rng(S)
    B1, N = 21, 700
    idx = rng.integers(0, B1, (S, N))
    x = (rng.random((S, N, 4)) * 100).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda i, v: jnp.zeros((B1, 4), jnp.float32).at[i].add(v)))(idx, x))
    seg = torch.from_numpy(idx + np.arange(S)[:, None] * B1).reshape(-1)
    got = kernels.ordered_segment_sum(torch.from_numpy(x).reshape(-1, 4),
                                      seg, S * B1).reshape(S, B1, 4)
    assert_same(got, want)


def test_failover_twin_matches_reference_transform():
    """KD's twin against the reference transform's placement fields on a
    random template with dead, added and disabled rows."""
    (jm, _), _ = build_both(20, 1000, seed=11, dead=(3,))
    a = {k: np.array(v) for k, v in model_arrays(jm).items()}
    rng = np.random.default_rng(5)
    S, B = 24, a["broker_capacity"].shape[0]
    P = a["replica_broker"].shape[0]
    offline = rng.random(a["replica_offline"].shape) < 0.05
    pref = np.argsort(rng.random(a["replica_pref_pos"].shape), 1).astype(
        np.int32)
    jm = jm.replace(replica_offline=jnp.asarray(offline),
                    replica_pref_pos=jnp.asarray(pref))
    dead = rng.random((S, B)) < 0.2
    add = rng.random((S, B)) < 0.1
    pvalid = a["partition_valid"][None] & (rng.random((S, P)) < 0.95)
    cap_scale = np.ones((S, B, 4), np.float32)
    pscale = np.ones((S, P), np.float32)
    model, has_alive = jax.jit(jax.vmap(
        j_transform, in_axes=(None, 0, 0, 0, 0, 0)))(
        jm, dead, add, cap_scale, pscale, pvalid)
    got = kernels.scenario_failover_plain(
        torch.from_numpy(a["replica_broker"]), torch.from_numpy(offline),
        torch.from_numpy(pref), torch.from_numpy(a["broker_valid"]),
        torch.from_numpy(a["broker_alive"]), torch.from_numpy(dead),
        torch.from_numpy(add), torch.from_numpy(pvalid))
    for t, want, name in zip(
            got, (model.replica_broker, model.replica_pref_pos,
                  model.replica_offline, has_alive),
            ("replica_broker", "replica_pref_pos", "replica_offline",
             "has_alive")):
        assert_same(t, np.asarray(want), what=name)
