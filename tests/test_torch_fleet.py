"""The port's fleet propose against the JAX package's, on
``tests/test_fleet.py``'s members (8/10/12 brokers x 96/128/160
partitions, stacked to one bucket) built in both packages.

The port runs on ``device="cpu"``; its fleet propose must equal the JAX
``FleetOptimizer.propose`` exactly (proposals JSON, moves, goal results,
the off-chain audit, telemetry without wall-clock fields and the provision
verdict) and a sequential ``optimize`` of each member of its own. Also:
the stacked fields, the grouping degrade, the group keys, padding slots
and the bucket floor, the exclusivity guards and the device rules."""

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.fleet as jf
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.fleet as tf
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu_torch.parallel.sharding import make_mesh
from torch_parity_util import MODEL_FIELDS, assert_same

torch.set_num_threads(1)

GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
#: tests/test_fleet.py's search: every knob at or below the smallest
#: member's clamp point, so the members share one scaled config
CFG = dict(num_replica_candidates=64, num_dest_candidates=4,
           num_swap_candidates=32, apply_per_iter=32, drain_batch=64,
           max_iters_per_goal=48)
SKIP = dict(seed=3, skip_hard_goal_check=True)
STRICT = dict(seed=5, waived_hard_goals=frozenset({"RackAwareGoal",
                                                   "CpuCapacityGoal"}))
#: a DISK threshold that leaves DiskCapacityGoal (in the off-chain audit)
#: violated on members c1 and c2 only
TIGHT = dict(capacity_threshold=(0.7, 0.8, 0.8, 0.018))
PACKAGES = {"jax": (jspec, ja, jf, {}), "torch": (tspec, ta, tf,
                                                  {"device": "cpu"})}


def _cluster(mod, brokers, partitions, seed, **kw):
    bs = [mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}")
          for i in range(brokers)]
    ps = [mod.PartitionSpec(topic=f"t{p % 5}", partition=p,
                            replicas=[p % 2, 2 + p % 3],
                            leader_load=(1.0, 10.0, 12.0,
                                         60.0 + ((p * seed) % 13)))
          for p in range(partitions)]
    return mod.flatten_spec(mod.ClusterSpec(brokers=bs, partitions=ps), **kw)


def _toy(mod, **kw):
    """A 3-broker member whose scaled config differs from the others'."""
    bs = [mod.BrokerSpec(broker_id=i, rack=f"r{i}") for i in range(3)]
    ps = [mod.PartitionSpec(topic=f"t{p % 5}", partition=p,
                            replicas=[p % 3, (p + 1) % 3],
                            leader_load=(1.0, 10.0, 12.0, 60.0 + (p % 9)))
          for p in range(96)]
    return mod.flatten_spec(mod.ClusterSpec(brokers=bs, partitions=ps), **kw)


def fleet3(pkg, **stack_kw):
    spec, _an, fl, kw = PACKAGES[pkg]
    members = [(f"c{i}",) + _cluster(spec, b, p, i + 3, **kw)
               for i, (b, p) in enumerate([(8, 96), (10, 128), (12, 160)])]
    return fl.FleetModel.stack(members, broker_pad_multiple=8,
                               partition_pad_multiple=64, **stack_kw, **kw)


def mixed(pkg):
    spec, _an, fl, kw = PACKAGES[pkg]
    return fl.FleetModel.stack(
        [("a",) + _cluster(spec, 8, 96, 1, **kw), ("b",) + _toy(spec, **kw)],
        broker_pad_multiple=8, partition_pad_multiple=64, **kw)


def optimizer(pkg, constraint=None, **kw):
    _spec, an, _fl, dev = PACKAGES[pkg]
    cls = an.TpuGoalOptimizer if pkg == "jax" else an.TorchGoalOptimizer
    c = an.BalancingConstraint(**(constraint or {}))
    return cls(goals=an.goals_by_name(GOALS, c), constraint=c,
               config=an.SearchConfig(**CFG), **kw, **dev)


@pytest.fixture(scope="module")
def engines():
    jopt, topt = optimizer("jax"), optimizer("torch")
    return (jopt, jf.FleetOptimizer(jopt)), (topt, tf.FleetOptimizer(topt))


@pytest.fixture(scope="module")
def tight_engines():
    jopt, topt = optimizer("jax", TIGHT), optimizer("torch", TIGHT)
    return (jopt, jf.FleetOptimizer(jopt)), (topt, tf.FleetOptimizer(topt))


@pytest.fixture(scope="module")
def jax_results(engines, tight_engines):
    """The JAX fleet's results per case (each case's program compiles
    once)."""
    (_jopt, jfo), _ = engines
    (_jopt, jtight), _ = tight_engines
    return {"skip": jfo.propose(fleet3("jax"), ja.OptimizationOptions(**SKIP)),
            "strict": jfo.propose(fleet3("jax"),
                                  ja.OptimizationOptions(**STRICT)),
            "tight": jtight.propose(fleet3("jax"),
                                    ja.OptimizationOptions(**STRICT)),
            "mixed": jfo.propose(mixed("jax"), ja.OptimizationOptions(
                seed=7, skip_hard_goal_check=True))}


def _unwrap(res):
    failed = isinstance(res, (ja.OptimizationFailureError,
                              ta.OptimizationFailureError))
    return (res.result if failed else res), failed


def _telemetry(t):
    """Telemetry without its wall-clock fields."""
    return {**t, "perGoal": [{k: v for k, v in g.items()
                              if k != "durationMs"} for g in t["perGoal"]]}


def _goal_rows(results):
    return [(g.name, g.hard, g.violation_before, g.violation_after,
             g.iterations, g.scale, g.accepted) for g in results]


def assert_same_result(jres, tres, what):
    jr, jfail = _unwrap(jres)
    tr, tfail = _unwrap(tres)
    assert tfail == jfail, what
    assert [p.to_json() for p in tr.proposals] \
        == [p.to_json() for p in jr.proposals], what
    assert tr.num_moves == jr.num_moves, what
    assert _goal_rows(tr.goal_results) == _goal_rows(jr.goal_results), what
    assert _goal_rows(tr.hard_goal_audit) \
        == _goal_rows(jr.hard_goal_audit), what
    assert tr.violated_hard_goals == jr.violated_hard_goals, what
    assert _telemetry(tr.telemetry) == _telemetry(jr.telemetry), what
    assert tr.provision_response.to_json() \
        == jr.provision_response.to_json(), what
    assert tr.stale_model == jr.stale_model, what


def assert_equals_sequential(opt, fleet, results, opts):
    for member, fres in zip(fleet.members, results):
        try:
            seq = opt.optimize(member.model, member.metadata, opts)
        except ta.OptimizationFailureError as e:
            seq = e.result
            assert isinstance(fres, ta.OptimizationFailureError)
        fr, _ = _unwrap(fres)
        what = member.cluster_id
        assert [p.to_json() for p in fr.proposals] \
            == [p.to_json() for p in seq.proposals], what
        assert fr.num_moves == seq.num_moves, what
        assert _goal_rows(fr.goal_results) == _goal_rows(seq.goal_results)
        assert _goal_rows(fr.hard_goal_audit) \
            == _goal_rows(seq.hard_goal_audit), what
        assert _telemetry(fr.telemetry) == _telemetry(seq.telemetry), what
        assert fr.provision_response.to_json() \
            == seq.provision_response.to_json(), what
        for f in MODEL_FIELDS:
            assert_same(getattr(fr.final_model, f),
                        getattr(seq.final_model, f), what=f"{what} {f}")


# ------------------------------------------------------------- stacking

@pytest.mark.parametrize("pad", [1, 4])
def test_stacked_fields_equal(pad):
    """The port stacks exactly the members (one card has no mesh to pad
    the cluster axis for); its slots equal the reference's real slots
    whatever the reference's ``cluster_pad_multiple``."""
    jfl = fleet3("jax", cluster_pad_multiple=pad)
    tfl = fleet3("torch")
    assert tfl.bucket == dict(jfl.bucket, clustersPadded=3)
    assert jfl.num_clusters_padded == (3 if pad == 1 else 4)
    assert tfl.num_clusters_padded == 3
    assert np.array_equal(tfl.cluster_valid, jfl.cluster_valid[:3])
    for f in MODEL_FIELDS:
        assert_same(getattr(tfl.stacked, f), getattr(jfl.stacked, f)[:3],
                    what=f"stacked.{f}")
    for jm, tm in zip(jfl.members, tfl.members):
        assert tm.cluster_id == jm.cluster_id
        for f in MODEL_FIELDS:
            assert_same(getattr(tm.model, f), getattr(jm.model, f),
                        what=f"{jm.cluster_id}.{f}")
    # The stacked model's shape properties answer the member shape.
    assert tfl.stacked.num_brokers_padded == tfl.bucket["brokersPadded"]
    assert tfl.stacked.num_partitions_padded \
        == tfl.bucket["partitionsPadded"]


def test_stack_rejects_duplicates_and_empty():
    with pytest.raises(ValueError, match="at least one"):
        tf.FleetModel.stack([], device="cpu")
    m, md = _cluster(tspec, 8, 96, 1, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        tf.FleetModel.stack([("a", m, md), ("a", m, md)], device="cpu")


# ------------------------------------------------------------- propose

@pytest.mark.parametrize("layout", ["DC", "D1"])
def test_fleet_propose_matches_reference(engines, jax_results, layout):
    """Skip options (seed 3): one group, every member equal to the JAX
    fleet's result — one cluster a device (DC) and every cluster on one
    device (D1, the port's layout)."""
    (jopt, _jfo), (_topt, tfo) = engines
    want = (jax_results["skip"] if layout == "DC" else
            jf.FleetOptimizer(jopt, max_devices=1).propose(
                fleet3("jax"), ja.OptimizationOptions(**SKIP)))
    results = tfo.propose(fleet3("torch"), ta.OptimizationOptions(**SKIP))
    assert tfo._groups_gauge_val == 1
    for jres, tres, cid in zip(want, results, ("c0", "c1", "c2")):
        assert_same_result(jres, tres, cid)


def test_fleet_propose_equals_sequential(engines):
    _, (topt, tfo) = engines
    fleet = fleet3("torch")
    opts = ta.OptimizationOptions(**SKIP)
    assert_equals_sequential(topt, fleet, tfo.propose(fleet, opts), opts)


@pytest.mark.parametrize("case", ["strict", "tight"])
def test_strict_member_returns_failure_like_reference(
        engines, tight_engines, jax_results, case):
    """Strict options: the off-chain audit runs, and a member whose hard
    goals stay violated (c1 and c2 under the tight DISK threshold) comes
    back as a returned ``OptimizationFailureError`` (the sequential path
    raises)."""
    _, (topt, tfo) = engines if case == "strict" else tight_engines
    fleet = fleet3("torch")
    opts = ta.OptimizationOptions(**STRICT)
    results = tfo.propose(fleet, opts)
    failed = [isinstance(r, ta.OptimizationFailureError) for r in results]
    assert failed == ([False] * 3 if case == "strict"
                      else [False, True, True])
    assert all(_unwrap(r)[0].hard_goal_audit for r in results)
    for jres, tres, cid in zip(jax_results[case], results,
                               ("c0", "c1", "c2")):
        assert_same_result(jres, tres, cid)
    assert_equals_sequential(topt, fleet, results, opts)


def test_grouping_degrades_on_mixed_configs(engines, jax_results):
    """A 3-broker toy clamps num_dest_candidates below the others: two
    groups, each equal to the reference and to its sequential optimize."""
    _, (topt, tfo) = engines
    fleet = mixed("torch")
    opts = ta.OptimizationOptions(seed=7, skip_hard_goal_check=True)
    results = tfo.propose(fleet, opts)
    assert tfo._groups_gauge_val == 2
    for jres, tres, cid in zip(jax_results["mixed"], results, ("a", "b")):
        assert_same_result(jres, tres, cid)
    assert_equals_sequential(topt, fleet, results, opts)


def test_padding_slots_and_bucket_floor(engines):
    """A bucket floor changes the reported layout only: no padding slot
    is stacked or runs, and the results stay equal."""
    _, (_topt, tfo) = engines
    opts = ta.OptimizationOptions(**SKIP)
    want = tfo.propose(fleet3("torch"), opts)
    fleet = fleet3("torch")
    assert fleet.num_clusters_padded == 3
    tfo.cluster_bucket_floor = 8
    try:
        got = tfo.propose(fleet, opts)
        assert tfo.last_layout == {"devices": 1, "clustersPerDevice": 8,
                                   "clustersPadded": 8}
    finally:
        tfo.cluster_bucket_floor = 0
    assert len(got) == 3
    for w, g in zip(want, got):
        assert [p.to_json() for p in g.proposals] \
            == [p.to_json() for p in w.proposals]
        assert _goal_rows(g.goal_results) == _goal_rows(w.goal_results)


# ------------------------------------------------------------- group keys

def test_group_key_carries_seed(engines):
    _, (_topt, tfo) = engines
    member = fleet3("torch").members[0]
    p1 = tfo._prepare_member(member, ta.OptimizationOptions(
        seed=1, skip_hard_goal_check=True))
    p2 = tfo._prepare_member(member, ta.OptimizationOptions(
        seed=2, skip_hard_goal_check=True))
    assert p1["group_key"] != p2["group_key"]


def test_tuned_buckets_split_groups_not_key_streams(tmp_path):
    """Members in differently tuned shape buckets split into groups; the
    split is the config, never the seed."""
    store = ta.TunedConfigStore(str(tmp_path / "tuned.json"))
    ma, mda = _cluster(tspec, 8, 96, 1, device="cpu")
    mb, mdb = _cluster(tspec, 8, 100, 2, device="cpu")
    mc, mdc = _cluster(tspec, 10, 128, 3, device="cpu")
    assert ta.shape_bucket(96, 8) == ta.shape_bucket(100, 8)
    assert ta.shape_bucket(96, 8) != ta.shape_bucket(128, 10)
    store.record(96, 8, {"max_iters_per_goal": 32}, save=False)
    store.record(128, 10, {"max_iters_per_goal": 40}, save=False)
    fo = tf.FleetOptimizer(optimizer("torch", tuned_store=store))
    fleet = tf.FleetModel.stack([("a", ma, mda), ("b", mb, mdb),
                                 ("c", mc, mdc)], broker_pad_multiple=8,
                                partition_pad_multiple=64, device="cpu")
    opts = ta.OptimizationOptions(seed=7, skip_hard_goal_check=True)
    pa, pb, pc = [fo._prepare_member(m, opts) for m in fleet.members]
    assert pa["cfg"].max_iters_per_goal == 32
    assert pc["cfg"].max_iters_per_goal == 40
    assert pa["group_key"] == pb["group_key"]
    assert pa["group_key"] != pc["group_key"]
    assert pa["group_key"][-1] == pc["group_key"][-1] == opts.seed


# ------------------------------------------------------------- guards

@pytest.mark.parametrize("kw", [
    dict(branches=2),
    dict(population=2),
    dict(mesh="one-device"),
], ids=["branches", "population", "mesh"])
def test_exclusivity_guards(kw):
    if kw.get("mesh"):
        kw = dict(mesh=make_mesh(1, device="cpu"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tf.FleetOptimizer(optimizer("torch", **kw))


def test_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, md = _cluster(tspec, 8, 96, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.FleetModel.stack([("a", m, md)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.FleetOptimizer(ta.TorchGoalOptimizer(goals=ta.goals_by_name(GOALS)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.FleetRegistry(ta.TorchGoalOptimizer(goals=ta.goals_by_name(GOALS)))


def test_fleet_on_another_device_is_refused(engines):
    _, (_topt, tfo) = engines
    fleet = fleet3("torch")
    tfo.device = torch.device("meta")
    try:
        with pytest.raises(ValueError, match="lies on"):
            tfo.propose(fleet, ta.OptimizationOptions(**SKIP))
        with pytest.raises(ValueError, match="lies on"):
            tfo.sweep_n1(fleet)
    finally:
        tfo.device = torch.device("cpu")
