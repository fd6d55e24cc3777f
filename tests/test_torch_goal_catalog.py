"""The goal catalog's second half in the port (``analyzer/goals.py``:
RackAware, RackAwareDistribution and the kafka-assigner pair, the topic,
leader and potential-NW_OUT goals, PreferredLeaderElection, BrokerSetAware
and the active MinTopicLeadersPerBroker) against the JAX package:

- per goal, on clusters that give each goal work (a rack-crowded RF-3
  cluster, one in broker sets with interested topics, and rows of B1 = 23,
  24, 25 and 32): violation (also vmapped over a batch of three
  scenarios) and scale, candidates, deltas, acceptance and the collective guard
  (topic and leader cells through KK's twin), all exact, float violations
  bit for bit;
- TopicReplicaDistributionGoal's ``[T, B1]`` violation sum in the order XLA
  gives it, unbatched, vmapped and nested, at T x B1 from 1 x 9 to
  200 x 104 (``utils/ordered.py:topic_cell_sum``);
- topic and topic-leader counts over a scenario batch, against the
  reference's vmapped ``init_state``;
- KK's twin (``kernels.cell_net_flow_plain``) against the reference's
  guard formula on colliding cell ids;
- the port's mirror of ``tests/test_goal_catalog.py`` (each goal repairs
  its fixture's violation), of the goal cases of ``test_goals_extra.py``
  and ``test_exclusions.py``, and of ``test_random_invariants.py``.

The reference runs every goal function inside a jitted program, so each
JAX call here is jitted too."""

import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu.model.flat as jflat
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer import (OptimizationFailureError,
                                               OptimizationOptions,
                                               SearchConfig,
                                               TorchGoalOptimizer,
                                               goals_by_name)
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from cruise_control_tpu_torch.config.brokersets import topic_set_array
from cruise_control_tpu_torch.model.flat import (FlatClusterModel,
                                                 broker_replica_counts,
                                                 broker_utilization,
                                                 sanity_check)
from cruise_control_tpu_torch.utils.ordered import topic_cell_sum
from torch_parity_util import assert_same, build_both, model_arrays

torch.set_num_threads(1)

NEW_GOALS = ["RackAwareGoal", "RackAwareDistributionGoal",
             "KafkaAssignerEvenRackAwareGoal",
             "KafkaAssignerDiskUsageDistributionGoal",
             "TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
             "LeaderBytesInDistributionGoal", "PotentialNwOutGoal",
             "PreferredLeaderElectionGoal", "BrokerSetAwareGoal",
             "MinTopicLeadersPerBrokerGoal"]
#: the goals whose violation is a float row (or the topic cells), held at
#: each pad width
ROW_GOALS = ["TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
             "LeaderBytesInDistributionGoal", "PotentialNwOutGoal",
             "KafkaAssignerDiskUsageDistributionGoal"]
#: tight capacities (PotentialNwOut and the capacity caps have work) and
#: a minimum of one leader of every t1* topic on every broker
CST = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
           topics_with_min_leaders_per_broker="t1*",
           min_topic_leaders_per_broker=1)
CFG = dict(num_replica_candidates=96, num_dest_candidates=8,
           num_swap_candidates=48, apply_per_iter=96, drain_batch=256)


def _spec_both(brokers, parts, **kw):
    """Both packages' flat models of one spec (dicts of spec fields)."""
    out = []
    for mod, dev in ((jspec, {}), (tspec, {"device": "cpu"})):
        spec = mod.ClusterSpec(
            brokers=[mod.BrokerSpec(**b) for b in brokers],
            partitions=[mod.PartitionSpec(**p) for p in parts])
        out.append(mod.flatten_spec(spec, **kw, **dev))
    return out[0], out[1]


def crowded_both():
    """12 brokers on 3 racks, RF 3, replicas often sharing a rack; leaders
    and topics crowded onto the first brokers."""
    rng = np.random.default_rng(21)
    brokers = [dict(broker_id=i, rack=f"r{i % 3}",
                    capacity=(100.0, 1e5, 1e5, 1e6)) for i in range(12)]
    parts = []
    for p in range(300):
        first = int(rng.integers(0, 4))
        reps = [first, (first + 3 * int(rng.integers(1, 4))) % 12,
                int(rng.integers(4, 12))]
        if len(set(reps)) < 3:
            reps = [first, (first + 1) % 12, (first + 2) % 12]
        parts.append(dict(topic=f"t{p % 5}", partition=p, replicas=reps,
                          leader_load=(0.02 + 0.02 * float(rng.random()),
                                       5 + 10 * float(rng.random()),
                                       8 + 15 * float(rng.random()),
                                       50 + 100 * float(rng.random()))))
    return _spec_both(brokers, parts)


def sets_both():
    """10 brokers in three broker sets, 12 topics (t1, t10, t11 interested),
    RF 2 at random: the broker-set and leader-minimum goals have work."""
    rng = np.random.default_rng(8)
    brokers = [dict(broker_id=i, rack=f"r{i % 4}", broker_set=f"s{i % 3}",
                    capacity=(100.0, 1e5, 1e5, 1e6)) for i in range(10)]
    parts = [dict(topic=f"t{p % 12}", partition=p,
                  replicas=[int(b) for b in rng.choice(4 if p % 2 else 10, 2,
                                                        replace=False)],
                  leader_load=(0.03, 5 + 10 * float(rng.random()),
                               8 + 15 * float(rng.random()),
                               50 + 100 * float(rng.random())))
             for p in range(240)]
    return _spec_both(brokers, parts)


MODELS = {
    "crowded": crowded_both,
    "sets": sets_both,
    # rows of B1 = 23, 24, 25 and 32: the pad multiple of one broker
    "b23": lambda: build_both(22, 600, seed=31, broker_pad_multiple=1),
    "b24": lambda: build_both(23, 600, seed=32, broker_pad_multiple=1),
    "b25": lambda: build_both(24, 600, seed=33, broker_pad_multiple=1),
    "b32": lambda: build_both(31, 600, seed=34, broker_pad_multiple=1),
}
CASES = ([(m, g) for m in ("crowded", "sets") for g in NEW_GOALS]
         + [(m, g) for m in ("b23", "b24", "b25", "b32") for g in ROW_GOALS])
_BUILT = {}


def _built(name):
    """(jax (state, ctx, md, stacked), port (state, ctx, md, stacked)),
    built once per module: the model, its metadata, and a batch of three
    scenarios (the model; loads x 1.1 with broker 1 dead; followers x 0.9
    with some replicas moved)."""
    if name not in _BUILT:
        (jm, jmd), (tm, tmd) = MODELS[name]()
        topics = dict(with_topic_counts=jmd.num_topics,
                      with_topic_leader_counts=True)
        arrays = model_arrays(jm)
        rows = []
        for s in range(3):
            a = {k: v.copy() for k, v in arrays.items()}
            if s == 1:
                a["leader_load"] = (a["leader_load"]
                                    * np.float32(1.1)).astype(np.float32)
                a["broker_alive"][1] = False
            if s == 2:
                a["follower_load"] = (a["follower_load"]
                                      * np.float32(0.9)).astype(np.float32)
                rb, B = a["replica_broker"], jmd.num_brokers
                for p in range(0, min(60, jmd.num_partitions), 3):
                    nb = (rb[p, -1] + 1) % B
                    if nb not in rb[p]:
                        rb[p, -1] = nb
            rows.append(a)
        stacked = {k: np.stack([r[k] for r in rows]) for k in arrays}
        jstack = jflat.FlatClusterModel(**{k: jnp.asarray(v)
                                           for k, v in stacked.items()})
        tstack = FlatClusterModel.from_numpy(device="cpu", **stacked)
        _BUILT[name] = (
            (js.init_state(jm, **topics), js.build_context(jm), jmd, jstack),
            (ts.init_state(tm, **topics), ts.build_context(tm), tmd, tstack))
    return _BUILT[name]


def _goal_pair(name, jmd, tmd):
    jgoal = jg.goals_by_name([name], JConstraint(**CST))[0].bind(jmd)
    tgoal = tg.goals_by_name([name], TConstraint(**CST))[0].bind(tmd)
    return jgoal, tgoal


def _same_cands(jc, tc, rows):
    for name in ("p", "r", "p2", "r2", "src", "dst", "kind", "valid", "must",
                 "d_util_src", "d_util_dst", "d_cnt", "d_lead", "d_pot",
                 "d_lni"):
        want = np.asarray(getattr(jc, name))
        if name == "p2":
            # an invalid topic swap's negative partner row: the row the
            # reference's gathers read
            want = np.where(want < 0, want + rows, want).clip(0, rows - 1)
        assert_same(want, getattr(tc, name), what=f"candidates.{name}")


@pytest.mark.parametrize("model,name", CASES)
def test_goal_parity(model, name):
    (jst, jctx, jmd, jstack), (tst, tctx, tmd, tstack) = _built(model)
    jgoal, tgoal = _goal_pair(name, jmd, tmd)
    assert (tgoal.name, tgoal.hard, tgoal.uses_topic_counts) == (
        jgoal.name, jgoal.hard, jgoal.uses_topic_counts)
    assert_same(jax.jit(jgoal.violation)(jst, jctx),
                tgoal.violation(tst, tctx), what="violation")
    assert_same(jax.jit(jgoal.violation_scale)(jst, jctx),
                tgoal.violation_scale(tst, tctx), what="scale")
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)

    # The goal's violation vmapped over the batch: its own program (the
    # scorer's scales, fused with every goal's, are held by
    # tests/test_torch_default_chain.py's N-1 sweeps at the same widths).
    def jbatch(m):
        return jgoal.violation(js.init_state(m, **topics),
                               js.build_context(m))
    tbs, tbc = ts.init_state(tstack, **topics), ts.build_context(tstack)
    assert_same(jax.jit(jax.vmap(jbatch))(jstack),
                tgoal.violation(tbs, tbc), what="vmapped violation")

    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jc = jax.jit(lambda s, c, k: jgoal.propose(s, c, k, jcfg))(
        jst, jctx, jax.random.PRNGKey(3))
    tc = tgoal.propose(tst, tctx, _random.PRNGKey(3), tcfg)
    _same_cands(jc, tc, tst.rb.shape[0])
    assert_same(jax.jit(jgoal.delta)(jst, jctx, jc),
                tgoal.delta(tst, tctx, tc), what="delta")
    assert_same(jax.jit(jgoal.accepts)(jst, jctx, jc),
                tgoal.accepts(tst, tctx, tc), what="accepts")
    M = min(96, tc.p.shape[0])
    earlier = np.tril(np.random.default_rng(5).random((M, M)) < 0.7, k=-1)
    jguard = jax.jit(jgoal.collective_guard)(
        jst, jctx, jax.tree.map(lambda x: x[:M], jc), jnp.asarray(earlier))
    tguard = tgoal.collective_guard(tst, tctx, tc.take(torch.arange(M)),
                                    torch.from_numpy(earlier))
    assert_same(jguard, tguard, what="collective_guard")


def test_cases_give_each_goal_work():
    """Every new goal starts violated on at least one of its clusters (so
    the parity above compares real candidates and deltas)."""
    violated = set()
    for model, name in CASES:
        (jst, jctx, jmd, _), (tst, tctx, tmd, _) = _built(model)
        _, tgoal = _goal_pair(name, jmd, tmd)
        if float(tgoal.violation(tst, tctx)) > 0:
            violated.add(name)
    assert violated == set(NEW_GOALS) - {"PreferredLeaderElectionGoal"}
    assert not tg.MinTopicLeadersPerBrokerGoal(TConstraint()).bind(
        _built("sets")[1][2]).uses_topic_counts


@pytest.mark.parametrize("model", sorted(MODELS))
def test_topic_counts_over_a_batch(model):
    """init_state's topic and topic-leader counts over a scenario batch
    (each scenario its own placement and validity) equal the reference's
    vmapped init_state."""
    (_, _, jmd, jstack), (_, _, _, tstack) = _built(model)
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    want = jax.jit(jax.vmap(lambda m: js.init_state(m, **topics)))(jstack)
    got = ts.init_state(tstack, **topics)
    assert got.topic_counts.shape == (3, jmd.num_topics,
                                      jstack.broker_capacity.shape[1] + 1)
    assert_same(want.topic_counts, got.topic_counts, what="topic_counts")
    assert_same(want.topic_leader_counts, got.topic_leader_counts,
                what="topic_leader_counts")
    nested = FlatClusterModel(**{k: v.reshape((1, 3) + v.shape[1:])
                                 for k, v in vars(tstack).items()})
    assert_same(want.topic_counts,
                ts.init_state(nested, **topics).topic_counts[0],
                what="nested topic_counts")


# ---------------------------------------------------------------------------
# The [T, B1] violation sum
# ---------------------------------------------------------------------------

def _topic_violation(goal, tc, alive, valid):
    return goal.violation(types.SimpleNamespace(topic_counts=tc),
                          types.SimpleNamespace(broker_alive=alive,
                                                broker_valid=valid))


@pytest.mark.parametrize("T,B1,lead", [
    (1, 9, ()), (4, 12, ()), (8, 9, ()), (8, 17, ()), (12, 22, ()),
    (16, 20, ()), (17, 9, ()), (31, 16, ()), (6, 23, ()), (16, 24, ()),
    (17, 25, ()), (5, 32, ()), (8, 33, ()), (40, 25, ()), (200, 104, ()),
    (1, 22, (3,)), (4, 9, (3,)), (8, 22, (3,)), (9, 17, (3,)),
    (18, 23, (3,)), (16, 31, (2, 3)), (1, 22, (2, 2)), (40, 25, (3,)),
    (200, 104, (2,))])
def test_topic_cell_sum_matches_xla(T, B1, lead):
    """The topic goal's violation bit for bit against the reference's
    jitted (vmapped, nested) violation, on counts spread over 14 binades
    so that any other order gives other bits."""
    rng = np.random.default_rng(T * 1000 + B1)
    jgoal = jg.TopicReplicaDistributionGoal(JConstraint())
    tgoal = tg.TopicReplicaDistributionGoal(TConstraint())
    fn = lambda tc, al, va: _topic_violation(jgoal, tc, al, va)  # noqa: E731
    for _ in lead:
        fn = jax.vmap(fn)
    for _ in range(3):
        tc = np.exp(rng.uniform(0, 14, lead + (T, B1))).astype(np.int32)
        tc[..., -1] = 0
        alive = rng.random(lead + (B1,)) < 0.85
        alive[..., -1] = False
        valid = alive | (rng.random(lead + (B1,)) < 0.5)
        valid[..., -1] = False
        want = jax.jit(fn)(tc, alive, valid)
        got = _topic_violation(tgoal, *(torch.from_numpy(a)
                                        for a in (tc, alive, valid)))
        assert_same(want, got, what=f"{T}x{B1} {lead}")


def test_topic_cell_sum_refuses_unread_widths():
    with pytest.raises(ValueError, match="not identified"):
        topic_cell_sum(torch.ones(8, 5))


# ---------------------------------------------------------------------------
# KK's twin
# ---------------------------------------------------------------------------

def _reference_net(query, key, val, earlier):
    """The reference's guard formula (goals.py:1397-1404, :1565-1570): per
    query, ``acc = 0`` plus one masked [M, M] product per cell slot."""
    e = earlier.astype(jnp.float32)
    out = []
    for a in range(val.shape[0]):
        acc = jnp.zeros(query.shape[1], jnp.float32)
        for k in range(val.shape[1]):
            acc = acc + (e * (query[a][:, None] == key[k][None, :])) @ val[a, k]
        out.append(acc)
    return jnp.stack(out)


@pytest.mark.parametrize("m,a,k,density", [
    (1, 4, 4, 0.5), (17, 4, 4, 0.7), (64, 2, 2, 0.9), (96, 4, 4, 0.0),
    (200, 3, 2, 0.6)])
def test_cell_net_flow_twin_matches_reference_formula(m, a, k, density):
    rng = np.random.default_rng(m + a)
    key = rng.integers(-1, 6, (k, m))               # few ids: many collide
    query = np.where(rng.random((a, m)) < 0.3, rng.integers(-1, 6, (a, m)),
                     key[np.arange(a) % k])
    val = rng.integers(-4, 5, (a, k, m)).astype(np.float32)
    earlier = np.tril(rng.random((m, m)) < density, k=-1)
    want = jax.jit(_reference_net)(jnp.asarray(query), jnp.asarray(key),
                                   jnp.asarray(val), jnp.asarray(earlier))
    got = kernels.cell_net_flow(*(torch.from_numpy(x)
                                  for x in (query, key, val, earlier)))
    assert_same(want, got, what="cell_net_flow")
    assert kernels.LAUNCHES["cell_net_flow"] == 0      # the twin on the CPU


def test_cell_net_flow_checks_shapes():
    q = torch.zeros(4, 8, dtype=torch.long)
    e = torch.zeros(8, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="1-4"):
        kernels.cell_net_flow(torch.zeros(5, 8, dtype=torch.long), q,
                              torch.zeros(5, 4, 8), e)
    with pytest.raises(ValueError, match="val"):
        kernels.cell_net_flow(q, q, torch.zeros(4, 3, 8), e)
    with pytest.raises(ValueError, match="earlier"):
        kernels.cell_net_flow(q, q, torch.zeros(4, 4, 8), e.float())


# ---------------------------------------------------------------------------
# Mirror of tests/test_goal_catalog.py: each goal repairs its violation
# ---------------------------------------------------------------------------

CATALOG_CFG = SearchConfig(num_replica_candidates=128, num_dest_candidates=8,
                           apply_per_iter=64, max_iters_per_goal=128,
                           drain_batch=512, drain_rounds=4)
CAP = (100.0, 1000.0, 1000.0, 10_000.0)


def _cluster(loads, num_brokers=6, partitions=96, racks=3, crowd=2,
             topic_mod=4):
    brokers = [tspec.BrokerSpec(broker_id=b, rack=f"r{b % racks}",
                                capacity=CAP) for b in range(num_brokers)]
    parts = [tspec.PartitionSpec(topic=f"t{p % topic_mod}", partition=p,
                                 replicas=[p % crowd, (p + 1) % crowd],
                                 leader_load=loads(p))
             for p in range(partitions)]
    return tspec.flatten_spec(tspec.ClusterSpec(brokers=brokers,
                                                partitions=parts),
                              device="cpu")


def _leader_skew_cluster(loads, num_brokers=6, partitions=96):
    brokers = [tspec.BrokerSpec(broker_id=b, rack=f"r{b % 3}", capacity=CAP)
               for b in range(num_brokers)]
    parts = [tspec.PartitionSpec(topic=f"t{p % 4}", partition=p,
                                 replicas=[p % 2, 2 + p % (num_brokers - 2)],
                                 leader_load=loads(p))
             for p in range(partitions)]
    return tspec.flatten_spec(tspec.ClusterSpec(brokers=brokers,
                                                partitions=parts),
                              device="cpu")


def _run(model, md, goals, config=CATALOG_CFG, **opts):
    opt = TorchGoalOptimizer(goals=goals, config=config, device="cpu")
    opts.setdefault("skip_hard_goal_check", True)
    res = opt.optimize(model, md, OptimizationOptions(seed=0, **opts))
    checks = sanity_check(res.final_model)
    assert all(int(v) == 0 for v in checks.values()), checks
    return res


FIXTURES = {
    "CpuCapacityGoal": lambda: _cluster(lambda p: (2.0, 1.0, 1.0, 10.0)),
    "NetworkInboundCapacityGoal":
        lambda: _cluster(lambda p: (0.1, 20.0, 1.0, 10.0)),
    "NetworkOutboundCapacityGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 20.0, 10.0)),
    "DiskCapacityGoal": lambda: _cluster(lambda p: (0.1, 1.0, 1.0, 200.0)),
    "CpuUsageDistributionGoal":
        lambda: _cluster(lambda p: (0.5 + 0.01 * (p % 7), 1.0, 1.0, 10.0)),
    "NetworkInboundUsageDistributionGoal":
        lambda: _cluster(lambda p: (0.1, 5.0 + p % 5, 1.0, 10.0)),
    "NetworkOutboundUsageDistributionGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 5.0 + p % 5, 10.0)),
    "DiskUsageDistributionGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 1.0, 40.0 + p % 11)),
    "ReplicaDistributionGoal": lambda: _cluster(lambda p: (0.1, 1, 1, 10.0)),
    "TopicReplicaDistributionGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 1.0, 10.0), topic_mod=1),
    "LeaderReplicaDistributionGoal":
        lambda: _leader_skew_cluster(lambda p: (0.1, 1.0, 1.0, 10.0)),
    "LeaderBytesInDistributionGoal":
        lambda: _leader_skew_cluster(lambda p: (0.1, 6.0 + p % 4, 1.0, 10.0)),
    "PotentialNwOutGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 18.0, 10.0)),
    "KafkaAssignerDiskUsageDistributionGoal":
        lambda: _cluster(lambda p: (0.1, 1.0, 1.0, 40.0 + p % 11)),
}


@pytest.mark.parametrize("goal_name", sorted(FIXTURES))
def test_goal_repairs_its_violation(goal_name):
    model, md = FIXTURES[goal_name]()
    res = _run(model, md, goals_by_name([goal_name]))
    g = res.goal_results[0]
    assert g.violation_before > 0, goal_name
    assert g.violation_after <= g.violation_before * 0.05 + 1e-6, (
        f"{goal_name}: {g.violation_before} -> {g.violation_after}")


@pytest.mark.parametrize("resource,goal_name", [
    (0, "CpuCapacityGoal"), (1, "NetworkInboundCapacityGoal"),
    (2, "NetworkOutboundCapacityGoal"), (3, "DiskCapacityGoal")])
def test_capacity_goal_enforces_threshold(resource, goal_name):
    model, md = FIXTURES[goal_name]()
    res = _run(model, md, goals_by_name([goal_name]))
    util = broker_utilization(res.final_model).numpy()[:6, resource]
    limit = CAP[resource] * TConstraint().capacity_threshold[resource]
    assert (util <= limit + 1e-3).all(), (util, limit)


def test_replica_capacity_goal_enforces_max_replicas():
    cst = TConstraint(max_replicas_per_broker=40)
    model, md = _cluster(lambda p: (0.1, 1.0, 1.0, 10.0))
    res = _run(model, md, goals_by_name(["ReplicaCapacityGoal"], cst))
    counts = broker_replica_counts(res.final_model).numpy()[:6]
    assert (counts <= 40).all() and counts.sum() == 192


def test_every_registry_goal_has_catalog_coverage():
    covered = set(FIXTURES) | {
        "ReplicaCapacityGoal", "RackAwareGoal", "RackAwareDistributionGoal",
        "PreferredLeaderElectionGoal", "MinTopicLeadersPerBrokerGoal",
        "BrokerSetAwareGoal", "KafkaAssignerEvenRackAwareGoal"}
    assert not sorted(set(tg.GOAL_REGISTRY) - covered)


# --- the goal cases of tests/test_goals_extra.py ---------------------------

def _build(brokers, parts):
    return tspec.flatten_spec(tspec.ClusterSpec(brokers=brokers,
                                                partitions=parts),
                              device="cpu")


def test_preferred_leader_election_restores_drifted_leaders():
    brokers = [tspec.BrokerSpec(broker_id=i, rack=f"r{i}") for i in range(3)]
    parts = [tspec.PartitionSpec("t", 0, replicas=[1, 0],
                                 preferred_replicas=[0, 1],
                                 leader_load=(1.0, 5.0, 5.0, 10.0)),
             tspec.PartitionSpec("t", 1, replicas=[1, 2],
                                 leader_load=(1.0, 5.0, 5.0, 10.0))]
    model, md = _build(brokers, parts)
    res = _run(model, md, goals_by_name(["PreferredLeaderElectionGoal"]))
    ple = res.goal_results[0]
    assert ple.violation_before == 1.0 and ple.violation_after == 0.0
    assert len(res.proposals) == 1 and res.proposals[0].new_leader == 0


def test_min_topic_leaders_per_broker():
    brokers = [tspec.BrokerSpec(broker_id=i, rack=f"r{i}") for i in range(3)]
    parts = [tspec.PartitionSpec("hot", p, replicas=[0, 1 + p % 2],
                                 leader_load=(1.0, 5.0, 5.0, 10.0))
             for p in range(6)]
    model, md = _build(brokers, parts)
    cst = TConstraint()
    goal = tg.MinTopicLeadersPerBrokerGoal(cst, interested_topics=[True])
    res = _run(model, md, [goal])
    assert res.goal_results[0].violation_before == 2.0
    assert res.goal_results[0].violation_after == 0.0
    res2 = _run(model, md, [tg.MinTopicLeadersPerBrokerGoal(cst)])
    assert res2.goal_results[0].violation_before == 0.0
    cst3 = TConstraint(topics_with_min_leaders_per_broker="hot*")
    res3 = _run(model, md, [tg.MinTopicLeadersPerBrokerGoal(cst3)])
    assert res3.goal_results[0].violation_before == 2.0
    assert res3.goal_results[0].violation_after == 0.0


def test_broker_set_aware_goal():
    sets = {0: "A", 1: "A", 2: "B", 3: "B"}
    brokers = [tspec.BrokerSpec(broker_id=i, rack=f"r{i}",
                                broker_set=sets[i]) for i in range(4)]
    parts = [tspec.PartitionSpec("a", p, replicas=[p % 2, 2 + p % 2],
                                 leader_load=(1.0, 5.0, 5.0, 10.0))
             for p in range(4)]
    model, md = _build(brokers, parts)
    tset = topic_set_array(md.topics, md.broker_sets, explicit={"a": "A"})
    res = _run(model, md, [tg.BrokerSetAwareGoal(TConstraint(),
                                                 topic_set=tset)])
    gr = res.goal_results[0]
    assert gr.violation_before == 4.0 and gr.violation_after == 0.0
    rb = res.final_model.replica_broker.numpy()
    assert set(rb[rb < res.final_model.broker_sentinel].tolist()) <= {0, 1}


def test_rack_aware_distribution_allows_rf_above_racks():
    brokers = [tspec.BrokerSpec(broker_id=i, rack=f"r{i % 2}")
               for i in range(4)]
    parts = [tspec.PartitionSpec("t", 0, replicas=[0, 2, 1],
                                 leader_load=(1.0, 5.0, 5.0, 10.0)),
             tspec.PartitionSpec("t", 1, replicas=[0, 2, 3],
                                 leader_load=(1.0, 5.0, 5.0, 10.0))]
    model, md = _build(brokers, parts)
    res = _run(model, md, [tg.RackAwareDistributionGoal()])
    assert res.goal_results[0].violation_after == 0.0
    rb = res.final_model.replica_broker.numpy()
    racks = res.final_model.broker_rack.numpy()
    for p in range(2):
        row = rb[p][rb[p] < res.final_model.broker_sentinel]
        assert np.bincount(racks[row], minlength=2).max() <= 2


# --- the goal cases of tests/test_exclusions.py ----------------------------

def test_excluded_brokers_receive_no_leadership():
    brokers = [tspec.BrokerSpec(broker_id=b, rack=f"r{b % 4}",
                                capacity=(100.0, 1e6, 1e6, 1e8))
               for b in range(8)]
    parts = [tspec.PartitionSpec(topic=f"t{p % 6}", partition=p,
                                 replicas=[p % 3, 3 + p % 3],
                                 leader_load=(0.02, 5.0, 6.0, 40.0 + p % 11))
             for p in range(256)]
    model, md = _build(brokers, parts)
    excluded = frozenset({0, 1})
    res = _run(model, md, goals_by_name(["LeaderReplicaDistributionGoal",
                                         "NetworkOutboundUsageDistributionGoal"]),
               excluded_brokers_for_leadership=excluded)
    rb0 = model.replica_broker.numpy()
    rbF = res.final_model.replica_broker.numpy()
    for p in range(md.num_partitions):
        if int(rbF[p, 0]) in excluded:
            assert int(rb0[p, 0]) == int(rbF[p, 0]), p
    for i in (4, 8, 12, 16, 20):
        assert rbF[i, 0] != 0, i


def test_kafka_assigner_mode_fixes_racks_with_minimal_movement():
    brokers = [tspec.BrokerSpec(broker_id=b, rack=f"r{b % 3}",
                                capacity=(100.0, 1e6, 1e6, 1e8))
               for b in range(6)]
    parts = [tspec.PartitionSpec(
        topic=f"t{p % 4}", partition=p,
        replicas=[0, 3] if p % 2 == 0 else [p % 3, 3 + (p + 1) % 3],
        leader_load=(0.02, 5.0, 6.0, 100.0)) for p in range(192)]
    model, md = _build(brokers, parts)
    res = _run(model, md, goals_by_name(tg.KAFKA_ASSIGNER_GOALS))
    rack = goals_by_name(["KafkaAssignerEvenRackAwareGoal"])[0]
    st = ts.init_state(res.final_model)
    assert float(rack.violation(st, ts.build_context(res.final_model))) == 0.0
    assert res.num_moves <= 96 * 2 + 32, res.num_moves


# --- the goal cases of tests/test_random_invariants.py ---------------------

GOAL_POOL = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
             "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
             "NetworkInboundUsageDistributionGoal",
             "LeaderReplicaDistributionGoal", "TopicReplicaDistributionGoal",
             "LeaderBytesInDistributionGoal", "PotentialNwOutGoal"]
INVARIANT_CFG = SearchConfig(num_replica_candidates=128,
                             num_dest_candidates=8, apply_per_iter=128,
                             max_iters_per_goal=96, drain_batch=1024,
                             drain_rounds=4)


def random_cluster(seed: int, dead_brokers: int = 0):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(8, 14))
    P = int(rng.integers(128, 320))
    racks = int(rng.integers(3, 6))
    brokers = [tspec.BrokerSpec(broker_id=b, rack=f"r{b % racks}",
                                capacity=(100.0, 1e6, 1e6, 1e8),
                                alive=(b >= dead_brokers)) for b in range(B)]
    parts = []
    for p in range(P):
        rf = int(rng.integers(2, 4))
        reps = rng.choice(B, size=rf, replace=False).tolist()
        load = (0.01 + 0.05 * rng.random(), 1 + 20 * rng.random(),
                1 + 25 * rng.random(), 10 + 300 * rng.random())
        parts.append(tspec.PartitionSpec(topic=f"t{p % 12}", partition=p,
                                         replicas=[int(b) for b in reps],
                                         leader_load=load))
    return _build(brokers, parts)


@pytest.mark.parametrize("seed", [11, 29, 47])
def test_random_goal_orderings_preserve_invariants(seed):
    model, md = random_cluster(seed)
    names = GOAL_POOL[:]
    random.Random(seed).shuffle(names)
    names = names[:6]
    hard = {"RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal"}
    opt = TorchGoalOptimizer(goals=goals_by_name(names), config=INVARIANT_CFG,
                             device="cpu")
    try:
        res = opt.optimize(model, md, OptimizationOptions(seed=seed))
    except OptimizationFailureError as e:
        assert set(e.result.violated_hard_goals) & hard, e.result
        return
    assert all(int(v) == 0 for v in sanity_check(res.final_model).values())
    st = ts.init_state(res.final_model)
    ctx = ts.build_context(res.final_model)
    for goal in goals_by_name([n for n in names if n in hard]):
        assert float(goal.violation(st, ctx)) <= 1e-6, goal.name
    rb0 = model.replica_broker.numpy()
    rbF = res.final_model.replica_broker.numpy()
    Bpad = model.num_brokers_padded
    proposed = set()
    for prop in res.proposals:
        p = md.partition_index[(prop.topic, prop.partition)]
        proposed.add(p)
        assert set(prop.old_replicas) == {int(b) for b in rb0[p] if b < Bpad}
        assert set(prop.new_replicas) == {int(b) for b in rbF[p] if b < Bpad}
    for p in range(md.num_partitions):
        if p not in proposed:
            assert (np.sort(rb0[p]) == np.sort(rbF[p])).all()
            assert rb0[p, 0] == rbF[p, 0]


@pytest.mark.parametrize("seed", [5, 23])
def test_self_healing_drains_dead_brokers(seed):
    model, md = random_cluster(seed, dead_brokers=2)
    res = _run(model, md, goals_by_name(["RackAwareGoal",
                                         "ReplicaDistributionGoal",
                                         "DiskUsageDistributionGoal"]),
               config=INVARIANT_CFG)
    rb = res.final_model.replica_broker.numpy()
    valid = rb < res.final_model.num_brokers_padded
    assert not (valid & (rb <= 1)).any()
