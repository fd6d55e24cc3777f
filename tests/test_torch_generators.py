"""The goals' candidate generators in the port — KR's, KS's and KT's twins
(``kernels.replica_priority_plain``, ``dest_select_plain``,
``assemble_candidates_plain``, which the wrappers take for CPU tensors) —
against the JAX package.

- Every goal of the catalog proposes from the same seeded inputs in both
  packages and all of the candidates' fields are equal: rows of B1 = 23,
  24, 32 and 105 (the one wide case), dead brokers, RF 3 with racks and
  broker sets, padding partition rows (topic -1), active and inactive
  MinTopicLeadersPerBroker and BrokerSetAware (an all -inf priority),
  and forced ties (no noise: every tie broken by index alone).
- The context's weight range is ``_unit01``'s range of every weight form,
  so an interval goal's swap planes read it instead of reducing the
  weights each call.
- The twins' own edges: more candidates than replica slots, more
  destinations than alive brokers, brokers with no light slot for a
  topic swap.

The reference runs every goal function inside a jitted program, so each
JAX call here is jitted too."""

import jax
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from torch_parity_util import assert_same, build_both

torch.set_num_threads(1)

#: tight capacities (the capacity goals have work) and a minimum of one
#: leader of every t1* topic a broker (MinTopicLeadersPerBroker active)
ACTIVE = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
              max_replicas_per_broker=40,
              topics_with_min_leaders_per_broker="t1*",
              min_topic_leaders_per_broker=1)
CFG = dict(num_replica_candidates=64, num_dest_candidates=8,
           num_swap_candidates=32, apply_per_iter=64, drain_batch=128)
#: every proposal's priorities tie but for their tiers
TIES = dict(CFG, noise_scale=0.0)
GOALS = sorted(tg.GOAL_REGISTRY)
FIELDS = ("p", "r", "p2", "r2", "src", "dst", "kind", "valid", "must",
          "d_util_src", "d_util_dst", "d_cnt", "d_lead", "d_pot", "d_lni")


def _racks_sets_both():
    """14 brokers on 3 racks in 3 broker sets (two without one), RF 3,
    300 partitions of 12 topics, each topic's leaders on one of the first
    three brokers, padded to 384 partition rows (topic -1)."""
    rng = np.random.default_rng(17)
    brokers = [dict(broker_id=i, rack=f"r{i % 3}",
                    broker_set=f"s{i % 3}" if i < 12 else None,
                    capacity=(100.0, 1e5, 1e5, 1e6)) for i in range(14)]
    parts = []
    for p in range(300):
        first = p % 12 % 3
        reps = [first] + [int(b) for b in rng.choice(
            [b for b in range(14) if b != first], 2, replace=False)]
        parts.append(dict(topic=f"t{p % 12}", partition=p, replicas=reps,
                          leader_load=(0.02 + 0.02 * float(rng.random()),
                                       5 + 10 * float(rng.random()),
                                       8 + 15 * float(rng.random()),
                                       50 + 100 * float(rng.random()))))
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        spec = mod.ClusterSpec(
            brokers=[mod.BrokerSpec(**{k: v for k, v in b.items()
                                       if v is not None}) for b in brokers],
            partitions=[mod.PartitionSpec(**p) for p in parts])
        out.append(mod.flatten_spec(spec, **kw))
    return out[0], out[1]


MODELS = {
    "b23 dead": lambda: build_both(22, 400, seed=41, dead=(3,),
                                   broker_pad_multiple=1),
    "b24": lambda: build_both(23, 400, seed=42, broker_pad_multiple=1),
    "b32 dead": lambda: build_both(31, 400, seed=43, dead=(0, 5),
                                   broker_pad_multiple=1),
    "rf3 sets": _racks_sets_both,
    "b105": lambda: build_both(100, 1500, seed=44, dead=(7,)),
}
_BUILT = {}


def _built(name):
    """(jax (state, ctx, md), port (state, ctx, md)), once per module."""
    if name not in _BUILT:
        (jm, jmd), (tm, tmd) = MODELS[name]()
        topics = dict(with_topic_counts=jmd.num_topics,
                      with_topic_leader_counts=True)
        _BUILT[name] = (
            (js.init_state(jm, **topics), js.build_context(jm), jmd),
            (ts.init_state(tm, **topics), ts.build_context(tm), tmd))
    return _BUILT[name]


def _goal_pair(name, jmd, tmd, cst=ACTIVE):
    jgoal = jg.goals_by_name([name], JConstraint(**cst))[0].bind(jmd)
    tgoal = tg.goals_by_name([name], TConstraint(**cst))[0].bind(tmd)
    return jgoal, tgoal


def _propose_both(jgoal, tgoal, built, cfg, seed):
    (jst, jctx, _), (tst, tctx, _) = built
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jc = jax.jit(lambda s, c, k: jgoal.propose(s, c, k, jcfg))(
        jst, jctx, jax.random.PRNGKey(seed))
    tc = tgoal.propose(tst, tctx, _random.PRNGKey(seed), tcfg)
    return jc, tc


def _same_cands(jc, tc, rows, what):
    """Every field equal; an invalid topic swap's negative partner row is
    the row the reference's gathers read."""
    for name in FIELDS:
        want = np.asarray(getattr(jc, name))
        if name == "p2":
            want = np.where(want < 0, want + rows, want).clip(0, rows - 1)
        assert_same(want, getattr(tc, name), what=f"{what}.{name}")


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("name", GOALS)
@pytest.mark.parametrize("cfg", ["noise", "ties"])
def test_every_goal_proposes_as_the_reference(model, name, cfg):
    built = _built(model)
    jgoal, tgoal = _goal_pair(name, built[0][2], built[1][2])
    jc, tc = _propose_both(jgoal, tgoal, built, CFG if cfg == "noise"
                           else TIES, seed=len(name))
    _same_cands(jc, tc, built[1][0].rb.shape[0], f"{model} {name} {cfg}")


@pytest.mark.parametrize("model", ["b24", "rf3 sets"])
@pytest.mark.parametrize("name", ["MinTopicLeadersPerBrokerGoal",
                                  "BrokerSetAwareGoal"])
def test_inactive_goals_propose_as_the_reference(model, name):
    """No interested topic (the default constraint) and no broker sets
    (``b24``): an inactive goal's all -inf proposal."""
    built = _built(model)
    jgoal, tgoal = _goal_pair(name, built[0][2], built[1][2],
                              cst=dict(capacity_threshold=ACTIVE[
                                  "capacity_threshold"]))
    active = (name == "BrokerSetAwareGoal" and model == "rf3 sets")
    assert (tgoal.eligibility_row()["kind"] == "nothing") != active
    jc, tc = _propose_both(jgoal, tgoal, built, CFG, seed=2)
    _same_cands(jc, tc, built[1][0].rb.shape[0], f"{model} {name}")
    if not active:
        assert not tc.valid.any()


def test_the_cases_give_the_generators_work():
    """The cases reach what they are meant to: padding rows, dead brokers,
    a violated goal of every kind of generator, a broker with no light
    slot for TopicReplicaDistribution's swaps."""
    for model in MODELS:
        (_, _, _), (tst, tctx, tmd) = _built(model)
        assert (tctx.partition_topic == -1).any(), model
    (_, _, _), (tst, tctx, tmd) = _built("b32 dead")
    assert int((~tctx.broker_alive[:-1] & tctx.broker_valid[:-1]).sum()) == 2
    for model, names in (("rf3 sets", ["RackAwareGoal",
                                       "RackAwareDistributionGoal",
                                       "BrokerSetAwareGoal",
                                       "MinTopicLeadersPerBrokerGoal",
                                       "TopicReplicaDistributionGoal"]),
                         ("b105", ["DiskUsageDistributionGoal",
                                   "LeaderReplicaDistributionGoal"])):
        built = _built(model)
        for name in names:
            _, tgoal = _goal_pair(name, built[0][2], built[1][2])
            assert float(tgoal.violation(built[1][0], built[1][1])) > 0, (
                model, name)
    # a dead broker's replicas are offline, so not swappable: no light slot
    built = _built("b32 dead")
    _, tgoal = _goal_pair("TopicReplicaDistributionGoal", built[0][2],
                          built[1][2])
    tst, tctx, _ = built[1]
    _, upper = tgoal._bounds(tst, tctx)
    over = torch.clamp(tst.topic_counts.float() - upper[:, None],
                       min=0.0)[tg._jax_index(tctx.partition_topic,
                                              upper.shape[0])[:, None],
                                tst.rb]
    light = (tctx.movable & ~tst.offline & tctx.raw_dest_allowed[tst.rb]
             & (over <= 0.0))
    has = torch.zeros(tctx.broker_alive.shape[0], dtype=torch.bool)
    has[tst.rb[light]] = True
    assert (tctx.broker_valid & ~has).any()


@pytest.mark.parametrize("model", ["b23 dead", "rf3 sets"])
@pytest.mark.parametrize("name", ["RackAwareGoal",
                                  "TopicReplicaDistributionGoal",
                                  "DiskUsageDistributionGoal",
                                  "NetworkOutboundUsageDistributionGoal",
                                  "MinTopicLeadersPerBrokerGoal"])
def test_more_candidates_than_slots_and_brokers(model, name):
    """K and the swaps above P * R, D above the alive brokers (the grid's
    short-list keeps barred brokers at -inf)."""
    built = _built(model)
    P, R = built[1][0].rb.shape
    B1 = built[1][1].broker_alive.shape[0]
    cfg = dict(CFG, num_replica_candidates=P * R + 7,
               num_dest_candidates=B1 + 5, num_swap_candidates=P * R + 3)
    jgoal, tgoal = _goal_pair(name, built[0][2], built[1][2])
    jc, tc = _propose_both(jgoal, tgoal, built, cfg, seed=11)
    _same_cands(jc, tc, P, f"{model} {name} K > P * R")


#: a goal of each ``_replica_weight`` form, in the weight range's row
#: order (``kernels.WEIGHT_FORMS``)
FORM_GOALS = ["CpuUsageDistributionGoal",
              "NetworkInboundUsageDistributionGoal",
              "NetworkOutboundUsageDistributionGoal",
              "DiskUsageDistributionGoal", "PotentialNwOutGoal",
              "ReplicaDistributionGoal"]


@pytest.mark.parametrize("model", ["b23 dead", "rf3 sets", "b105"])
@pytest.mark.parametrize("form", range(len(FORM_GOALS)))
def test_weight_range_is_unit01s_range(model, form):
    """Each weight form's row of the context's weight range is
    ``_unit01``'s (min, max) over the goal's replica weights (a zero's
    sign aside), and the q an interval goal's swap planes form from it is
    ``_unit01``'s q bit for bit."""
    _, (tst, tctx, tmd) = _built(model)
    goal = tg.goals_by_name([FORM_GOALS[form]])[0]
    assert kernels._weight_form(goal) == form
    w = goal._replica_weight(tst, tctx)
    q, finite = tg._unit01(w)
    xmin, xmax = tctx.weight_range[form]
    fin = w[torch.isfinite(w)]
    assert float(xmin) == float(fin.min()) and float(xmax) == float(fin.max())
    q_table = (w - xmin) / torch.clamp(xmax - xmin, min=1e-12)
    assert torch.equal(q_table[finite], q[finite])
    # and the reference's weights give the same range
    (jst, jctx, jmd), _ = _built(model)
    jw = np.asarray(jg.goals_by_name([FORM_GOALS[form]])[0]._replica_weight(
        jst, jctx))
    assert float(xmin) == float(jw.min()) and float(xmax) == float(jw.max())
