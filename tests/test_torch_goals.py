"""Parity of the port's goal kernels (``analyzer/goals.py``, every registered
goal) with the JAX package: bounds, violations and scales, candidate
generation (flow/swap/leadership generators and both bulk drains),
per-candidate delta/acceptance and the collective guard (through KC's and
KK's twins). The states carry topic and topic-leader counts, which the
topic goals read.

The reference runs every goal function inside a jitted program, so each
JAX call here is jitted too. Tolerances: candidates (indices, kinds,
validity, deltas) and acceptance exact; violations and scores rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import _random
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from torch_parity_util import (assert_close, assert_same, build_both,
                               tiny_both, to_np)

torch.set_num_threads(1)

MODELS = {
    "tiny": tiny_both,
    "20x1k": lambda: build_both(20, 1000, seed=5),
    "20x1k_dead": lambda: build_both(20, 1000, seed=6, dead=(2,)),
    # 24 brokers: rows of B1 = 25, where XLA sums a distribution goal's
    # penalty in eight lanes (NetworkOutboundUsageDistributionGoal's
    # violation differs in the last bit from the tree order)
    "24x1k": lambda: build_both(24, 1000, seed=3),
}
#: tight capacity thresholds so the capacity goals have work to do
TIGHT = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
             max_replicas_per_broker=150)
CFG = dict(num_replica_candidates=96, num_dest_candidates=8,
           num_swap_candidates=48, apply_per_iter=96, drain_batch=256)

REGISTERED = sorted(tg.GOAL_REGISTRY)
#: IntervalGoal shapes outside the main path's goals, built the same way in
#: both packages, so the leadership drain, leadership proposals and the
#: potential/leader-NW_IN metrics are held to the reference too
EXTRA = ["LeaderCount", "LeaderNwIn", "PotentialNwOut"]


def _extra_goal(goals_mod, state_mod, name, cst):
    class LeaderCount(goals_mod.IntervalGoal):
        actions = "both"

        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1, integer=True)

    class LeaderNwIn(goals_mod.IntervalGoal):
        actions = "leadership"
        upper_only = True

        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1, upper_only=True)

    class PotentialNwOut(goals_mod.IntervalGoal):
        upper_only = True

        def bounds(self, state, ctx):
            upper = ctx.broker_capacity[:, 2] * 0.03
            return upper * float("-inf"), upper

        def _cap_factor(self, ctx):          # consulted by the port only
            return ctx.broker_capacity[:, 2], 0.03

    cls, metric = {"LeaderCount": (LeaderCount, state_mod.METRIC_LEADER_COUNT),
                   "LeaderNwIn": (LeaderNwIn, state_mod.METRIC_LEADER_NW_IN),
                   "PotentialNwOut": (PotentialNwOut,
                                      state_mod.METRIC_POTENTIAL_NW_OUT)}[name]
    return cls(name, metric, hard=False, constraint=cst)


def _goal_pair(name):
    jc, tc = JConstraint(**TIGHT), TConstraint(**TIGHT)
    if name in EXTRA:
        return _extra_goal(jg, js, name, jc), _extra_goal(tg, ts, name, tc)
    return jg.goals_by_name([name], jc)[0], tg.goals_by_name([name], tc)[0]


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request):
    (jm, jmd), (tm, _) = MODELS[request.param]()
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    return ((js.init_state(jm, **topics), js.build_context(jm)),
            (ts.init_state(tm, **topics), ts.build_context(tm)))


def _same_cands(jc, tc, what, rows=None):
    """Every candidate field equal. An invalid topic swap's partner row may
    be negative in the reference; the port keeps the row the reference's
    gathers read (``rows``: the partition rows)."""
    for name in ("p", "r", "p2", "r2", "src", "dst", "kind", "valid", "must",
                 "d_util_src", "d_util_dst", "d_cnt", "d_lead", "d_pot",
                 "d_lni"):
        want = np.asarray(getattr(jc, name))
        if name == "p2" and rows is not None:
            want = np.where(want < 0, want + rows, want).clip(0, rows - 1)
        assert_same(want, getattr(tc, name), what=f"{what}.{name}")


@pytest.mark.parametrize("name", REGISTERED + EXTRA)
def test_bounds_violation_scale(setup, name):
    (jst, jctx), (tst, tctx) = setup
    jgoal, tgoal = _goal_pair(name)
    assert_same(jax.jit(jgoal.violation)(jst, jctx),
                tgoal.violation(tst, tctx), what="violation")
    assert_same(jax.jit(jgoal.violation_scale)(jst, jctx),
                tgoal.violation_scale(tst, tctx), what="scale")
    if hasattr(jgoal, "bounds"):
        for a, b in zip(jax.jit(jgoal.bounds)(jst, jctx),
                        tgoal.bounds(tst, tctx)):
            assert_close(a, b, what="bounds")
    assert_same(jax.jit(jgoal.receptive_dest)(jst, jctx),
                tgoal.receptive_dest(tst, tctx), what="receptive_dest")


@pytest.mark.parametrize("name", REGISTERED + EXTRA)
@pytest.mark.parametrize("seed", [0, 7])
def test_propose_and_score(setup, name, seed):
    (jst, jctx), (tst, tctx) = setup
    jgoal, tgoal = _goal_pair(name)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jk, tk = jax.random.PRNGKey(seed), _random.PRNGKey(seed)
    jc = jax.jit(lambda s, c, k: jgoal.propose(s, c, k, jcfg))(jst, jctx, jk)
    tc = tgoal.propose(tst, tctx, tk, tcfg)
    _same_cands(jc, tc, "propose", rows=tst.rb.shape[0])

    assert_close(jax.jit(jgoal.delta)(jst, jctx, jc),
                 tgoal.delta(tst, tctx, tc), what="delta")
    assert_same(jax.jit(jgoal.accepts)(jst, jctx, jc),
                tgoal.accepts(tst, tctx, tc), what="accepts")

    # Guard over the first M candidates with a random prefix mask.
    M = min(64, tc.p.shape[0])
    rng = np.random.default_rng(seed)
    earlier = np.tril(rng.random((M, M)) < 0.7, k=-1)
    jsub = jax.tree.map(lambda x: x[:M], jc)
    tsub = tc.take(torch.arange(M))
    jguard = jax.jit(jgoal.collective_guard)(jst, jctx, jsub,
                                             jnp.asarray(earlier))
    tguard = tgoal.collective_guard(tst, tctx, tsub, torch.from_numpy(earlier))
    if jguard is None:
        assert tguard is None
    else:
        assert_same(jguard, tguard, what="collective_guard")


@pytest.mark.parametrize("name", [n for n in REGISTERED + EXTRA
                                  if _goal_pair(n)[0].supports_bulk_drain])
@pytest.mark.parametrize("seed", [0, 3])
def test_bulk_drain(setup, name, seed):
    (jst, jctx), (tst, tctx) = setup
    jgoal, tgoal = _goal_pair(name)
    assert tgoal.supports_bulk_drain
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 70_000)
    tk = _random.fold_in(_random.PRNGKey(seed), 70_000)
    jc = jax.jit(lambda s, c, k: jgoal.bulk_drain(s, c, k, jcfg))(jst, jctx,
                                                                  jk)
    tc = tgoal.bulk_drain(tst, tctx, tk, tcfg)
    _same_cands(jc, tc, "bulk_drain")


@pytest.mark.parametrize("seed", [0, 5])
def test_top_replica_dest_grid(setup, seed):
    """The shared top-K x top-D generator, which the catalog's later goals
    build on, from the same numpy priorities in both packages."""
    (jst, jctx), (tst, tctx) = setup
    P, R = tst.rb.shape
    rng = np.random.default_rng(seed)
    rprio = rng.random((P, R)).astype(np.float32)
    dprio = rng.random(tctx.dest_allowed.shape[0]).astype(np.float32)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jc = jax.jit(lambda s, c, k, rp, dp: jg._top_replica_dest_grid(
        s, c, k, jcfg, rp, dp))(jst, jctx, jax.random.PRNGKey(seed),
                                jnp.asarray(rprio), jnp.asarray(dprio))
    tc = tg._top_replica_dest_grid(tst, tctx, _random.PRNGKey(seed), tcfg,
                                   torch.from_numpy(rprio),
                                   torch.from_numpy(dprio))
    _same_cands(jc, tc, "grid")


def test_supports_bulk_drain_flags():
    for name in REGISTERED + EXTRA:
        jgoal, tgoal = _goal_pair(name)
        assert jgoal.supports_bulk_drain == tgoal.supports_bulk_drain, name
        assert (jgoal.name, jgoal.hard) == (tgoal.name, tgoal.hard)


def test_min_topic_leaders_inactive(setup):
    (_, _), (tst, tctx) = setup
    goal = tg.MinTopicLeadersPerBrokerGoal(TConstraint())
    assert goal.violation(tst, tctx).item() == 0.0
    cands = goal.propose(tst, tctx, _random.PRNGKey(0), TConfig(**CFG))
    assert not to_np(cands.valid).any()
    assert to_np(goal.accepts(tst, tctx, cands)).all()
    assert to_np(goal.collective_guard(tst, tctx, cands, None)).all()
    assert not goal.uses_topic_counts and not goal.uses_topic_leader_counts


def test_min_topic_leaders_active_form_not_ported():
    """Binding a pattern that matches a topic gives the active form (the
    name is kept from before the active form was ported)."""
    from cruise_control_tpu_torch.model.spec import ClusterMetadata
    md = ClusterMetadata(broker_ids=[0], broker_index={0: 0},
                         topics=["orders", "logs"],
                         topic_index={"orders": 0, "logs": 1},
                         partition_keys=[], partition_index={}, racks=["r"],
                         hosts=["h"], broker_sets=[])
    inactive = tg.MinTopicLeadersPerBrokerGoal(TConstraint())
    assert inactive.bind(md) is inactive
    nomatch = tg.MinTopicLeadersPerBrokerGoal(
        TConstraint(topics_with_min_leaders_per_broker="x*"))
    assert nomatch.bind(md) is nomatch
    active = tg.MinTopicLeadersPerBrokerGoal(
        TConstraint(topics_with_min_leaders_per_broker="ord*")).bind(md)
    assert active.uses_topic_counts and active.uses_topic_leader_counts
    assert active.interested_topics.host.tolist() == [True, False]
    jactive = jg.MinTopicLeadersPerBrokerGoal(
        JConstraint(topics_with_min_leaders_per_broker="ord*")).bind(md)
    assert active.bind_signature() == jactive.bind_signature()


def test_goal_names():
    assert sorted(tg.GOAL_REGISTRY) == sorted(jg.GOAL_REGISTRY)
    assert [g.name for g in tg.goals_by_name(REGISTERED)] == [
        g.name for g in jg.goals_by_name(REGISTERED)]
    assert [g.name for g in tg.goals_by_name(
        ["com.linkedin.kafka.cruisecontrol.analyzer.goals."
         "LeaderBytesInDistributionGoal"])] == [
        "LeaderBytesInDistributionGoal"]
    assert not hasattr(tg, "NOT_YET_PORTED")
    with pytest.raises(ValueError, match="unknown goal"):
        tg.goals_by_name(["NoSuchGoal"])
    assert [(g.name, g.hard) for g in tg.default_goals()] == [
        (g.name, g.hard) for g in jg.default_goals()]
    assert [n for n, _ in tg.DEFAULT_GOALS] == [
        g.name for g in jg.default_goals()]
    assert [h for _, h in tg.DEFAULT_GOALS] == [
        g.hard for g in jg.default_goals()]
    assert tg.KAFKA_ASSIGNER_GOALS == jg.KAFKA_ASSIGNER_GOALS
    assert tg.HARD_GOAL_ALTERNATIVES == jg.HARD_GOAL_ALTERNATIVES
