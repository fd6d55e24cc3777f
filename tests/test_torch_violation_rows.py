"""KX's and KY's twins (``kernels.violation_rows_plain``,
``interval_planes_plain``) against the reference, on the CPU: every goal
of the catalog (the default chain, part B and the kafka-assigner set, an
active and an inactive MinTopicLeadersPerBrokerGoal, an active
BrokerSetAwareGoal) as one table, its violations and scales bit for bit
(int32 images: the sign of a zero residual reaches ``lax.top_k``'s order)
equal to the reference's ``violation`` / ``violation_scale`` of every goal
compiled as one program a width, and to the port's own per-goal methods;
at B1 = 5, 9, 22-25, 28, 30-33 and 64 (every ROW_LOOPS width and the tree
on either side), TopicReplicaDistribution's [T, B1] cells at T <= 32 and
past 32, with a dead broker; vmapped over a stack of scenarios at B1 =
22, 23, 25, 30 and 32; rows that sum to zero. KY's twin equals each
interval goal's own planes. A default-chain optimize whose audit holds a
violated hard goal equals the reference's, audit and all.

The twins read the tables' fields, never the goals' methods, so these hold
the table's encoding of every goal; the kernels are held to the twins on
the card (``tests/test_torch_violation_rows_cuda.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint)
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint)

torch.set_num_threads(1)

WIDTHS = (5, 9, 22, 23, 24, 25, 28, 30, 31, 32, 33, 64)
VMAPPED = (22, 23, 25, 30, 32)
#: bounds that leave most brokers out of band, so each row's order shows
TIGHT = dict(capacity_threshold=(0.002, 0.005, 0.001, 0.005),
             max_replicas_per_broker=40,
             resource_balance_threshold=(1.01,) * 4,
             replica_balance_threshold=1.01)


def build_both(B1, topics, dead=(), seed=0, loads=None):
    """((jax model, md), (port model, md)): B1 - 1 brokers (pad multiple
    1) on racks r0-r3, two thirds of them in broker sets s0 / s1, 12
    partitions a broker at RF 1-3 over ``topics`` topics, half of them
    crowded onto a fifth of the brokers; ``loads`` (4 floats) the same
    load on every partition."""
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        rng = np.random.default_rng(seed + 101 * B1 + topics)
        nb = B1 - 1
        brokers = [mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}",
                                  capacity=(100.0, 1e5, 1e5, 1e6),
                                  alive=i not in dead,
                                  broker_set=(f"s{i % 2}" if i % 3 else None))
                   for i in range(nb)]
        parts = []
        hot = max(nb // 5, 2)
        for p in range(12 * nb):
            pool = hot if p % 2 == 0 else nb
            rf = min(1 + p % 3, pool)
            reps = rng.choice(pool, size=rf, replace=False).tolist()
            load = loads or (
                float(0.02 + 2 * rng.random()), float(5 + 1e3 * rng.random()),
                float(8 + 1e3 * rng.random()), float(50 + 1e4 * rng.random()))
            parts.append(mod.PartitionSpec(
                topic=f"t{p % topics}", partition=p,
                replicas=[int(b) for b in reps], leader_load=tuple(load)))
        out.append(mod.flatten_spec(mod.ClusterSpec(
            brokers=brokers, partitions=parts), broker_pad_multiple=1, **kw))
    return out[0], out[1]


def goals_both(jmd, tmd, tight=True):
    """The catalog in both packages, bound to the model, then an active
    MinTopicLeadersPerBrokerGoal (every other topic, two leaders a broker)
    and an active BrokerSetAwareGoal (topics in sets -1, 0, 1 by turns);
    the registry's MinTopicLeadersPerBrokerGoal is the inactive one."""
    names = sorted(tg.GOAL_REGISTRY)
    jc, tc = (JConstraint(**TIGHT), TConstraint(**TIGHT)) if tight else (
        JConstraint(), TConstraint())
    T = tmd.num_topics
    mask, sets = np.arange(T) % 2 == 0, (np.arange(T) % 3 - 1).astype(np.int32)
    jgoals = [g.bind(jmd) for g in jg.goals_by_name(names, jc)] + [
        jg.MinTopicLeadersPerBrokerGoal(jc, interested_topics=jnp.asarray(mask),
                                        min_count=2),
        jg.BrokerSetAwareGoal(jc, topic_set=jnp.asarray(sets))]
    tgoals = [g.bind(tmd) for g in tg.goals_by_name(names, tc)] + [
        tg.MinTopicLeadersPerBrokerGoal(tc, interested_topics=mask,
                                        min_count=2),
        tg.BrokerSetAwareGoal(tc, topic_set=sets)]
    return jgoals, tgoals


def _states(jm, jmd, tm, tmd):
    return _jax_state(jm, jmd), _port_state(tm, tmd)


def _jax_state(m, md):
    return (js.init_state(m, with_topic_counts=md.num_topics,
                          with_topic_leader_counts=True),
            js.build_context(m))


def _port_state(m, md):
    return (ts.init_state(m, with_topic_counts=md.num_topics,
                          with_topic_leader_counts=True),
            ts.build_context(m))


def _bits(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x.astype(np.float32)).view(np.int32)


def _reference(jgoals, jstate, jctx, vmapped=False):
    """Every goal's (violation, violation_scale) in one compiled program."""
    def stack(st, cx):
        return (jnp.stack([g.violation(st, cx) for g in jgoals], axis=-1),
                jnp.stack([g.violation_scale(st, cx) for g in jgoals],
                          axis=-1))
    fn = jax.vmap(stack) if vmapped else stack
    return [np.asarray(x) for x in jax.jit(fn)(jstate, jctx)]


def _narrow_topic_rows(goals, B1, T):
    """The TopicReplicaDistribution rows XLA's loop was not read for (B1 <
    9 at T <= 32): the port raises there."""
    if B1 >= 9 or T > 32:
        return []
    return [k for k, g in enumerate(goals)
            if isinstance(g, tg.TopicReplicaDistributionGoal)]


def _assert_rows(jgoals, tgoals, want, got, methods, what):
    assert got[0].shape == want[0].shape, what
    for k, (j, t) in enumerate(zip(jgoals, tgoals)):
        for name, w, g, m in zip(("violation", "scale"), want, got, methods):
            assert np.array_equal(_bits(g[..., k]), _bits(w[..., k])), \
                f"{what}: {t.name} {name} {g[..., k]} != {w[..., k]}"
            assert np.array_equal(_bits(m[..., k]), _bits(w[..., k])), \
                f"{what}: {t.name}'s own {name}"


@pytest.mark.parametrize("B1", WIDTHS)
@pytest.mark.parametrize("topics,dead", [(8, ()), (40, (1,))])
def test_every_goal_at_every_width(B1, topics, dead):
    (jm, jmd), (tm, tmd) = build_both(B1, topics, dead)
    (jst, jcx), (tst, tcx) = _states(jm, jmd, tm, tmd)
    jgoals, tgoals = goals_both(jmd, tmd)
    narrow = _narrow_topic_rows(tgoals, B1, topics)
    for k in narrow:
        with pytest.raises(ValueError, match="not identified"):
            kernels.violation_rows_plain(kernels.ViolationTable(
                [tgoals[k]]), tst, tcx)
        with pytest.raises(ValueError, match="not identified"):
            tgoals[k].violation(tst, tcx)
    jgoals = [g for k, g in enumerate(jgoals) if k not in narrow]
    tgoals = [g for k, g in enumerate(tgoals) if k not in narrow]
    want = _reference(jgoals, jst, jcx)
    table = kernels.ViolationTable(tgoals)
    assert table.outside == []
    got = kernels.violation_rows_plain(table, tst, tcx, True)
    methods = [torch.stack([g.violation(tst, tcx) for g in tgoals]),
               torch.stack([g.violation_scale(tst, tcx) for g in tgoals])]
    _assert_rows(jgoals, tgoals, want, got, methods, f"B1 {B1}, T {topics}")
    assert (want[0] > 0).sum() >= len(tgoals) // 2      # rows with terms
    # the routed sites' wrapper takes the twin on the CPU
    wrapped = kernels.violation_rows(table, tst, tcx, True)
    for w, g in zip(wrapped, got):
        assert np.array_equal(_bits(w), _bits(g))


def _stack_states(states):
    """One state (or context) with a leading scenario axis from several."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: None if getattr(first, f.name) is None
        else torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first) if f.name != "weight_range"})


def _scenarios(jm, tm, S):
    """S edits of each package's model: scenario s kills broker s and
    scales every load by 1 + s / 8."""
    out = ([], [])
    for s in range(S):
        for k, m in enumerate((jm, tm)):
            alive = np.asarray(m.broker_alive).copy()
            alive[s % alive.shape[0]] = False
            f = np.float32(1.0 + s / 8)
            lead = np.asarray(m.leader_load) * f
            foll = np.asarray(m.follower_load) * f
            if k == 0:
                out[0].append(m.replace(broker_alive=jnp.asarray(alive),
                                        leader_load=jnp.asarray(lead),
                                        follower_load=jnp.asarray(foll)))
            else:
                out[1].append(m.replace(broker_alive=torch.from_numpy(alive),
                                        leader_load=torch.from_numpy(lead),
                                        follower_load=torch.from_numpy(foll)))
    return out


@pytest.mark.parametrize("B1", VMAPPED)
def test_every_goal_vmapped(B1):
    """A stack of scenarios (the what-if scorer's vmapped form): the
    reference's goals vmapped over stacked states, the table's twin over
    the port's batched state."""
    topics = 8 if B1 != 22 else 1
    (jm, jmd), (tm, tmd) = build_both(B1, topics, seed=7)
    jms, tms = _scenarios(jm, tm, 6)
    jst = [_jax_state(m, jmd) for m in jms]
    tst = [_port_state(m, tmd) for m in tms]
    jstate = jax.tree.map(lambda *x: jnp.stack(x), *[s for s, _ in jst])
    jctx = jax.tree.map(lambda *x: jnp.stack(x), *[c for _, c in jst])
    tstate = _stack_states([s for s, _ in tst])
    tctx = _stack_states([c for _, c in tst])
    tctx = dataclasses.replace(tctx, weight_range=None)
    jgoals, tgoals = goals_both(jmd, tmd)
    want = _reference(jgoals, jstate, jctx, vmapped=True)
    table = kernels.ViolationTable(tgoals)
    got = kernels.violation_rows_plain(table, tstate, tctx, True)
    methods = [torch.stack([g.violation(tstate, tctx) for g in tgoals], -1),
               torch.stack([g.violation_scale(tstate, tctx)
                            for g in tgoals], -1)]
    _assert_rows(jgoals, tgoals, want, got, methods, f"vmapped B1 {B1}")


@pytest.mark.parametrize("B1", [9, 25, 33])
def test_rows_that_sum_to_zero(B1):
    """Equal loads under the default bounds: most rows are all zero; their
    violations keep the reference's signed zero (int32 images)."""
    (jm, jmd), (tm, tmd) = build_both(B1, 4, seed=3,
                                      loads=(0.5, 10.0, 10.0, 100.0))
    (jst, jcx), (tst, tcx) = _states(jm, jmd, tm, tmd)
    jgoals, tgoals = goals_both(jmd, tmd, tight=False)
    narrow = _narrow_topic_rows(tgoals, B1, 4)
    jgoals = [g for k, g in enumerate(jgoals) if k not in narrow]
    tgoals = [g for k, g in enumerate(tgoals) if k not in narrow]
    want = _reference(jgoals, jst, jcx)
    got = kernels.violation_rows_plain(kernels.ViolationTable(tgoals), tst,
                                       tcx, True)
    methods = [torch.stack([g.violation(tst, tcx) for g in tgoals]),
               torch.stack([g.violation_scale(tst, tcx) for g in tgoals])]
    _assert_rows(jgoals, tgoals, want, got, methods, f"zero rows, B1 {B1}")
    assert (want[0] == 0).sum() >= 4


@pytest.mark.parametrize("B1,dead", [(9, ()), (23, (2,)), (64, (5,))])
def test_interval_planes_twin_is_the_goals_planes(B1, dead):
    (_jm, _jmd), (tm, tmd) = build_both(B1, 8, dead, seed=5)
    st, cx = ts.init_state(tm), ts.build_context(tm)
    for tight in (True, False):
        _jgoals, tgoals = goals_both(_jmd, tmd, tight)
        for goal in tgoals:
            if not isinstance(goal, tg.IntervalGoal):
                continue
            want = goal.plain_planes(st, cx)
            got = kernels.interval_planes_plain(
                kernels.ViolationTable([goal]), st, cx)
            routed = goal.propose_planes(st, cx)
            for name, w, g, r in zip(("values", "lo", "up", "excess",
                                      "deficit"), want, got, routed):
                assert np.array_equal(_bits(g), _bits(w)), (goal.name, name)
                assert np.array_equal(_bits(r), _bits(w)), (goal.name, name)


def test_tables_a_graph_reads_are_held_by_their_owners(monkeypatch):
    """Every KX or KY table a captured graph can read stays alive while
    its owner does: a pass's tables (its converged test, its boundary
    stack), the chain's and each interval goal's own one-row table, the
    one its proposals hand KY. Many other tables coming and going, and a
    collection, leave them the same live objects."""
    import gc
    import weakref
    from cruise_control_tpu_torch.analyzer import engine
    (_jm, _jmd), (tm, tmd) = build_both(25, 8)
    st, cx = _port_state(tm, tmd)
    goals = [g.bind(tmd) for g in tg.default_goals()]
    chain = engine.CompiledGoalChain(goals, ta.SearchConfig())
    used = []
    real = tg.interval_planes

    def spy(table, state, ctx):
        used.append(table)
        return real(table, state, ctx)
    monkeypatch.setattr(tg, "interval_planes", spy)
    interval = [g for g in goals if isinstance(g, tg.IntervalGoal)]
    for goal in interval:
        goal.propose_planes(st, cx)
    assert [t.goals for t in used] == [[g] for g in interval]
    held = ([chain.rows] + [s.active_rows for s in chain.segments]
            + [s.stack_rows for s in chain.segments] + used)
    refs = [weakref.ref(t) for t in held]
    ids = [id(t) for t in held]
    del held, used[:]
    for k in range(100):
        other = kernels.ViolationTable(goals[k % 16:] + goals[:k % 7])
        kernels.violation_rows(other, st, cx)
    del other
    gc.collect()
    assert all(r() is not None for r in refs)
    assert [id(r()) for r in refs] == ids
    for goal in interval:
        goal.propose_planes(st, cx)
    assert [id(t) for t in used] == ids[-len(interval):]


def test_table_takes_a_goal_without_a_row_on_the_cpu():
    """A goal with no row (``outside``) is refused on the card; its twin
    takes the goal's own methods."""
    class NoRow(tg.IntervalGoal):
        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1)

    (_j, _jmd), (tm, tmd) = build_both(25, 8)
    st, cx = ts.init_state(tm), ts.build_context(tm)
    goal = NoRow("NoRow", ts.METRIC_REPLICA_COUNT, hard=False,
                 constraint=TConstraint())
    table = kernels.ViolationTable([goal])
    assert table.outside == [goal]
    with pytest.raises(ValueError, match="NoRow"):
        table.rows_on(torch.device("cpu"), 25, 8, False)
    v, s = kernels.violation_rows_plain(table, st, cx, True)
    assert np.array_equal(_bits(v[0]), _bits(goal.violation(st, cx)))
    assert np.array_equal(_bits(s[0]), _bits(goal.violation_scale(st, cx)))


def test_default_chain_audit_with_a_violated_hard_goal():
    """``goals=None`` with the audit widened to BrokerSetAwareGoal on a
    cluster in broker sets whose topics are spread over every set: the
    chain leaves replicas outside their sets, the audit reports a
    non-zero violation (an OptimizationFailureError), and the port's
    failure, proposals and audit rows equal the reference's."""
    from test_torch_default_chain import SEARCH, topic_skew_both
    (jm, jmd), (tm, tmd) = topic_skew_both(broker_sets=2)
    hard = [n for n, h in tg.DEFAULT_GOALS if h] + ["BrokerSetAwareGoal"]
    cfg = dict(SEARCH, max_iters_per_goal=8, fused_chain=True)
    jopt = ja.TpuGoalOptimizer(goals=None, config=ja.SearchConfig(**cfg),
                               hard_goal_names=hard)
    topt = ta.TorchGoalOptimizer(goals=None, config=ta.SearchConfig(**cfg),
                                 hard_goal_names=hard, device="cpu")

    def run(opt, mod, m, md):
        try:
            return None, opt.optimize(m, md, mod.OptimizationOptions(seed=1))
        except mod.OptimizationFailureError as err:
            return str(err), err.result
    jerr, jres = run(jopt, ja, jm, jmd)
    terr, tres = run(topt, ta, tm, tmd)
    assert terr == jerr
    assert tres.proposals == jres.proposals
    rows = [(g.name, g.satisfied, g.violation_before, g.violation_after,
             g.scale) for g in tres.hard_goal_audit]
    assert rows == [(g.name, g.satisfied, g.violation_before,
                     g.violation_after, g.scale)
                    for g in jres.hard_goal_audit]
    assert any(name == "BrokerSetAwareGoal" and after > 0
               for name, _s, _b, after, _sc in rows)
