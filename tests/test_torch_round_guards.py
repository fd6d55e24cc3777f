"""Parity of KQ's twin (``kernels.round_guards`` on the CPU, which takes
``round_guards_plain``) with the reference's apply round: the masks and
every guard goal's ``collective_guard`` composed as
``cruise_control_tpu/analyzer/engine.py``'s round composes them (a helper
here; the JAX package is not edited), and KQ's guard table on its own.

Inputs: a seeded cluster past 32 brokers and 32 topics (one broker dead,
so that moves off it are mandatory), candidates of every kind — moves,
leadership transfers, swaps — in a seeded order, a seeded pending mask and
a seeded eligibility verdict standing in for KN's. Every row kind of the
table is covered: interval (two-sided, upper-only over the average, and
upper-only over capacity), hard cap (capacity and constant), topic
replica, topic leaders, serialize, and the partition-local goals, which
have no row. The reference's round runs jitted, as inside its pass
program. Tolerance: exact (``do`` and ``pending``)."""

import jax
import jax.numpy as jnp
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
    BalancingConstraint as JConstraint)
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint)
from torch_parity_util import assert_same

torch.set_num_threads(1)

BROKERS = 40
TOPICS = 48
PARTITIONS = 600
DEAD = 2
HOT = 5
#: tight capacities, so that the capacity guards bind, and the t1* topics
#: under a leader minimum, so that MinTopicLeadersPerBroker has a row
CST = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
           max_replicas_per_broker=40,
           topics_with_min_leaders_per_broker="t1*",
           min_topic_leaders_per_broker=1)
#: chains by name; the pass goal is the last, the others are earlier
CHAINS = {
    "one": ["TopicReplicaDistributionGoal"],
    "four": ["DiskCapacityGoal", "LeaderBytesInDistributionGoal", "serial",
             "ReplicaDistributionGoal"],
    "default": None,
    "partb": ["BrokerSetAwareGoal", "RackAwareDistributionGoal",
              "PreferredLeaderElectionGoal", "MinTopicLeadersPerBrokerGoal"],
}
EPS = 1e-6


def _serial_goal(mod):
    """A goal with no guard of its own: the engine serializes the brokers
    it shares with earlier candidates."""
    class SerialGoal(mod.GoalKernel):
        name = "SerialGoal"
    return SerialGoal()


def _chain(mod, cmod, name, md):
    cst = cmod(**CST)
    names = CHAINS[name]
    goals = (mod.default_goals(cst) if names is None else
             [_serial_goal(mod) if n == "serial"
              else mod.goals_by_name([n], cst)[0] for n in names])
    return [g.bind(md) for g in goals]


def _models(seed=11):
    """((jax model, md), (port model, md)): BROKERS brokers on four racks
    (broker DEAD not alive), TOPICS topics, RF 2, half of the partitions on
    the first fifth of the brokers."""
    rng = np.random.default_rng(seed)
    brokers = [dict(broker_id=i, rack=f"r{i % 4}",
                    capacity=(100.0, 1e5, 1e5, 1e6)) for i in range(BROKERS)]
    parts = []
    for p in range(PARTITIONS):
        pool = BROKERS // 5 if p % 2 == 0 else BROKERS
        reps = rng.choice(pool, size=2, replace=False).tolist()
        load = (float(0.02 + 0.02 * rng.random()),
                float(5 + 10 * rng.random()), float(8 + 15 * rng.random()),
                float(50 + 100 * rng.random()))
        parts.append(dict(topic=f"t{p % TOPICS}", partition=p,
                          replicas=[int(b) for b in reps], leader_load=load))
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        spec = mod.ClusterSpec(
            brokers=[mod.BrokerSpec(alive=b["broker_id"] != DEAD, **b)
                     for b in brokers],
            partitions=[mod.PartitionSpec(**p) for p in parts])
        out.append(mod.flatten_spec(spec, broker_pad_multiple=1, **kw))
    return out[0], out[1]


@pytest.fixture(scope="module")
def cluster():
    (jm, jmd), (tm, tmd) = _models()
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    return dict(jm=jm, jmd=jmd, tmd=tmd,
                j=(js.init_state(jm, **topics), js.build_context(jm)),
                t=(ts.init_state(tm, **topics), ts.build_context(tm)))


def _rows(jm, case, seed, n=48):
    """Candidate rows of each kind (numpy) and a seeded order of the 3n
    candidates: ``mixed`` draws them from all partitions, half of the
    moves off the dead broker's replicas (mandatory); ``hot`` makes every
    candidate touch broker HOT (moves off it or into it, leadership onto
    it or off it, swaps with it on either side)."""
    rng = np.random.default_rng(seed)
    rb = np.asarray(jm.replica_broker)
    R = rb.shape[1]
    real = int(np.asarray(jm.partition_valid).sum())
    B1 = jm.num_brokers_padded + 1
    on = {b: np.argwhere(rb[:real] == b) for b in (DEAD, HOT)}
    out = {}
    for kind in range(3):
        p, r = rng.integers(0, real, n), rng.integers(0, R, n)
        p2, r2 = rng.integers(0, real, n), rng.integers(0, R, n)
        dst = rng.integers(0, B1 - 1, n)
        if case == "mixed" and kind == 0:
            pick = on[DEAD][rng.integers(0, len(on[DEAD]), n // 2)]
            p[:n // 2], r[:n // 2] = pick[:, 0], pick[:, 1]
        if case == "hot":
            pick = on[HOT][rng.integers(0, len(on[HOT]), n)]
            half = rng.random(n) < 0.5
            if kind == 0:
                p = np.where(half, pick[:, 0], p)
                r = np.where(half, pick[:, 1], r)
                dst = np.where(half, dst, HOT)
            elif kind == 1:
                p, r = pick[:, 0], pick[:, 1]
            else:
                p = np.where(half, pick[:, 0], p)
                r = np.where(half, pick[:, 1], r)
                p2 = np.where(half, p2, pick[:, 0])
                r2 = np.where(half, r2, pick[:, 1])
        if kind == 1:                      # a leadership move's slot > 0
            r = np.where(r == 0, 1, r)
        out[kind] = dict(p=p, r=r, p2=p2, r2=r2, dst=dst,
                         valid=rng.random(n) < 0.95)
    return out, rng.permutation(3 * n)


def _cands(mod, state, ctx, rows, conv):
    parts = []
    for kind in range(3):
        a = {k: conv(v) for k, v in rows[kind].items()}
        if kind == 0:
            parts.append(mod.make_move_candidates(state, ctx, a["p"], a["r"],
                                                  a["dst"], a["valid"]))
        elif kind == 1:
            parts.append(mod.make_leadership_candidates(
                state, ctx, a["p"], a["r"], a["valid"]))
        else:
            parts.append(mod.make_swap_candidates(
                state, ctx, a["p"], a["r"], a["p2"], a["r2"], a["valid"]))
    out = parts[0]
    for extra in parts[1:]:
        out = mod.concat_candidates(out, extra)
    return out


def _jconv(x):
    return jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x)


def _tconv(x):
    return torch.from_numpy(np.asarray(x))


_JROUNDS = {}


def _jround(chain, goals):
    """The reference's apply round over ``goals`` (pass goal last),
    jitted: ``engine.py:157-178``'s masks and guards, composed here."""
    fn = _JROUNDS.get(chain)
    if fn is None:
        goal, prev = goals[-1], goals[:-1]

        def same(a, b):
            return a[:, None] == b[None, :]

        def run(state, ctx, c, conflict_earlier, pending, kn_elig):
            M = pending.shape[0]
            earlier = jnp.tril(jnp.ones((M, M), bool), k=-1)
            elig = pending & kn_elig
            blocked = (conflict_earlier & elig[None, :]).any(axis=1)
            ok = jnp.ones((M,), bool)
            gmask = earlier & elig[None, :]
            for g in [goal, *prev]:
                gok = g.collective_guard(state, ctx, c, gmask)
                if gok is None:
                    gok = ~((same(c.src, c.src) | same(c.dst, c.dst))
                            & gmask).any(axis=1)
                if g is goal:
                    gok = gok | c.must
                ok = ok & gok
            do = elig & ~blocked & ok
            return do, pending & ~do
        fn = _JROUNDS[chain] = jax.jit(run)
    return fn


def _round_case(cluster, chain, M, case, seed):
    """(reference's (do, pending), twin's (do, pending, more), the numpy
    inputs) of one round."""
    jm, jmd, tmd = cluster["jm"], cluster["jmd"], cluster["tmd"]
    (jst, jctx), (tst, tctx) = cluster["j"], cluster["t"]
    rows, order = _rows(jm, case, seed)
    jc = _cands(js, jst, jctx, rows, _jconv)
    tc = _cands(ts, tst, tctx, rows, _tconv)
    take = order[:M]
    jc = jax.tree.map(lambda x: x[jnp.asarray(take)], jc)
    tc = tc.take(torch.from_numpy(take))
    rng = np.random.default_rng(seed + 1)
    p, p2 = np.asarray(tc.p), np.asarray(tc.p2)

    def same(a, b):
        return a[:, None] == b[None, :]
    conflict = ((same(p, p) | same(p, p2) | same(p2, p) | same(p2, p2))
                & np.tril(np.ones((M, M), bool), k=-1))
    pending = rng.random(M) < 0.9
    kn = rng.random(M) < 0.85
    jgoals = _chain(jg, JConstraint, chain, jmd)
    tgoals = _chain(tg, TConstraint, chain, tmd)
    want = _jround(chain, jgoals)(jst, jctx, jc, jnp.asarray(conflict),
                                  jnp.asarray(pending), jnp.asarray(kn))
    table = kernels.GuardTable(kernels.GoalChecks(tgoals[-1], tgoals[:-1],
                                                  EPS))
    got = kernels.round_guards(tst, tctx, tc, torch.from_numpy(conflict),
                               torch.from_numpy(pending),
                               torch.from_numpy(kn), table)
    return want, got, dict(conflict=conflict, pending=pending, kn=kn,
                           must=np.asarray(tc.must))


def _check(want, got, inputs, what):
    assert_same(want[0], got[0], what=f"{what} do")
    assert_same(want[1], got[1], what=f"{what} pending")
    do, pending = np.asarray(got[0]), np.asarray(got[1])
    assert bool(got[2]) == bool(pending.any() and do.any()), what
    elig = inputs["pending"] & inputs["kn"]
    blocked = (inputs["conflict"] & elig[None, :]).any(axis=1)
    return int((elig & ~blocked & ~do).sum())        # the guards' vetoes


@pytest.mark.parametrize("M", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("case", ["mixed", "hot"])
def test_round_four_goals_every_m(cluster, M, case):
    """A chain of four (a capacity cap, an upper-only average, a goal with
    the default guard, a two-sided pass goal) at M 1, 31, 32, 33 and 64:
    windows of 32 columns cut anywhere."""
    want, got, inputs = _round_case(cluster, "four", M, case, seed=M)
    vetoes = _check(want, got, inputs, f"four M={M} {case}")
    if M == 64:
        assert vetoes > 0


@pytest.mark.parametrize("chain,M", [("one", 33), ("one", 64),
                                     ("default", 64), ("default", 33),
                                     ("partb", 64)])
@pytest.mark.parametrize("case", ["mixed", "hot"])
def test_round_chains(cluster, chain, M, case):
    """A chain of one (the topic guard), the default chain of sixteen
    (every row kind but serialize; MinTopicLeadersPerBroker active) and
    the part-B chain (partition-local goals and the topic leaders' guard
    as the pass goal), with mandatory moves off the dead broker and a hot
    broker every candidate shares."""
    want, got, inputs = _round_case(cluster, chain, M, case, seed=7 + M)
    vetoes = _check(want, got, inputs, f"{chain} M={M} {case}")
    if chain == "default" and M == 64:
        assert vetoes > 0
    if case == "mixed" and chain != "partb":
        assert inputs["must"].any()


def test_mandatory_moves_pass_their_own_goal_only(cluster):
    """The pass goal's guard is or'ed with must; an earlier goal's is not:
    with every candidate a mandatory move off the dead broker into the
    hot broker, the pass goal vetoes none of them."""
    jm, jmd, tmd = cluster["jm"], cluster["jmd"], cluster["tmd"]
    (jst, jctx), (tst, tctx) = cluster["j"], cluster["t"]
    rb = np.asarray(jm.replica_broker)
    real = int(np.asarray(jm.partition_valid).sum())
    pick = np.argwhere(rb[:real] == DEAD)[:40]
    M = len(pick)
    row = dict(p=pick[:, 0], r=pick[:, 1], dst=np.full(M, HOT),
               valid=np.ones(M, bool))
    jc = js.make_move_candidates(jst, jctx, *(_jconv(row[k]) for k in
                                              ("p", "r", "dst", "valid")))
    tc = ts.make_move_candidates(tst, tctx, *(_tconv(row[k]) for k in
                                              ("p", "r", "dst", "valid")))
    assert np.asarray(tc.must).all()
    conflict = np.zeros((M, M), bool)
    ones = np.ones(M, bool)
    for chain in ("one", "four"):
        jgoals = _chain(jg, JConstraint, chain, jmd)
        tgoals = _chain(tg, TConstraint, chain, tmd)
        want = _jround(f"{chain}-must", jgoals)(
            jst, jctx, jc, jnp.asarray(conflict), jnp.asarray(ones),
            jnp.asarray(ones))
        table = kernels.GuardTable(kernels.GoalChecks(tgoals[-1],
                                                      tgoals[:-1], EPS))
        got = kernels.round_guards(tst, tctx, tc, torch.from_numpy(conflict),
                                   torch.from_numpy(ones),
                                   torch.from_numpy(ones), table)
        _check(want, got, dict(conflict=conflict, pending=ones, kn=ones),
               f"{chain} all must")
        if chain == "one":                   # the pass goal alone
            assert np.asarray(got[0]).all()
        else:                                # the earlier goals veto some
            assert not np.asarray(got[0]).all()


# ---------------------------------------------------------------------------
# The guard table
# ---------------------------------------------------------------------------

def test_guard_table_of_the_default_chain(cluster):
    """The default chain's last position: the pass goal's row first, then
    one a guard goal but RackAwareGoal (partition-local); the kinds, the
    metrics a slot, the must flag and each average row's bounds row of
    KN's table."""
    goals = _chain(tg, TConstraint, "default", cluster["tmd"])
    checks = kernels.GoalChecks(goals[-1], goals[:-1], EPS)
    table = kernels.GuardTable(checks)
    assert table.outside == [] and table.n == 15
    assert table.kinds == (["interval", "topic_leaders"] + ["hard_cap"] * 5
                           + ["interval"] * 6 + ["topic_replica", "interval"])
    # leader NW_IN, count, disk, NW_IN, NW_OUT, CPU, potential, leaders
    assert table.metrics == [7, 4, 3, 1, 2, 0, 6, 5]
    assert table.reads == 3
    musts = [table.rows[k].must for k in range(table.n)]
    assert musts == [1] + [0] * 14
    # each interval row's KN row: the same goal's
    guarded = [g for g in [goals[-1], *goals[:-1]]
               if g.guard_row()["kind"] != "local"]
    for k, g in enumerate(guarded):
        row = table.rows[k]
        if table.kinds[k] in ("interval", "hard_cap"):
            kn = checks.rows[row.bound_row]
            assert kernels.ROW_KINDS[kn.kind] == table.kinds[k], g.name
            assert table.metrics[row.slot] == kn.metric, g.name
            assert (row.form, row.upper_only, row.cap_col) == (
                kn.form, kn.upper_only, kn.cap_col), g.name
    topic = table.rows[table.kinds.index("topic_replica")]
    assert topic.slot == 0 and checks.topic_gaps


def test_guard_table_rows_by_goal():
    """Which goals get a row: the partition-local goals none, an inactive
    MinTopicLeadersPerBroker none, a goal with the default guard a
    serialize row; a pass goal repeated among the earlier goals is or'ed
    with must in both of its rows."""
    cst = TConstraint()
    local = tg.goals_by_name(["RackAwareGoal", "RackAwareDistributionGoal",
                              "BrokerSetAwareGoal",
                              "PreferredLeaderElectionGoal",
                              "MinTopicLeadersPerBrokerGoal"], cst)
    serial = _serial_goal(tg)
    goal = tg.goals_by_name(["ReplicaDistributionGoal"], cst)[0]
    table = kernels.GuardTable(kernels.GoalChecks(goal, [*local, serial,
                                                         goal], EPS))
    assert table.outside == []
    assert table.kinds == ["interval", "serialize", "interval"]
    assert [table.rows[k].must for k in range(3)] == [1, 0, 1]
    assert table.metrics == [4] and table.reads == 0
    alone = kernels.GuardTable(kernels.GoalChecks(local[0], [], EPS))
    assert alone.n == 0 and alone.kinds == []


def test_guard_table_refuses_an_unknown_goal():
    """A goal whose guard KQ has no kind for is listed in ``outside``; the
    table refuses to load (KQ raises); the twin takes it."""
    class OwnGuard(tg.GoalKernel):
        name = "OwnGuard"

        def collective_guard(self, state, ctx, c, earlier):
            return torch.ones(c.p.shape, dtype=torch.bool)

    class NoRow(tg.IntervalGoal):
        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1)

    cst = TConstraint()
    own = OwnGuard()
    norow = NoRow("NoRow", ts.METRIC_REPLICA_COUNT, hard=False,
                  constraint=cst)
    goal = tg.goals_by_name(["ReplicaDistributionGoal"], cst)[0]
    table = kernels.GuardTable(kernels.GoalChecks(goal, [own, norow], EPS))
    assert table.outside == [own, norow]
    with pytest.raises(ValueError, match="OwnGuard"):
        table.rows_on(torch.device("cpu"))
    assert kernels.GuardTable(kernels.GoalChecks(
        goal, [], EPS)).rows_on(torch.device("cpu"))[0].numel() > 0


def test_round_guards_refuses_bad_shapes(cluster):
    (tst, tctx) = cluster["t"]
    goal = tg.goals_by_name(["ReplicaDistributionGoal"], TConstraint())[0]
    table = kernels.GuardTable(kernels.GoalChecks(goal, [], EPS))
    tc = _cands(ts, tst, tctx, _rows(cluster["jm"], "mixed", 0, n=4)[0],
                _tconv)
    M = tc.p.shape[0]
    mask = torch.ones(M, dtype=torch.bool)
    conflict = torch.zeros((M, M), dtype=torch.bool)
    with pytest.raises(ValueError, match="conflict_earlier"):
        kernels.round_guards(tst, tctx, tc, conflict[:-1], mask, mask, table)
    with pytest.raises(ValueError, match="elig"):
        kernels.round_guards(tst, tctx, tc, conflict, mask, mask[:-1], table)
