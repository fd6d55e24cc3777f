"""Parity of the goal pass's fused kernels' twins with the JAX package on
the CPU: KM (``kernels.apply_group``), KN (``candidate_eligibility``), KO
(``flow_priority`` and ``flow_match``, through ``_flow_candidates``) and
KP (``bulk_drain_fill``, through ``_replica_bulk_drain``), each fed the
same seeded inputs as the reference's function, and a whole fused
optimize of the main path's chain (the default chain's is
``test_torch_default_chain.py``'s).

On the CPU every wrapper takes its plain twin, the function the card's
kernel is held to bit for bit (``tests/test_torch_kernels_cuda.py``).
Each JAX function runs jitted, as inside the reference's pass program.
Tolerance: exact equality everywhere (float aggregates, deltas and
candidates included)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.analyzer.engine as te
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from torch_parity_util import assert_same, build_both, tiny_both

torch.set_num_threads(1)

CHAIN = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal"]
#: tight capacity thresholds so the capacity goals have work to do
TIGHT = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
             max_replicas_per_broker=150)
SEARCH = dict(num_replica_candidates=96, num_dest_candidates=8,
              num_swap_candidates=48, apply_per_iter=96, drain_batch=256)
CAND_FIELDS = ("p", "r", "p2", "r2", "src", "dst", "kind", "valid", "must",
               "d_util_src", "d_util_dst", "d_cnt", "d_lead", "d_pot",
               "d_lni")


def _same_fields(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f"{what}.{f.name}"
            continue
        assert_same(x, y, what=f"{what}.{f.name}")


def _same_cands(jc, tc, what):
    for name in CAND_FIELDS:
        assert_same(getattr(jc, name), getattr(tc, name),
                    what=f"{what}.{name}")


def _states(jm, jmd, tm):
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    return ((js.init_state(jm, **topics), js.build_context(jm)),
            (ts.init_state(tm, **topics), ts.build_context(tm)))


# ---------------------------------------------------------------------------
# KM: apply_group
# ---------------------------------------------------------------------------

def _make(mod, state, ctx, kind, a, conv):
    if kind == 0:
        return mod.make_move_candidates(state, ctx, conv(a["p"]),
                                        conv(a["r"]), conv(a["dst"]),
                                        conv(a["valid"]))
    if kind == 1:
        return mod.make_leadership_candidates(state, ctx, conv(a["p"]),
                                              conv(a["r"]), conv(a["valid"]))
    return mod.make_swap_candidates(state, ctx, conv(a["p"]), conv(a["r"]),
                                    conv(a["p2"]), conv(a["r2"]),
                                    conv(a["valid"]))


def _jconv(x):
    return jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x)


def _tconv(x):
    return torch.from_numpy(np.asarray(x))


def _group(jm, seed, case, n=64):
    """A partition-disjoint group of all three kinds (swaps with r2 == 0
    among them); "padding" appends candidates on padding partitions (topic
    -1) that do not apply, "none" applies nothing."""
    rng = np.random.default_rng(seed)
    P, R = jm.replica_broker.shape
    B1 = jm.num_brokers_padded + 1
    real = int(np.asarray(jm.partition_valid).sum())
    rows = rng.choice(real, size=2 * n, replace=False)
    p, p2 = rows[:n], rows[n:]
    kind = rng.integers(0, 3, n)
    p2 = np.where(kind == 2, p2, p)
    r = rng.integers(0, R, n)
    r = np.where(kind == 1, np.maximum(r, 1), r)
    r2 = np.where(kind == 2, rng.integers(0, R, n), r)
    r2[np.nonzero(kind == 2)[0][:4]] = 0
    do = rng.random(n) < 0.7
    if case == "none":
        do[:] = False
    if case == "padding" and P > real:
        k = min(8, P - real)
        extra = rng.integers(real, P, k)
        p = np.concatenate([p, extra])
        p2 = np.concatenate([p2, extra])
        r = np.concatenate([r, np.zeros(k, int)])
        r2 = np.concatenate([r2, np.zeros(k, int)])
        kind = np.concatenate([kind, np.zeros(k, int)])
        do = np.concatenate([do, np.zeros(k, bool)])
    dst = rng.integers(0, B1 - 1, p.shape[0])
    return dict(p=p, r=r, p2=p2, r2=r2, dst=dst, kind=kind, do=do)


def _group_cands(mod, state, ctx, g, conv):
    parts = []
    for k in range(3):
        sel = g["kind"] == k
        a = {key: v[sel] for key, v in g.items()}
        a["valid"] = np.ones(int(sel.sum()), bool)
        parts.append(_make(mod, state, ctx, k, a, conv))
    out = parts[0]
    for extra in parts[1:]:
        out = mod.concat_candidates(out, extra)
    order = np.concatenate([np.nonzero(g["kind"] == k)[0] for k in range(3)])
    return out, g["do"][order]


APPLY_CASES = {"mixed": (lambda: build_both(20, 1000, seed=3), "mixed"),
               "padding": (lambda: build_both(20, 1000, seed=4), "padding"),
               "dead": (lambda: build_both(20, 1000, seed=5, dead=(0, 7)),
                        "mixed"),
               "none": (tiny_both, "none")}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_group_twin(case):
    """KM's twin against the reference's apply_group over three rounds with
    topic tables: swaps (some with r2 == 0), non-applied rows on padding
    partitions (topic -1), replicas offline on dead brokers, nothing
    applied; the count it returns is do's."""
    build, kind = APPLY_CASES[case]
    (jm, jmd), (tm, _) = build()
    (jst, jctx), (tst, tctx) = _states(jm, jmd, tm)
    if case == "dead":
        assert bool(tst.offline.any())
    apply_j = jax.jit(js.apply_group)
    for rnd in range(3):
        g = _group(jm, 10 * rnd + len(case), kind)
        jc, jdo = _group_cands(js, jst, jctx, g, _jconv)
        tc, tdo = _group_cands(ts, tst, tctx, g, _tconv)
        jst = apply_j(jst, jctx, jc, jnp.asarray(jdo))
        tst, count = kernels.apply_group(tst, tctx, tc, torch.from_numpy(tdo))
        assert int(count) == int(tdo.sum())
        _same_fields(jst, tst, f"{case} round {rnd}")


# ---------------------------------------------------------------------------
# KN: eligibility at every chain position
# ---------------------------------------------------------------------------

def _goals(mod, chain, cst, md):
    goals = (mod.default_goals(cst) if chain == "default"
             else mod.goals_by_name(CHAIN, cst))
    return [g.bind(md) for g in goals]


def _mixed_cands(mod, state, ctx, jm, seed, conv, n=96):
    """Moves (some off offline replicas), leadership transfers and swaps
    from random partition rows, most of them legal."""
    rng = np.random.default_rng(seed)
    P, R = jm.replica_broker.shape
    B1 = jm.num_brokers_padded + 1
    real = int(np.asarray(jm.partition_valid).sum())
    out = None
    for kind in range(3):
        a = dict(p=rng.integers(0, real, n), r=rng.integers(0, R, n),
                 p2=rng.integers(0, real, n), r2=rng.integers(0, R, n),
                 dst=rng.integers(0, B1, n), valid=rng.random(n) < 0.95)
        if kind == 1:
            a["r"] = np.maximum(a["r"], 1)
        c = _make(mod, state, ctx, kind, a, conv)
        out = c if out is None else mod.concat_candidates(out, c)
    return out


@pytest.mark.parametrize("brokers", [8, 22, 31, 32],
                         ids=lambda n: f"B1_{n + 1}")
@pytest.mark.parametrize("chain", ["main", "default"])
def test_eligibility_every_chain_position(chain, brokers):
    """KN's twin (``GoalChecks`` of each chain position: the pass goal's
    delta, every earlier goal's acceptance) against the reference's
    eligibility — base legality, the chain's acceptance and (delta < -eps)
    | must — and the goal's delta, at B1 = 9, 23, 32 and 33, with a dead
    broker's replicas offline."""
    (jm, jmd), (tm, tmd) = build_both(brokers, 200, seed=brokers,
                                      dead=(1,), broker_pad_multiple=1)
    assert jm.num_brokers_padded + 1 == brokers + 1
    (jst, jctx), (tst, tctx) = _states(jm, jmd, tm)
    jgoals = _goals(jg, chain, JConstraint(), jmd)
    tgoals = _goals(tg, chain, TConstraint(), tmd)
    jc = _mixed_cands(js, jst, jctx, jm, brokers, _jconv)
    tc = _mixed_cands(ts, tst, tctx, jm, brokers, _tconv)
    eps = TConfig().epsilon
    seen = 0
    for i in range(len(jgoals)):
        def jelig(state, ctx, cands, i=i):
            ok = js.base_legality(state, ctx, cands)
            for g in jgoals[:i]:
                ok = ok & g.accepts(state, ctx, cands)
            delta = jgoals[i].delta(state, ctx, cands)
            return ok & ((delta < -eps) | cands.must), delta
        want_ok, want_delta = jax.jit(jelig)(jst, jctx, jc)
        checks = kernels.GoalChecks(tgoals[i], tgoals[:i], eps)
        got_ok, got_delta = kernels.candidate_eligibility(tst, tctx, tc,
                                                          checks)
        what = f"{chain}[{i}] {tgoals[i].name}"
        assert_same(want_delta, got_delta, what=f"{what} delta")
        assert_same(want_ok, got_ok, what=f"{what} eligible")
        seen += int(got_ok.sum())
    assert seen > 0


def test_goal_checks_split_the_chain():
    """Every goal of the chain has a row of KN's table: the pass goal's
    first, then the earlier goals' but for MinTopicLeadersPerBroker,
    which with no topics configured accepts every candidate."""
    goals = tg.default_goals(TConstraint())
    checks = kernels.GoalChecks(goals[9], goals[:9], 1e-6)
    assert checks.outside == []
    assert checks.n == 9
    kinds = [kernels.ROW_KINDS[checks.rows[k].kind] for k in range(checks.n)]
    assert kinds == ["interval", "rack_aware"] + ["hard_cap"] * 5 + [
        "interval"] * 2
    topic = kernels.GoalChecks(goals[13], goals[:13], 1e-6)
    assert topic.outside == [] and topic.n == 13
    assert kernels.ROW_KINDS[topic.rows[0].kind] == "topic_replica"


# ---------------------------------------------------------------------------
# KO: flow candidates
# ---------------------------------------------------------------------------

FLOW_GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
              "NetworkOutboundUsageDistributionGoal",
              "LeaderReplicaDistributionGoal", "PotentialNwOutGoal",
              "DiskCapacityGoal", "ReplicaCapacityGoal"]
FLOW_MODELS = {"20x1k_dead": lambda: build_both(20, 1000, seed=6, dead=(2,)),
               "b23": lambda: build_both(22, 600, seed=7,
                                         broker_pad_multiple=1)}


def _jflow(goal, state, ctx, key, cfg):
    """The reference's propose prelude, then its _flow_candidates."""
    values = js.metric_values(state, goal.metric)
    lower, upper = goal.bounds(state, ctx)
    lo = jnp.broadcast_to(jnp.asarray(lower, values.dtype), values.shape)
    up = jnp.broadcast_to(jnp.asarray(upper, values.dtype), values.shape)
    alive = ctx.broker_alive
    excess = jnp.where(alive, jnp.maximum(values - up, 0.0), values)
    deficit = (jnp.zeros_like(values) if goal.upper_only else
               jnp.where(alive & jnp.isfinite(lo),
                         jnp.maximum(lo - values, 0.0), 0.0))
    return goal._flow_candidates(state, ctx, key, cfg, values, lo, up,
                                 excess, deficit)


def _tflow(goal, state, ctx, key, cfg):
    """The port's propose prelude, then its _flow_candidates (KO)."""
    return goal._flow_candidates(state, ctx, key, cfg,
                                 *goal.propose_planes(state, ctx))


@pytest.mark.parametrize("model", sorted(FLOW_MODELS))
@pytest.mark.parametrize("name", FLOW_GOALS)
def test_flow_candidates_twins(model, name):
    """KO's twins (the priorities, the top-k, the destination match)
    against the reference's _flow_candidates: every candidate field."""
    (jm, jmd), (tm, _) = FLOW_MODELS[model]()
    (jst, jctx), (tst, tctx) = _states(jm, jmd, tm)
    jgoal = jg.goals_by_name([name], JConstraint(**TIGHT))[0]
    tgoal = tg.goals_by_name([name], TConstraint(**TIGHT))[0]
    jcfg, tcfg = JConfig(**SEARCH), TConfig(**SEARCH)
    for seed in (0, 1):
        jc = jax.jit(_jflow, static_argnums=(0, 4))(
            jgoal, jst, jctx, jax.random.PRNGKey(seed), jcfg)
        tc = _tflow(tgoal, tst, tctx, _random.PRNGKey(seed), tcfg)
        _same_cands(jc, tc, f"{name} seed {seed}")
        # a capacity goal without a dead broker may find no headroom
        assert bool(tc.valid.any()) or (tgoal.upper_only
                                        and model == "b23")


# ---------------------------------------------------------------------------
# KP: the replica bulk drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ReplicaDistributionGoal",
                                  "DiskUsageDistributionGoal",
                                  "DiskCapacityGoal"])
@pytest.mark.parametrize("dead", [(), (0, 9)], ids=["alive", "dead"])
def test_bulk_drain_twin(name, dead):
    """KP's twin through _replica_bulk_drain against the reference's: a
    count goal, a util goal (the replica-count cap of its budgets) and a
    capacity goal (the FMA of its ceiling), with and without dead brokers
    whose replicas must move."""
    (jm, jmd), (tm, _) = build_both(20, 1000, seed=8, dead=dead)
    (jst, jctx), (tst, tctx) = _states(jm, jmd, tm)
    jgoal = jg.goals_by_name([name], JConstraint(**TIGHT))[0]
    tgoal = tg.goals_by_name([name], TConstraint(**TIGHT))[0]
    jcfg, tcfg = JConfig(**SEARCH), TConfig(**SEARCH)
    for seed in (0, 1):
        jc = jax.jit(jgoal._replica_bulk_drain, static_argnums=(3,))(
            jst, jctx, jax.random.PRNGKey(seed), jcfg)
        tc = tgoal._replica_bulk_drain(tst, tctx, _random.PRNGKey(seed),
                                       tcfg)
        _same_cands(jc, tc, f"{name} seed {seed}")
        assert bool(tc.valid.any())
        if dead:
            assert bool(tc.must.any())


# ---------------------------------------------------------------------------
# One whole fused optimize per chain through the twins
# ---------------------------------------------------------------------------

def test_fused_optimize_through_the_twins():
    """The fused walk of the main path's four goals, every pass through
    KM-KP's twins, against the reference: the same proposals, moves and
    per-goal outcomes (22 brokers, B1 = 23, one of them dead). The default
    chain's fused walk through the same twins is held by
    ``test_torch_default_chain.py::test_default_chain_parity``."""
    (jm, jmd), (tm, tmd) = build_both(22, 400, seed=12, dead=(5,),
                                      broker_pad_multiple=1)
    cfg = dict(SEARCH, max_iters_per_goal=24, fused_chain=True)
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN),
                               config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 config=ta.SearchConfig(**cfg), device="cpu")
    outs = []
    for opt, mod, m, md in ((jopt, ja, jm, jmd), (topt, ta, tm, tmd)):
        try:
            outs.append((opt.optimize(m, md, mod.OptimizationOptions(
                seed=1)), None))
        except mod.OptimizationFailureError as err:
            outs.append((err.result, str(err)))
    (jres, jerr), (tres, terr) = outs
    assert terr == jerr
    assert tres.proposals == jres.proposals
    assert tres.num_moves == jres.num_moves > 0
    assert [(g.name, g.iterations, g.accepted, g.violation_before,
             g.violation_after) for g in tres.goal_results] == [
        (g.name, g.iterations, g.accepted, g.violation_before,
         g.violation_after) for g in jres.goal_results]


# ---------------------------------------------------------------------------
# KM's in-place form (``out=``), the goal-loop graphs' form
# ---------------------------------------------------------------------------

def _same_bits(a, b, what):
    """Every field equal, floats bit for bit (the sign of a zero too),
    integers by value (the reference keeps int32 indices)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f"{what}.{f.name}"
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, f"{what}.{f.name}"
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            assert x.dtype == y.dtype == np.float32, f"{what}.{f.name}"
            assert x.tobytes() == y.tobytes(), f"{what}.{f.name}"
        else:
            assert np.array_equal(x.astype(np.int64), y.astype(np.int64)), \
                f"{what}.{f.name}"


def _copy(state):
    return state.replace(**{f.name: None if getattr(state, f.name) is None
                            else getattr(state, f.name).clone()
                            for f in dataclasses.fields(state)})


def test_apply_group_out_form_matches_both():
    """KM's twin written into buffers (``out=``, a copy of the state the
    way a goal pass's carry holds it) over three rounds, each equal bit for
    bit to the functional form and to the reference's apply_group: four
    brokers' float aggregates start at -0.0 (the rows of candidates that
    do not apply then turn them to +0.0), and candidates on padding
    partitions (topic -1) do not apply. The functional form leaves its
    inputs untouched."""
    (jm, jmd), (tm, _) = build_both(20, 1000, seed=4)
    (jst, jctx), (tst, tctx) = _states(jm, jmd, tm)
    jst = jst.replace(util=jst.util.at[:4].set(-0.0),
                      potential_nw_out=jst.potential_nw_out.at[:4].set(-0.0),
                      leader_nw_in=jst.leader_nw_in.at[:4].set(-0.0))
    tst = tst.replace(util=tst.util.clone(),
                      potential_nw_out=tst.potential_nw_out.clone(),
                      leader_nw_in=tst.leader_nw_in.clone())
    tst.util[:4] = -0.0
    tst.potential_nw_out[:4] = -0.0
    tst.leader_nw_in[:4] = -0.0
    _same_bits(jst, tst, "-0.0 bases")
    apply_j = jax.jit(js.apply_group)
    carry = _copy(tst)
    for rnd in range(3):
        g = _group(jm, 30 + rnd, "padding")
        jc, jdo = _group_cands(js, jst, jctx, g, _jconv)
        tc, tdo = _group_cands(ts, tst, tctx, g, _tconv)
        do = torch.from_numpy(tdo)
        padding = ~np.asarray(tctx.partition_valid)[np.asarray(tc.p)]
        assert padding.any() and not (padding & tdo).any()
        jst = apply_j(jst, jctx, jc, jnp.asarray(jdo))
        before = _copy(tst)
        fun, count = kernels.apply_group(tst, tctx, tc, do)
        _same_bits(tst, before, f"round {rnd}: the functional form's input")
        out, count_out = kernels.apply_group(carry, tctx, tc, do, out=carry)
        assert out is carry
        assert int(count) == int(count_out) == int(tdo.sum())
        _same_bits(fun, carry, f"round {rnd}: out= against the functional")
        _same_bits(jst, carry, f"round {rnd}: out= against the reference")
        tst = fun


def test_fused_optimize_through_the_graph_interpreter(monkeypatch):
    """The main path's fused walk with every pass run by ``GraphLoop`` —
    its graphs interpreted on the host, its drain and apply rounds writing
    KM's twin into the carry (``out=``) — against the reference's fused
    optimize: the same proposals, moves and per-goal outcomes."""
    from test_torch_goal_loop import HostInterpreter
    from cruise_control_tpu_torch.analyzer.graph_loop import GraphLoop
    built = []

    def graph_loop(self, state, ctx):
        if not self._graphs:
            self._graphs["interpreted"] = GraphLoop(
                self.segments, state, ctx, aux=self._aux,
                backend=HostInterpreter())
            built.append(self._graphs["interpreted"])
        return self._graphs["interpreted"]

    monkeypatch.setattr(te._PassRunner, "_on_host", lambda self, state: False)
    monkeypatch.setattr(te._PassRunner, "graph_loop", graph_loop)
    (jm, jmd), (tm, tmd) = build_both(22, 400, seed=12, dead=(5,),
                                      broker_pad_multiple=1)
    cfg = dict(SEARCH, max_iters_per_goal=24, fused_chain=True)
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN),
                               config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 config=ta.SearchConfig(**cfg), device="cpu")
    outs = []
    for opt, mod, m, md in ((jopt, ja, jm, jmd), (topt, ta, tm, tmd)):
        try:
            outs.append((opt.optimize(m, md, mod.OptimizationOptions(
                seed=1)), None))
        except mod.OptimizationFailureError as err:
            outs.append((err.result, str(err)))
    (jres, jerr), (tres, terr) = outs
    assert built, "the walk did not run through GraphLoop"
    assert terr == jerr
    assert tres.proposals == jres.proposals
    assert tres.num_moves == jres.num_moves > 0
    assert [(g.name, g.iterations, g.accepted, g.violation_before,
             g.violation_after) for g in tres.goal_results] == [
        (g.name, g.iterations, g.accepted, g.violation_before,
         g.violation_after) for g in jres.goal_results]
