"""A proposal's selection in the port — KU's, KV's and KW's twins
(``kernels.top_k_plain``, ``steer_dest_plain``, ``proposal_select_plain``,
which the wrappers take for CPU tensors) — against the JAX package.

- KU: ``jax.lax.top_k`` over planes of the generators' sizes and every K
  they keep (the tests' 32 and 64, the main path's 128 and 512, the scale
  cell's 1,024 of 400,128), random, quantized to a few levels, mostly
  -inf, and with signed zeros and NaNs.
- KV: the reference's steering composed in JAX from the reference goals'
  ``receptive_dest`` (``engine.py:201-209``) at every position of the
  default chain, with and without dead brokers, and its empty-intersection
  fallback; the table's rows, evaluated as the kernel reads them, give the
  same mask.
- KW: the reference's ``apply_batch`` up to its rounds composed in JAX
  (``engine.py:131-150``) over real proposals of every goal of the
  catalog: every field of the M winners, the conflicts and ``pending``
  exactly; the ``out=`` form writes the same into given buffers and sets
  the flag.
- One fused default-chain optimize through both packages stays equal, its
  proposals made through the three wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.analyzer.engine as je
import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.analyzer.engine as te
import cruise_control_tpu_torch.analyzer.goals as tg
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from cruise_control_tpu_torch.utils.ordered import tree_sum_last
from test_torch_default_chain import (SEARCH, _assert_same_outcome, _outcome,
                                      topic_skew_both)
from test_torch_generators import (ACTIVE, CFG, FIELDS, GOALS, TIES,
                                   _built, _goal_pair, _propose_both)
from torch_parity_util import assert_same

torch.set_num_threads(1)

NAN = np.float32("nan")


# ---------------------------------------------------------------------------
# KU
# ---------------------------------------------------------------------------

def _plane(form, n, seed):
    rng = np.random.default_rng(seed)
    if form == "noise":
        return (rng.random(n) * 2 - 1).astype(np.float32)
    if form == "quantized":
        return rng.integers(-4, 5, n).astype(np.float32) * 0.25
    if form == "masked":                    # a goal's -inf beyond its slots
        x = np.full(n, -np.inf, np.float32)
        live = rng.random(n) < 0.01
        x[live] = rng.random(live.sum()).astype(np.float32)
        return x
    x = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    x[rng.random(n) < 0.05] = NAN
    x[rng.random(n) < 0.05] = -NAN
    x[rng.random(n) < 0.05] = -np.inf
    return x


@pytest.mark.parametrize("form", ["noise", "quantized", "masked",
                                  "zeros and nans"])
@pytest.mark.parametrize("n,k", [(3_000, 32), (3_000, 64), (40_192, 128),
                                 (40_192, 512), (400_128, 1_024)])
def test_top_k_twin_matches_lax_top_k(n, k, form):
    x = _plane(form, n, n + k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = kernels.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


def test_top_k_twin_rows_match_lax_top_k():
    """The interval swap's two planes in one call: [2, N] rows."""
    x = np.stack([_plane("quantized", 40_192, 1), _plane("masked", 40_192,
                                                         2)])
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 128)
    got_v, got_i = kernels.top_k(torch.from_numpy(x), 128)
    assert got_v.shape == (2, 128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert_same(np.asarray(want_v), got_v)


# ---------------------------------------------------------------------------
# KV
# ---------------------------------------------------------------------------

def _chains(built):
    (_j, _jc, jmd), (_t, _tc, tmd) = built
    return ([g.bind(jmd) for g in jg.default_goals(JConstraint(**ACTIVE))],
            [g.bind(tmd) for g in tg.default_goals(TConstraint(**ACTIVE))])


def _ref_steer(prev, state, ctx):
    """``engine.py:steer_ctx``'s mask, as the reference composes it."""
    recv = jnp.ones(ctx.broker_alive.shape, bool)
    for g in prev:
        recv = recv & g.receptive_dest(state, ctx)
    dest = recv & ctx.dest_allowed
    return jnp.where(dest.any(), dest, ctx.dest_allowed)


def _rows_mask(table, state, ctx):
    """The mask from KV's rows as ``csrc/steer.cu`` reads them: each row's
    metric against its upper bound (avg * t in tree order over the alive
    count, integer rows at least ceil(avg); cap * t; t)."""
    planes = {4: state.replica_count.float(), 5: state.leader_count.float(),
              6: state.potential_nw_out, 7: state.leader_nw_in}
    n_alive = torch.clamp(ctx.broker_alive.sum(-1), min=1)
    ok = ctx.dest_allowed.clone()
    for row in table.rows[:table.n]:
        v = planes.get(row.metric)
        v = state.util[:, row.metric] if v is None else v
        t = torch.tensor(row.t, dtype=torch.float32)
        if row.form == 0:
            total = tree_sum_last(torch.where(ctx.broker_valid, v, 0.0))
            avg = total / n_alive
            up = avg * t
            if row.integer:
                up = torch.maximum(up, torch.ceil(avg))
        elif row.form == 1:
            up = ctx.broker_capacity[:, row.cap_col] * t
        else:
            up = t
        ok &= (v + 1.0 <= up) if row.metric in (4, 5) else (v < up)
    return torch.where(ok.any(), ok, ctx.dest_allowed)


@pytest.mark.parametrize("model", ["b23 dead", "b24", "b32 dead", "b105"])
def test_steer_dest_twin_matches_reference_at_every_position(model):
    built = _built(model)
    (jst, jctx, _), (tst, tctx, _) = built
    jchain, tchain = _chains(built)
    steered = 0
    for pos in range(len(tchain)):
        want = np.asarray(jax.jit(lambda s, c: _ref_steer(
            jchain[:pos], s, c))(jst, jctx))
        table = kernels.SteerTable(tchain[:pos])
        assert not table.outside
        assert table.n == sum(isinstance(g, tg.IntervalGoal)
                              for g in tchain[:pos])
        got = kernels.steer_dest(tst, tctx, table)
        assert_same(want, got, what=f"{model} position {pos}")
        assert_same(want, _rows_mask(table, tst, tctx),
                    what=f"{model} position {pos}: the rows")
        seg = te.PassSegments(tchain[pos], tchain[:pos], TConfig(**CFG),
                              tchain)
        assert_same(want, seg.steer_ctx(tst, tctx).dest_allowed)
        # the out= form writes the caller's buffer
        out = torch.zeros(want.shape[0], dtype=torch.bool)
        assert kernels.steer_dest(tst, tctx, table, out=out) is out
        assert_same(want, out)
        steered += int((want != np.asarray(jctx.dest_allowed)).any())
    assert steered, "no position steered: the case tests nothing"


@pytest.mark.parametrize("model", ["b23 dead", "b105"])
def test_steer_dest_falls_back_where_nothing_is_left(model):
    """dest_allowed cut to brokers no earlier goal receives on: the steered
    set is dest_allowed itself, in both packages."""
    built = _built(model)
    (jst, jctx, _), (tst, tctx, _) = built
    jchain, tchain = _chains(built)
    prev_j, prev_t = jchain[:-1], tchain[:-1]
    recv = np.asarray(jax.jit(lambda s, c: _ref_steer(
        prev_j, s, c.replace(dest_allowed=jnp.ones_like(c.dest_allowed))))(
            jst, jctx))
    refused = ~recv
    assert refused.any()
    jctx2 = jctx.replace(dest_allowed=jnp.asarray(refused))
    tctx2 = tctx.replace(dest_allowed=torch.from_numpy(refused))
    want = np.asarray(jax.jit(lambda s, c: _ref_steer(prev_j, s, c))(
        jst, jctx2))
    np.testing.assert_array_equal(want, refused)
    table = kernels.SteerTable(prev_t)
    assert_same(want, kernels.steer_dest(tst, tctx2, table))
    assert_same(want, _rows_mask(table, tst, tctx2))


def test_steer_table_rows():
    """Goals that receive everywhere have no row; a goal whose
    ``receptive_dest`` KV has no form for is listed and refused on the
    card only."""

    class Odd(tg.ReplicaDistributionGoal):
        def receptive_dest(self, state, ctx):
            return ~ctx.dest_allowed

    cst = TConstraint()
    chain = tg.default_goals(cst)
    table = kernels.SteerTable(chain)
    assert table.n == sum(isinstance(g, tg.IntervalGoal) for g in chain)
    assert table.n and not table.outside
    odd = Odd(cst)
    table = kernels.SteerTable([chain[0], odd])
    assert table.outside == [odd] and table.n == 0
    with pytest.raises(ValueError, match="KV has no row"):
        table.rows_on(torch.device("cpu"))


# ---------------------------------------------------------------------------
# KW
# ---------------------------------------------------------------------------

def _ref_select(goal, prev, cfg, state, ctx, cands):
    """``engine.py``'s eligibility, score and ``apply_batch`` up to its
    rounds (:131-150), as the reference composes them."""
    ok = js.base_legality(state, ctx, cands)
    ok = ok & je._chain_accepts(prev, state, ctx, cands)
    delta = goal.delta(state, ctx, cands)
    elig = ok & ((delta < -cfg.epsilon) | cands.must)
    score = jnp.where(elig, jnp.where(cands.must, je._MUST_FIRST,
                                      jnp.clip(delta, -1e29, 1e29)),
                      jnp.inf)
    M = min(cfg.apply_per_iter, score.shape[0])
    _, order = jax.lax.top_k(-score, M)
    c = jax.tree.map(lambda x: x[order], cands)
    sel = jnp.isfinite(score[order])

    def same(a, b):
        return a[:, None] == b[None, :]

    conflict = (same(c.p, c.p) | same(c.p, c.p2)
                | same(c.p2, c.p) | same(c.p2, c.p2))
    earlier = jnp.tril(jnp.ones((M, M), bool), k=-1)
    return c, conflict & earlier, sel


def _same_selection(jout, tout, rows, what):
    jc, jce, jsel = jout
    tc, tce, tsel = tout
    for name in FIELDS:
        want = np.asarray(getattr(jc, name))
        if name == "p2":
            want = np.where(want < 0, want + rows, want).clip(0, rows - 1)
        assert_same(want, getattr(tc, name), what=f"{what}.{name}")
    assert_same(np.asarray(jce), tce, what=f"{what} conflicts")
    assert_same(np.asarray(jsel), tsel, what=f"{what} pending")


def _select_both(model, name, cfg, chain_pos=None):
    built = _built(model)
    (jst, jctx, jmd), (tst, tctx, tmd) = built
    if chain_pos is None:
        jgoal, tgoal = _goal_pair(name, jmd, tmd)
        jprev, tprev = [], []
    else:
        jchain, tchain = _chains(built)
        jgoal, tgoal = jchain[chain_pos], tchain[chain_pos]
        jprev, tprev = jchain[:chain_pos], tchain[:chain_pos]
    jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
    jc, tc = _propose_both(jgoal, tgoal, built, cfg, seed=3)
    jout = jax.jit(lambda s, c, x: _ref_select(jgoal, jprev, jcfg, s, c, x))(
        jst, jctx, jc)
    seg = te.PassSegments(tgoal, tprev, tcfg)
    elig, delta = seg.eligibility(tst, tctx, tc)
    M = min(tcfg.apply_per_iter, tc.p.shape[0])
    return jout, (tc, elig, delta, M), tst.rb.shape[0]


@pytest.mark.parametrize("model", ["b23 dead", "rf3 sets"])
@pytest.mark.parametrize("name", GOALS)
@pytest.mark.parametrize("cfg", ["noise", "ties"])
def test_proposal_select_twin_matches_reference(model, name, cfg):
    jout, (tc, elig, delta, M), rows = _select_both(
        model, name, CFG if cfg == "noise" else TIES)
    _same_selection(jout, kernels.proposal_select(tc, elig, delta, M), rows,
                    f"{model} {name} {cfg}")


@pytest.mark.parametrize("model", ["b23 dead", "b105"])
@pytest.mark.parametrize("pos", [3, 7, 9, 13, 15])
def test_proposal_select_at_default_chain_positions(model, pos):
    """The pass goal's proposal checked against every earlier goal of the
    default chain (KN's verdict), selected as the reference selects it;
    the ``out=`` form writes the same into the caller's buffers and sets
    the flag to ``pending.any()``."""
    jout, (tc, elig, delta, M), rows = _select_both(model, None, CFG, pos)
    got = kernels.proposal_select(tc, elig, delta, M)
    _same_selection(jout, got, rows, f"{model} position {pos}")
    if pos == 7:            # ReplicaDistribution has work on both models
        assert bool(got[2].any()), "nothing pending: the case tests nothing"
    out = (ts_empty(got[0]), torch.zeros_like(got[1]),
           torch.zeros_like(got[2]))
    flag = torch.full((), 7, dtype=torch.int64)
    back = kernels.proposal_select(tc, elig, delta, M, out=out, flag=flag)
    assert back[0] is out[0] and back[1] is out[1] and back[2] is out[2]
    _same_selection(jout, out, rows, f"{model} position {pos}, out=")
    assert int(flag) == int(got[2].any())


def ts_empty(c):
    """Candidates of zeros shaped like ``c``."""
    return type(c)(**{f: torch.zeros_like(getattr(c, f)) for f in FIELDS})


def test_proposal_select_mandatory_first_and_nothing_eligible():
    """Mandatory moves rank first whatever their delta, ineligible ones
    last and not pending; with nothing eligible the flag is 0."""
    _jout, (tc, elig, delta, M), _rows = _select_both("b23 dead", None, CFG,
                                                      7)
    must = torch.zeros_like(tc.must)
    must[-3:] = True
    c = tc.replace(must=must)
    elig2 = elig.clone()
    elig2[-3:] = True
    got, _ce, pending = kernels.proposal_select(c, elig2, delta, M)
    assert got.must[:3].all() and pending[:3].all()
    flag = torch.ones((), dtype=torch.int64)
    _c, _ce, pending = kernels.proposal_select(
        tc, torch.zeros_like(elig), delta, M, flag=flag)
    assert not pending.any() and int(flag) == 0


# ---------------------------------------------------------------------------
# The whole optimize
# ---------------------------------------------------------------------------

def test_fused_default_chain_goes_through_the_selection(monkeypatch):
    """``goals=None``, fused, on the topic-skewed cluster with a dead
    broker: the port's outcome equals the reference's, and every proposal
    of it went through KV, KU and KW's wrappers."""
    calls = {"steer_dest": 0, "top_k": 0, "proposal_select": 0}

    def counted(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, call)
    counted(te, "steer_dest")
    counted(te, "proposal_select")
    counted(tg, "top_k")
    cfg = dict(SEARCH, fused_chain=True)
    jopt = ja.TpuGoalOptimizer(config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(config=ta.SearchConfig(**cfg), device="cpu")
    (jm, jmd), (tm, tmd) = topic_skew_both(dead=(3,))
    tout = _outcome(topt, ta, tm, tmd)
    _assert_same_outcome(_outcome(jopt, ja, jm, jmd), tout, "fused default")
    iters = sum(g.iterations for g in tout[0].goal_results)
    assert calls["proposal_select"] >= iters > 0
    assert calls["steer_dest"] > 0 and calls["top_k"] > 0
