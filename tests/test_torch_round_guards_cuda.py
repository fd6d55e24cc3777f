"""KQ (``kernels.round_guards``) on the card, bit for bit against its twin
run on the same CUDA state (``round_guards_plain``: the goals' guards
through KC and KK, the path an apply round took before KQ).

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_round_guards_cuda.py -q

Rounds: real ones (a pass's first proposal and the round's KN launch) at
positions of the main, default and part-B chains and at the scale cell;
adversarial ones over the default chain and a chain of 64 goals (KN in two
chunks of rows): every candidate on one source or one destination, no
candidate eligible, every candidate mandatory, a random conflict mask
that is not lower-triangular, M from 1 to 2,048.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return {"main": chip_smoke.build_flat_direct(100, 20_000, 2),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2)}


def _chain(name, md):
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   default_goals,
                                                   goals_by_name)
    import chip_smoke
    if name == "main":
        return goals_by_name(chip_smoke.GOALS)
    if name == "partb":
        cst = BalancingConstraint(**chip_smoke.PARTB_CONSTRAINT)
        return [g.bind(md) for g in goals_by_name(chip_smoke.PARTB_CHAIN,
                                                  cst)]
    goals = [g.bind(md) for g in default_goals()]
    return goals * 4 if name == "64 goals" else goals


def _same(got, want, what):
    for name, g, w in zip(("do", "pending", "more"), got, want):
        assert g.dtype == torch.bool and g.shape == w.shape, (what, name)
        assert torch.equal(g, w), f"{what}: {name} differs from the twin"


def _launches(fn):
    before = dict(kernels.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                 if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("model,chain,pos,propose_pos,search", [
    ("main", "main", 3, 3, None), ("main", "main", 0, 0, None),
    ("main", "default", 15, 13, None), ("main", "default", 13, 13, None),
    ("main", "default", 8, 8, None), ("main", "default", 2, 2, None),
    ("main", "default", 0, 0, None), ("main", "partb", 3, 3, None),
    ("scale", "main", 3, 3, "scale"), ("scale", "default", 14, 14,
                                       "scale")])
def test_round_guards_matches_twin_on_real_rounds(models, model, chain, pos,
                                                  propose_pos, search):
    import chip_smoke
    m, md = models[model]
    if chain == "partb":
        state, ctx, goals = chip_smoke.partb_pass(m.device)
    else:
        state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
        goals = _chain(chain, md)
    cfg = (chip_smoke.MAIN_SEARCH if search is None else
           chip_smoke.KQ_SHAPES["scale"][0][2])
    seg, c, ce, pending, elig, bounds = chip_smoke.kq_round(
        state, ctx, goals, pos, cfg, propose_pos)
    args = (state, ctx, c, ce, pending, elig, seg.guards)
    got, counts = _launches(lambda: kernels.round_guards(*args, bounds))
    assert counts == {"round_guards": 1}
    _same(got, kernels.round_guards_plain(*args),
          f"{model} {chain}[{pos}]")


def _adversarial(state, ctx, c, m, form, seed):
    """(candidates, conflict_earlier, pending, elig) of an adversarial
    round over ``c``'s first m candidates."""
    rng = np.random.default_rng(seed)
    dev = state.rb.device
    c = c.take(torch.arange(m, device=dev))
    p, p2 = c.p.cpu().numpy(), c.p2.cpu().numpy()
    conflict = (((p[:, None] == p) | (p[:, None] == p2)
                 | (p2[:, None] == p) | (p2[:, None] == p2))
                & np.tril(np.ones((m, m), bool), k=-1))
    pending = rng.random(m) < 0.9
    elig = rng.random(m) < 0.85
    hot = int(np.bincount(c.src.cpu().numpy()).argmax())
    if form == "one source":
        c = c.replace(src=torch.full_like(c.src, hot))
    elif form == "one destination":
        c = c.replace(dst=torch.full_like(c.dst, hot))
    elif form == "no candidate eligible":
        elig[:] = False
    elif form == "all mandatory":
        c = c.replace(must=torch.ones_like(c.must))
    elif form == "random conflicts":
        conflict = rng.random((m, m)) < 0.02

    def t(x):
        return torch.from_numpy(x).to(dev)
    return c, t(conflict), t(pending), t(elig)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["default", "64 goals"])
@pytest.mark.parametrize("m", [1, 33, 512, 2048])
@pytest.mark.parametrize("form", ["mixed", "one source", "one destination",
                                  "no candidate eligible", "all mandatory",
                                  "random conflicts"])
def test_round_guards_adversarial(models, chain, m, form):
    """KQ against its twin on adversarial rounds; the bounds are KN's at
    the state (one launch of the chain's last position), the candidates
    ``kn_case``'s, the masks seeded."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    model, md = models["main"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    goals = _chain(chain, md)
    checks = kernels.GoalChecks(goals[-1], goals[:-1],
                                SearchConfig().epsilon)
    guards = kernels.GuardTable(checks)
    assert guards.outside == []
    c = chip_smoke.kn_case(state, ctx, max(m, 64), seed=m)
    bounds = checks.round_bounds(state)
    kernels.candidate_eligibility(state, ctx, c, checks, bounds)
    c, ce, pending, elig = _adversarial(state, ctx, c, m, form, seed=m + 1)
    args = (state, ctx, c, ce, pending, elig, guards)
    got = kernels.round_guards(*args, bounds)
    want = kernels.round_guards_plain(*args)
    torch.cuda.synchronize()
    _same(got, want, f"{chain} M={m} {form}")
    if form == "no candidate eligible":
        assert not got[0].any() and not got[2]


@pytest.mark.cuda
def test_an_apply_round_launches_kq_and_not_kc_or_kk(models):
    """``PassSegments.round`` on the card: KN, KQ and KM once each, KC and
    KK never, one apply round counted; its state, pending, count and flag
    equal the same round on a CPU copy (the twins)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import engine
    model, md = models["main"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    goals = _chain("default", md)
    seg, c, ce, pending, _, _ = chip_smoke.kq_round(
        state, ctx, goals, 13, chip_smoke.MAIN_SEARCH)
    rounds = engine.APPLY_ROUNDS
    got, counts = _launches(lambda: seg.round(state, ctx, c, ce, pending))
    assert engine.APPLY_ROUNDS == rounds + 1
    assert counts == {"candidate_eligibility": 1, "round_guards": 1,
                      "apply_group": 1}
    cpu = [chip_smoke.to_device(x, "cpu") for x in (state, ctx, c)]
    want = seg.round(*cpu, ce.cpu(), pending.cpu())
    for f in ("rb", "pos", "offline", "util", "replica_count",
              "topic_counts", "moves_applied"):
        assert torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f)), f
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_round_guards_refuses_bad_inputs(models):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    model, md = models["main"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    goals = _chain("main", md)
    seg, c, ce, pending, elig, bounds = chip_smoke.kq_round(
        state, ctx, goals, 3, chip_smoke.MAIN_SEARCH)
    args = (state, ctx, c)
    with pytest.raises(ValueError):
        kernels.round_guards(*args, ce[:-1], pending, elig, seg.guards,
                             bounds)
    with pytest.raises(TypeError):
        kernels.round_guards(*args, ce, pending.int(), elig, seg.guards,
                             bounds)
    with pytest.raises(ValueError, match="bounds"):
        kernels.round_guards(*args, ce, pending, elig, seg.guards)

    class OwnGuard(g.GoalKernel):
        name = "OwnGuard"

        def collective_guard(self, state, ctx, c, earlier):
            return torch.ones_like(c.must)

    checks = kernels.GoalChecks(goals[3], [*goals[:3], OwnGuard()], 1e-6)
    with pytest.raises(ValueError, match="OwnGuard"):
        kernels.round_guards(*args, ce, pending, elig,
                             kernels.GuardTable(checks), bounds)
