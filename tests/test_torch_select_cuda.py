"""KU, KV and KW (``kernels.top_k``, ``steer_dest``, ``proposal_select``)
on the card, bit for bit against their twins.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_select_cuda.py -q

KU on crafted rows (``chip_smoke.TOP_K_EDGES``: ties, signed zeros,
NaNs, -inf masks, one block's largest row, the chunked form, k = N, N =
1, k 4,096) and on the generators' real planes; KV at every position of
the main and default chains on the main path's cluster, the scale cell
and 20,000 brokers (its tree scratch in global memory); KW over every
default-chain goal's first proposal at its position and on crafted
verdicts (mandatory moves, nothing eligible, the scale cell's M 1,024 of
16,384); the wrappers' refusals; and a warm optimize that launches KU,
KV and KW through the goal-loop graphs and captures nothing new.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import _random, kernels


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return {"main": chip_smoke.build_flat_direct(100, 20_000, 2),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2),
            "wide": chip_smoke.build_flat_direct(20_000, 100_000, 2)}


def _chain(name, md):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import (default_goals,
                                                   goals_by_name)
    if name == "main":
        return goals_by_name(chip_smoke.GOALS)
    return [g.bind(md) for g in default_goals()]


def _same_top_k(got, want):
    return (torch.equal(got[1].cpu(), want[1])
            and torch.equal(got[0].cpu().view(torch.int32),
                            want[0].view(torch.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(9))
def test_top_k_matches_twin_on_crafted_rows(models, case):
    import chip_smoke
    tag, S, n, k, form = chip_smoke.TOP_K_EDGES[case]
    rng = np.random.default_rng(case)
    x = np.stack([chip_smoke.top_k_row(form, n, rng) for _ in range(S)])
    got = kernels.top_k(torch.from_numpy(x).cuda(), k)
    want = kernels.top_k_plain(torch.from_numpy(x), k)
    assert got[0].shape == (S, k)
    assert _same_top_k(got, want), tag


@pytest.mark.cuda
@pytest.mark.parametrize("model,chain", [("main", "main"),
                                         ("main", "default"),
                                         ("scale", "default")])
def test_generators_top_k_matches_twin(models, model, chain):
    """Every KU call of each chain goal's propose (KR's real planes) held
    to its twin (``chip_smoke.check_generators`` records and compares
    KR, KS, KT and KU)."""
    import chip_smoke
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    search = (chip_smoke.MAIN_SEARCH if model == "main"
              else chip_smoke.SCALE3_SEARCH)
    seen = 0
    for _goal, name, *_rest in chip_smoke.check_generators(
            state, ctx, _chain(chain, md), search, f"{model} {chain}"):
        seen += name == "top_k"
    assert seen


@pytest.mark.cuda
@pytest.mark.parametrize("model,chain", [("main", "main"),
                                         ("main", "default"),
                                         ("scale", "default"),
                                         ("wide", "default")])
def test_steer_dest_matches_twin_at_every_position(models, model, chain):
    import chip_smoke
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chain(chain, md)
    cs, cc = chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx)
    for pos in range(1, len(goals)):
        table = kernels.SteerTable(goals[:pos])
        if not table.n:
            continue
        got = kernels.steer_dest(state, ctx, table)
        want = kernels.steer_dest_plain(cs, cc, table.prev_goals)
        assert torch.equal(got.cpu(), want), (model, chain, pos)
        out = torch.zeros_like(got)
        assert kernels.steer_dest(state, ctx, table, out=out) is out
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
def test_steer_dest_falls_back_where_nothing_is_left(models):
    import chip_smoke
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chain("default", md)
    table = kernels.SteerTable(goals[:-1])
    every = ctx.replace(dest_allowed=torch.ones_like(ctx.dest_allowed))
    refused = ~kernels.steer_dest(state, every, table)
    assert refused.any()
    ctx2 = ctx.replace(dest_allowed=refused)
    got = kernels.steer_dest(state, ctx2, table)
    assert torch.equal(got, refused)
    assert torch.equal(got.cpu(), kernels.steer_dest_plain(
        chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx2), table.prev_goals))


def _proposal(state, ctx, goals, pos, search, seed=0):
    from cruise_control_tpu_torch.analyzer import SearchConfig
    from cruise_control_tpu_torch.analyzer.engine import PassSegments
    cfg = SearchConfig(**search)
    seg = PassSegments(goals[pos], goals[:pos], cfg, all_goals=goals)
    cands = goals[pos].propose(state, seg.steer_ctx(state, ctx),
                               _random.PRNGKey(seed, device=state.rb.device),
                               cfg)
    elig, delta = seg.eligibility(state, ctx, cands)
    return cands, elig, delta, min(cfg.apply_per_iter, cands.p.shape[0])


def _same_selection(got, want):
    fields = [f for f, _d, _w in kernels.CANDIDATE_FIELDS]
    for f in fields:
        g, w = getattr(got[0], f).cpu(), getattr(want[0], f)
        if g.dtype.is_floating_point:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["main", "scale"])
def test_proposal_select_matches_twin_at_every_position(models, model):
    import chip_smoke
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chain("default", md)
    search = (chip_smoke.MAIN_SEARCH if model == "main"
              else chip_smoke.SCALE3_SEARCH)
    pending = 0
    for pos in range(len(goals)):
        cands, elig, delta, M = _proposal(state, ctx, goals, pos, search)
        got = kernels.proposal_select(cands, elig, delta, M)
        want = kernels.proposal_select_plain(chip_smoke.to_cpu(cands),
                                             elig.cpu(), delta.cpu(), M)
        _same_selection(got, want)
        pending += int(got[2].sum())
        # the carry's form: into given buffers, the flag set
        out = tuple(chip_smoke.clone_fields(got[0]) if i == 0
                    else t.clone().zero_() for i, t in enumerate(got))
        flag = torch.full((), 5, dtype=torch.int64, device="cuda")
        back = kernels.proposal_select(cands, elig, delta, M, out=out,
                                       flag=flag)
        assert all(b is o for b, o in zip(back, out))
        _same_selection(out, want)
        assert int(flag) == int(want[2].any())
    assert pending


@pytest.mark.cuda
def test_proposal_select_crafted_verdicts(models):
    """Mandatory moves first, nothing eligible (the flag 0), deltas of
    equal value (ties by index) and the scale cell's M 1,024 of 16,384."""
    import chip_smoke
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chain("default", md)
    cands, elig, delta, M = _proposal(state, ctx, goals, 7,
                                      chip_smoke.MAIN_SEARCH)
    rng = np.random.default_rng(3)
    N = cands.p.shape[0]
    cases = {
        "must": (elig | torch.from_numpy(rng.random(N) < 0.1).cuda(),
                 delta, cands.replace(must=torch.from_numpy(
                     rng.random(N) < 0.05).cuda())),
        "none": (torch.zeros_like(elig), delta, cands),
        "ties": (torch.ones_like(elig), torch.full_like(delta, -1.0), cands),
    }
    for tag, (e, d, c) in cases.items():
        for m_ in (M, 1, N):
            if m_ > kernels.PROPOSAL_MAX:
                continue
            flag = torch.ones((), dtype=torch.int64, device="cuda")
            got = kernels.proposal_select(c, e, d, m_, flag=flag)
            want = kernels.proposal_select_plain(
                chip_smoke.to_cpu(c), e.cpu(), d.cpu(), m_)
            _same_selection(got, want)
            assert int(flag) == int(want[2].any()), tag
    ms, mmd = models["scale"]
    sstate, sctx = chip_smoke.pass_state(ms, mmd, dead=(3,))
    c = chip_smoke.kn_case(sstate, sctx, 16_384, seed=5)
    e = torch.from_numpy(rng.random(16_384) < 0.7).cuda()
    d = torch.from_numpy((rng.random(16_384) - 0.8).astype(np.float32)
                         ).cuda()
    got = kernels.proposal_select(c, e, d, 1_024)
    _same_selection(got, kernels.proposal_select_plain(
        chip_smoke.to_cpu(c), e.cpu(), d.cpu(), 1_024))


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(models):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    x = torch.rand(100, device="cuda")
    for bad in (lambda: kernels.top_k(x, 101),
                lambda: kernels.top_k(torch.rand(5000, device="cuda"), 4097),
                lambda: kernels.top_k(x.double(), 3),
                lambda: kernels.top_k(x.reshape(2, 5, 10), 3),
                lambda: kernels.top_k(x, -1)):
        with pytest.raises((ValueError, TypeError)):
            bad()
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chain("default", md)
    cands, elig, delta, M = _proposal(state, ctx, goals, 7,
                                      chip_smoke.MAIN_SEARCH)
    N = cands.p.shape[0]
    for bad in (lambda: kernels.proposal_select(cands, elig, delta, N + 1),
                lambda: kernels.proposal_select(cands, elig[:-1], delta, M),
                lambda: kernels.proposal_select(
                    cands, elig, delta, M, flag=torch.zeros(
                        (), dtype=torch.bool, device="cuda")),
                lambda: kernels.proposal_select(
                    cands, elig, delta, M, out=(chip_smoke.clone_fields(
                        kernels.proposal_select(cands, elig, delta, M)[0]),
                        torch.zeros((M, M), dtype=torch.uint8,
                                    device="cuda"),
                        torch.zeros(M, dtype=torch.bool, device="cuda")))):
        with pytest.raises(ValueError):
            bad()

    class Odd(g.ReplicaDistributionGoal):
        def receptive_dest(self, state, ctx):
            return ~ctx.dest_allowed

    table = kernels.SteerTable([goals[2], Odd(g.BalancingConstraint())])
    with pytest.raises(ValueError, match="KV has no row"):
        kernels.steer_dest(state, ctx, table)
    with pytest.raises(ValueError):
        kernels.steer_dest(state, ctx, kernels.SteerTable(goals[:1]))


@pytest.mark.cuda
def test_warm_optimize_launches_the_selection_and_captures_nothing(models):
    """The main path's optimize through the goal-loop graphs: KU, KV and
    KW launch in it, a warm one captures no graph and reads no loop test
    on the host, and two seed-1 runs give the same proposals."""
    import chip_smoke
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(chip_smoke.build_spec(), device="cuda")
    opt = chip_smoke.main_path_optimizer()
    chip_smoke._optimize(opt, model, md, 0)
    kernels.reset_launch_counts()
    caps = chip_smoke._captures()
    res1, _w, syncs1, caps1 = chip_smoke._optimize(opt, model, md, 1)
    res2, _w, syncs2, caps2 = chip_smoke._optimize(opt, model, md, 1)
    launches = chip_smoke._launch_counts()
    assert syncs1 == syncs2 == 0 and caps1 == caps2 == 0
    assert chip_smoke._captures() == caps
    assert all(launches[k] for k in ("top_k", "steer_dest",
                                     "proposal_select")), launches
    assert res1.proposals == res2.proposals
