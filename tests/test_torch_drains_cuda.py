"""KZ (``kernels.drain_order``) and KAA (``kernels.leadership_drain``), the
bulk drains on the card, against their plain twins on the CPU, bit for bit.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel has
no CPU mode. The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_drains_cuda.py -q
"""

import dataclasses

import pytest
import torch

from cruise_control_tpu_torch import _random, kernels

#: tight capacity thresholds, so the capacity goals drain too
TIGHT = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
             max_replicas_per_broker=150)
REPLICA_GOALS = ("ReplicaDistributionGoal", "DiskUsageDistributionGoal",
                 "DiskCapacityGoal", "ReplicaCapacityGoal")
LEADERSHIP_GOALS = ("LeaderReplicaDistributionGoal",
                    "LeaderBytesInDistributionGoal")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return {"main": chip_smoke.build_flat_direct(100, 20_000, 2),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2)}


def _cpu(obj):
    import chip_smoke
    return chip_smoke.to_device(obj, "cpu")


def _goal(name):
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   goals_by_name)
    return goals_by_name([name], BalancingConstraint(**TIGHT))[0]


def _keys(seed, word, device):
    """The same round key as a path on the card and on the CPU."""
    return (_random.fold(_random.PRNGKey(seed, device=device), word),
            _random.fold(_random.PRNGKey(seed), word))


def _same(got, want, what):
    """Tensors equal, floats bit for bit (the sign of a zero too)."""
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if g.is_floating_point():
            g, w = g.contiguous().view(torch.int32), w.contiguous().view(
                torch.int32)
        assert torch.equal(g, w), (what, k)


def _state(models, shape, dead=(3,), case="plain"):
    """(state, ctx) of a model: ``case`` "one" puts every slot (for the
    leadership drain every leader) on broker 5; "zeros" gives the replicas
    on the dead brokers loads of +0.0 and -0.0, alternating, on every
    resource."""
    import chip_smoke
    model, md = models[shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=dead)
    if case == "one":
        state = dataclasses.replace(state, rb=torch.full_like(state.rb, 5))
    elif case == "lead_one":
        rb = state.rb.clone()
        rb[:, 0] = 5
        rb[:, 1] = torch.where(rb[:, 1] == 5, 6, rb[:, 1])
        state = dataclasses.replace(state, rb=rb)
    elif case == "zeros":
        on_dead = torch.zeros_like(state.offline)
        for b in dead:
            on_dead |= state.rb == b
        p = on_dead.any(dim=1)
        sign = torch.where(torch.arange(p.shape[0], device=p.device) % 2
                           == 0, 0.0, -0.0)[:, None]
        lead = torch.where(p[:, None], sign.expand(-1, 4), ctx.leader_load)
        foll = torch.where(p[:, None], sign.expand(-1, 4),
                           ctx.follower_load)
        ctx = ctx.replace(leader_load=lead, follower_load=foll)
    return state, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("shape,case", [("main", "plain"), ("main", "zeros"),
                                        ("main", "one"), ("scale", "plain"),
                                        ("scale", "zeros")])
@pytest.mark.parametrize("name", REPLICA_GOALS)
def test_drain_order_matches_twin(cuda_device, models, shape, case, name):
    """KZ's planes, order and slot fields against its twin: the main path's
    and the scale cell's shapes with broker 3 dead, loads of +0.0 and -0.0
    on the dead broker's replicas, and every slot on one broker (one run
    of 40,192 slots: ten chunks merged); one launch counted a call."""
    state, ctx = _state(models, shape, case=case)
    goal = _goal(name)
    key, ckey = _keys(11, 70_003, cuda_device)
    kernels.reset_launch_counts()
    got = kernels.drain_order(goal, state, ctx, key)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["drain_order"] == 1
    want = kernels.drain_order_plain(goal, _cpu(state), _cpu(ctx), ckey)
    _same(got, want, f"{name} {shape} {case}")
    # KP takes the order as it took the lexsort's
    cfg = _search(shape)
    fill = kernels.bulk_drain_fill(goal, state, ctx, cfg, *got)
    want_fill = kernels.bulk_drain_fill_plain(goal, _cpu(state), _cpu(ctx),
                                              cfg, *want)
    _same(fill, want_fill, f"{name} {shape} {case}: KP")


def _search(shape):
    from cruise_control_tpu_torch.analyzer import SearchConfig
    return SearchConfig(drain_batch=16_384 if shape == "main" else 25_000)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,case,batch", [
    ("main", "plain", 16_384), ("main", "plain", 7), ("main", "zeros", 512),
    ("main", "lead_one", 16_384), ("scale", "plain", 25_000)])
@pytest.mark.parametrize("name", LEADERSHIP_GOALS)
def test_leadership_drain_matches_twin(cuda_device, models, shape, case,
                                       batch, name):
    """KAA's (p, r, ok) against its twin at the main path's and the scale
    cell's shapes (broker 3 dead), ±0.0 loads, every leader on one broker
    (one pass-1 run of 20,096 partitions) and a batch that truncates."""
    from cruise_control_tpu_torch.analyzer import SearchConfig
    state, ctx = _state(models, shape, case=case)
    goal = _goal(name)
    cfg = SearchConfig(drain_batch=batch)
    w_all = goal._leadership_drain_weight(ctx)
    key, ckey = _keys(5, 70_000, cuda_device)
    kernels.reset_launch_counts()
    got = kernels.leadership_drain(goal, state, ctx, key, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["leadership_drain"] == 1
    want = kernels.leadership_drain_plain(goal, _cpu(state), _cpu(ctx), ckey,
                                          cfg, w_all.cpu())
    _same(got, want, f"{name} {shape} {case} N={batch}")


@pytest.mark.cuda
def test_drain_order_ties_and_nans(cuda_device, models):
    """Forced ties (every weight 1.0 on a util goal), NaN loads of either
    sign and ±0.0: the order equals the twin's lexsort."""
    state, ctx = _state(models, "main")
    goal = _goal("DiskUsageDistributionGoal")
    lead = ctx.leader_load.clone()
    foll = ctx.follower_load.clone()
    col = 3
    lead[:, col] = 1.0
    foll[:, col] = 1.0
    lead[::7, col] = float("nan")
    foll[1::11, col] = -float("nan")
    lead[2::13, col] = -0.0
    foll[3::17, col] = 0.0
    ctx = ctx.replace(leader_load=lead, follower_load=foll)
    key, ckey = _keys(2, 70_001, cuda_device)
    got = kernels.drain_order(goal, state, ctx, key)
    want = kernels.drain_order_plain(goal, _cpu(state), _cpu(ctx), ckey)
    _same(got, want, "ties and NaNs")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ReplicaDistributionGoal",
                                  "LeaderReplicaDistributionGoal"])
def test_captured_drain_segment_replays_equal(cuda_device, models, name):
    """A pass's drain segment (KV, KZ/KAA, KP, KT, KN, KM) captured in a
    CUDA graph replays to the eager call's state and count."""
    import gc

    from cruise_control_tpu_torch.analyzer import SearchConfig, engine
    state, ctx = _state(models, "main")
    goal = _goal(name)
    seg = engine.PassSegments(goal, [], SearchConfig(drain_batch=16_384))
    key = _random.PRNGKey(9, device=cuda_device)
    want_state, want_n = seg.drain(state, ctx, key, 1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            got_state, got_n = seg.drain(state, ctx, key, 1)
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    assert int(got_n) == int(want_n) > 0
    for f in dataclasses.fields(want_state):
        w = getattr(want_state, f.name)
        if isinstance(w, torch.Tensor):
            assert torch.equal(getattr(got_state, f.name), w), f.name
