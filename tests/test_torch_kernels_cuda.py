"""The port's CUDA kernels on the card against their plain twins on the CPU.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel has
no CPU mode. The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from cruise_control_tpu_torch import _random, kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_the_card(cuda_device):
    """KA and KB bit for bit, KC within rtol 1e-6 (integer deltas are exact
    in any summation order)."""
    gen = torch.Generator().manual_seed(0)
    key = _random.PRNGKey(7, device=cuda_device)
    ctr = torch.arange(10_000, device=cuda_device)
    for got, want in zip(kernels.threefry2x32(key, ctr),
                         kernels.threefry2x32_plain(key.cpu(), ctr.cpu())):
        assert torch.equal(got.cpu(), want)
    seg = torch.randint(0, 33, (5000,), generator=gen)
    vals = torch.rand(5000, 4, generator=gen) * 100
    assert torch.equal(
        kernels.ordered_segment_sum(vals.to(cuda_device), seg.to(cuda_device),
                                    33).cpu(),
        kernels.ordered_segment_sum_plain(vals, seg, 33))
    offsets = torch.tensor([0, 0, 7, 1200, 1201, 5000])
    assert torch.equal(
        kernels.ordered_range_sum(vals.to(cuda_device),
                                  offsets.to(cuda_device)).cpu(),
        kernels.ordered_range_sum(vals, offsets))
    m = 256
    src = torch.randint(0, 20, (m,), generator=gen)
    dst = torch.randint(0, 20, (m,), generator=gen)
    earlier = torch.rand(m, m, generator=gen).tril(-1) < 0.5
    d = torch.randint(-3, 4, (m,), generator=gen).float()
    got = kernels.net_broker_flow(*(t.to(cuda_device)
                                    for t in (src, dst, earlier, d, -d)))
    for g, want in zip(got, kernels.net_broker_flow_plain(src, dst, earlier,
                                                          d, -d)):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_wrappers_count_their_launches(cuda_device):
    kernels.reset_launch_counts()
    key = _random.PRNGKey(1, device=cuda_device)
    _random.uniform(key, (64,))
    kernels.ordered_segment_sum(torch.ones(8, device=cuda_device),
                                torch.zeros(8, dtype=torch.long,
                                            device=cuda_device), 1)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["threefry2x32"] == 1
    assert kernels.LAUNCHES["ordered_segment_sum"] == 1
    assert kernels.LAUNCHES["net_broker_flow"] == 0


def _failover_inputs(gen, S, P, R, B, batched):
    shape = (S, P, R) if batched else (P, R)
    rb = torch.randint(0, B + 1, shape, generator=gen, dtype=torch.int32)
    off = torch.rand(shape, generator=gen) < 0.1
    pref = torch.argsort(torch.rand(shape, generator=gen), dim=-1).to(
        torch.int32)
    bvalid = torch.rand(B, generator=gen) < 0.9
    balive = torch.rand(B, generator=gen) < 0.9
    dead = torch.rand(S, B, generator=gen) < 0.2
    add = torch.rand(S, B, generator=gen) < 0.1
    pvalid = torch.rand(S, P, generator=gen) < 0.9
    return rb, off, pref, bvalid, balive, dead, add, pvalid


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_scenario_failover_matches_twin(cuda_device, batched):
    """KD bit for bit against its twin, on a shared template placement and
    on one placement per scenario."""
    gen = torch.Generator().manual_seed(3)
    args = _failover_inputs(gen, 16, 500, 3, 24, batched)
    got = kernels.scenario_failover(*(t.to(cuda_device) for t in args))
    want = kernels.scenario_failover_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [float("inf"), 150.0])
def test_first_fit_matches_twin(cuda_device, budget):
    """KE bit for bit against its twin, with and without a bandwidth
    budget (padding moves and padding rows included)."""
    gen = torch.Generator().manual_seed(4)
    M, W, B = 300, 3, 12
    rows = torch.randint(0, B + 1, (M, W), generator=gen, dtype=torch.int32)
    dest = torch.where(torch.rand(M, W, generator=gen) < 0.5, rows, B)
    sizes = torch.rand(M, generator=gen) * 100
    valid = torch.arange(M) < 280
    caps = torch.randint(1, 4, (B + 1,), generator=gen, dtype=torch.int32)
    caps[B] = 1 << 30
    for K in (8, 64, 512):
        args = (rows, dest, sizes, valid, caps)
        got = kernels.first_fit(*(t.to(cuda_device) for t in args), 20,
                                budget, K)
        want = kernels.first_fit_plain(*args, 20, budget, K)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_delta_row_scatter_matches_twin(cuda_device):
    """KF writes exactly its twin's rows into both planes in place, drops
    indices outside [0, P) and counts one launch."""
    gen = torch.Generator().manual_seed(3)
    P, K = 2000, 200
    lead = torch.rand(P, 4, generator=gen)
    foll = torch.rand(P, 4, generator=gen)
    idx = torch.cat([torch.randperm(P, generator=gen)[:K - 2],
                     torch.tensor([P, -1])]).to(torch.int32)
    lead_rows = torch.rand(K, 4, generator=gen)
    foll_rows = torch.rand(K, 4, generator=gen)
    want = kernels.delta_row_scatter_plain(lead.clone(), foll.clone(), idx,
                                           lead_rows, foll_rows)
    dl, df = lead.to(cuda_device), foll.to(cuda_device)
    kernels.reset_launch_counts()
    out = kernels.delta_row_scatter(dl, df, idx.to(cuda_device),
                                    lead_rows.to(cuda_device),
                                    foll_rows.to(cuda_device))
    assert out[0] is dl and out[1] is df
    assert torch.equal(dl.cpu(), want[0]) and torch.equal(df.cpu(), want[1])
    assert kernels.LAUNCHES["delta_row_scatter"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("brokers", [8, 24, 104, 1000])
def test_cluster_stats_matches_twin(cuda_device, brokers):
    """KG equals its twin bit for bit (tree-order sums, correctly rounded
    division and root), dead brokers excluded."""
    gen = torch.Generator().manual_seed(brokers)
    util = torch.rand(brokers, 4, generator=gen) * torch.tensor(
        [100.0, 1e4, 1e4, 1e6])
    replicas = torch.randint(0, 500, (brokers,), generator=gen,
                             dtype=torch.int32)
    leaders = torch.randint(0, 250, (brokers,), generator=gen,
                            dtype=torch.int32)
    potential = torch.rand(brokers, generator=gen) * 1e4
    alive = torch.rand(brokers, generator=gen) < 0.9
    args = (util, replicas, leaders, potential, alive)
    want, n_want = kernels.cluster_stats_plain(*args)
    got, n = kernels.cluster_stats(*(t.to(cuda_device) for t in args))
    assert torch.equal(got.cpu(), want) and int(n) == int(n_want)


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False])
def test_resident_warmup_leaves_no_library_load(cuda_device, warm,
                                                monkeypatch):
    """With the kernel library unloaded, as in a fresh process, the first
    metric-only cycle after ``ResidentClusterState.warmup`` records no
    library load; without ``warmup`` that cycle loads it (one compile
    event), so the gate can fail."""
    from cruise_control_tpu_torch.core import runtime_obs
    from cruise_control_tpu_torch.model.resident import ResidentClusterState
    from cruise_control_tpu_torch.model.spec import (BrokerSpec, ClusterSpec,
                                                     PartitionSpec,
                                                     flatten_spec)
    spec = ClusterSpec(
        brokers=[BrokerSpec(broker_id=b, rack=f"r{b}",
                            capacity=(100.0, 1e6, 1e6, 1e8))
                 for b in range(4)],
        partitions=[PartitionSpec(topic="t", partition=p,
                                  replicas=[p % 4, (p + 1) % 4],
                                  leader_load=(0.5, 10.0, 20.0, 100.0 + p))
                    for p in range(16)])
    arrays = flatten_spec(spec, device="cpu")[0].to_numpy()
    collector = runtime_obs.DeviceStatsCollector()
    monkeypatch.setattr(runtime_obs, "_DEFAULT", collector)
    monkeypatch.setattr(kernels, "_LIB", None)
    state = ResidentClusterState(device=cuda_device, collector=collector)
    state.update(arrays)
    if warm:
        assert state.warmup() is True
    before = collector.snapshot()
    lead = arrays["leader_load"].copy()
    lead[3] += 1.0
    state.update(dict(arrays, leader_load=lead))
    assert state.last_update == "delta" and state.last_delta_rows == 1
    assert torch.equal(state.model.leader_load.cpu(), torch.from_numpy(lead))
    built = collector.snapshot()["compileEvents"] - before["compileEvents"]
    assert built == (0 if warm else 1)


def _jbod_inputs(gen, B, D, P, R, max_rows_on_one=None):
    """A random JBOD layout (padding brokers and partitions, draining and
    absent disks, equal and zero sizes) as (rd, size, rb, cap, valid)."""
    rb = torch.randint(0, B, (P, R), generator=gen, dtype=torch.int32)
    rb[-3:] = B + 1                                  # padding partitions
    Bp = B + 1
    rb = torch.where(rb > B, Bp, rb)
    on = rb < Bp
    rd = torch.where(on, torch.randint(0, D, (P, R), generator=gen), -1)
    rd = torch.where(on & (torch.rand(P, R, generator=gen) < 0.6), 0, rd)
    choices = torch.tensor([0.0, 10.0, 25.5, 40.0, 40.0, 77.25])
    size = choices[torch.randint(0, 6, (P, R), generator=gen)]
    size = torch.where(on, size, 0.0)
    cap = torch.rand(Bp, D, generator=gen) * 2000 + 100
    valid = torch.ones(Bp, D, dtype=torch.bool)
    valid[B:] = False
    valid[::3, -1] = False
    cap = torch.where(valid, cap, 0.0)
    cap[1::4, 0] = 0.0                               # draining
    return rd.to(torch.int32), size, rb, cap, valid


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,P,max_iters", [(8, 4, 400, 512),
                                             (5, 3, 60, 3),
                                             (104, 4, 20_096, 512),
                                             (2, 4, 40_000, 20),
                                             (6, 12, 2_000, 512),
                                             (6, 48, 3_000, 512),
                                             (4, 64, 3_000, 512)])
def test_intra_broker_walk_matches_twin(cuda_device, B, D, P, max_iters):
    """The fourth case puts ~40,000 replicas on each broker, more than a
    block's shared memory stages: the walk reads a global scratch copy. The
    last three sum the mean over 12, 48 and 64 disks (one and two windows
    of XLA's tree order)."""
    gen = torch.Generator().manual_seed(B * 1000 + D)
    args = _jbod_inputs(gen, B, D, P, 2)
    rd, it = kernels.intra_broker_walk(*(t.to(cuda_device) for t in args),
                                       max_iters)
    want_rd, want_it = kernels.intra_broker_walk_plain(*args, max_iters)
    assert torch.equal(rd.cpu(), want_rd)
    assert int(it) == int(want_it)


@pytest.mark.cuda
@pytest.mark.parametrize("K,G,hard", [(4, 4, "mixed"), (64, 16, "soft"),
                                      (64, 16, "hard"), (1024, 22, "mixed"),
                                      (128, 22, "soft")])
def test_population_select_matches_twin(cuda_device, K, G, hard):
    gen = torch.Generator().manual_seed(K + G)
    boundary = torch.rand(K, G, generator=gen) * torch.pow(
        10.0, torch.randint(-7, 4, (K, G), generator=gen).float())
    boundary[K // 2] = boundary[K // 3]                 # a tie
    boundary[1, 0] = float("nan")                       # sorts last
    boundary[K - 1] = 0.0
    scales = torch.rand(G, generator=gen) * 1e4
    mask = {"soft": torch.zeros(G, dtype=torch.bool),
            "hard": torch.ones(G, dtype=torch.bool),
            "mixed": torch.arange(G) % 3 == 0}[hard]
    moves = torch.randint(0, 100_000, (K,), generator=gen)
    for move_weight, pareto in ((0.0, False), (0.1, True)):
        n_surv = max(1, min(K // 2, K - 1))
        got = kernels.population_select(
            *(t.to(cuda_device) for t in (boundary, moves, scales, mask)),
            1000.0, move_weight, n_surv, pareto)
        want = kernels.population_select_plain(
            boundary, moves, scales, mask, 1000.0, move_weight, n_surv,
            pareto)
        for g, w in zip(got, want):
            # bit for bit, NaN (the NaN row's score) equal to NaN
            torch.testing.assert_close(g.cpu(), w.to(g.dtype), rtol=0,
                                       atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("C,S,P,R,B", [(3, 16, 500, 3, 24),
                                       (2, 104, 2000, 2, 104)])
def test_fleet_scenario_failover_matches_twin(cuda_device, C, S, P, R, B):
    """KJ bit for bit against its twin over a [C, S] grid (per-cluster
    placements and broker masks, empty and offline slots, kills, adds and
    disabled partitions), one launch per call, and equal cluster by
    cluster to KD on the card."""
    gen = torch.Generator().manual_seed(5)
    rb = torch.randint(0, B + 1, (C, P, R), generator=gen, dtype=torch.int32)
    off = torch.rand(C, P, R, generator=gen) < 0.1
    pref = torch.argsort(torch.rand(C, P, R, generator=gen), dim=-1).to(
        torch.int32)
    bvalid = torch.rand(C, B, generator=gen) < 0.9
    balive = torch.rand(C, B, generator=gen) < 0.9
    dead = torch.rand(C, S, B, generator=gen) < 0.2
    add = torch.rand(C, S, B, generator=gen) < 0.1
    pvalid = torch.rand(C, P, generator=gen) < 0.9
    args = (rb, off, pref, bvalid, balive, dead, add, pvalid)
    kernels.reset_launch_counts()
    got = kernels.fleet_scenario_failover(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fleet_scenario_failover"] == 1
    want = kernels.fleet_scenario_failover_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for c in range(C):
        kd = kernels.scenario_failover(*(t.to(cuda_device) for t in (
            rb[c], off[c], pref[c], bvalid[c], balive[c], dead[c], add[c],
            pvalid[c].expand(S, P).contiguous())))
        for g, k in zip(got, kd):
            assert torch.equal(g[c], k)
