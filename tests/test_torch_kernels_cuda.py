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


def _segment_case(case, gen):
    """(values, seg, S, base) on the CPU for one KB case."""
    def rand(*shape):
        return torch.rand(*shape, generator=gen) * 1000 - 300
    if case == "ragged":                # uneven segments, some empty
        seg = (torch.rand(20_000, generator=gen) ** 3 * 105).long()
        return rand(20_000, 4), seg, 105, None
    if case == "empty_segments":        # only every third segment has rows
        seg = torch.randint(0, 35, (9_000,), generator=gen) * 3
        return rand(9_000, 4), seg, 105, None
    if case == "out_of_range":          # ids below 0 and at or past S drop
        seg = torch.randint(-7, 40, (12_000,), generator=gen)
        return rand(12_000, 2), seg, 33, None
    if case == "one_segment":           # every row in one segment, 3 rounds
        return rand(10_000, 4), torch.full((10_000,), 17), 105, None
    if case == "large_S":               # S above 100,000
        seg = torch.randint(0, 150_000, (300_000,), generator=gen)
        return rand(300_000), seg, 150_000, None
    if case == "no_rows":
        return (rand(0, 4), torch.zeros(0, dtype=torch.long), 9,
                rand(9, 4))
    if case == "apply_group":           # 1,024 rows x 6 columns with a base
        seg = torch.randint(0, 105, (1_024,), generator=gen)
        return rand(1_024, 6), seg, 105, rand(105, 6)
    if case == "batched_int32":         # a batch axis, int32 ids, a base
        seg = torch.randint(-1, 22, (7, 5_000), generator=gen).int()
        return rand(7, 5_000, 4), seg, 21, rand(7, 21, 4)
    if case == "batched_flat":          # a batch axis over 1-D values
        seg = torch.randint(0, 105, (3, 4_000), generator=gen)
        return rand(3, 4_000), seg, 105, None
    if case == "wide":                  # nine columns: three column groups
        seg = torch.randint(0, 50, (6_000,), generator=gen)
        return rand(6_000, 9), seg, 50, None
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "empty_segments", "out_of_range",
                                  "one_segment", "large_S", "no_rows",
                                  "apply_group", "batched_int32",
                                  "batched_flat", "wide"])
def test_segment_sum_equals_its_twin(cuda_device, case):
    """KB bit for bit (max abs error 0) against its sequential twin."""
    vals, seg, S, base = _segment_case(case, torch.Generator().manual_seed(3))
    got = kernels.ordered_segment_sum(
        vals.to(cuda_device), seg.to(cuda_device), S,
        None if base is None else base.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       kernels.ordered_segment_sum_plain(vals, seg, S, base))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 3])
def test_range_sum_runs_of_1_to_32_rows(cuda_device, cols):
    gen = torch.Generator().manual_seed(cols)
    lengths = torch.randint(0, 33, (2_000,), generator=gen)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long),
                         torch.cumsum(lengths, 0)])
    vals = torch.rand(int(offsets[-1]), cols, generator=gen) * 1e4 - 3e3
    got = kernels.ordered_range_sum(vals.to(cuda_device),
                                    offsets.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.ordered_range_sum(vals, offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 31, 32, 33, 512, 1000, 1024])
def test_net_broker_flow_adds_in_ascending_j(cuda_device, m):
    """KC bit for bit (max abs error 0) against the ascending-j form, on
    float loads whose sums depend on the order."""
    gen = torch.Generator().manual_seed(m)
    src = torch.randint(0, 105, (m,), generator=gen)
    dst = torch.randint(0, 105, (m,), generator=gen)
    src[: m // 4] = 7                   # a hot broker: long partial sums
    earlier = torch.rand(m, m, generator=gen).tril(-1) < 0.6
    a = (torch.rand(m, generator=gen) - 0.5) * 300
    b = (torch.rand(m, generator=gen) - 0.5) * 300
    got = kernels.net_broker_flow(*(t.to(cuda_device)
                                    for t in (src, dst, earlier, a, b)))
    torch.cuda.synchronize()
    for g, want in zip(got, kernels.net_broker_flow_ascending(
            src, dst, earlier, a, b)):
        assert torch.equal(g.cpu(), want)


def _cell_case(gen, m, a, k, density, ids):
    """KK's inputs on the CPU: colliding cell ids, integer terms."""
    key = torch.randint(-1, ids, (k, m), generator=gen)
    query = torch.where(torch.rand(a, m, generator=gen) < 0.3,
                        torch.randint(-1, ids, (a, m), generator=gen),
                        key[torch.arange(a) % k])
    val = torch.randint(-4, 5, (a, k, m), generator=gen).float()
    earlier = torch.rand(m, m, generator=gen).tril(-1) < density
    return query, key, val, earlier


@pytest.mark.cuda
@pytest.mark.parametrize("m,a,k,density", [
    (1, 4, 4, 0.6), (31, 4, 4, 0.6), (33, 2, 2, 0.9), (256, 1, 3, 0.6),
    (257, 4, 4, 0.6), (512, 4, 4, 0.6), (512, 2, 2, 0.6), (512, 4, 4, 0.0),
    (1000, 3, 1, 0.5), (1024, 4, 4, 0.6), (1024, 2, 2, 1.0)])
def test_cell_net_flow_matches_twin(cuda_device, m, a, k, density):
    """KK bit for bit against its masked-matmul twin (every term an integer,
    so every order is exact), with one launch counted."""
    gen = torch.Generator().manual_seed(m * 16 + a * 4 + k)
    args = _cell_case(gen, m, a, k, density, ids=24)
    kernels.reset_launch_counts()
    got = kernels.cell_net_flow(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cell_net_flow"] == 1
    assert torch.equal(got.cpu(), kernels.cell_net_flow_plain(*args))
    if density == 0.0:
        assert not got.any()


@pytest.mark.cuda
def test_cell_net_flow_refuses_bad_shapes(cuda_device):
    gen = torch.Generator().manual_seed(1)
    q, key, val, e = (t.to(cuda_device)
                      for t in _cell_case(gen, 8, 4, 4, 0.5, ids=4))
    with pytest.raises(ValueError):
        kernels.cell_net_flow(q, key, val[:, :3], e)
    with pytest.raises(ValueError):
        kernels.cell_net_flow(torch.cat([q, q[:1]]), key, val, e)
    with pytest.raises(ValueError):
        kernels.cell_net_flow(q, key, val, e.float())


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
@pytest.mark.parametrize("S", [1, 3, 100])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("form", ["shared", "per-scenario"])
def test_scenario_failover_forms_match_twin(cuda_device, form, R, S):
    """KD's tiled kernel (R of 1-4) and its row kernel (R = 5) against the
    twin, for a placement shared by the scenarios and one per scenario
    (the boundary audit's), each with pvalid per scenario and expanded
    over them; P off a multiple of 4 for odd R (element loads and
    stores), broker ids -1 and at or past B."""
    gen = torch.Generator().manual_seed(100 * R + S)
    B = 104
    P = 2_050 if R % 2 else 2_052
    args = list(_failover_inputs(gen, S, P, R, B, form == "per-scenario"))
    args[0][..., :3, 0] = torch.tensor([-1, B, B + 7], dtype=torch.int32)
    assert (kernels.failover_chunk(1, S, P, R, B) == 0) == (R > 4)
    dev = [t.to(cuda_device) for t in args]
    # an expanded pvalid is read once (stride 0 kept on the card)
    expanded = args[7][0].expand(S, P)
    for pvalid, on_card in ((args[7], dev[7]),
                            (expanded, dev[7][0].expand(S, P))):
        got = kernels.scenario_failover(*dev[:7], on_card)
        want = kernels.scenario_failover_plain(*args[:7], pvalid)
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


def _first_fit_case(case, K, gen, W=4):
    """(rows, dest, sizes, valid, caps, cluster_cap, budget) for one of
    KE's regimes at K batch slots and W touched rows a move."""
    B = 40
    if case == "frontier_1":
        # caps and the cluster cap never bind: every move lands in slot 0
        M = 300
        caps = torch.full((B + 1,), 1 << 20, dtype=torch.int32)
        ccap, budget = 1 << 20, float("inf")
    elif case == "frontier_near_k":
        # every move touches row 0, whose cap is 1: move i opens batch i,
        # and the last moves find every slot taken (assigned K)
        M = K + 3
        caps = torch.full((B + 1,), 1 << 20, dtype=torch.int32)
        caps[0] = 1
        ccap, budget = 1 << 20, float("inf")
    elif case == "cap_zero":
        M = 400
        caps = torch.randint(1, 4, (B + 1,), generator=gen,
                             dtype=torch.int32)
        caps[7] = 0                                    # never admitted
        ccap, budget = 25, float("inf")
    else:                                              # budget with spills
        M = 600
        caps = torch.randint(2, 6, (B + 1,), generator=gen,
                             dtype=torch.int32)
        ccap, budget = 60, 150.0
    rows = torch.randint(0, B + 1, (M, W), generator=gen, dtype=torch.int32)
    if case == "frontier_near_k":
        rows[:, 0] = 0
    if case == "budget_spills":
        rows[:, 1] = torch.randint(0, 3, (M,), generator=gen,
                                   dtype=torch.int32)
    dest = torch.where(torch.rand(M, W, generator=gen) < 0.5, rows, B)
    dest[:, 1] = rows[:, 1]
    sizes = torch.rand(M, generator=gen) * 100
    valid = torch.rand(M, generator=gen) < 0.95
    caps[B] = 1 << 30
    return rows, dest, sizes, valid, caps, ccap, budget


@pytest.mark.cuda
@pytest.mark.parametrize("K", [8, 64, 512, 1024])
@pytest.mark.parametrize("case", ["frontier_1", "frontier_near_k",
                                  "cap_zero", "budget_spills"])
def test_first_fit_regimes_match_twin(cuda_device, case, K):
    """KE at the frontier of 1 and near K (slots past the shared-memory
    ones), a row with a cap of 0, and a budget that spills moves."""
    gen = torch.Generator().manual_seed(K + len(case))
    *args, ccap, budget = _first_fit_case(case, K, gen)
    got = kernels.first_fit(*(t.to(cuda_device) for t in args), ccap, budget,
                            K)
    want = kernels.first_fit_plain(*args, ccap, budget, K)
    assert torch.equal(got.cpu(), want)
    if case == "frontier_near_k":
        assert int(want.max()) == K


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 9, 24])
@pytest.mark.parametrize("case", ["frontier_near_k", "budget_spills"])
def test_first_fit_any_touched_rows(cuda_device, case, W):
    """KE at a compiled-in row count (W = 2) and at the generic form, which
    reads a move's rows in a run-time loop (W = 9, and 24 rows as a
    reassignment at a replication factor of 12 touches), at K = 1,024."""
    gen = torch.Generator().manual_seed(W + len(case))
    *args, ccap, budget = _first_fit_case(case, 1024, gen, W)
    got = kernels.first_fit(*(t.to(cuda_device) for t in args), ccap, budget,
                            1024)
    want = kernels.first_fit_plain(*args, ccap, budget, 1024)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case,K", [("random_order", 200),
                                    ("random_order", 1),
                                    ("random_order", 20_096),
                                    ("padded", 512), ("negative", 64),
                                    ("three_columns", 100)])
def test_delta_row_scatter_matches_twin(cuda_device, case, K):
    """KF writes exactly its twin's planes, out of place: fresh outputs,
    the input planes untouched, indices outside [0, P) (P, the reference's
    padding, and negatives) dropped, any K up to every row; one launch."""
    gen = torch.Generator().manual_seed(K + len(case))
    P, C = 20_096, 3 if case == "three_columns" else 4
    lead = torch.rand(P, C, generator=gen)
    foll = torch.rand(P, C, generator=gen)
    idx = torch.randperm(P, generator=gen)[:K].to(torch.int32)
    if case == "padded":
        idx[40:] = P
    elif case == "negative":
        idx[::3] = -1 - torch.arange(idx[::3].numel(), dtype=torch.int32)
    lead_rows = torch.rand(K, C, generator=gen)
    foll_rows = torch.rand(K, C, generator=gen)
    payload = torch.from_numpy(kernels.pack_delta_rows(
        idx.numpy(), lead_rows.numpy(), foll_rows.numpy()))
    want = kernels.delta_row_scatter_plain(lead, foll, payload)
    dl, df = lead.to(cuda_device), foll.to(cuda_device)
    kernels.reset_launch_counts()
    out = kernels.delta_row_scatter(dl, df, payload.to(cuda_device))
    assert out[0] is not dl and out[1] is not df
    assert torch.equal(dl.cpu(), lead) and torch.equal(df.cpu(), foll)
    assert torch.equal(out[0].cpu(), want[0])
    assert torch.equal(out[1].cpu(), want[1])
    assert kernels.LAUNCHES["delta_row_scatter"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("brokers", [8, 24, 104, 1000, 8000, 20_000,
                                     100_000])
def test_cluster_stats_matches_twin(cuda_device, brokers):
    """KG equals its twin bit for bit (tree-order sums, correctly rounded
    division and root, dead brokers excluded, the three counts) in one
    launch: one staged chunk up to 5,120 brokers, several past it, the
    level sums in global scratch past about 27,000. The replica mask
    starts off a 16-byte boundary and its length is no multiple of 16."""
    gen = torch.Generator().manual_seed(brokers)
    util = torch.rand(brokers, 4, generator=gen) * torch.tensor(
        [100.0, 1e4, 1e4, 1e6])
    replicas = torch.randint(0, 500, (brokers,), generator=gen,
                             dtype=torch.int32)
    leaders = torch.randint(0, 250, (brokers,), generator=gen,
                            dtype=torch.int32)
    potential = torch.rand(brokers, generator=gen) * 1e4
    alive = torch.rand(brokers, generator=gen) < 0.9
    P, R = 20_093, 3
    rvalid = (torch.rand(P * R + 5, generator=gen) < 0.8)[5:].view(P, R)
    pvalid = torch.rand(P, generator=gen) < 0.7
    args = (util, replicas, leaders, potential, alive, rvalid, pvalid)
    want = kernels.cluster_stats_plain(*args)
    kernels.reset_launch_counts()
    got = kernels.cluster_stats(*(t.to(cuda_device) for t in args))
    assert kernels.LAUNCHES["cluster_stats"] == 1
    assert torch.equal(got.cpu(), want)
    assert kernels.split_cluster_stats(got.cpu())[1].tolist() == [
        int(alive.sum()), int(rvalid.sum()), int(pvalid.sum())]


@pytest.mark.cuda
def test_cluster_stats_propagates_nan(cuda_device):
    """A NaN at an alive broker makes its column's avg, std, max and min
    NaN in KG as in the twin; a NaN at a dead broker changes nothing."""
    gen = torch.Generator().manual_seed(5)
    B = 104
    util = torch.rand(B, 4, generator=gen) * 100
    alive = torch.ones(B, dtype=torch.bool)
    alive[7] = False
    util[3, 1] = float("nan")
    util[7, 2] = float("nan")
    args = (util, torch.arange(B, dtype=torch.int32),
            torch.arange(B, dtype=torch.int32) // 2,
            torch.rand(B, generator=gen), alive,
            torch.ones(40, 2, dtype=torch.bool),
            torch.ones(40, dtype=torch.bool))
    want = kernels.cluster_stats_plain(*args)
    got = kernels.cluster_stats(*(t.to(cuda_device) for t in args)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    table = kernels.split_cluster_stats(got)[0]
    assert table[:, 1].isnan().all() and not table[:, 2].isnan().any()


@pytest.mark.cuda
def test_empty_kernel_launches(cuda_device):
    kernels.reset_launch_counts()
    kernels.empty_launch()
    torch.cuda.synchronize()
    assert not any(kernels.LAUNCHES.values())


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
                                             (4, 64, 3_000, 512),
                                             (6, 65, 3_000, 512),
                                             (5, 96, 4_000, 512),
                                             (4, 128, 5_000, 512)])
def test_intra_broker_walk_matches_twin(cuda_device, B, D, P, max_iters):
    """The fourth case puts ~40,000 replicas on each broker, more than a
    block's shared memory stages: the walk reads a global scratch copy. The
    others sum the mean over 12-128 disks (one to four windows of XLA's
    tree order)."""
    gen = torch.Generator().manual_seed(B * 1000 + D)
    args = _jbod_inputs(gen, B, D, P, 2)
    rd, it = kernels.intra_broker_walk(*(t.to(cuda_device) for t in args),
                                       max_iters)
    want_rd, want_it = kernels.intra_broker_walk_plain(*args, max_iters)
    assert torch.equal(rd.cpu(), want_rd)
    assert int(it) == int(want_it)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["first", "last", "skewed", "nan",
                                  "drain_zero"])
def test_intra_broker_walk_edge_cases(cuda_device, case):
    """KH where the moved replica is the first or the last element of its
    disk's list, where one broker holds far more replicas than the others
    (its lists exceed the launch's shared allotment: global scratch), where
    a size is NaN, and where a draining disk holds zero-size replicas."""
    gen = torch.Generator().manual_seed(len(case))
    B, D, R = 6, 4, 2
    P = 30_000 if case == "skewed" else 600
    rd, size, rb, cap, valid = _jbod_inputs(gen, B, D, P, R)
    if case == "skewed":
        rb[: P - 200] = torch.where(rb[: P - 200] < B, 0, rb[: P - 200])
        rb[: P - 200, 1] = torch.where(rb[: P - 200, 1] < B, 1,
                                       rb[: P - 200, 1])
        size = torch.rand(P, R, generator=gen) * 100
        size = torch.where(rb < B, size, 0.0)
    elif case in ("first", "last"):
        # broker 0's heaviest replica on disk 0 at the list's front or back
        on0 = (rb == 0) & (rd == 0)
        flat = torch.nonzero(on0.reshape(-1)).squeeze(1)
        pick = flat[0] if case == "first" else flat[-1]
        size.view(-1)[pick] = 1500.0
        cap[0] = 5000.0
        valid[0] = True
    elif case == "nan":
        on = torch.nonzero((rb < B).reshape(-1)).squeeze(1)
        size.view(-1)[on[len(on) // 2]] = float("nan")
    else:
        cap[2, 1] = 0.0                                 # drains
        valid[2, 1] = True
        on = (rb == 2)
        rd = torch.where(on & (torch.arange(P)[:, None] % 5 == 0),
                         torch.ones_like(rd), rd)
        size = torch.where(on & (rd == 1) & (torch.arange(P)[:, None] % 2
                                             == 0), 0.0, size)
    args = (rd, size, rb, cap, valid)
    # the skewed broker's 30,000 replicas make the twin slow: 40 iterations
    max_iters = 40 if case == "skewed" else 512
    out, it = kernels.intra_broker_walk(*(t.to(cuda_device) for t in args),
                                        max_iters)
    want_rd, want_it = kernels.intra_broker_walk_plain(*args, max_iters)
    assert torch.equal(out.cpu(), want_rd)
    assert int(it) == int(want_it)


@pytest.mark.cuda
@pytest.mark.parametrize("K,G,hard", [(4, 4, "mixed"), (64, 16, "soft"),
                                      (64, 16, "hard"), (1024, 22, "mixed"),
                                      (128, 22, "soft"), (16, 33, "mixed"),
                                      (16, 33, "hard"), (64, 40, "soft"),
                                      (64, 48, "mixed"), (32, 96, "mixed"),
                                      (16, 64, "mixed"), (64, 64, "soft"),
                                      (1024, 64, "mixed"),
                                      (256, 300, "soft"), (4, 23, "mixed"),
                                      (16, 24, "hard"), (64, 27, "soft"),
                                      (4, 28, "mixed"), (2, 31, "mixed"),
                                      (1024, 32, "mixed")])
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
    for move_weight, pareto, final in ((0.0, False, False),
                                       (0.1, True, False),
                                       (0.0, True, True)):
        n_surv = max(1, min(K // 2, K - 1))
        got = kernels.population_select(
            *(t.to(cuda_device) for t in (boundary, moves, scales, mask)),
            1000.0, move_weight, n_surv, pareto, final)
        want = kernels.population_select_plain(
            boundary, moves, scales, mask, 1000.0, move_weight, n_surv,
            pareto, final)
        for g, w in zip(got, want):
            # bit for bit, NaN (the NaN row's score) equal to NaN
            torch.testing.assert_close(g.cpu(), w.to(g.dtype), rtol=0,
                                       atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("K,G", [
    (K, G) for K in (1, 2, 31, 32, 33, 1024)
    for G in (1, 22, 23, 28, 32, 33, 64, 1024)
    if K * G <= 1024 * 64])            # the twin's [K, K, G] dominance test
def test_population_select_block_and_grid_match_twin(cuda_device, K, G):
    """KI's one-block form and its grid (past one block's compares or
    shared memory) against the twin: a warp's lanes over 31-33 plans, one
    plan, 1,024 plans, 1-1,024 goals; a NaN row, tied rows and a zero row;
    mixed and all-hard weights; the weighted and the Pareto objective;
    with and without a move weight, at the boundaries and the final
    scores."""
    gen = torch.Generator().manual_seed(7 * K + G)
    boundary = torch.rand(K, G, generator=gen) * torch.pow(
        10.0, torch.randint(-7, 4, (K, G), generator=gen).float())
    boundary[K // 2] = boundary[K // 3]                 # a tie
    boundary[min(1, K - 1), 0] = float("nan")           # sorts last
    boundary[K - 1] = 0.0
    scales = torch.rand(G, generator=gen) * 1e4
    moves = torch.randint(0, 100_000, (K,), generator=gen)
    n_surv = max(1, min(K // 2, K - 1))
    for mask in (torch.arange(G) % 3 == 0, torch.ones(G, dtype=torch.bool)):
        for move_weight, pareto, final in ((0.0, False, False),
                                           (0.1, True, False),
                                           (0.0, True, True),
                                           (0.1, False, True)):
            got = kernels.population_select(
                *(t.to(cuda_device) for t in (boundary, moves, scales,
                                              mask)),
                1000.0, move_weight, n_surv, pareto, final)
            want = kernels.population_select_plain(
                boundary, moves, scales, mask, 1000.0, move_weight, n_surv,
                pareto, final)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w.to(g.dtype), rtol=0,
                                           atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [23, 32])
def test_population_select_refuses_23_to_32_goals(cuda_device, G):
    """(Named for the refusal it replaced.) KI scores 23-32 goals in the
    reference's vector loops, the boundary's and the final scores' (which
    differ at 23 and 32 goals), equal to its twin, one launch each."""
    gen = torch.Generator().manual_seed(G)
    boundary = torch.rand(16, G, generator=gen) * 1e3
    scales = torch.rand(G, generator=gen) * 1e3
    mask = torch.arange(G) % 3 == 0
    moves = torch.zeros(16, dtype=torch.int32)
    for final in (False, True):
        kernels.reset_launch_counts()
        got = kernels.population_select(
            *(t.to(cuda_device) for t in (boundary, moves, scales, mask)),
            1000.0, 0.0, 8, False, final)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["population_select"] == 1
        want = kernels.population_select_plain(
            boundary, moves, scales, mask, 1000.0, 0.0, 8, False, final)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.to(g.dtype))


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 7, 1_000, 1, 33), (2, 5, 2_052, 2, 104),
                                   (2, 5, 2_050, 2, 104), (2, 9, 777, 3, 1_001),
                                   (3, 4, 1_029, 4, 104), (1, 1, 5, 2, 104),
                                   (4, 1, 4_096, 2, 104), (1, 3, 64, 1, 1_001),
                                   (1, 6, 4_096, 5, 33), (2, 3, 3, 2, 2),
                                   (1, 2_000, 64, 2, 60_000)], ids=str)
def test_fleet_scenario_failover_edges(cuda_device, shape):
    """KJ's tiled kernel (R of 1-4) and its row kernel (R = 5) against the
    twin: broker counts 33, 104 and 1,001, P off the 1,024-partition tile
    and off a multiple of 4 (element stores), one cluster, one scenario,
    broker ids -1 and at or past B, partitions a cluster does not hold,
    and an S x B whose broker masks fill several scenario chunks."""
    import chip_smoke
    C, S, P, R, B = shape
    args = chip_smoke.kj_case(C, S, P, R, B, seed=sum(shape),
                              device=cuda_device)
    chunk = kernels.failover_chunk(C, S, P, R, B)
    assert (chunk == 0) == (R > 4)
    if S * B >= 1_000_000:
        assert 0 < chunk < S            # the masks must be chunked
    got = kernels.fleet_scenario_failover(*args)
    want = kernels.fleet_scenario_failover_plain(*(t.cpu() for t in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["noise", "uniform", "drain", "bits",
                                  "keys", "randint", "device word"])
@pytest.mark.parametrize("n", [1, 31, 40_192])
def test_threefry_draw_matches_twin(cuda_device, form, n):
    """KA's fused draw, each output form through a four-word path (and a
    device scalar word), bit for bit against its twin, one launch."""
    key = _random.PRNGKey(9, device=cuda_device)
    words = (2, 17, 0, 1)
    if form == "device word":
        words = (torch.tensor(2, device=cuda_device), 17, 0, 1)
    kind, kw = {"noise": ("affine", dict(a=1e-3, b=0.0)),
                "uniform": ("affine", {}),
                "drain": ("affine", dict(a=0.01, b=1.0)),
                "bits": ("bits", {}), "keys": ("keys", {}),
                "randint": ("randint", dict(minval=3, maxval=77)),
                "device word": ("affine", dict(a=1e-3, b=0.0))}[form]
    kernels.reset_launch_counts()
    got = kernels.threefry_draw(key, words, (n,), kind, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["threefry2x32"] == 1
    want = kernels.threefry_draw_plain(
        key.cpu(), tuple(w.cpu() if isinstance(w, torch.Tensor) else w
                         for w in words), (n,), kind, **kw)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_key_paths_match_public_draws(cuda_device):
    """The search's key paths on the card: fold-ins and splits drawn
    through one launch equal the step-by-step public keys."""
    k = _random.PRNGKey(4, device=cuda_device)
    step = _random.fold_in(_random.fold_in(k, 3), 11)
    step = _random.split(step)[1]
    path = _random.subkeys(_random.fold(_random.fold(k, 3), 11))[1]
    assert torch.equal(path.key(), step)
    assert torch.equal(_random.uniform(path, (513,)),
                       _random.uniform(step, (513,)))


# ---------------------------------------------------------------------------
# KM-KP: a goal pass's apply, eligibility, flow candidates and drain fill,
# at the main path's shapes (100 brokers x 20,096 partitions) and the scale
# cell's (B1 1,001, P 200,064), each held to its twin on the CPU with error 0
# ---------------------------------------------------------------------------

#: tight capacity thresholds so the capacity goals have work to do
_TIGHT = dict(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
              max_replicas_per_broker=150)


@pytest.fixture(scope="module")
def pass_models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return {"main": chip_smoke.build_flat_direct(100, 20_000, 2),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2)}


def _cpu(obj):
    import chip_smoke
    return chip_smoke.to_device(obj, "cpu")


def _assert_fields_equal(got, want, what):
    """Every field equal, floats bit for bit (the sign of a zero too)."""
    import dataclasses
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f"{what}.{f.name}"
            continue
        assert g.dtype == w.dtype, f"{what}.{f.name}"
        g = g.cpu()
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}.{f.name}"


def _goal(name):
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   goals_by_name)
    return goals_by_name([name], BalancingConstraint(**_TIGHT))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [("main", 1), ("main", 512),
                                     ("main", 16_384), ("scale", 1_024),
                                     ("scale", 16_384), ("negzero", 512)])
def test_apply_group_matches_twin(cuda_device, pass_models, shape, n):
    """KM bit for bit against its twin: a partition-disjoint group of moves,
    leadership transfers and swaps (some in slot 0) with topic tables and a
    dead broker; "negzero": every broker's aggregates start at -0.0, so
    the rows of candidates that do not apply turn some to +0.0, as KB's
    order does. The caller's state is not written."""
    import chip_smoke
    model, md = pass_models["main" if shape == "negzero" else shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    if shape == "negzero":
        state = state.replace(util=torch.full_like(state.util, -0.0),
                              potential_nw_out=torch.full_like(
                                  state.potential_nw_out, -0.0),
                              leader_nw_in=torch.full_like(
                                  state.leader_nw_in, -0.0))
    c, do = chip_smoke.km_case(state, ctx, n, seed=n)
    before = _cpu(state)
    kernels.reset_launch_counts()
    got, count = kernels.apply_group(state, ctx, c, do)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["apply_group"] == 1
    want, want_count = kernels.apply_group_plain(before, _cpu(ctx), _cpu(c),
                                                 do.cpu())
    assert int(count) == int(want_count) == int(do.sum())
    _assert_fields_equal(got, want, f"apply_group {shape} N={n}")
    _assert_fields_equal(state, before, "the caller's state")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chain,n", [
    ("main", "main", 1), ("main", "main", 1_024), ("main", "main", 16_384),
    ("main", "default", 1_024), ("scale", "main", 1_024),
    ("scale", "default", 1_024)])
def test_candidate_eligibility_matches_twin(cuda_device, pass_models, shape,
                                            chain, n):
    """KN bit for bit against its twin at every chain position of the main
    path's four goals and of the default chain (RackAware's and
    TopicReplicaDistribution's rows among the interval family's)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import default_goals, goals_by_name
    model, md = pass_models[shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    c = chip_smoke.kn_case(state, ctx, n, seed=n)
    goals = [g.bind(md) for g in (default_goals() if chain == "default"
                                  else goals_by_name(chip_smoke.GOALS))]
    cs, cc, ccand = _cpu(state), _cpu(ctx), _cpu(c)
    for i, goal in enumerate(goals):
        checks = kernels.GoalChecks(goal, goals[:i], 1e-6)
        kernels.reset_launch_counts()
        got = kernels.candidate_eligibility(state, ctx, c, checks)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["candidate_eligibility"] == 1
        want = kernels.candidate_eligibility_plain(cs, cc, ccand, checks)
        for g, w, what in zip(got, want, ("eligible", "delta")):
            assert torch.equal(g.cpu(), w), f"{goal.name} {what}"


_FLOW_GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
               "NetworkInboundUsageDistributionGoal",
               "NetworkOutboundUsageDistributionGoal",
               "LeaderReplicaDistributionGoal", "PotentialNwOutGoal",
               "DiskCapacityGoal", "ReplicaCapacityGoal"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,K", [("main", 1), ("main", 512),
                                     ("scale", 1_024)])
@pytest.mark.parametrize("name", _FLOW_GOALS)
def test_flow_candidates_match_twins(cuda_device, pass_models, shape, K,
                                     name):
    """KO's two launches bit for bit against their twins: the [P, R]
    priorities, then the destinations of the top K (1, the main path's
    512, the scale cell's 1,024)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    from cruise_control_tpu_torch.utils.ordered import top_k
    model, md = pass_models[shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    cfg = SearchConfig(**dict(chip_smoke.MAIN_SEARCH,
                              num_replica_candidates=K))
    goal = _goal(name)
    planes = goal.propose_planes(state, ctx)
    cplanes = [t.cpu() for t in planes]
    keys = [_random.subkeys(_random.PRNGKey(5, device=d)) for d in
            (cuda_device, "cpu")]
    cs, cc = _cpu(state), _cpu(ctx)
    kernels.reset_launch_counts()
    prio = kernels.flow_priority(goal, state, ctx, keys[0][0], cfg, *planes)
    torch.cuda.synchronize()
    want = kernels.flow_priority_plain(goal, cs, cc, keys[1][0], cfg,
                                       *cplanes)
    assert torch.equal(prio.cpu(), want)
    vals, idx = top_k(prio.reshape(-1), K)
    values, lo, up, _excess, deficit = planes
    got = kernels.flow_match(goal, state, ctx, keys[0][1], cfg, values, lo,
                             up, deficit, vals, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flow_priority"] == 1
    assert kernels.LAUNCHES["flow_match"] == 1
    want = kernels.flow_match_plain(goal, cs, cc, keys[1][1], cfg,
                                    cplanes[0], cplanes[1], cplanes[2],
                                    cplanes[4], vals.cpu(), idx.cpu())
    for g, w, what in zip(got, want, ("p", "r", "dst", "valid")):
        assert torch.equal(g.cpu(), w), what
    assert bool(got[3].any()) or K == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,batch", [("main", 1), ("main", 16_384),
                                         ("scale", 25_000)])
@pytest.mark.parametrize("name", ["ReplicaDistributionGoal",
                                  "DiskUsageDistributionGoal",
                                  "DiskCapacityGoal"])
def test_bulk_drain_fill_matches_twin(cuda_device, pass_models, shape, batch,
                                      name):
    """KP bit for bit against its twin from the same lexsort: a count goal,
    a util goal and a capacity goal, with a dead broker, at drain batches
    of 1, 16,384 (the main path's) and 25,000 (the scale cell's)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    model, md = pass_models[shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    cfg = SearchConfig(drain_batch=batch)
    goal = _goal(name)
    args = goal.drain_sort(state, ctx, _random.PRNGKey(11, device=cuda_device))
    kernels.reset_launch_counts()
    got = kernels.bulk_drain_fill(goal, state, ctx, cfg, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bulk_drain_fill"] == 1
    want = kernels.bulk_drain_fill_plain(goal, _cpu(state), _cpu(ctx), cfg,
                                         *(a.cpu() for a in args))
    for g, w, what in zip(got, want, ("p", "r", "dst", "ok")):
        assert torch.equal(g.cpu(), w), what
    assert bool(got[3].any())


# ---------------------------------------------------------------------------
# KM's two forms and its bucketed walk at the edges; KP's launches at slot
# counts that cut its chunks and windows anywhere
# ---------------------------------------------------------------------------

def _km_both_forms(state, ctx, c, do, what):
    """KM out of place and in place (on a copy of ``state``) against the
    twin on the CPU, bit for bit; the caller's state is not written."""
    import chip_smoke
    before = _cpu(state)
    want, want_count = kernels.apply_group_plain(before, _cpu(ctx), _cpu(c),
                                                 do.cpu())
    kernels.reset_launch_counts()
    got, count = kernels.apply_group(state, ctx, c, do)
    carry = chip_smoke.clone_fields(state)
    got_in, count_in = kernels.apply_group(carry, ctx, c, do, out=carry)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["apply_group"] == 2
    assert got_in is carry
    assert int(count) == int(count_in) == int(want_count) == int(do.sum())
    _assert_fields_equal(got, want, f"{what} out of place")
    _assert_fields_equal(got_in, want, f"{what} in place")
    _assert_fields_equal(state, before, f"{what}: the caller's state")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["apply", "spread", "hot", "drain"])
def test_apply_group_forms_match_twin(cuda_device, pass_models, kind):
    """KM in both forms at the main path's KM shapes: an apply round's M
    512, N 16,384 spread over the brokers, the same with every source on
    broker 94 (an 11,000-row chain on one broker) and a real drain round
    of ReplicaDistributionGoal with broker 94 dead."""
    import chip_smoke
    model, md = pass_models["main"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    case = dict(chip_smoke.km_cases(model, md, "main", state, ctx))
    tag = {"apply": "M 512", "spread": "N 16,384",
           "hot": "N 16,384, every source on broker 94",
           "drain": "a real drain round, broker 94 dead"}[kind]
    st, cx, c, do = case[tag]
    if kind == "hot":
        assert chip_smoke.km_chain(c, do, st.util.shape[0]) > 10_000
    _km_both_forms(st, cx, c, do, tag)


@pytest.mark.cuda
def test_apply_group_brokers_without_rows(cuda_device, pass_models):
    """KM with 40 candidates over 105 brokers: most brokers have no row in
    any tile, and their aggregates pass through unchanged; one candidate
    and none applied too."""
    import chip_smoke
    model, md = pass_models["main"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    c, do = chip_smoke.km_case(state, ctx, 40, seed=3)
    touched = set(c.src[do].tolist()) | set(c.dst[do].tolist())
    assert len(touched) < state.util.shape[0] // 2
    _km_both_forms(state, ctx, c, do, "40 candidates")
    c, do = chip_smoke.km_case(state, ctx, 1, seed=4)
    _km_both_forms(state, ctx, c, torch.zeros_like(do), "none applied")


@pytest.fixture(scope="module")
def wide_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return chip_smoke.build_flat_direct(20_000, 40_000, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("brokers", [1_000, 20_000], ids=["B1_1001",
                                                         "B1_20001"])
@pytest.mark.parametrize("n,hot", [(1_024, False), (25_000, False),
                                   (16_384, True)])
def test_apply_group_wide_brokers(cuda_device, pass_models, wide_model,
                                  brokers, n, hot):
    """KM in both forms at B1 1,001 (the scale cell) and 20,001: the run
    table holds a row of B1 a tile; N 1,024, 25,000 (25 tiles of 2,048
    rows) and a hot chain of 16,384 on broker 7."""
    import chip_smoke
    model, md = pass_models["scale"] if brokers == 1_000 else wide_model
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    assert state.util.shape[0] == brokers + 1
    c, do = chip_smoke.km_case(state, ctx, n, seed=n, src=7 if hot else None)
    _km_both_forms(state, ctx, c, do, f"B1 {brokers + 1} N {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,hot", [(40_000, False), (125_000, False),
                                   (125_000, True)])
def test_apply_group_past_32_tiles(cuda_device, pass_models, n, hot):
    """KM in both forms past 65,536 candidates on the scale cell (B1
    1,001): N 40,000 (20 tiles of 4,096 rows, sorted by 1,024 threads) and
    N 125,000 (a drain batch of partitions // 8 at 1M partitions: 62
    tiles, so a broker's warp reads its run table in two groups of 32),
    spread and with every source on broker 7 (an ~88,000-row chain that
    crosses every tile)."""
    import chip_smoke
    model, md = pass_models["scale"]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    c, do = chip_smoke.km_case(state, ctx, n, seed=n, src=7 if hot else None)
    if hot:
        assert chip_smoke.km_chain(c, do, state.util.shape[0]) > 80_000
    _km_both_forms(state, ctx, c, do, f"N {n}")


def _slice_partitions(model, P):
    """The model cut to its first P partition rows (no padding)."""
    return model.replace(**{f: getattr(model, f)[:P] for f in (
        "replica_broker", "leader_load", "follower_load", "partition_topic",
        "partition_valid", "replica_offline", "replica_pref_pos")})


@pytest.mark.cuda
@pytest.mark.parametrize("shape,P", [("main", 13), ("main", 2_049),
                                     ("main", 4_099), ("main", 20_001),
                                     ("scale", 4_099), ("scale", 100_003)])
@pytest.mark.parametrize("case", ["sorted", "one broker", "no candidates",
                                  "N above the taken"])
def test_bulk_drain_fill_edges(cuda_device, pass_models, shape, P, case):
    """KP bit for bit against its twin at slot counts (P x 2) that are no
    multiple of 16, 32 or the 4,096-slot chunk: 26 (below one window of
    32), 4,098 (a second chunk of 2 slots), 8,198 (the 32-windows padded
    13 in front, so the chunk edge at 4,096 falls inside a window),
    40,002 and 200,006 (B1 1,001); a chunk edge is a multiple of 16^3
    and so always a 16-block edge. Cases: the drain's own order; every
    slot on one broker (one run longer than any chunk); no candidates; N
    above the slots taken."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    model, md = pass_models[shape]
    model = _slice_partitions(model, P)
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    goal = _goal("ReplicaDistributionGoal")
    args = list(goal.drain_sort(state, ctx,
                                _random.PRNGKey(11, device=cuda_device)))
    n = P * state.rb.shape[1]
    if case == "one broker":
        args[5] = torch.full_like(args[5], 5)
    if case == "no candidates":
        args[7] = torch.zeros_like(args[7])
        args[8] = torch.zeros_like(args[8])
    N = n + 5 if case == "N above the taken" else 16_384
    cfg = SearchConfig(drain_batch=N)
    kernels.reset_launch_counts()
    got = kernels.bulk_drain_fill(goal, state, ctx, cfg, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bulk_drain_fill"] == 1
    want = kernels.bulk_drain_fill_plain(goal, _cpu(state), _cpu(ctx), cfg,
                                         *(a.cpu() for a in args))
    for g, w, what in zip(got, want, ("p", "r", "dst", "ok")):
        assert torch.equal(g.cpu(), w), what
    if case == "no candidates":
        assert not bool(got[3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["registers", "loads"])
def test_dependent_add_probe(cuda_device, form):
    """The dependent-add probe sums its chain in order: n adds of x[0]
    (registers) or of x[i] (loads), equal to the same float32 sum on the
    CPU."""
    gen = torch.Generator().manual_seed(5)
    n = 1_000
    x = torch.rand(n, generator=gen)
    out = torch.empty(1, device=cuda_device)
    kernels.dependent_add_launch(x.to(cuda_device), n, form, out)
    terms = {"registers": x[:1].repeat(n), "loads": x}[form]
    acc = torch.zeros((), dtype=torch.float32)
    for t in terms:
        acc = acc + t
    assert out.cpu()[0].item() == acc.item()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [4_099, 40_000])
def test_bulk_drain_fill_wide_brokers(cuda_device, wide_model, P):
    """KP bit for bit against its twin at B1 20,001: the one-block scans
    and the budgets past what shared memory stages (2,048 brokers) and the
    cumulative budgets read from global memory; the ranks of -deficit over
    313 x 10 blocks."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    model, md = wide_model
    state, ctx = chip_smoke.pass_state(_slice_partitions(model, P), md,
                                       dead=(3,))
    assert state.util.shape[0] == 20_001
    goal = _goal("ReplicaDistributionGoal")
    args = goal.drain_sort(state, ctx, _random.PRNGKey(13, device=cuda_device))
    cfg = SearchConfig(drain_batch=16_384)
    got = kernels.bulk_drain_fill(goal, state, ctx, cfg, *args)
    want = kernels.bulk_drain_fill_plain(goal, _cpu(state), _cpu(ctx), cfg,
                                         *(a.cpu() for a in args))
    for g, w, what in zip(got, want, ("p", "r", "dst", "ok")):
        assert torch.equal(g.cpu(), w), what


# ---------------------------------------------------------------------------
# KO's weight range, KO and KN redesigned: every shape and edge, including
# B1 20,001, where flow_match and KN read global memory instead of shared
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return chip_smoke.build_flat_direct(8, 1_000, 2)


def _ko_model(name, pass_models, small_model, wide_model):
    return {"b9": small_model, "main": pass_models["main"],
            "scale": pass_models["scale"], "b20001": wide_model}[name]


def _same_bits(got, want, what):
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["b9", "main", "scale", "b20001"])
@pytest.mark.parametrize("case", ["plain", "batched", "signed zeros",
                                  "non-finite", "R1", "R3"])
def test_weight_range_matches_twin(cuda_device, pass_models, small_model,
                                   wide_model, shape, case):
    """KO's range launch bit for bit against its twin, every weight form:
    a context's loads; a stack of three contexts (the fleet's [C, ...]
    form); loads whose minimum mixes -0.0 and +0.0 (the table keeps
    +0.0); loads with inf, -inf and NaN (left out); one and three slots."""
    model, _ = _ko_model(shape, pass_models, small_model, wide_model)
    lead, foll = model.leader_load, model.follower_load
    R = model.replica_broker.shape[1]
    gen = torch.Generator().manual_seed(3)
    if case == "batched":
        lead = torch.stack([lead, lead * 2.0, lead.flip(0)])
        foll = torch.stack([foll, foll * 0.5, foll.flip(0)])
    elif case == "signed zeros":
        lead, foll = lead.clone(), foll.clone()
        rows = torch.randint(0, lead.shape[0], (64,), generator=gen)
        lead[rows.to(lead.device)] = -0.0
        foll[:] = torch.where(foll == 0.0, -0.0, foll)
    elif case == "non-finite":
        lead, foll = lead.clone(), foll.clone()
        lead[0, 0], lead[1, 3], foll[2, 1] = float("inf"), float("nan"), \
            -float("inf")
    elif case in ("R1", "R3"):
        R = int(case[1])
    kernels.reset_launch_counts()
    got = kernels.replica_weight_range(lead, foll, R)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["replica_weight_range"] == 1
    want = kernels.replica_weight_range_plain(lead.cpu(), foll.cpu(), R)
    _same_bits(got, want, f"{shape} {case}")
    if case == "signed zeros":
        assert not bool(torch.signbit(got.cpu()[..., :4, 0]).any())


_ALL_FORMS = ["CpuUsageDistributionGoal", *_FLOW_GOALS]


def _ko_both(goal, state, ctx, cfg, planes, K, dev, seed=5):
    """KO's two launches on the card and the twins on the CPU from the same
    inputs: (got, want) of (prio, p, r, dst, valid)."""
    from cruise_control_tpu_torch.utils.ordered import top_k
    keys = [_random.subkeys(_random.PRNGKey(seed, device=d))
            for d in (dev, "cpu")]
    cs, cc = _cpu(state), _cpu(ctx)
    cplanes = [t.cpu() for t in planes]
    kernels.reset_launch_counts()
    prio = kernels.flow_priority(goal, state, ctx, keys[0][0], cfg, *planes)
    want_prio = kernels.flow_priority_plain(goal, cs, cc, keys[1][0], cfg,
                                            *cplanes)
    _same_bits(prio, want_prio, "prio")
    vals, idx = top_k(prio.reshape(-1), K)
    values, lo, up, _excess, deficit = planes
    got = kernels.flow_match(goal, state, ctx, keys[0][1], cfg, values, lo,
                             up, deficit, vals, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flow_priority"] == 1
    assert kernels.LAUNCHES["flow_match"] == 1
    want = kernels.flow_match_plain(goal, cs, cc, keys[1][1], cfg,
                                    cplanes[0], cplanes[1], cplanes[2],
                                    cplanes[4], vals.cpu(), idx.cpu())
    for g, w, what in zip(got, want, ("p", "r", "dst", "valid")):
        assert torch.equal(g.cpu(), w), what
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["b9", "scale", "b20001"])
@pytest.mark.parametrize("K", [1, 512, 1_024])
@pytest.mark.parametrize("name", _ALL_FORMS)
def test_flow_candidates_every_shape(cuda_device, pass_models, small_model,
                                     wide_model, shape, K, name):
    """KO bit for bit against its twins for every weight form at B1 9,
    1,001 and 20,001 (flow_match over its global workspace), K 1, 512 and
    1,024."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    model, md = _ko_model(shape, pass_models, small_model, wide_model)
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    B1 = state.util.shape[0]
    lib = kernels.load_library()
    assert bool(lib.cc_flow_match_workspace(B1, K, 2)) == (shape == "b20001")
    cfg = SearchConfig(**dict(chip_smoke.MAIN_SEARCH,
                              num_replica_candidates=K))
    goal = _goal(name)
    _ko_both(goal, state, ctx, cfg, goal.propose_planes(state, ctx), K,
             cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["b9", "main", "b20001"])
@pytest.mark.parametrize("case", ["one destination", "no midpoint room",
                                  "re-route"])
@pytest.mark.parametrize("name", ["ReplicaDistributionGoal",
                                  "DiskUsageDistributionGoal",
                                  "LeaderReplicaDistributionGoal",
                                  "DiskCapacityGoal"])
def test_flow_candidates_edges(cuda_device, pass_models, small_model,
                               wide_model, shape, case, name):
    """KO bit for bit against its twins at K 512 where the match takes
    its rare branches: every destination refused but one; no destination
    below its midpoint (the headroom falls back to the ceiling); the
    brokers' priorities led by the broker that hosts most of the top
    candidates, with room for all of them (their re-route to the first
    legal broker in priority order)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    from cruise_control_tpu_torch.utils.ordered import top_k
    model, md = _ko_model(shape, pass_models, small_model, wide_model)
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    B1 = state.util.shape[0]
    K = 512
    cfg = SearchConfig(**dict(chip_smoke.MAIN_SEARCH,
                              num_replica_candidates=K))
    goal = _goal(name)
    values, lo, up, excess, deficit = goal.propose_planes(state, ctx)
    if case == "one destination":
        dest = torch.zeros_like(ctx.dest_allowed)
        dest[B1 // 2] = True
        ctx = ctx.replace(dest_allowed=dest)
    elif case == "no midpoint room":
        lo = torch.full_like(values, -float("inf"))
        up = values * 1.5
    else:
        prio = kernels.flow_priority(
            goal, state, ctx, _random.subkeys(_random.PRNGKey(
                5, device=cuda_device))[0], cfg, values, lo, up, excess,
            deficit)
        _, idx = top_k(prio.reshape(-1), K)
        counts = state.rb[idx // state.rb.shape[1]].reshape(-1).bincount(
            minlength=B1)
        hub = int(counts.masked_fill(~ctx.dest_allowed, -1).argmax())
        deficit = deficit.clone()
        deficit[hub] = 1.0
        lo = torch.full_like(values, -float("inf"))
        up = values.clone()
        up[hub] = values[hub] + 1e9
    planes = _planes_like(values, lo, up, excess, deficit)
    p, r, dst, valid = _ko_both(goal, state, ctx, cfg, planes, K,
                                cuda_device)
    if case == "one destination":
        assert bool((dst[valid] == B1 // 2).all())
    if case == "re-route" and not goal.upper_only:
        hosted = (state.rb[p] == hub).any(dim=1)
        assert bool((hosted & (dst != hub)).any())
        assert bool((~hosted & (dst == hub)).any())


def _planes_like(values, *planes):
    return [values, *(torch.broadcast_to(t, values.shape).contiguous()
                      for t in planes)]


def _goal_table_48(md):
    """A pass goal and 47 earlier goals of the interval family (the
    catalog's, repeated): a 48-row table, KN's most."""
    from cruise_control_tpu_torch.analyzer import goals_by_name
    names = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
             "NetworkInboundUsageDistributionGoal",
             "NetworkOutboundUsageDistributionGoal",
             "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal",
             "PotentialNwOutGoal", "DiskCapacityGoal", "CpuCapacityGoal",
             "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
             "ReplicaCapacityGoal", "LeaderBytesInDistributionGoal"]
    goals = [g.bind(md) for g in goals_by_name(names,
                                                _tight_constraint())]
    chain = [goals[k % len(goals)] for k in range(48)]
    return chain[-1], chain[:-1]


def _tight_constraint():
    from cruise_control_tpu_torch.analyzer import BalancingConstraint
    return BalancingConstraint(**_TIGHT)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [("main", 1), ("main", 512),
                                     ("main", 16_384), ("b20001", 1_024)])
@pytest.mark.parametrize("chain", ["main", "default", "table 48"])
def test_candidate_eligibility_every_shape(cuda_device, pass_models,
                                           wide_model, shape, n, chain):
    """KN bit for bit against its twin at N 1, 512 and 16,384 and at B1
    20,001 (its planes read from global memory): every position of the
    main chain and of the default chain, and a 48-row table."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import default_goals, goals_by_name
    model, md = wide_model if shape == "b20001" else pass_models[shape]
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    c = chip_smoke.kn_case(state, ctx, n, seed=n)
    if chain == "table 48":
        goal, earlier = _goal_table_48(md)
        positions = [(goal, earlier)]
    else:
        goals = [g.bind(md) for g in (default_goals() if chain == "default"
                                      else goals_by_name(chip_smoke.GOALS))]
        positions = [(g, goals[:i]) for i, g in enumerate(goals)]
    cs, cc, ccand = _cpu(state), _cpu(ctx), _cpu(c)
    lib = kernels.load_library()
    staged = []
    for goal, earlier in positions:
        checks = kernels.GoalChecks(goal, earlier, 1e-6)
        if chain == "table 48":
            assert checks.n == kernels.MAX_GOAL_ROWS
        staged.append(bool(lib.cc_eligibility_staged(
            checks.rows, checks.n, state.util.shape[0])))
        kernels.reset_launch_counts()
        got = kernels.candidate_eligibility(state, ctx, c, checks)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["candidate_eligibility"] == 1
        want = kernels.candidate_eligibility_plain(cs, cc, ccand, checks)
        for g, w, what in zip(got, want, ("eligible", "delta")):
            _same_bits(g, w, f"{goal.name} {what}")
    # at B1 20,001 the longer tables' planes outgrow shared memory
    assert all(staged) if shape != "b20001" else not staged[-1]
