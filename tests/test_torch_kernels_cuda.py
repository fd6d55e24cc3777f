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
