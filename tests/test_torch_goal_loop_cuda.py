"""The goal passes as CUDA graphs (``analyzer/graph_loop.py``, KL in
``csrc/goal_loop.cu``) against the host-driven loop on the card.

Every test here needs an NVIDIA GPU (CUDA 12.4 or later) and skips without
one. The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_goal_loop_cuda.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer import (OptimizationOptions,
                                               SearchConfig,
                                               TorchGoalOptimizer, engine,
                                               goals_by_name)
from cruise_control_tpu_torch.analyzer import state as ts
from cruise_control_tpu_torch.analyzer.goals import default_goals
from cruise_control_tpu_torch.core.runtime_obs import default_collector
from cruise_control_tpu_torch.model.spec import (BrokerSpec, ClusterSpec,
                                                 PartitionSpec, flatten_spec)

SEARCH = dict(num_replica_candidates=128, num_dest_candidates=8,
              num_swap_candidates=64, apply_per_iter=128,
              max_iters_per_goal=48, drain_batch=512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the goal-loop graphs have no CPU "
                    "mode")
    return torch.device("cuda")


def skewed_cluster(brokers=12, partitions=600, seed=0, dead=()):
    """A seeded skewed cluster: even partitions crowd onto the first
    quarter of the brokers; 24 topics, RF 2, four racks."""
    rng = np.random.default_rng(seed)
    hot = np.arange(max(brokers // 4, 2))
    parts = []
    for p in range(partitions):
        pool = hot if p % 2 == 0 else np.arange(brokers)
        reps = rng.choice(pool, size=2, replace=False)
        parts.append(PartitionSpec(
            topic=f"t{p % 24}", partition=p, replicas=[int(b) for b in reps],
            leader_load=(0.2 + 0.2 * rng.random(), 5 + 10 * rng.random(),
                         8 + 15 * rng.random(), 50 + 100 * rng.random())))
    spec = ClusterSpec(
        brokers=[BrokerSpec(broker_id=i, rack=f"r{i % 4}",
                            capacity=(100.0, 1e4, 1e4, 1e6),
                            alive=i not in dead) for i in range(brokers)],
        partitions=parts)
    return flatten_spec(spec, device="cuda")


def _same_state(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None:
            assert y is None, f"{what}.{f.name}"
        else:
            assert torch.equal(x, y), f"{what}.{f.name}"


@pytest.mark.cuda
def test_kl_matches_its_twin(cuda_device):
    gen = torch.Generator().manual_seed(0)
    for trial in range(40):
        for op in kernels.GOAL_LOOP_OPS:
            c = torch.randint(0, 5, (len(kernels.GOAL_LOOP_SLOTS),),
                              generator=gen, dtype=torch.int64)
            d = c.to(cuda_device)
            a, b = trial % 4, trial % 6
            want = kernels.goal_loop_step_plain(c, op, a, b)
            got = kernels.goal_loop_step(d, op, a, b)
            assert bool(got) == bool(want), op
            assert torch.equal(d.cpu(), c), op


@pytest.mark.cuda
def test_tensor_fold_words_on_the_card(cuda_device):
    """KA reading a fold word through its pointer draws the bits of the same
    word given as a Python int (the fine loop's ``it``, the drain's
    ``70_000 + r``)."""
    root = _random.PRNGKey(42, device=cuda_device)
    word = torch.zeros((), dtype=torch.int64, device=cuda_device)
    for v in [*range(301), *(70_000 + r for r in range(16))]:
        word.fill_(v)
        assert torch.equal(_random.uniform(_random.fold(root, word), (33,)),
                           _random.uniform(_random.fold(root, v), (33,)))
        assert torch.equal(_random.fold(root, word).key(),
                           _random.fold(root, v).key())


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [(), (3,)], ids=["balanced", "dead"])
def test_graph_loop_equals_host_loop_on_each_default_goal(cuda_device, dead):
    model, md = skewed_cluster(dead=dead)
    goals = [g.bind(md) for g in default_goals()]
    cfg = SearchConfig(**SEARCH).scaled_for(md.num_partitions,
                                            md.num_brokers)
    graph = engine.CompiledGoalChain(goals, cfg)
    host = engine.CompiledGoalChain(goals, cfg, loop="host")
    state = ts.init_state(model, with_topic_counts=md.num_topics,
                          with_topic_leader_counts=True)
    ctx = ts.build_context(model)
    key = _random.PRNGKey(5, device=cuda_device)
    ran = 0
    for i, (g_pass, h_pass) in enumerate(zip(graph.passes, host.passes)):
        k = _random.fold(key, i)
        hs, hit, hstack, hmv = h_pass(state, ctx, k)
        gs, git, gstack, gmv = g_pass(state, ctx, k)
        assert int(git) == hit, goals[i].name
        assert int(gmv) == int(hmv), goals[i].name
        assert torch.equal(gstack, hstack), goals[i].name
        _same_state(gs, hs, goals[i].name)
        state = hs
        ran += hit
    assert ran > 0
    fused = graph.fused(ts.init_state(model, with_topic_counts=md.num_topics,
                                      with_topic_leader_counts=True),
                        ctx, key)
    want = host.fused(ts.init_state(model, with_topic_counts=md.num_topics,
                                    with_topic_leader_counts=True), ctx, key)
    _same_state(fused[0], want[0], "fused")
    for a, b in zip(fused[2:], want[2:]):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_warm_call_captures_nothing_and_reads_no_loop_test(cuda_device):
    model, md = skewed_cluster(seed=1)
    opt = TorchGoalOptimizer(
        goals=goals_by_name(["ReplicaDistributionGoal",
                             "DiskUsageDistributionGoal"]),
        config=SearchConfig(**SEARCH, fused_chain=True), device="cuda")
    options = OptimizationOptions(seed=1, skip_hard_goal_check=True)
    cold = opt.optimize(model, md, options)
    caps, syncs = default_collector().capture_count(), engine.HOST_SYNCS
    kernels.reset_launch_counts()
    warm = opt.optimize(model, md, options)
    assert default_collector().capture_count() == caps
    assert engine.HOST_SYNCS == syncs
    assert [p.to_json() for p in warm.proposals] == [
        p.to_json() for p in cold.proposals]
    assert kernels.LAUNCHES["goal_loop"] > 0
    assert kernels.LAUNCHES["threefry2x32"] > 0
    assert kernels.LAUNCHES["ordered_segment_sum"] > 0


class _PeekingGoal(type(goals_by_name(["ReplicaDistributionGoal"])[0])):
    """ReplicaDistributionGoal with a host read hidden in its proposals."""

    def propose(self, state, ctx, key, cfg):
        if state.moves_applied.item() < 0:
            raise AssertionError("unreachable")
        return super().propose(state, ctx, key, cfg)


@pytest.mark.cuda
def test_hidden_host_read_raises_at_capture(cuda_device):
    model, md = skewed_cluster(seed=2)
    goal = copy.copy(goals_by_name(["ReplicaDistributionGoal"])[0])
    goal.__class__ = _PeekingGoal
    cfg = SearchConfig(**SEARCH).scaled_for(md.num_partitions,
                                            md.num_brokers)
    chain = engine.CompiledGoalChain([goal], cfg)
    state, ctx = ts.init_state(model), ts.build_context(model)
    syncs = engine.HOST_SYNCS
    with pytest.raises(RuntimeError):
        chain.passes[0](state, ctx, _random.PRNGKey(0, device=cuda_device))
    assert engine.HOST_SYNCS == syncs           # no host loop ran instead
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_refused_capture_restores_the_generator(cuda_device):
    """A capture refused at a hidden host read leaves the default CUDA
    generator out of capture and as it was: the next draw works and equals
    a draw from the generator state taken before the capture."""
    model, md = skewed_cluster(seed=2)
    goal = copy.copy(goals_by_name(["ReplicaDistributionGoal"])[0])
    goal.__class__ = _PeekingGoal
    cfg = SearchConfig(**SEARCH).scaled_for(md.num_partitions,
                                            md.num_brokers)
    chain = engine.CompiledGoalChain([goal], cfg)
    state, ctx = ts.init_state(model), ts.build_context(model)
    before = torch.cuda.get_rng_state()
    with pytest.raises(RuntimeError):
        chain.passes[0](state, ctx, _random.PRNGKey(0, device=cuda_device))
    got = torch.rand(4096, device=cuda_device)
    after = torch.cuda.get_rng_state()
    torch.cuda.set_rng_state(before)
    want = torch.rand(4096, device=cuda_device)
    assert torch.equal(got, want)
    assert torch.equal(after, torch.cuda.get_rng_state())
