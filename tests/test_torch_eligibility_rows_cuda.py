"""KN's rows of the goals outside the interval family on the card, bit for
bit against ``kernels.candidate_eligibility_plain`` on the CPU.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_eligibility_rows_cuda.py -q

The candidates mix moves, leadership transfers and swaps (half the swaps
with a partner of the same topic), some on padding partitions (topic -1,
whose table row is the last), some to a dead broker. The chains hold all
six goals of the kind: RackAware, RackAwareDistribution, two
TopicReplicaDistribution goals of different gaps, an active
MinTopicLeadersPerBroker, BrokerSetAware with a topic set, and
PreferredLeaderElection, beside interval goals.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels


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
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2),
            "b20001": chip_smoke.build_flat_direct(20_000, 40_000, 2),
            "rf3": chip_smoke.build_flat_direct(60, 6_000, 3),
            "rf5": chip_smoke.build_flat_direct(60, 3_000, 5)}


def _cpu(obj):
    import chip_smoke
    return chip_smoke.to_device(obj, "cpu")


def pass_inputs(model, md, seed=0):
    """(state, ctx) with broker 3 dead, brokers in ten sets (every
    seventh in none) and half the partition rows' preferred order
    reversed."""
    import chip_smoke
    state, ctx = chip_smoke.pass_state(model, md, dead=(3,))
    B1 = ctx.broker_set.shape[0]
    sets = torch.arange(B1, dtype=torch.int32, device=ctx.broker_set.device)
    sets = torch.where(sets % 7 == 6, -1, sets % 10).to(torch.int32)
    ctx = ctx.replace(broker_set=sets.contiguous())
    rng = np.random.default_rng(seed)
    flip = torch.from_numpy(rng.random(state.pos.shape[0]) < 0.5).to(
        state.pos.device)
    pos = torch.where(flip[:, None], state.pos.flip(1), state.pos)
    return state.replace(pos=pos.contiguous()), ctx


def rows_case(state, ctx, n, seed):
    """n candidates of all three kinds: 5% on padding partition rows
    (topic -1), half the swaps' partners of the same topic as their
    partition, destinations anywhere (the dead broker and the sentinel
    too)."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    P, R = state.rb.shape
    B1 = state.util.shape[0]
    topic = ctx.partition_topic.cpu().numpy()
    real = int(ctx.partition_valid.sum())
    kinds = rng.choice(3, n, p=[0.5, 0.25, 0.25])
    p = rng.integers(0, real, n)
    pad = rng.random(n) < 0.05
    if P > real:
        p[pad] = rng.integers(real, P, int(pad.sum()))
    r = rng.integers(0, R, n)
    r[kinds == 1] = np.maximum(r[kinds == 1], 1)
    p2 = rng.integers(0, real, n)
    by_topic = {}
    for k in np.nonzero((kinds == 2) & (rng.random(n) < 0.5))[0]:
        t = topic[p[k]]
        rows = by_topic.setdefault(t, np.nonzero(topic[:real] == t)[0])
        if rows.size:
            p2[k] = rng.choice(rows)
    r2 = rng.integers(0, R, n)
    dst = rng.integers(0, B1, n)
    return chip_smoke._cands(state, ctx, kinds, p, r, p2, r2, dst,
                             rng.random(n) < 0.95)[0]


def six_chain(T, seed=0):
    """The six goals outside the interval family, a second
    TopicReplicaDistribution of tighter gaps, and interval goals between
    them, bound to a model of T topics."""
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   goals_by_name)
    from cruise_control_tpu_torch.analyzer import goals as g
    rng = np.random.default_rng(seed)
    cst = BalancingConstraint(capacity_threshold=(0.05, 0.03, 0.03, 0.03),
                              max_replicas_per_broker=150)
    tight = BalancingConstraint(topic_replica_balance_threshold=1.1,
                                topic_replica_balance_min_gap=0,
                                topic_replica_balance_max_gap=3)
    topic_set = np.where(rng.random(T) < 0.2, -1,
                         rng.integers(0, 10, T)).astype(np.int32)
    interested = rng.random(T) < 0.5
    interval = goals_by_name(["ReplicaDistributionGoal", "DiskCapacityGoal",
                              "LeaderReplicaDistributionGoal"], cst)
    return [g.RackAwareGoal(), interval[0],
            g.MinTopicLeadersPerBrokerGoal(cst, interested_topics=interested,
                                           min_count=2),
            g.BrokerSetAwareGoal(cst, topic_set=topic_set),
            g.RackAwareDistributionGoal(), interval[1],
            g.TopicReplicaDistributionGoal(cst),
            g.TopicReplicaDistributionGoal(tight),
            g.PreferredLeaderElectionGoal(), interval[2]]


def _chain(name, model, md, T):
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   default_goals,
                                                   goals_by_name)
    from cruise_control_tpu_torch.analyzer.goals import KAFKA_ASSIGNER_GOALS
    if name == "default":
        return [g.bind(md) for g in default_goals()]
    if name == "kafka_assigner":
        return goals_by_name(KAFKA_ASSIGNER_GOALS, BalancingConstraint())
    if name == "longer than 48":
        return six_chain(T) * 6
    return six_chain(T)


def _same(got, want, what):
    for g, w, field in zip(got, want, ("eligible", "delta")):
        g = g.cpu()
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what} {field}"


def _check_positions(state, ctx, c, chain, positions, what):
    cs, cc, ccand = _cpu(state), _cpu(ctx), _cpu(c)
    for i in positions:
        checks = kernels.GoalChecks(chain[i], chain[:i], 1e-6)
        assert checks.outside == []
        kernels.reset_launch_counts()
        got = kernels.candidate_eligibility(state, ctx, c, checks)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["candidate_eligibility"] == 1
        want = kernels.candidate_eligibility_plain(cs, cc, ccand, checks)
        _same(got, want, f"{what} position {i} ({chain[i].name})")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [("main", 1), ("main", 1_024),
                                     ("main", 16_384), ("rf3", 1_024),
                                     ("rf5", 1_024)])
@pytest.mark.parametrize("chain", ["six", "default", "kafka_assigner"])
def test_rows_match_twin(cuda_device, models, shape, n, chain):
    """Every position of the chain, each goal outside the interval family
    as the pass goal (its delta) and as an earlier goal (its acceptance),
    at RF 2, 3 and 5 (R 5 reads its rows from global memory)."""
    model, md = models[shape]
    state, ctx = pass_inputs(model, md, seed=n)
    c = rows_case(state, ctx, n, seed=n)
    goals = _chain(chain, model, md, state.topic_counts.shape[0])
    _check_positions(state, ctx, c, goals, range(len(goals)),
                     f"{chain} {shape} N={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["scale", "b20001"])
def test_rows_past_shared_memory(cuda_device, models, shape):
    """The scale cell (T x B1 = 400 x 1,001 topic cells, 1.6 MB) and B1
    20,001 (the planes read from global memory): the six-goal chain's
    positions and the default chain's last."""
    model, md = models[shape]
    state, ctx = pass_inputs(model, md)
    c = rows_case(state, ctx, 1_024, seed=7)
    T = state.topic_counts.shape[0]
    assert T * state.util.shape[0] * 4 > 227 * 1024
    goals = six_chain(T)
    _check_positions(state, ctx, c, goals, range(len(goals)),
                     f"six {shape}")
    lib = kernels.load_library()
    default = _chain("default", model, md, T)
    checks = kernels.GoalChecks(default[-1], default[:-1], 1e-6)
    staged = lib.cc_eligibility_staged(checks.rows, checks.n,
                                       state.util.shape[0])
    assert bool(staged) == (shape == "scale")
    _check_positions(state, ctx, c, default, [len(default) - 1],
                     f"default {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["main", "b20001"])
def test_chain_longer_than_48_goals(cuda_device, models, shape):
    """60 goals: the table read in two chunks of rows, the second carrying
    the first's verdict and delta; positions inside the first chunk, at
    its edge and past it."""
    model, md = models[shape]
    state, ctx = pass_inputs(model, md)
    c = rows_case(state, ctx, 1_024, seed=11)
    goals = _chain("longer than 48", model, md, state.topic_counts.shape[0])
    assert len(goals) == 60
    checks = kernels.GoalChecks(goals[-1], goals[:-1], 1e-6)
    assert checks.n > kernels.MAX_GOAL_ROWS
    _check_positions(state, ctx, c, goals, [20, 48, 49, 55, 59],
                     f"60 goals {shape}")


@pytest.mark.cuda
def test_default_chain_last_position_launches_kn_alone(cuda_device, models):
    """At the default chain's last position the wrapper runs KN and the
    topic row's bounds on the card, and nothing else: no goal's
    ``accepts`` or ``delta`` in torch."""
    from torch.profiler import ProfilerActivity, profile
    model, md = models["main"]
    state, ctx = pass_inputs(model, md)
    c = rows_case(state, ctx, 1_024, seed=3)
    goals = _chain("default", model, md, 0)
    checks = kernels.GoalChecks(goals[-1], goals[:-1], 1e-6)
    kernels.candidate_eligibility(state, ctx, c, checks)
    torch.cuda.synchronize()
    # a window of calls: the profiler has recorded fewer launches than a
    # window makes (one call's window: none)
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernels.candidate_eligibility(state, ctx, c, checks)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {n: names.count(n) for n in set(names)}
    assert len(counts) == 2, counts
    assert sum("topic_bounds_kernel" in n for n in counts) == 1, counts
    assert sum("eligibility_kernel" in n for n in counts) == 1, counts
    assert max(counts.values()) <= reps, counts


@pytest.mark.cuda
def test_topic_rows_refuse_a_state_without_their_table(cuda_device, models):
    """A topic-leaders row on a state without topic_leader_counts, or a
    topic-replica row without topic_counts, is refused at the launch (no
    read through a null table)."""
    model, md = models["main"]
    state, ctx = pass_inputs(model, md)
    c = rows_case(state, ctx, 64, seed=1)
    goals = six_chain(state.topic_counts.shape[0])
    leaders = kernels.GoalChecks(goals[3], goals[:3], 1e-6)
    with pytest.raises(RuntimeError, match="candidate_eligibility"):
        kernels.candidate_eligibility(
            state.replace(topic_leader_counts=None), ctx, c, leaders)
    topic = kernels.GoalChecks(goals[6], goals[:2], 1e-6)
    with pytest.raises(RuntimeError, match="candidate_eligibility"):
        kernels.candidate_eligibility(
            state.replace(topic_counts=None), ctx, c, topic)
