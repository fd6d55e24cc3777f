"""KX and KY (``kernels.violation_rows``, ``interval_planes``) on the card,
bit for bit against their twins (int32 images of the float32 outputs).

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_violation_rows_cuda.py -q

KX over every row kind at every width of ``chip_smoke.KX_WIDTHS`` (every
ROW_LOOPS width and the tree on either side, topic tables within 32 x 32
and past it), unbatched and as an N-1 stack; the default chain, the main
chain, the hard-goal audit set and the whole catalog on the main path's
cluster (B1 105, TopicReplica at T 200) and the scale cell (B1 1,001, T
400); the default chain's what-if stack at S 100; the converged-test
flag; a replay inside a CUDA graph; a chain's captured graphs replayed
after many other tables came and went (the tables a graph reads are held
by their owners). KY for every interval goal at those shapes.
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
    from cruise_control_tpu_torch.model.spec import flatten_spec
    return {"main": flatten_spec(chip_smoke.build_spec(), device="cuda"),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2)}


def _bits(t):
    return t.cpu().contiguous().view(torch.int32)


def _same(got, want):
    return all(torch.equal(_bits(g), w.contiguous().view(torch.int32))
               for g, w in zip(got, want))


def _chains(md):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import default_goals, goals_by_name
    from cruise_control_tpu_torch.analyzer import goals as g
    return {"default": [x.bind(md) for x in default_goals()],
            "main": goals_by_name(chip_smoke.GOALS),
            "audit": [x.bind(md) for x in goals_by_name(
                [n for n, hard in g.DEFAULT_GOALS if hard])],
            "catalog": chip_smoke.violation_goals(md)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(12))
@pytest.mark.parametrize("stacked", [False, True])
def test_every_row_kind_at_every_width(models, case, stacked):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    B1, S, topics, dead = chip_smoke.KX_WIDTHS[case]
    m, md = chip_smoke.violation_case(B1, topics, dead)
    goals = chip_smoke.violation_goals(md)
    if stacked:
        state, ctx = chip_smoke.scenario_stack(m, md, S)
    else:
        state, ctx = chip_smoke.pass_state(m, md)
    if B1 < 9 and topics <= 32:
        topic = [x for x in goals
                 if isinstance(x, g.TopicReplicaDistributionGoal)]
        with pytest.raises(ValueError, match="not identified"):
            kernels.violation_rows(kernels.ViolationTable(topic), state, ctx)
        goals = [x for x in goals if x not in topic]
    table = kernels.ViolationTable(goals)
    got = kernels.violation_rows(table, state, ctx, True)
    want = kernels.violation_rows_plain(
        table, chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx), True)
    assert got[0].shape == ((S,) if stacked else ()) + (len(goals),)
    assert _same(got, want), (B1, stacked)
    if not stacked:
        for goal in goals:
            if isinstance(goal, g.IntervalGoal):
                chip_smoke.check_interval_planes(state, ctx, goal, str(B1))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["main", "scale"])
@pytest.mark.parametrize("chain", ["default", "main", "audit", "catalog"])
def test_chains_at_the_main_path_shapes(models, model, chain):
    import chip_smoke
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    goals = _chains(md)[chain]
    table = kernels.ViolationTable(goals)
    got = kernels.violation_rows(table, state, ctx, True)
    want = kernels.violation_rows_plain(
        table, chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx), True)
    assert _same(got, want)
    assert kernels._topics(state) == (200 if model == "main" else 400)


@pytest.mark.cuda
@pytest.mark.parametrize("B1,topics", [(256, 319), (320, 256), (287, 300),
                                       (1001, 400)])
def test_topic_row_past_four_windows_a_warp(models, B1, topics):
    """TopicReplica's cells where their 32 x 32 windows outnumber the
    block's warps four times (a thread a window, ``window_rows_sums``):
    one padding row and no padding column, no padding, and a padding
    column of one (the warps' path again), unbatched and as a stack of 3,
    bit for bit against the twin."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    m, md = chip_smoke.violation_case(B1, topics, (1,))
    goals = [x for x in chip_smoke.violation_goals(md)
             if isinstance(x, g.TopicReplicaDistributionGoal)]
    table = kernels.ViolationTable(goals)
    for state, ctx in (chip_smoke.pass_state(m, md),
                       chip_smoke.scenario_stack(m, md, 3)):
        assert kernels._topics(state) == topics
        got = kernels.violation_rows(table, state, ctx, True)
        want = kernels.violation_rows_plain(
            table, chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx), True)
        assert _same(got, want), (B1, topics, state.util.dim())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["main", "scale"])
def test_interval_planes_at_the_main_path_shapes(models, model):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    for goal in _chains(md)["catalog"]:
        if isinstance(goal, g.IntervalGoal):
            planes = chip_smoke.check_interval_planes(state, ctx, goal, model)
            assert all(p.data_ptr() % 16 == 0 for p in planes)


@pytest.mark.cuda
def test_whatif_stack_of_100(models):
    import chip_smoke
    m, md = models["main"]
    state, ctx = chip_smoke.scenario_stack(m, md, 100)
    table = kernels.ViolationTable(_chains(md)["default"])
    got = kernels.violation_rows(table, state, ctx, True)
    want = kernels.violation_rows_plain(
        table, chip_smoke.to_cpu(state), chip_smoke.to_cpu(ctx), True)
    assert got[0].shape == (100, 16)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [(), (3,)])
def test_converged_flag(models, dead):
    """A one-row table's flag: the violation above epsilon, or a replica
    offline (a dead broker's), as the pass's converged test reads it."""
    import chip_smoke
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=dead)
    for goal in _chains(md)["default"]:
        table = kernels.ViolationTable([goal])
        flag = torch.full((), 7, dtype=torch.int64, device="cuda")
        kernels.violation_rows(table, state, ctx, flag=flag, eps=1e-6)
        cpu = chip_smoke.to_cpu(state)
        want = bool((kernels.violation_rows_plain(
            table, cpu, chip_smoke.to_cpu(ctx))[0] > 1e-6)
            | cpu.offline.any())
        assert int(flag) == int(want), goal.name


@pytest.mark.cuda
def test_replay_in_a_cuda_graph(models):
    """KX captured once into a CUDA graph writes the same stack into the
    caller's buffers on every replay as an eager launch, also after the
    state's planes change in place."""
    import chip_smoke
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    table = kernels.ViolationTable(_chains(md)["default"])
    out = torch.empty(table.n, device="cuda")
    scale = torch.empty(table.n, device="cuda")
    eager = kernels.violation_rows(table, state, ctx, True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.violation_rows(table, state, ctx, True, out=out,
                               scale_out=scale)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert _same((out, scale), [_bits(t).view(torch.float32) for t in eager])
    state.util.mul_(1.5)
    graph.replay()
    again = kernels.violation_rows(table, state, ctx, True)
    torch.cuda.synchronize()
    assert _same((out, scale), [_bits(t).view(torch.float32) for t in again])
    assert not _same((out,), [_bits(eager[0]).view(torch.float32)])


@pytest.mark.cuda
def test_refusals(models):
    """KX refuses a goal without a row, a flag over several rows and a
    wrong out buffer; KY refuses a goal outside the interval family."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import goals as g
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md)

    class NoRow(g.IntervalGoal):
        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1)

    goals = _chains(md)["default"]
    norow = NoRow("NoRow", ("count", None), hard=False,
                  constraint=goals[2].constraint)
    with pytest.raises(ValueError, match="NoRow"):
        kernels.violation_rows(kernels.ViolationTable([norow]), state, ctx)
    flag = torch.zeros((), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="flag"):
        kernels.violation_rows(kernels.ViolationTable(goals), state, ctx,
                               flag=flag)
    with pytest.raises(ValueError, match="out"):
        kernels.violation_rows(kernels.ViolationTable(goals), state, ctx,
                               out=torch.empty(3, device="cuda"))
    with pytest.raises(ValueError, match="interval row"):
        kernels.interval_planes(kernels.ViolationTable(goals[:1]), state,
                                ctx)
    assert np.isfinite(kernels.violation_rows(
        kernels.ViolationTable(goals), state, ctx).cpu().numpy()).all()


def _churn(md, state, ctx):
    """Build, launch and drop many tables of other goal lists, collect,
    and hand the freed blocks to new tensors that overwrite them."""
    import gc
    goals = _chains(md)["catalog"]
    for k in range(80):
        table = kernels.ViolationTable(goals[k % len(goals):] + goals[:k % 5])
        kernels.violation_rows(table, state, ctx, True)
    del table
    gc.collect()
    torch.cuda.synchronize()
    return [torch.full((n,), -1, dtype=torch.int32, device="cuda")
            for n in (16, 32, 64, 128, 256) for _ in range(200)]


@pytest.mark.cuda
def test_captured_tables_outlive_other_tables(models):
    """A pass's graphs read KX's tables and each interval goal's KY table
    at every replay, so their owners keep them: a capture, many other
    tables built and dropped, a second capture at another B1, more of
    them, and the first cluster's replays still give the cold run's
    plan, which equals the host loop's."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    cst = BalancingConstraint(**chip_smoke.KX_CONSTRAINT)
    names = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
             "TopicReplicaDistributionGoal"]
    search = SearchConfig(num_replica_candidates=128, num_dest_candidates=8,
                          num_swap_candidates=64, apply_per_iter=128,
                          max_iters_per_goal=48, drain_batch=512,
                          fused_chain=True)
    options = OptimizationOptions(seed=1, skip_hard_goal_check=True)
    a, amd = chip_smoke.violation_case(64, 40)
    b, bmd = chip_smoke.violation_case(33, 40)
    opt = TorchGoalOptimizer(goals=goals_by_name(names, cst), config=search,
                             device="cuda")
    cold = opt.optimize(a, amd, options)
    junk = _churn(amd, *chip_smoke.pass_state(a, amd))
    opt.optimize(b, bmd, options)
    junk += _churn(bmd, *chip_smoke.pass_state(b, bmd))
    warm = opt.optimize(a, amd, options)
    host = TorchGoalOptimizer(goals=goals_by_name(names, cst), config=search,
                              device="cuda", goal_loop="host").optimize(
        a, amd, options)
    assert cold.num_moves > 0
    assert [p.to_json() for p in warm.proposals] == [
        p.to_json() for p in cold.proposals] == [
        p.to_json() for p in host.proposals]
    assert [g.violation_after for g in warm.goal_results] == [
        g.violation_after for g in host.goal_results]
    del junk
