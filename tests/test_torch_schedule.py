"""Move-scheduler parity: the port's ``DeviceMoveScheduler`` (device="cpu",
KE on its plain twin) against ``cruise_control_tpu.executor``'s and against
the port's own host greedy planner run to quiescence.

Batches, ETAs and stats must be identical on every case: the cap grid,
concurrency one, a bandwidth budget, an oversized move's spill, the ETA,
the boundary audit (clean, verified independently, repaired by bisection,
strict), empty and leadership-only plans, and the whole pipeline —
optimize, schedule the proposals with the hard-goal boundary audit, and
sweep the optimized model's N-1 scenarios — on a seeded 20-broker cluster.
The executor-pipeline cases of ``tests/test_schedule.py`` wait for the
executor's port (ROADMAP queue 1 item 11).
"""

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.executor as je
import cruise_control_tpu.whatif as jw
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.executor as te
import cruise_control_tpu_torch.whatif as tw
from cruise_control_tpu.executor.schedule import _first_fit_program
from cruise_control_tpu.model.proposals import ExecutionProposal as JProposal
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.executor.strategy import StrategyContext
from cruise_control_tpu_torch.executor.tasks import ExecutionTask
from cruise_control_tpu_torch.model.proposals import (
    ExecutionProposal as TProposal)
from torch_parity_util import assert_reports_equal, build_both, spec_both

torch.set_num_threads(1)

AUDIT_GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]


@pytest.fixture(scope="module")
def schedulers():
    return je.DeviceMoveScheduler(), te.DeviceMoveScheduler(device="cpu")


def host_greedy_batches(proposals, concurrency, ctx=None):
    """The port's host planner run to quiescence batch by batch — the
    batching the first-fit kernel must reproduce exactly."""
    ctx = ctx or StrategyContext()
    planner = te.ExecutionTaskPlanner()
    tasks = [ExecutionTask(i, p, te.TaskType.INTER_BROKER_REPLICA_ACTION)
             for i, p in enumerate(proposals) if p.has_replica_action]
    planner.begin_phase(tasks, ctx)
    pending = list(tasks)
    batches = []
    while pending:
        batch = planner.inter_broker_batch(pending, [], concurrency, ctx)
        if not batch:
            break
        batches.append(tuple(t.execution_id for t in batch))
        done = {id(t) for t in batch}
        pending = [t for t in pending if id(t) not in done]
    return batches


def ring(num_brokers=6, partitions=24, kind=TProposal):
    """A follower-rotation plan touching every broker unevenly."""
    return [kind(f"t{p % 3}", p, old_leader=(p + 1) % num_brokers,
                 old_replicas=((p + 1) % num_brokers, p % num_brokers),
                 new_replicas=((p + 1) % num_brokers,
                               (p + 2) % num_brokers))
            for p in range(partitions)]


def as_jax(proposals):
    return [JProposal(*p) for p in proposals]


def both(schedulers, proposals, cc_kwargs=None, ctx_sizes=None, **kw):
    """The same plan scheduled by both packages; asserts the schedules are
    identical and returns the port's."""
    jsch, tsch = schedulers
    cc_kwargs = cc_kwargs or {}
    jkw, tkw = dict(kw), dict(kw)
    if ctx_sizes is not None:
        jkw["strategy_context"] = je.StrategyContext(
            partition_size_mb=ctx_sizes)
        tkw["strategy_context"] = StrategyContext(
            partition_size_mb=ctx_sizes)
    for key in ("goals",):
        if key in kw:
            jkw[key], tkw[key] = kw[key]
    for key in ("model", "metadata"):
        if key in kw:
            jkw[key], tkw[key] = kw[key]
    want = jsch.schedule(as_jax(proposals), je.ExecutionConcurrencyManager(
        je.ConcurrencyConfig(**cc_kwargs)), **jkw)
    got = tsch.schedule(proposals, te.ExecutionConcurrencyManager(
        te.ConcurrencyConfig(**cc_kwargs)), **tkw)
    assert got.batches == want.batches
    assert got.eta_ms == want.eta_ms
    assert got.stats == want.stats
    assert got.to_json() == want.to_json()
    return got


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("per_broker,cluster_cap", [
    (1, 100), (2, 100), (1, 3), (5, 4)])
def test_first_fit_matches_reference_and_host_greedy(schedulers, per_broker,
                                                     cluster_cap):
    cc = dict(num_concurrent_partition_movements_per_broker=per_broker,
              max_num_cluster_partition_movements=cluster_cap)
    proposals = ring()
    sched = both(schedulers, proposals, cc)
    assert sched.batches == host_greedy_batches(
        proposals, te.ExecutionConcurrencyManager(te.ConcurrencyConfig(**cc)))
    assert sched.num_moves == len(proposals)
    assert sched.stats["spilled_moves"] == 0


def test_concurrency_one_is_fully_serial(schedulers):
    cc = dict(num_concurrent_partition_movements_per_broker=1,
              max_num_cluster_partition_movements=1)
    proposals = ring(num_brokers=4, partitions=8)
    sched = both(schedulers, proposals, cc)
    assert sched.batches == host_greedy_batches(
        proposals, te.ExecutionConcurrencyManager(te.ConcurrencyConfig(**cc)))
    assert all(len(b) == 1 for b in sched.batches)


def test_bandwidth_budget_caps_batch_inbound(schedulers):
    proposals = [TProposal("t", p, old_leader=0, old_replicas=(0, 1),
                           new_replicas=(0, 2)) for p in range(4)]
    sizes = {("t", p): 100.0 for p in range(4)}
    cc = dict(num_concurrent_partition_movements_per_broker=10)
    sched = both(schedulers, proposals, cc, ctx_sizes=sizes,
                 bandwidth_mb_per_batch=200.0)
    assert [len(b) for b in sched.batches] == [2, 2]
    wide = both(schedulers, proposals, cc, ctx_sizes=sizes)
    assert wide.batches == host_greedy_batches(
        proposals, te.ExecutionConcurrencyManager(te.ConcurrencyConfig(**cc)),
        StrategyContext(partition_size_mb=sizes))


def test_oversized_move_spills_to_singleton_batch(schedulers):
    proposals = [TProposal("t", p, old_leader=0, old_replicas=(0, 1),
                           new_replicas=(0, 2)) for p in range(3)]
    sched = both(schedulers, proposals,
                 dict(num_concurrent_partition_movements_per_broker=10),
                 ctx_sizes={("t", p): 500.0 for p in range(3)},
                 bandwidth_mb_per_batch=100.0)
    assert [len(b) for b in sched.batches] == [1, 1, 1]
    assert sched.num_moves == 3


def test_spill_when_the_batch_bound_runs_out(schedulers):
    """A two-destination move whose destinations are busy in disjoint
    batches needs a batch beyond the first-fit bound: the kernel assigns it
    the sentinel and the host spills it to a trailing singleton."""
    x, y, w = 0, 1, 2
    src = iter(range(10, 100))
    proposals = []
    for topic, dests, n in (("a", (x,), 4), ("d", (w,), 4),
                            ("b", (y, w), 4), ("f", (x, y), 1)):
        for i in range(n):
            old = tuple(next(src) for _ in dests)
            proposals.append(TProposal(topic, i, old_leader=old[0],
                                       old_replicas=old, new_replicas=dests))
    sizes = {(p.topic, p.partition): 100.0 for p in proposals}
    sched = both(schedulers, proposals,
                 dict(num_concurrent_partition_movements_per_broker=100,
                      max_num_cluster_partition_movements=1000),
                 ctx_sizes=sizes, bandwidth_mb_per_batch=100.0)
    assert sched.stats["spilled_moves"] == 1
    assert sched.batches[-1] == (12,)
    assert sched.num_moves == 13


def test_mixed_sizes_under_a_budget(schedulers):
    proposals = [TProposal("t", p, old_leader=p % 3,
                           old_replicas=(p % 3, 3 + p % 2),
                           new_replicas=(p % 3, 5 + p % 3))
                 for p in range(40)]
    sizes = {("t", p): float(30 + 70 * (p % 4)) for p in range(40)}
    sched = both(schedulers, proposals,
                 dict(num_concurrent_partition_movements_per_broker=3,
                      max_num_cluster_partition_movements=6),
                 ctx_sizes=sizes, bandwidth_mb_per_batch=120.0,
                 throttle_bytes=50_000_000)
    assert sched.num_moves == 40 and len(sched.batches) > 40 // 6


def test_eta_reflects_worst_destination_inbound(schedulers):
    proposals = ring(num_brokers=4, partitions=4)
    sizes = {(p.topic, p.partition): 50.0 for p in proposals}
    cc = dict(num_concurrent_partition_movements_per_broker=4)
    sched = both(schedulers, proposals, cc, ctx_sizes=sizes,
                 throttle_bytes=10_000_000)
    assert sched.batches and sched.eta_ms[0] >= 5_000.0
    no_throttle = both(schedulers, proposals, cc, ctx_sizes=sizes)
    assert all(e is None for e in no_throttle.eta_ms)


# ------------------------------------------------------- boundary audit
def audit_both(partitions=12, **cst):
    """(jax (model, md), port (model, md)) of test_schedule.py's audit
    spec, and each package's bound audit goals."""
    (jm, jmd), (tm, tmd) = spec_both(partitions=partitions, nw_out=3.0)
    jgoals = tuple(ja.goals_by_name(AUDIT_GOALS,
                                    ja.BalancingConstraint(**cst)))
    tgoals = tuple(ta.goals_by_name(AUDIT_GOALS,
                                    ta.BalancingConstraint(**cst)))
    return dict(model=(jm, tm), metadata=(jmd, tmd), goals=(jgoals, tgoals))


def rotation(partitions=12):
    return [TProposal(f"t{p % 2}", p, old_leader=p % 4,
                      old_replicas=(p % 4, (p + 1) % 4),
                      new_replicas=(p % 4, (p + 2) % 4))
            for p in range(partitions)]


def test_boundary_audit_passes_on_balanced_plan(schedulers):
    cc = dict(num_concurrent_partition_movements_per_broker=2)
    sched = both(schedulers, rotation(), cc, **audit_both())
    assert sched.stats["unrepaired_violations"] == 0
    assert sched.stats["boundaries_audited"] >= len(sched.batches)
    assert sched.batches == both(schedulers, rotation(), cc).batches


def test_boundary_placements_verified_independently(schedulers):
    """Replay each boundary on the host and score it with the port's
    what-if engine: the audit's verdict holds under reconstruction."""
    cc = dict(num_concurrent_partition_movements_per_broker=2)
    sched = both(schedulers, rotation(), cc, **audit_both())
    engine = tw.WhatIfEngine(goals=ta.goals_by_name(AUDIT_GOALS),
                             device="cpu")
    applied = {}
    for batch in sched.batches:
        for i in batch:
            prop = rotation()[i]
            applied[(prop.topic, prop.partition)] = list(prop.new_replicas)
        _, (tm, tmd) = spec_both(partitions=12, nw_out=3.0)
        rb = tm.replica_broker.clone()
        for (topic, part), reps in applied.items():
            row = tmd.partition_index[(topic, part)]
            rb[row, :2] = torch.tensor([tmd.broker_index[b] for b in reps])
        report = engine.sweep(tm.replace(replica_broker=rb), tmd,
                              [tw.LoadScale(1.0)])
        assert not report.outcomes[0].violated_goals, batch


def test_audit_repairs_a_crowded_boundary(schedulers):
    """Moves that pile replicas onto broker 0 before others leave it: the
    audit finds the crowded boundaries and bisects, exactly as the
    reference does (same rounds, same unrepaired count, same batches)."""
    proposals = ([TProposal("t0", p, old_leader=1 + p % 3,
                            old_replicas=(1 + p % 3, 1 + (p + 1) % 3),
                            new_replicas=(1 + p % 3, 0))
                  for p in range(0, 12, 2)]
                 + [TProposal("t1", p, old_leader=p % 4,
                              old_replicas=(p % 4, (p + 1) % 4),
                              new_replicas=(p % 4, (p + 2) % 4))
                    for p in range(1, 12, 2)])
    cc = dict(num_concurrent_partition_movements_per_broker=4)
    sched = both(schedulers, proposals, cc, max_repair_rounds=3,
                 **audit_both(max_replicas_per_broker=7))
    assert sched.stats["repair_rounds"] > 0


def test_bisection_repair_splits_first_offending_batch(schedulers,
                                                       monkeypatch):
    """Report batch 0 as violating until it is a singleton: the scheduler
    halves it each round, keeps the move order and converges."""
    _, tsch = schedulers
    proposals = ring(num_brokers=4, partitions=8)
    kw = audit_both(partitions=8)
    monkeypatch.setattr(tsch, "_violating_boundaries",
                        lambda batches, *a, **k:
                        [0] if len(batches[0]) > 1 else [])
    cc = te.ExecutionConcurrencyManager(te.ConcurrencyConfig(
        num_concurrent_partition_movements_per_broker=8))
    sched = tsch.schedule(proposals, cc, model=kw["model"][1],
                          metadata=kw["metadata"][1], goals=kw["goals"][1],
                          max_repair_rounds=6)
    base = tsch.schedule(proposals, cc)
    assert [i for b in sched.batches for i in b] == \
        [i for b in base.batches for i in b]
    assert len(sched.batches[0]) == 1
    assert sched.stats["repair_rounds"] > 0
    assert sched.stats["unrepaired_violations"] == 0


def test_strict_mode_raises_on_unrepairable_violation(schedulers,
                                                      monkeypatch):
    _, tsch = schedulers
    proposals = ring(num_brokers=4, partitions=4)
    kw = audit_both(partitions=4)
    monkeypatch.setattr(tsch, "_violating_boundaries",
                        lambda batches, *a, **k: [0])
    cc = te.ExecutionConcurrencyManager(te.ConcurrencyConfig(
        num_concurrent_partition_movements_per_broker=8))
    args = dict(model=kw["model"][1], metadata=kw["metadata"][1],
                goals=kw["goals"][1], max_repair_rounds=2)
    with pytest.raises(te.ScheduleAuditError):
        tsch.schedule(proposals, cc, strict=True, **args)
    assert tsch.schedule(proposals, cc, **args).stats[
        "unrepaired_violations"] > 0


def test_empty_and_leadership_only_plans_yield_empty_schedule(schedulers):
    assert both(schedulers, []).batches == []
    lead_only = [TProposal("t", 0, old_leader=0, old_replicas=(0, 1),
                           new_replicas=(1, 0))]
    sched = both(schedulers, lead_only)
    assert sched.batches == [] and sched.num_moves == 0
    mixed = lead_only + [TProposal("t", 1, old_leader=0,
                                   old_replicas=(0, 1), new_replicas=(0, 2))]
    assert both(schedulers, mixed).batches == [(1,)]


class _Scenario:
    def __init__(self, factors):
        self.factors = tuple(sorted(factors.items()))


def test_forecast_filter_partitions_by_projected_factor():
    props = [TProposal(t, 0, old_leader=0, old_replicas=(0, 1),
                       new_replicas=(0, 2))
             for t in ("shrinking", "steady", "hot")]
    kept, deferred, hot = te.forecast_filter(
        props, _Scenario({"shrinking": 0.4, "steady": 1.0, "hot": 2.0}),
        shrink_below=0.7, hot_above=1.5)
    assert [p.topic for p in deferred] == ["shrinking"]
    assert [p.topic for p in kept] == ["steady", "hot"]
    assert hot == {"hot"}
    kept2, deferred2, _ = te.forecast_filter(
        props, _Scenario({}), shrink_below=0.7, hot_above=1.5)
    assert not deferred2 and len(kept2) == 3


def test_scheduler_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.DeviceMoveScheduler()


# ------------------------------------------------- the kernel's function
@pytest.mark.parametrize("K", [8, 64])
@pytest.mark.parametrize("budget", [np.inf, 120.0])
def test_first_fit_twin_matches_reference_program(budget, K):
    """KE's twin against the reference's first-fit program on random moves
    (padding moves, padding rows, and with K = 8 moves no batch admits)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(int(budget) if np.isfinite(budget) else 1)
    M, W, B = 256, 3, 10
    rows = rng.integers(0, B + 1, (M, W)).astype(np.int32)
    dest = np.where(rng.random((M, W)) < 0.5, rows, B).astype(np.int32)
    sizes = (rng.random(M) * 100).astype(np.float32)
    valid = np.arange(M) < 230
    caps = rng.integers(1, 4, B + 1).astype(np.int32)
    caps[B] = 1 << 30
    want = np.asarray(_first_fit_program(M, W, K)(
        jnp.asarray(rows), jnp.asarray(dest), jnp.asarray(sizes),
        jnp.asarray(valid), jnp.asarray(caps), jnp.int32(12),
        jnp.float32(budget)))
    got = kernels.first_fit(*(torch.from_numpy(a) for a in
                              (rows, dest, sizes, valid, caps)), 12,
                            float(np.float32(budget)), K)
    np.testing.assert_array_equal(got.numpy(), want)
    if K == 8:
        assert (want[valid] == K).any()


# --------------------------------------------------- the whole pipeline
CHAIN = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal"]
SEARCH = dict(num_replica_candidates=128, num_dest_candidates=8,
              apply_per_iter=128, max_iters_per_goal=128, fused_chain=True)
WAIVED = frozenset({"RackAwareGoal"})


@pytest.fixture(scope="module")
def optimized():
    """Both packages' seed-1 optimization of the 20-broker cluster."""
    (jm, jmd), (tm, tmd) = build_both(20, 1000, seed=9)
    jres = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN),
                               config=ja.SearchConfig(**SEARCH)).optimize(
        jm, jmd, ja.OptimizationOptions(seed=1, waived_hard_goals=WAIVED))
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 config=ta.SearchConfig(**SEARCH),
                                 device="cpu")
    tres = topt.optimize(tm, tmd, ta.OptimizationOptions(
        seed=1, waived_hard_goals=WAIVED))
    assert tres.proposals == jres.proposals
    return (jm, jmd, jres), (tm, tmd, tres, topt)


@pytest.mark.parametrize("bandwidth", [None, 2_000.0])
def test_pipeline_schedules_the_optimizers_proposals(schedulers, optimized,
                                                  bandwidth):
    """Optimize -> schedule with the registered hard-goal boundary audit,
    as the facade wires it: identical schedules in both packages, equal to
    the host greedy planner without a bandwidth budget."""
    (jm, jmd, jres), (tm, tmd, tres, topt) = optimized
    tgoals = topt._audit_goals_for([], tmd, ta.OptimizationOptions(
        waived_hard_goals=WAIVED))
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN))
    jgoals = jopt._audit_goals_for([], jmd, ja.OptimizationOptions(
        waived_hard_goals=WAIVED))
    assert [g.name for g in tgoals] == [g.name for g in jgoals]
    assert len(tgoals) == 6
    disk = tm.leader_load[:, 3].numpy()
    sizes = {k: float(disk[i]) for i, k in enumerate(tmd.partition_keys)}
    sched = both(schedulers, tres.proposals, {}, ctx_sizes=sizes,
                 model=(jm, tm), metadata=(jmd, tmd),
                 goals=(tuple(jgoals), tuple(tgoals)),
                 capacity_threshold=topt.constraint.capacity_threshold,
                 throttle_bytes=20_000_000,
                 bandwidth_mb_per_batch=bandwidth)
    assert sched.num_moves == sum(p.has_replica_action
                                  for p in tres.proposals)
    assert sched.stats["unrepaired_violations"] == 0
    if bandwidth is None:
        assert sched.batches == host_greedy_batches(
            tres.proposals, te.ExecutionConcurrencyManager(),
            StrategyContext(partition_size_mb=sizes))


def test_pipeline_sweeps_the_optimized_cluster(optimized):
    """The optimized placement's N-1 sweep: the same report in both."""
    (jm, jmd, jres), (tm, tmd, tres, _) = optimized
    jrep = jw.WhatIfEngine(goals=ja.goals_by_name(CHAIN)).sweep(
        jres.final_model, jmd, jw.n1_sweep(jmd.broker_ids))
    trep = tw.WhatIfEngine(goals=ta.goals_by_name(CHAIN), device="cpu").sweep(
        tres.final_model, tmd, tw.n1_sweep(tmd.broker_ids))
    assert_reports_equal(jrep, trep)
