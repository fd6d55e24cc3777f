"""Whole-optimize parity past 32 brokers: the main path's 4-goal chain,
fused, at 40 brokers x 1,500 partitions (B1 = 41: every violation row and
the guards' broker flows at a width XLA reduces in its windowed tree,
``utils/ordered.py:tree_sum_last``), against the JAX package — identical
proposals, moves and per-goal iterations, violations bit for bit and the
same audit verdicts."""

import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu_torch.analyzer as ta
from torch_parity_util import build_both

torch.set_num_threads(1)

CHAIN = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal"]
SEARCH = dict(num_replica_candidates=128, num_dest_candidates=8,
              apply_per_iter=128, max_iters_per_goal=128, fused_chain=True)
WAIVE = frozenset({"RackAwareGoal"})


def test_four_goal_chain_parity_at_40_brokers():
    (jm, jmd), (tm, tmd) = build_both(40, 1500, seed=12)
    assert tm.num_brokers_padded + 1 == 41
    jres = ja.TpuGoalOptimizer(
        goals=ja.goals_by_name(CHAIN), config=ja.SearchConfig(**SEARCH)
    ).optimize(jm, jmd, ja.OptimizationOptions(seed=0,
                                               waived_hard_goals=WAIVE))
    tres = ta.TorchGoalOptimizer(
        goals=ta.goals_by_name(CHAIN), config=ta.SearchConfig(**SEARCH),
        device="cpu"
    ).optimize(tm, tmd, ta.OptimizationOptions(seed=0,
                                               waived_hard_goals=WAIVE))
    assert tres.proposals == jres.proposals
    assert tres.num_moves == jres.num_moves > 0
    for jg, tg in zip(jres.goal_results, tres.goal_results):
        assert (tg.name, tg.iterations, tg.accepted) == (
            jg.name, jg.iterations, jg.accepted)
        for field in ("violation_before", "violation_after", "scale"):
            assert getattr(tg, field) == getattr(jg, field), \
                f"{jg.name} {field}"
    assert [(g.name, g.satisfied, g.violation_after)
            for g in tres.hard_goal_audit] == [
        (g.name, g.satisfied, g.violation_after)
        for g in jres.hard_goal_audit]
    assert (tres.telemetry["violationTrajectory"]
            == jres.telemetry["violationTrajectory"])
