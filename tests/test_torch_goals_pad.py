"""The goal parity of ``tests/test_torch_goals.py`` at broker rows other
than the default padding's 8k + 1: B1 = 23, 24 and 32 (broker pad
multiples 1 and 2), where XLA's CPU backend sums a violation row in other
vector loops (``cruise_control_tpu_torch/utils/ordered.py:ROW_LOOPS``),
plus every capacity and distribution goal's violation over loads that
put most brokers out of bounds, so that the row's order shows. Held bit
for bit, as there."""

import jax
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint)
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint)
from test_torch_goals import (test_bounds_violation_scale,  # noqa: F401
                              test_bulk_drain, test_propose_and_score,
                              test_top_replica_dest_grid,
                              test_min_topic_leaders_inactive)
from torch_parity_util import assert_same, build_both

torch.set_num_threads(1)

#: (brokers, pad multiple) -> B1: 23 (22 / 2 and 22 / 1), 24, 32
PAD_MODELS = {
    "22x1k_pad2": lambda: build_both(22, 1000, seed=0, broker_pad_multiple=2),
    "22x1k_pad1": lambda: build_both(22, 1000, seed=3, broker_pad_multiple=1),
    "23x1k_pad1": lambda: build_both(23, 1000, seed=0, broker_pad_multiple=1),
    "31x1k_pad1": lambda: build_both(31, 1000, seed=0, broker_pad_multiple=1),
}


@pytest.fixture(scope="module", params=sorted(PAD_MODELS))
def setup(request):
    (jm, jmd), (tm, _) = PAD_MODELS[request.param]()
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    return ((js.init_state(jm, **topics), js.build_context(jm)),
            (ts.init_state(tm, **topics), ts.build_context(tm)))


#: capacity thresholds and balance bands that leave most brokers out of
#: bounds, so every goal's penalty row has many non-zero elements
OUT_OF_BOUNDS = dict(capacity_threshold=(0.002, 0.005, 0.001, 0.005),
                     max_replicas_per_broker=40,
                     resource_balance_threshold=(1.01,) * 4,
                     replica_balance_threshold=1.01)
ROW_GOALS = ["ReplicaCapacityGoal", "DiskCapacityGoal",
             "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
             "CpuCapacityGoal", "ReplicaDistributionGoal",
             "DiskUsageDistributionGoal",
             "NetworkInboundUsageDistributionGoal",
             "NetworkOutboundUsageDistributionGoal",
             "CpuUsageDistributionGoal"]


@pytest.mark.parametrize("brokers,multiple",
                         [(22, 2), (22, 1), (23, 1), (24, 8), (27, 1),
                          (31, 1)])
@pytest.mark.parametrize("name", ROW_GOALS)
def test_violation_rows_out_of_bounds(brokers, multiple, name):
    """B1 = 23, 23, 24, 25 (the default padding), 28 and 32."""
    (jm, _), (tm, _) = build_both(brokers, 600, seed=brokers + multiple,
                                  broker_pad_multiple=multiple)
    jgoal = jg.goals_by_name([name], JConstraint(**OUT_OF_BOUNDS))[0]
    tgoal = tg.goals_by_name([name], TConstraint(**OUT_OF_BOUNDS))[0]
    jst, jctx = js.init_state(jm), js.build_context(jm)
    tst, tctx = ts.init_state(tm), ts.build_context(tm)
    lo, up = tgoal.bounds(tst, tctx)
    pen = tgoal._penalty(ts.metric_values(tst, tgoal.metric), lo, up,
                         tctx.broker_alive, tctx)
    assert int((pen > 0).sum()) >= 3       # the order shows
    assert_same(jax.jit(jgoal.violation)(jst, jctx),
                tgoal.violation(tst, tctx), what=f"{name} violation")
