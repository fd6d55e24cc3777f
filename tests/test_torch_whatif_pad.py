"""What-if parity at broker rows other than the default padding's 8k + 1:
the raw scorer outputs of an N-1 sweep (``viol [S, G]`` and the rest) at
B1 = 23, 24 and 32 (broker pad multiples 1 and 2), bit for bit. The
scorer's vmapped violation rows run other vector loops there
(``cruise_control_tpu_torch/utils/ordered.py:ROW_LOOPS``); the chain holds
every capacity and distribution goal, with bounds that leave most brokers
out of band so that each row's order shows."""

import pytest
import torch

import cruise_control_tpu.whatif as jw
import cruise_control_tpu_torch.whatif as tw
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint)
from cruise_control_tpu.analyzer.goals import goals_by_name as jgoals
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint)
from cruise_control_tpu_torch.analyzer.goals import goals_by_name as tgoals
from test_torch_goals_pad import OUT_OF_BOUNDS, ROW_GOALS
from test_torch_whatif import raw_outputs
from torch_parity_util import assert_same, build_both

torch.set_num_threads(1)


@pytest.mark.parametrize("brokers,multiple", [(22, 2), (22, 1), (23, 1),
                                              (31, 1)])
def test_n1_sweep_raw_outputs_at_pad_widths(brokers, multiple):
    (jm, jmd), (tm, tmd) = build_both(brokers, 800, seed=brokers,
                                      broker_pad_multiple=multiple)
    je = jw.WhatIfEngine(goals=jgoals(ROW_GOALS, JConstraint(**OUT_OF_BOUNDS)),
                         constraint=JConstraint(**OUT_OF_BOUNDS),
                         broker_pad_multiple=multiple)
    te = tw.WhatIfEngine(goals=tgoals(ROW_GOALS, TConstraint(**OUT_OF_BOUNDS)),
                         constraint=TConstraint(**OUT_OF_BOUNDS),
                         broker_pad_multiple=multiple, device="cpu")
    scenarios = jw.n1_sweep(jmd.broker_ids)
    jout, tout = raw_outputs(je, te, jm, jmd, tm, tmd, scenarios)
    assert jout[0].shape == (brokers, len(ROW_GOALS))
    assert (jout[0] > 0).sum() >= brokers * 4      # rows with terms
    names = ("viol", "vscale", "headroom", "hfrac", "pressure",
             "unavailable", "n_offline")
    for name, j, t in zip(names, jout, tout):
        assert_same(t, j, what=f"{brokers}/{multiple} {name}")
