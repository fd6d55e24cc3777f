"""What-if scenario layer: batched simulation of hypothetical topologies —
failures, growth, capacity changes — scored by the same goal kernels that
drive optimization (counterpart of ``cruise_control_tpu.whatif``).

A hypothetical topology is an array transform of the flat model: a
100-broker N-1 sweep is one batch over a leading ``[S, ...]`` scenario
axis, not 100 sequential model rebuilds.
"""

from .spec import (BrokerAdd, BrokerLoss, CapacityResize, LoadScale,
                   Scenario, TopicAdd, TrajectoryScale, alive_broker_ids,
                   n1_sweep, n2_sweep, parse_scenarios)
from .engine import (ScenarioOutcome, WhatIfEngine, WhatIfReport,
                     trajectory_pscale_row)

__all__ = [
    "Scenario", "BrokerLoss", "BrokerAdd", "CapacityResize", "LoadScale",
    "TopicAdd", "TrajectoryScale", "n1_sweep", "n2_sweep",
    "alive_broker_ids", "parse_scenarios", "WhatIfEngine", "WhatIfReport",
    "ScenarioOutcome", "trajectory_pscale_row",
]
