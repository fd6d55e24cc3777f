"""Goal-chain search of the port (counterpart of ``cruise_control_tpu.analyzer``)."""

from .constraint import BalancingConstraint, PopulationConfig, SearchConfig
from .goals import (GOAL_REGISTRY, CapacityGoal, GoalKernel, IntervalGoal,
                    MinTopicLeadersPerBrokerGoal, ReplicaCapacityGoal,
                    ReplicaDistributionGoal, ResourceDistributionGoal,
                    default_goals, goals_by_name)
from .intra import (DiskState, IntraBrokerResult, build_disk_state,
                    intra_broker_rebalance, optimize_intra_broker)
from .optimizer import (GoalResult, OptimizationFailureError,
                        OptimizerResult, TorchGoalOptimizer)
from .options import OptimizationOptions
from .tuning import (SuccessiveHalvingTuner, TunedConfigStore, autotune,
                     plan_quality, shape_bucket)

__all__ = [
    "BalancingConstraint", "CapacityGoal", "DiskState", "GOAL_REGISTRY",
    "GoalKernel", "GoalResult", "IntervalGoal", "IntraBrokerResult",
    "MinTopicLeadersPerBrokerGoal", "OptimizationFailureError",
    "OptimizationOptions", "OptimizerResult", "PopulationConfig",
    "ReplicaCapacityGoal", "ReplicaDistributionGoal",
    "ResourceDistributionGoal", "SearchConfig", "SuccessiveHalvingTuner",
    "TorchGoalOptimizer", "TunedConfigStore", "autotune", "build_disk_state",
    "default_goals", "goals_by_name", "intra_broker_rebalance",
    "optimize_intra_broker", "plan_quality", "shape_bucket",
]
