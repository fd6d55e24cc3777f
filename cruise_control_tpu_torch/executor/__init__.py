"""Executor layer of the port (counterpart of ``cruise_control_tpu.executor``):
the move scheduler with its boundary audit, and the host-only planning it
shares with the reference — :mod:`.planner`/:mod:`.strategy` for batch
planning, :mod:`.concurrency` for caps and the adaptive adjuster,
:mod:`.tasks` for the task lifecycle. The phase driver (``Executor``) and
the simulated cluster are not ported yet (ROADMAP queue 1 item 11).
"""

from .concurrency import (ConcurrencyAdjuster, ConcurrencyConfig,
                          ConcurrencyType, ExecutionConcurrencyManager)
from .planner import ExecutionTaskPlanner
from .schedule import (DeviceMoveScheduler, MoveSchedule,
                       ScheduleAuditError, forecast_filter)
from .strategy import (STRATEGY_REGISTRY, ReplicaMovementStrategy,
                       StrategyContext, strategy_chain)
from .tasks import (ExecutionTask, ExecutionTaskManager, ExecutionTaskTracker,
                    IntraBrokerReplicaMove, TaskState, TaskType)

__all__ = [
    "ConcurrencyAdjuster", "ConcurrencyConfig", "ConcurrencyType",
    "ExecutionConcurrencyManager", "ExecutionTaskPlanner",
    "DeviceMoveScheduler", "MoveSchedule", "ScheduleAuditError",
    "forecast_filter", "StrategyContext", "ReplicaMovementStrategy",
    "STRATEGY_REGISTRY", "strategy_chain", "ExecutionTask",
    "ExecutionTaskManager", "ExecutionTaskTracker", "IntraBrokerReplicaMove",
    "TaskState", "TaskType",
]
