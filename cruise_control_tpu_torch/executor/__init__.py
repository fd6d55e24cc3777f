"""Executor layer of the port (counterpart of ``cruise_control_tpu.executor``):
the move scheduler with its boundary audit, and the host-only planning it
shares with the reference — :mod:`.planner`/:mod:`.strategy` for batch
planning, :mod:`.concurrency` for caps and the adaptive adjuster,
:mod:`.tasks` for the task lifecycle — plus the admin SPI (:mod:`.admin`),
the admin error types (:mod:`.kafka_admin`) and the in-process cluster
double (:mod:`.simulated`) the monitor reads. The executor itself
(``Executor``) and the real-cluster adapter are not ported yet (ROADMAP
queue 1 item 11).
"""

from .admin import ClusterAdminClient, PartitionInfo, ReassignmentInfo
from .kafka_admin import (AdminAuthorizationError, AdminOperationError,
                          AdminTimeoutError, KafkaWireError)
from .concurrency import (ConcurrencyAdjuster, ConcurrencyConfig,
                          ConcurrencyType, ExecutionConcurrencyManager)
from .planner import ExecutionTaskPlanner
from .schedule import (DeviceMoveScheduler, MoveSchedule,
                       ScheduleAuditError, forecast_filter)
from .simulated import SimClock, SimulatedKafkaCluster
from .strategy import (STRATEGY_REGISTRY, ReplicaMovementStrategy,
                       StrategyContext, strategy_chain)
from .tasks import (ExecutionTask, ExecutionTaskManager, ExecutionTaskTracker,
                    IntraBrokerReplicaMove, TaskState, TaskType)

__all__ = [
    "ClusterAdminClient", "PartitionInfo", "ReassignmentInfo",
    "AdminAuthorizationError", "AdminOperationError", "AdminTimeoutError",
    "KafkaWireError", "SimClock", "SimulatedKafkaCluster",
    "ConcurrencyAdjuster", "ConcurrencyConfig", "ConcurrencyType",
    "ExecutionConcurrencyManager", "ExecutionTaskPlanner",
    "DeviceMoveScheduler", "MoveSchedule", "ScheduleAuditError",
    "forecast_filter", "StrategyContext", "ReplicaMovementStrategy",
    "STRATEGY_REGISTRY", "strategy_chain", "ExecutionTask",
    "ExecutionTaskManager", "ExecutionTaskTracker", "IntraBrokerReplicaMove",
    "TaskState", "TaskType",
]
