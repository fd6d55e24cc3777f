"""Fleet-scale control plane: one process balancing many clusters
(counterpart of ``cruise_control_tpu.fleet``).

``model/fleet.py`` stacks per-cluster flat models into ``[C, ...]``
tensors; ``engine.py`` runs the full optimize loop (goal chain + hard-goal
audit + polish) for every member and the N-1 and trajectory sweeps over a
``[C, S]`` scenario grid (one KJ launch per sweep); ``registry.py`` is the
host side — per-cluster monitors feeding the shared tick, per-cluster
proposal caches, the member health machine and anomaly fan-out.
``backends.py`` wraps per-member remote endpoints with deadlines, retry
and a circuit breaker; ``budget.py`` grants per-tick moves from one
fleet-wide budget.
"""

from ..model.fleet import FleetMember, FleetModel
from .backends import (CallDeadlineExceeded, CircuitBreaker,
                       CircuitOpenError, MemberHealth, RemoteBackend)
from .budget import BudgetGrant, BudgetRequest, MoveBudgetCoordinator
from .engine import CLUSTER_AXIS, FleetOptimizer
from .registry import FleetRegistry

__all__ = ["BudgetGrant", "BudgetRequest", "CallDeadlineExceeded",
           "CircuitBreaker", "CircuitOpenError", "FleetMember",
           "FleetModel", "FleetOptimizer", "FleetRegistry",
           "MemberHealth", "MoveBudgetCoordinator", "RemoteBackend",
           "CLUSTER_AXIS"]
