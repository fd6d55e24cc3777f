"""Execution concurrency control (ref ``ExecutionConcurrencyManager.java``,
``ConcurrencyType.java``, and the ``ConcurrencyAdjuster`` inner class of
``Executor.java:493-644``).

Per-broker and cluster-wide caps bound how many movements run at once; the
adjuster is the feedback controller that scales the caps from live broker
health (additive increase on healthy polls, multiplicative decrease when a
broker looks stressed or partitions sit (at/under) min-ISR).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field


class ConcurrencyType(enum.Enum):
    """ref ConcurrencyType.java."""

    INTER_BROKER_REPLICA = "INTER_BROKER_REPLICA"
    INTRA_BROKER_REPLICA = "INTRA_BROKER_REPLICA"
    LEADERSHIP_CLUSTER = "LEADERSHIP_CLUSTER"
    LEADERSHIP_BROKER = "LEADERSHIP_BROKER"


@dataclass
class ConcurrencyConfig:
    """Defaults mirror ExecutorConfig (ref config/constants/ExecutorConfig:
    num.concurrent.partition.movements.per.broker=5,
    num.concurrent.intra.broker.partition.movements=2,
    num.concurrent.leader.movements=1000,
    max.num.cluster.[partition.]movements caps, and the adjuster's
    min/max bounds)."""

    num_concurrent_partition_movements_per_broker: int = 5
    num_concurrent_intra_broker_partition_movements: int = 2
    num_concurrent_leader_movements: int = 1000
    num_concurrent_leader_movements_per_broker: int = 1000
    max_num_cluster_partition_movements: int = 1250
    # Adjuster bounds (ref min/max.num.concurrency config keys).
    min_partition_movements_per_broker: int = 1
    max_partition_movements_per_broker: int = 12
    min_leader_movements: int = 100
    max_leader_movements: int = 1000
    # Broker-health thresholds the adjuster reacts to (ref
    # concurrency.adjuster.* configs: request-queue size, log-flush time...).
    limit_request_queue_size: float = 1000.0
    limit_log_flush_time_ms: float = 1000.0
    limit_produce_local_time_ms: float = 1000.0


class ExecutionConcurrencyManager:
    """Tracks current caps, per broker and cluster-wide (ref
    ExecutionConcurrencyManager.java). Thread-safe: the adjuster thread
    writes while the planner reads."""

    def __init__(self, config: ConcurrencyConfig | None = None,
                 broker_ids: list[int] | None = None) -> None:
        self.config = config or ConcurrencyConfig()
        self._lock = threading.RLock()
        c = self.config
        self._inter_per_broker: dict[int, int] = {
            b: c.num_concurrent_partition_movements_per_broker
            for b in (broker_ids or [])}
        self._default_inter = c.num_concurrent_partition_movements_per_broker
        self._intra = c.num_concurrent_intra_broker_partition_movements
        self._leadership_cluster = c.num_concurrent_leader_movements
        self._leadership_broker = c.num_concurrent_leader_movements_per_broker

    # ----------------------------------------------------------- reads
    def inter_broker_cap(self, broker_id: int) -> int:
        with self._lock:
            return self._inter_per_broker.get(broker_id, self._default_inter)

    @property
    def intra_broker_cap(self) -> int:
        return self._intra

    @property
    def leadership_cluster_cap(self) -> int:
        with self._lock:
            return self._leadership_cluster

    @property
    def leadership_broker_cap(self) -> int:
        with self._lock:
            return self._leadership_broker

    @property
    def cluster_movement_cap(self) -> int:
        return self.config.max_num_cluster_partition_movements

    # ----------------------------------------------------------- writes
    def set_inter_broker_cap(self, broker_id: int, cap: int) -> None:
        c = self.config
        with self._lock:
            self._inter_per_broker[broker_id] = max(
                c.min_partition_movements_per_broker,
                min(cap, c.max_partition_movements_per_broker))

    def set_cluster_leadership_cap(self, cap: int) -> None:
        c = self.config
        with self._lock:
            self._leadership_cluster = max(c.min_leader_movements,
                                           min(cap, c.max_leader_movements))

    def summary(self) -> dict:
        with self._lock:
            return {
                "interBrokerPerBroker": dict(self._inter_per_broker),
                "defaultInterBroker": self._default_inter,
                "intraBroker": self._intra,
                "leadershipCluster": self._leadership_cluster,
                "leadershipBroker": self._leadership_broker,
            }


#: adjuster-controllable concurrency types (ref
#: (DISABLE|ENABLE)_CONCURRENCY_ADJUSTER_FOR_PARAM value set)
VALID_ADJUSTER_TYPES = frozenset({"inter_broker_replica", "leadership"})


class ConcurrencyAdjuster:
    """Auto-scales movement concurrency from broker health metrics (ref
    ``Executor.ConcurrencyAdjuster`` ``Executor.java:493-644``).

    Call :meth:`refresh` once per progress-check cycle with the latest
    per-broker metrics (request-queue size, log-flush time) and the set of
    (at/under) min-ISR partitions; it applies AIMD per broker:

    - any stress signal -> halve that broker's cap (multiplicative decrease);
    - cluster-wide (at/under)-min-ISR partitions -> halve every cap
      (ref ``:560-584`` min-ISR based adjustment);
    - otherwise -> +1 (additive increase) up to the configured max.
    """

    def __init__(self, manager: ExecutionConcurrencyManager) -> None:
        self.manager = manager
        #: concurrency types the adjuster must leave alone (ref
        #: (DISABLE|ENABLE)_CONCURRENCY_ADJUSTER_FOR_PARAM; values from
        #: {"inter_broker_replica", "leadership"}).
        self.disabled_types: set[str] = set()

    def set_enabled_for(self, concurrency_type: str, enabled: bool) -> None:
        key = concurrency_type.strip().lower()
        if key not in VALID_ADJUSTER_TYPES:
            raise ValueError(
                f"unknown concurrency type {concurrency_type!r} "
                f"(want one of {sorted(VALID_ADJUSTER_TYPES)})")
        (self.disabled_types.discard if enabled
         else self.disabled_types.add)(key)

    def refresh(self, broker_metrics: dict[int, dict[str, float]],
                num_min_isr_partitions: int = 0) -> dict[int, int]:
        cfg = self.manager.config
        new_caps: dict[int, int] = {}
        cluster_stressed = num_min_isr_partitions > 0
        if "inter_broker_replica" not in self.disabled_types:
            for broker_id, metrics in broker_metrics.items():
                cap = self.manager.inter_broker_cap(broker_id)
                stressed = (
                    cluster_stressed
                    or metrics.get("request_queue_size", 0.0)
                    > cfg.limit_request_queue_size
                    or metrics.get("log_flush_time_ms", 0.0)
                    > cfg.limit_log_flush_time_ms
                    or metrics.get("produce_local_time_ms", 0.0)
                    > cfg.limit_produce_local_time_ms)
                cap = max(cfg.min_partition_movements_per_broker, cap // 2) \
                    if stressed else cap + 1
                self.manager.set_inter_broker_cap(broker_id, cap)
                new_caps[broker_id] = self.manager.inter_broker_cap(broker_id)
        # Leadership cap follows the same cluster-level signal (ref :614-onw).
        if "leadership" not in self.disabled_types:
            lead = self.manager.leadership_cluster_cap
            self.manager.set_cluster_leadership_cap(
                max(cfg.min_leader_movements, lead // 2) if cluster_stressed
                else lead + max(1, lead // 10))
        return new_caps
