"""Cluster admin SPI — the executor's boundary to the managed cluster.

The reference executor drives Kafka through ``AdminClient``
(``ExecutionUtils.submitReplicaReassignmentTasks`` ``ExecutionUtils.java:485``,
``electLeaders`` ``:435``, ``alterReplicaLogDirs``). This module defines the
minimal protocol those call sites need, so the executor logic is testable
against :class:`~cruise_control_tpu_torch.executor.simulated.SimulatedKafkaCluster`
and deployable against a real Kafka by implementing the same protocol with
confluent-kafka/kafka-python (not bundled in this environment).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol


@dataclass
class PartitionInfo:
    """Current state of one partition (subset of Kafka metadata)."""

    topic: str
    partition: int
    replicas: list[int]          # broker ids, preferred leader first
    leader: int                  # broker id, -1 if none
    isr: set[int] = field(default_factory=set)
    size_mb: float = 0.0
    #: broker id -> logdir name hosting this partition's replica
    logdirs: dict[int, str] = field(default_factory=dict)

    @property
    def tp(self) -> tuple[str, int]:
        return (self.topic, self.partition)


@dataclass
class ReassignmentInfo:
    """In-flight reassignment (ref AdminClient.listPartitionReassignments)."""

    target: list[int]
    adding: list[int]
    removing: list[int]


class ClusterAdminClient(Protocol):
    """The executor's required admin surface."""

    def describe_cluster(self) -> dict[int, bool]:
        """broker id -> alive."""
        ...

    def describe_partitions(self) -> dict[tuple[str, int], PartitionInfo]:
        ...

    def alter_partition_reassignments(
            self, targets: dict[tuple[str, int], list[int] | None]
    ) -> dict[tuple[str, int], str | None]:
        """Start (list) or cancel (None) reassignments; returns per-partition
        error string or None (ref ExecutionUtils.java:485)."""
        ...

    def list_partition_reassignments(self) -> dict[tuple[str, int], ReassignmentInfo]:
        ...

    def elect_preferred_leaders(self, tps: list[tuple[str, int]]
                                ) -> dict[tuple[str, int], str | None]:
        """ref ExecutionUtils.java:435."""
        ...

    def alter_replica_log_dirs(self, moves: dict[tuple[str, int, int], str]
                               ) -> dict[tuple[str, int, int], str | None]:
        """(topic, partition, broker) -> target logdir (intra-broker move)."""
        ...

    def describe_replica_log_dirs(self) -> dict[tuple[str, int, int], str]:
        ...

    # Optional (not part of the required Protocol surface):
    # ``describe_logdirs() -> dict[int, list[str]]`` — all LIVE configured
    # logdirs per broker, including empty ones (ref
    # AdminClient.describeLogDirs, which omits offline dirs). Callers fall
    # back to the dirs observed in replica placement when absent.

    def alter_broker_config(self, broker_id: int, config: dict[str, str | None]
                            ) -> None:
        """Set (or delete, value None) dynamic broker configs (throttles)."""
        ...

    def describe_broker_config(self, broker_id: int) -> dict[str, str]:
        ...

    def alter_topic_config(self, topic: str, config: dict[str, str | None]
                           ) -> None:
        ...

    def describe_topic_config(self, topic: str) -> dict[str, str]:
        ...

    def broker_metrics(self, broker_id: int) -> dict[str, float]:
        """Live health metrics for the concurrency adjuster (request queue
        size, log flush time — ref ConcurrencyAdjuster's metric queries)."""
        ...
