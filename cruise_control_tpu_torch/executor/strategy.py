"""Replica movement strategies (ref ``executor/strategy/*.java``).

A strategy orders the pending inter-broker movement tasks the planner hands
out each round. Strategies chain (ref
``AbstractReplicaMovementStrategy.chain``): the first strategy is the
primary sort key, ties fall through to the next, and every chain ends with
:class:`BaseReplicaMovementStrategy` (execution-id order) so the total order
is deterministic.

Instead of the reference's comparator objects, a strategy here is a *sort
key function* ``(task, context) -> value``; chaining is tuple composition —
the natural Python shape for the same semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from .tasks import ExecutionTask


@dataclass
class StrategyContext:
    """Cluster facts strategies may consult (ref strategies receive a
    ``StrategyOptions`` with partition sizes / URP / min-ISR info)."""

    #: (topic, partition) -> data size in MB (disk load of the partition)
    partition_size_mb: dict[tuple[str, int], float] = field(default_factory=dict)
    #: partitions currently under-replicated
    urp: set[tuple[str, int]] = field(default_factory=set)
    #: partitions at/below min-ISR with an offline replica
    min_isr_with_offline: set[tuple[str, int]] = field(default_factory=set)
    #: partitions one above min-ISR with an offline replica
    one_above_min_isr_with_offline: set[tuple[str, int]] = field(default_factory=set)


class ReplicaMovementStrategy:
    """SPI (ref ReplicaMovementStrategy.java)."""

    name = "ReplicaMovementStrategy"

    def key(self, task: ExecutionTask, ctx: StrategyContext):
        """Sort key component; lower sorts earlier."""
        raise NotImplementedError

    def chain(self, nxt: "ReplicaMovementStrategy") -> "ChainedStrategy":
        return ChainedStrategy([self, nxt])


class ChainedStrategy(ReplicaMovementStrategy):
    def __init__(self, strategies: Sequence[ReplicaMovementStrategy]):
        flat: list[ReplicaMovementStrategy] = []
        for s in strategies:
            flat.extend(s.strategies if isinstance(s, ChainedStrategy) else [s])
        self.strategies = flat
        self.name = "+".join(s.name for s in flat)

    def key(self, task: ExecutionTask, ctx: StrategyContext):
        return tuple(s.key(task, ctx) for s in self.strategies)

    def chain(self, nxt: ReplicaMovementStrategy) -> "ChainedStrategy":
        return ChainedStrategy([*self.strategies, nxt])


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """Execution-id (proposal) order (ref BaseReplicaMovementStrategy.java)."""

    name = "BaseReplicaMovementStrategy"

    def key(self, task, ctx):
        return task.execution_id


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    """Small partitions first — quick wins drain the queue fast (ref
    PrioritizeSmallReplicaMovementStrategy.java)."""

    name = "PrioritizeSmallReplicaMovementStrategy"

    def key(self, task, ctx):
        return ctx.partition_size_mb.get(task.topic_partition, 0.0)


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Large partitions first — start the long poles early (ref
    PrioritizeLargeReplicaMovementStrategy.java)."""

    name = "PrioritizeLargeReplicaMovementStrategy"

    def key(self, task, ctx):
        return -ctx.partition_size_mb.get(task.topic_partition, 0.0)


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move healthy (non-under-replicated) partitions first (ref
    PostponeUrpReplicaMovementStrategy.java)."""

    name = "PostponeUrpReplicaMovementStrategy"

    def key(self, task, ctx):
        return 1 if task.topic_partition in ctx.urp else 0


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """(At/under)-min-ISR partitions with offline replicas first: these are
    one failure from unavailability (ref
    PrioritizeMinIsrWithOfflineReplicasStrategy.java)."""

    name = "PrioritizeMinIsrWithOfflineReplicasStrategy"

    def key(self, task, ctx):
        return 0 if task.topic_partition in ctx.min_isr_with_offline else 1


class PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """Partitions exactly one above min-ISR with offline replicas next (ref
    PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy.java)."""

    name = "PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy"

    def key(self, task, ctx):
        return 0 if task.topic_partition in ctx.one_above_min_isr_with_offline else 1


STRATEGY_REGISTRY: dict[str, Callable[[], ReplicaMovementStrategy]] = {
    cls.name: cls for cls in (
        BaseReplicaMovementStrategy,
        PrioritizeSmallReplicaMovementStrategy,
        PrioritizeLargeReplicaMovementStrategy,
        PostponeUrpReplicaMovementStrategy,
        PrioritizeMinIsrWithOfflineReplicasStrategy,
        PrioritizeOneAboveMinIsrWithOfflineReplicasStrategy,
    )
}


def strategy_chain(names: Sequence[str] | None) -> ReplicaMovementStrategy:
    """Build a chained strategy from config names, always terminated by the
    base strategy (ref default.replica.movement.strategies resolution)."""
    strategies = [STRATEGY_REGISTRY[n]() for n in (names or [])]
    strategies.append(BaseReplicaMovementStrategy())
    return ChainedStrategy(strategies)
