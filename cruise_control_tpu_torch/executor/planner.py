"""Execution task planner (ref ``executor/ExecutionTaskPlanner.java``).

Hands the executor per-round batches of movement tasks honoring per-broker
and cluster concurrency caps, in the order of the configured movement
strategy chain (``getInterBrokerReplicaMovementTasks``
``ExecutionTaskPlanner.java:348``, ``getLeadershipMovementTasks`` ``:302``).
"""

from __future__ import annotations

from .concurrency import ExecutionConcurrencyManager
from .strategy import ReplicaMovementStrategy, StrategyContext, strategy_chain
from .tasks import ExecutionTask, TaskType


class ExecutionTaskPlanner:
    def __init__(self, strategy: ReplicaMovementStrategy | None = None):
        self.strategy = strategy or strategy_chain(None)
        self._ordered: list[ExecutionTask] | None = None

    def sort_key(self, task: ExecutionTask, ctx: StrategyContext):
        """Total-order sort key: the strategy chain's key first, then an
        explicit typed tie-break. Chains built by ``strategy_chain`` end
        in execution-id order, but a caller-supplied bare strategy can
        tie — and Python's stable sort would then fall back to the
        *insertion order* of the list being sorted, which differs across
        processes (tracker iteration after a restore, a replayed plan).
        The device scheduler and the host batcher must order identically
        in every process, so equal strategy keys break on
        ``(task_type, execution_id)`` — typed values, no ``id()`` or
        insertion-order dependence."""
        return (self.strategy.key(task, ctx), task.task_type.value,
                task.execution_id)

    def begin_phase(self, tasks: list[ExecutionTask],
                    ctx: StrategyContext | None = None) -> None:
        """Sort the phase's tasks by the strategy chain ONCE (ref
        ``ExecutionTaskPlanner.addExecutionProposals`` sorting into a
        TreeSet at plan time): at LinkedIn scale a rebalance carries
        ~500K movement tasks, and re-evaluating the Python strategy key
        inside a per-round sort (thousands of rounds per execution) is
        hours of pure ordering overhead. Per-round batch calls then walk
        this order, filtering by live task state — O(N) with no key
        calls."""
        ctx = ctx or StrategyContext()
        self._ordered = sorted(tasks,
                               key=lambda t: self.sort_key(t, ctx))

    def _in_order(self, pending: list[ExecutionTask],
                  ctx: StrategyContext) -> list[ExecutionTask]:
        if self._ordered is None:
            return sorted(pending, key=lambda t: self.sort_key(t, ctx))
        live = {id(t) for t in pending}
        if len(self._ordered) == len(pending):
            # Cheap identity check before trusting the cached order:
            # equal length alone would silently return stale tasks for a
            # caller passing a same-length but different list.
            if all(id(t) in live for t in self._ordered):
                return self._ordered
        covered = [t for t in self._ordered if id(t) in live]
        if len(covered) == len(pending):
            return covered
        # Pending tasks the cached phase order has never seen (caller
        # skipped begin_phase for them): the cache can't order what it
        # doesn't contain — sort the actual list rather than silently
        # dropping the uncovered tasks from every batch.
        return sorted(pending, key=lambda t: self.sort_key(t, ctx))

    def inter_broker_batch(self, pending: list[ExecutionTask],
                           in_progress: list[ExecutionTask],
                           concurrency: ExecutionConcurrencyManager,
                           ctx: StrategyContext | None = None
                           ) -> list[ExecutionTask]:
        """Next batch of inter-broker movements.

        A movement occupies a slot on every broker it adds a replica to AND
        every broker it removes one from (ref
        ``ExecutionTaskPlanner.java:348-420`` tracking both sides' in-progress
        counts); the cluster-wide cap bounds total concurrent movements.
        """
        ctx = ctx or StrategyContext()
        slots: dict[int, int] = {}
        for t in in_progress:
            for b in (*t.proposal.replicas_to_add, *t.proposal.replicas_to_remove):
                slots[b] = slots.get(b, 0) + 1
        budget = concurrency.cluster_movement_cap - len(in_progress)
        batch: list[ExecutionTask] = []
        for task in self._in_order(pending, ctx):
            if budget <= 0:
                break
            brokers = (*task.proposal.replicas_to_add,
                       *task.proposal.replicas_to_remove)
            if any(slots.get(b, 0) >= concurrency.inter_broker_cap(b)
                   for b in brokers):
                continue
            for b in brokers:
                slots[b] = slots.get(b, 0) + 1
            batch.append(task)
            budget -= 1
        return batch

    def leadership_batch(self, pending: list[ExecutionTask],
                         concurrency: ExecutionConcurrencyManager
                         ) -> list[ExecutionTask]:
        """Next batch of leadership movements: cluster cap plus a per-broker
        cap on the broker *gaining* leadership (ref
        ``ExecutionTaskPlanner.java:302-340``)."""
        cap = concurrency.leadership_cluster_cap
        per_broker: dict[int, int] = {}
        batch: list[ExecutionTask] = []
        for task in pending:
            if len(batch) >= cap:
                break
            leader = task.proposal.new_leader
            if per_broker.get(leader, 0) >= concurrency.leadership_broker_cap:
                continue
            per_broker[leader] = per_broker.get(leader, 0) + 1
            batch.append(task)
        return batch

    def intra_broker_batch(self, pending: list[ExecutionTask],
                           in_progress: list[ExecutionTask],
                           concurrency: ExecutionConcurrencyManager
                           ) -> list[ExecutionTask]:
        """Next batch of intra-broker (disk) movements: per-broker cap on
        concurrent logdir copies (ref ExecutionTaskPlanner's intra path)."""
        slots: dict[int, int] = {}
        for t in in_progress:
            b = t.proposal.broker_id
            slots[b] = slots.get(b, 0) + 1
        batch: list[ExecutionTask] = []
        for task in pending:
            b = task.proposal.broker_id
            if slots.get(b, 0) >= concurrency.intra_broker_cap:
                continue
            slots[b] = slots.get(b, 0) + 1
            batch.append(task)
        return batch
