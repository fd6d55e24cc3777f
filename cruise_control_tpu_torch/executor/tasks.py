"""Execution task lifecycle (ref ``executor/ExecutionTask.java``,
``ExecutionTaskTracker.java``, ``ExecutionTaskManager.java``).

An :class:`ExecutionTask` wraps one ``ExecutionProposal`` with a task type
and a state machine::

    PENDING -> IN_PROGRESS -> COMPLETED
                           -> ABORTING -> ABORTED
                           -> DEAD

(ref ``ExecutionTask.State``; valid transitions ``ExecutionTask.java:45-60``).
The tracker keeps per-type/per-state sets and counts for ``ExecutorState``
serialization (ref ``ExecutionTaskTracker.java``).
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field

from ..model.proposals import ExecutionProposal


class TaskType(enum.Enum):
    """ref ``ExecutionTask.TaskType``."""

    INTER_BROKER_REPLICA_ACTION = "INTER_BROKER_REPLICA_ACTION"
    INTRA_BROKER_REPLICA_ACTION = "INTRA_BROKER_REPLICA_ACTION"
    LEADER_ACTION = "LEADER_ACTION"


class TaskState(enum.Enum):
    """ref ``ExecutionTask.State``."""

    PENDING = "PENDING"
    IN_PROGRESS = "IN_PROGRESS"
    ABORTING = "ABORTING"
    ABORTED = "ABORTED"
    DEAD = "DEAD"
    COMPLETED = "COMPLETED"


_VALID_TRANSITIONS: dict[TaskState, set[TaskState]] = {
    TaskState.PENDING: {TaskState.IN_PROGRESS},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD,
                            TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.ABORTED: set(),
    TaskState.DEAD: set(),
    TaskState.COMPLETED: set(),
}

#: Terminal states (ref ExecutionTask.IN_EXECUTION_STATES complement).
COMPLETED_STATES = {TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD}


@dataclass
class ExecutionTask:
    """One unit of executor work (ref ``ExecutionTask.java``)."""

    execution_id: int
    proposal: ExecutionProposal
    task_type: TaskType
    state: TaskState = TaskState.PENDING
    start_time_ms: int | None = None
    end_time_ms: int | None = None
    alert_time_ms: int | None = None

    def transition(self, new_state: TaskState, now_ms: int) -> None:
        if new_state not in _VALID_TRANSITIONS[self.state]:
            raise ValueError(
                f"illegal task transition {self.state.value} -> "
                f"{new_state.value} (task {self.execution_id})")
        self.state = new_state
        if new_state is TaskState.IN_PROGRESS:
            self.start_time_ms = now_ms
        elif new_state in COMPLETED_STATES:
            self.end_time_ms = now_ms

    @property
    def done(self) -> bool:
        return self.state in COMPLETED_STATES

    @property
    def topic_partition(self) -> tuple[str, int]:
        return (self.proposal.topic, self.proposal.partition)

    def to_json(self) -> dict:
        return {"executionId": self.execution_id,
                "type": self.task_type.value,
                "state": self.state.value,
                "proposal": self.proposal.to_json()}


@dataclass(frozen=True)
class IntraBrokerReplicaMove:
    """One replica's move between logdirs of a broker (ref the disk-aware
    ``ExecutionProposal`` variant used by IntraBrokerDiskUsageDistribution)."""

    topic: str
    partition: int
    broker_id: int
    source_logdir: str
    dest_logdir: str
    size_mb: float = 0.0

    @property
    def tp(self) -> tuple[str, int]:
        return (self.topic, self.partition)

    def to_json(self) -> dict:
        return {"topicPartition": {"topic": self.topic,
                                   "partition": self.partition},
                "brokerId": self.broker_id,
                "sourceLogdir": self.source_logdir,
                "destLogdir": self.dest_logdir}


class ExecutionTaskTracker:
    """Counts/sets of tasks by (type, state) (ref ExecutionTaskTracker.java).

    Thread-safe: the executor's runnable mutates while the API layer reads
    for ``/state``.
    """

    def __init__(self, tracer=None) -> None:
        self._tasks: dict[TaskType, dict[TaskState, dict[int, ExecutionTask]]] = {
            t: {s: {} for s in TaskState} for t in TaskType}
        self._lock = threading.RLock()
        #: optional span tracer: a task reaching a terminal state records
        #: an ``executor.task`` lifecycle span (duration = its
        #: IN_PROGRESS→terminal window on the executor's clock). The port
        #: has no tracer of its own yet, so None records nothing.
        self._tracer = tracer

    def add(self, task: ExecutionTask) -> None:
        with self._lock:
            self._tasks[task.task_type][task.state][task.execution_id] = task

    def transition(self, task: ExecutionTask, new_state: TaskState,
                   now_ms: int) -> None:
        with self._lock:
            del self._tasks[task.task_type][task.state][task.execution_id]
            task.transition(new_state, now_ms)
            self._tasks[task.task_type][new_state][task.execution_id] = task
        if (self._tracer is not None and task.done
                and task.start_time_ms is not None):
            # Reconstructed lifecycle span (the executor's now_ms clock may
            # be simulated; only the duration is trusted — the span ends
            # "now" on the tracer's clock). Parent = whatever phase span
            # the executing thread currently holds.
            proposal = task.proposal
            self._tracer.record(
                "executor.task",
                max((task.end_time_ms or now_ms) - task.start_time_ms, 0)
                / 1000.0,
                attrs={"type": task.task_type.value,
                       "state": task.state.value,
                       "topic": getattr(proposal, "topic", None),
                       "partition": getattr(proposal, "partition", None),
                       "executionId": task.execution_id})

    def tasks_in(self, task_type: TaskType,
                 state: TaskState) -> list[ExecutionTask]:
        with self._lock:
            return list(self._tasks[task_type][state].values())

    def num_in(self, task_type: TaskType, state: TaskState) -> int:
        with self._lock:
            return len(self._tasks[task_type][state])

    def num_remaining(self, task_type: TaskType) -> int:
        with self._lock:
            return sum(len(self._tasks[task_type][s]) for s in
                       (TaskState.PENDING, TaskState.IN_PROGRESS,
                        TaskState.ABORTING))

    def all_tasks(self) -> list[ExecutionTask]:
        with self._lock:
            return [t for by_state in self._tasks.values()
                    for tasks in by_state.values() for t in tasks.values()]

    def summary(self) -> dict:
        """Per-type per-state counts (feeds ExecutorState, ref
        ExecutionTasksSummary)."""
        with self._lock:
            return {t.value: {s.value: len(self._tasks[t][s])
                              for s in TaskState if self._tasks[t][s]}
                    for t in TaskType}


class ExecutionTaskManager:
    """Creates tasks from proposals and hands them to the planner/tracker
    (ref ExecutionTaskManager.java)."""

    def __init__(self, tracer=None) -> None:
        self._id_gen = itertools.count()
        self.tracker = ExecutionTaskTracker(tracer=tracer)

    def add_execution_proposals(self, proposals: list[ExecutionProposal]
                                ) -> list[ExecutionTask]:
        """Split proposals into inter-broker / leadership tasks (ref
        ExecutionTaskManager.addExecutionProposals; intra-broker tasks come
        from the disk-aware path)."""
        tasks: list[ExecutionTask] = []
        for p in proposals:
            if p.has_replica_action:
                tasks.append(ExecutionTask(next(self._id_gen), p,
                                           TaskType.INTER_BROKER_REPLICA_ACTION))
            elif p.has_leader_action:
                tasks.append(ExecutionTask(next(self._id_gen), p,
                                           TaskType.LEADER_ACTION))
        for t in tasks:
            self.tracker.add(t)
        return tasks

    def add_intra_broker_tasks(self, moves) -> list[ExecutionTask]:
        """Intra-broker (disk) movement tasks (ref
        ExecutionTaskManager's intra-broker path). ``moves`` is a list of
        IntraBrokerReplicaMove-like objects carrying a proposal."""
        tasks = [ExecutionTask(next(self._id_gen), m,
                               TaskType.INTRA_BROKER_REPLICA_ACTION)
                 for m in moves]
        for t in tasks:
            self.tracker.add(t)
        return tasks
