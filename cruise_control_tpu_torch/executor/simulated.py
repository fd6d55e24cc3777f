"""In-process simulated Kafka cluster implementing the admin SPI.

The reference tests its executor against embedded in-JVM Kafka brokers
(``CCKafkaIntegrationTestHarness`` / ``CCEmbeddedBroker``); this is the
equivalent test double for a Python control plane: a deterministic,
clock-driven cluster model with bandwidth-limited reassignment progress,
broker death, ISR tracking, preferred-leader election, logdir moves, and
dynamic configs (throttles). The executor is exercised end-to-end against
it with zero wall-clock sleeps — time advances only via :meth:`advance_to`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .admin import PartitionInfo, ReassignmentInfo

#: Dynamic config keys (same names Kafka uses; ref
#: ReplicationThrottleHelper.java LEADER_THROTTLED_RATE etc.)
LEADER_THROTTLED_RATE = "leader.replication.throttled.rate"
FOLLOWER_THROTTLED_RATE = "follower.replication.throttled.rate"
LEADER_THROTTLED_REPLICAS = "leader.replication.throttled.replicas"
FOLLOWER_THROTTLED_REPLICAS = "follower.replication.throttled.replicas"


@dataclass
class _Copy:
    """One replica copy in flight: partition data streaming to a broker
    (inter-broker reassignment) or between logdirs (intra-broker)."""

    tp: tuple[str, int]
    dest_broker: int
    remaining_mb: float
    intra_target_logdir: str | None = None


@dataclass
class _BrokerSim:
    broker_id: int
    alive: bool = True
    #: replication bandwidth available for incoming copies, MB/s
    reassignment_rate_mb_s: float = 100.0
    logdirs: tuple[str, ...] = ("logdir0",)
    failed_logdirs: set[str] = field(default_factory=set)
    config: dict[str, str] = field(default_factory=dict)
    metrics: dict[str, float] = field(default_factory=dict)


class SimulatedKafkaCluster:
    """Deterministic cluster sim behind :class:`ClusterAdminClient`."""

    def __init__(self, now_ms: int = 0) -> None:
        self._now_ms = now_ms
        self._brokers: dict[int, _BrokerSim] = {}
        self._partitions: dict[tuple[str, int], PartitionInfo] = {}
        self._topic_configs: dict[str, dict[str, str]] = {}
        self._reassign: dict[tuple[str, int], list[int]] = {}   # tp -> target
        self._copies: list[_Copy] = []
        self.num_reassignment_batches = 0
        self.num_leader_elections = 0

    # ------------------------------------------------------------- build
    def add_broker(self, broker_id: int, *, rate_mb_s: float = 100.0,
                   logdirs: tuple[str, ...] = ("logdir0",)) -> None:
        self._brokers[broker_id] = _BrokerSim(broker_id,
                                              reassignment_rate_mb_s=rate_mb_s,
                                              logdirs=logdirs)

    def add_partition(self, topic: str, partition: int, replicas: list[int],
                      size_mb: float = 100.0,
                      logdir_by_broker: dict[int, str] | None = None) -> None:
        info = PartitionInfo(topic=topic, partition=partition,
                             replicas=list(replicas), leader=replicas[0],
                             isr=set(replicas), size_mb=size_mb)
        for b in replicas:
            info.logdirs[b] = (logdir_by_broker or {}).get(
                b, self._brokers[b].logdirs[0])
        self._partitions[(topic, partition)] = info

    @classmethod
    def from_spec(cls, spec, *, rate_mb_s: float = 100.0,
                  now_ms: int = 0) -> "SimulatedKafkaCluster":
        """Build from a :class:`~cruise_control_tpu_torch.model.spec.ClusterSpec`
        (partition size = DISK load, matching the model's units)."""
        from ..core.resources import Resource
        sim = cls(now_ms=now_ms)
        for b in spec.brokers:
            sim.add_broker(b.broker_id, rate_mb_s=rate_mb_s)
            if not b.alive:
                sim.kill_broker(b.broker_id)
        for p in spec.partitions:
            sim.add_partition(p.topic, p.partition, list(p.replicas),
                              size_mb=float(p.leader_load[Resource.DISK]))
        return sim

    def _elect_leader(self, info: PartitionInfo) -> None:
        """ISR-based re-election when the leader is lost (one rule, used by
        broker death, logdir failure, and reassignment finalization)."""
        alive_isr = [b for b in info.replicas
                     if b in info.isr and self._brokers[b].alive]
        info.leader = alive_isr[0] if alive_isr else -1

    # ------------------------------------------------------------ faults
    def kill_broker(self, broker_id: int) -> None:
        self._brokers[broker_id].alive = False
        for info in self._partitions.values():
            info.isr.discard(broker_id)
            if info.leader == broker_id:
                self._elect_leader(info)

    def fail_logdir(self, broker_id: int, logdir: str) -> None:
        """A disk dies: replicas on that logdir go offline (ref the
        offline-logdir state DiskFailureDetector scans for)."""
        broker = self._brokers[broker_id]
        broker.failed_logdirs.add(logdir)
        for info in self._partitions.values():
            if info.logdirs.get(broker_id) == logdir:
                info.isr.discard(broker_id)
                if info.leader == broker_id:
                    self._elect_leader(info)

    def offline_logdirs(self) -> dict[int, list[str]]:
        return {b.broker_id: sorted(b.failed_logdirs)
                for b in self._brokers.values() if b.failed_logdirs}

    def describe_logdirs(self) -> dict[int, list[str]]:
        """All LIVE configured logdirs per broker, including empty ones
        (ref AdminClient.describeLogDirs, which omits offline dirs) —
        empty disks are valid drain destinations the replica placement
        alone can't reveal; failed ones are not."""
        return {b.broker_id: sorted(set(b.logdirs) - b.failed_logdirs)
                for b in self._brokers.values()}

    def offline_replicas(self) -> set[tuple[str, int, int]]:
        """Replicas currently offline: hosted on a dead broker or a failed
        logdir (feeds the monitor's per-replica offline marks)."""
        out: set[tuple[str, int, int]] = set()
        for (t, p), info in self._partitions.items():
            for b in info.replicas:
                broker = self._brokers[b]
                if (not broker.alive
                        or info.logdirs.get(b) in broker.failed_logdirs):
                    out.add((t, p, b))
        return out

    def create_partitions(self, topic: str, additional: int,
                          rf: int = 2, size_mb: float = 0.0) -> None:
        """Expand a topic (ref PartitionProvisioner's actuation path)."""
        existing = [p for (t, p) in self._partitions if t == topic]
        next_id = max(existing, default=-1) + 1
        alive = sorted(b.broker_id for b in self._brokers.values() if b.alive)
        if not alive:
            raise RuntimeError("no alive brokers to place partitions on")
        rf = min(rf, len(alive))   # replica lists must be duplicate-free
        for i in range(additional):
            offset = (next_id + i) % len(alive)
            replicas = [alive[(offset + j) % len(alive)] for j in range(rf)]
            self.add_partition(topic, next_id + i, replicas, size_mb=size_mb)

    def restart_broker(self, broker_id: int) -> None:
        self._brokers[broker_id].alive = True
        for info in self._partitions.values():
            if broker_id in info.replicas:
                info.isr.add(broker_id)
                if info.leader == -1:
                    info.leader = broker_id

    # -------------------------------------------------------------- time
    @property
    def now_ms(self) -> int:
        return self._now_ms

    def advance_to(self, now_ms: int) -> None:
        """Progress in-flight copies with per-broker fair-shared bandwidth,
        bounded by the follower throttle when set."""
        dt_s = max(0, now_ms - self._now_ms) / 1000.0
        self._now_ms = now_ms
        if dt_s == 0 or not self._copies:
            return
        by_dest: dict[int, list[_Copy]] = {}
        for c in self._copies:
            by_dest.setdefault(c.dest_broker, []).append(c)
        for broker_id, copies in by_dest.items():
            broker = self._brokers[broker_id]
            if not broker.alive:
                continue  # stalled
            rate = broker.reassignment_rate_mb_s
            throttle = broker.config.get(FOLLOWER_THROTTLED_RATE)
            if throttle is not None:
                # Kafka throttle configs are bytes/s.
                rate = min(rate, float(throttle) / 1e6)
            share = rate / len(copies) * dt_s
            for c in copies:
                c.remaining_mb -= share
        finished = [c for c in self._copies if c.remaining_mb <= 0]
        self._copies = [c for c in self._copies if c.remaining_mb > 0]
        for c in finished:
            self._finish_copy(c)

    def _healthy_logdir(self, broker_id: int) -> str:
        broker = self._brokers[broker_id]
        for d in broker.logdirs:
            if d not in broker.failed_logdirs:
                return d
        return broker.logdirs[0]

    def _finish_copy(self, c: _Copy) -> None:
        info = self._partitions[c.tp]
        if c.intra_target_logdir is not None:
            info.logdirs[c.dest_broker] = c.intra_target_logdir
            return
        info.isr.add(c.dest_broker)
        info.logdirs.setdefault(c.dest_broker,
                                self._healthy_logdir(c.dest_broker))
        target = self._reassign.get(c.tp)
        # Reassignment completes when every adding replica is in ISR.
        if target is not None and all(b in info.isr for b in target):
            self._finalize_reassignment(c.tp)

    def _finalize_reassignment(self, tp: tuple[str, int]) -> None:
        info = self._partitions[tp]
        target = self._reassign.pop(tp)
        removed = [b for b in info.replicas if b not in target]
        info.replicas = list(target)
        info.isr = {b for b in info.replicas if self._brokers[b].alive}
        for b in removed:
            info.logdirs.pop(b, None)
        for b in info.replicas:
            info.logdirs.setdefault(b, self._healthy_logdir(b))
        if info.leader not in target or not self._brokers[info.leader].alive:
            self._elect_leader(info)

    # --------------------------------------------------- admin SPI (reads)
    def describe_cluster(self) -> dict[int, bool]:
        return {b.broker_id: b.alive for b in self._brokers.values()}

    def describe_partitions(self) -> dict[tuple[str, int], PartitionInfo]:
        return dict(self._partitions)

    def list_partition_reassignments(self) -> dict[tuple[str, int], ReassignmentInfo]:
        out = {}
        for tp, target in self._reassign.items():
            info = self._partitions[tp]
            out[tp] = ReassignmentInfo(
                target=list(target),
                adding=[b for b in target if b not in info.replicas],
                removing=[b for b in info.replicas if b not in target])
        return out

    def describe_replica_log_dirs(self) -> dict[tuple[str, int, int], str]:
        return {(t, p, b): d
                for (t, p), info in self._partitions.items()
                for b, d in info.logdirs.items()}

    def broker_metrics(self, broker_id: int) -> dict[str, float]:
        b = self._brokers[broker_id]
        inflight = sum(1 for c in self._copies if c.dest_broker == broker_id)
        metrics = {"request_queue_size": 10.0 * inflight,
                   "log_flush_time_ms": 5.0 * inflight}
        metrics.update(b.metrics)  # test-injected overrides win
        return metrics

    # -------------------------------------------------- admin SPI (writes)
    def alter_partition_reassignments(
            self, targets: dict[tuple[str, int], list[int] | None]
    ) -> dict[tuple[str, int], str | None]:
        self.num_reassignment_batches += 1
        results: dict[tuple[str, int], str | None] = {}
        for tp, target in targets.items():
            info = self._partitions.get(tp)
            if info is None:
                results[tp] = "UNKNOWN_TOPIC_OR_PARTITION"
                continue
            if target is None:  # cancellation
                if tp in self._reassign:
                    del self._reassign[tp]
                    self._copies = [c for c in self._copies if c.tp != tp]
                    results[tp] = None
                else:
                    results[tp] = "NO_REASSIGNMENT_IN_PROGRESS"
                continue
            if any(b not in self._brokers for b in target):
                results[tp] = "INVALID_REPLICA_ASSIGNMENT"
                continue
            self._reassign[tp] = list(target)
            for b in target:
                if b not in info.replicas and not any(
                        c.tp == tp and c.dest_broker == b
                        for c in self._copies):
                    self._copies.append(_Copy(tp=tp, dest_broker=b,
                                              remaining_mb=info.size_mb))
            # Reorder-only (or already-caught-up) reassignments complete
            # immediately — Kafka applies them as pure metadata updates.
            if all(b in info.isr for b in target):
                self._finalize_reassignment(tp)
            results[tp] = None
        return results

    def elect_preferred_leaders(self, tps: list[tuple[str, int]]
                                ) -> dict[tuple[str, int], str | None]:
        self.num_leader_elections += 1
        results: dict[tuple[str, int], str | None] = {}
        for tp in tps:
            info = self._partitions.get(tp)
            if info is None:
                results[tp] = "UNKNOWN_TOPIC_OR_PARTITION"
                continue
            preferred = info.replicas[0]
            if preferred in info.isr and self._brokers[preferred].alive:
                info.leader = preferred
                results[tp] = None
            else:
                results[tp] = "PREFERRED_LEADER_NOT_AVAILABLE"
        return results

    def alter_replica_log_dirs(self, moves: dict[tuple[str, int, int], str]
                               ) -> dict[tuple[str, int, int], str | None]:
        results: dict[tuple[str, int, int], str | None] = {}
        for (t, p, b), logdir in moves.items():
            info = self._partitions.get((t, p))
            if info is None or b not in info.replicas:
                results[(t, p, b)] = "REPLICA_NOT_AVAILABLE"
                continue
            if logdir not in self._brokers[b].logdirs:
                results[(t, p, b)] = "LOG_DIR_NOT_FOUND"
                continue
            self._copies.append(_Copy(tp=(t, p), dest_broker=b,
                                      remaining_mb=info.size_mb,
                                      intra_target_logdir=logdir))
            results[(t, p, b)] = None
        return results

    def alter_broker_config(self, broker_id: int,
                            config: dict[str, str | None]) -> None:
        cfg = self._brokers[broker_id].config
        for k, v in config.items():
            if v is None:
                cfg.pop(k, None)
            else:
                cfg[k] = v

    def describe_broker_config(self, broker_id: int) -> dict[str, str]:
        return dict(self._brokers[broker_id].config)

    def alter_topic_config(self, topic: str,
                           config: dict[str, str | None]) -> None:
        cfg = self._topic_configs.setdefault(topic, {})
        for k, v in config.items():
            if v is None:
                cfg.pop(k, None)
            else:
                cfg[k] = v

    def describe_topic_config(self, topic: str) -> dict[str, str]:
        return dict(self._topic_configs.get(topic, {}))


class SimClock:
    """Deterministic clock whose ``sleep`` advances the simulated cluster —
    executor tests run in milliseconds of wall time."""

    def __init__(self, cluster: SimulatedKafkaCluster):
        self.cluster = cluster

    def now_ms(self) -> int:
        return self.cluster.now_ms

    def sleep_ms(self, ms: int) -> None:
        self.cluster.advance_to(self.cluster.now_ms + ms)
