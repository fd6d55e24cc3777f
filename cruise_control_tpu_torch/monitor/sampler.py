"""Metric sampler SPI + bundled implementations.

Ref ``monitor/sampling/MetricSampler.java`` (the pluggable interface),
``CruiseControlMetricsReporterSampler.java`` (consumes the agent's metrics
topic) and ``prometheus/PrometheusMetricSampler.java``. Here:

- :class:`MetricSampler` — the SPI (``get_samples(assignment, window)``);
- :class:`AgentTopicSampler` — consumes :class:`CruiseControlMetric` records
  produced by the L0 reporter agent into a :class:`MetricsTransport`
  (the stand-in for the ``__CruiseControlMetrics`` Kafka topic) and runs
  them through the processor — the default pipeline, matching the
  reference's reporter -> topic -> sampler -> processor flow;
- :class:`SyntheticWorkloadSampler` — samples a
  :class:`~cruise_control_tpu_torch.executor.simulated.SimulatedKafkaCluster`
  with a deterministic synthetic workload model (tests, demos, benches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Protocol

import numpy as np

from ..core.metricdef import BrokerMetric, KafkaMetric
from .samples import BrokerMetricSample, PartitionMetricSample


@dataclass
class SamplerAssignment:
    """Which partitions/brokers this sampler call covers (ref
    MetricFetcherManager splits the partition universe across fetchers)."""

    partitions: list[tuple[str, int]]
    brokers: list[int]
    start_ms: int
    end_ms: int


@dataclass
class Samples:
    """ref MetricSampler.Samples."""

    partition_samples: list[PartitionMetricSample]
    broker_samples: list[BrokerMetricSample]


class MetricSampler(Protocol):
    """SPI (ref MetricSampler.java:121).

    Implementations that can be called concurrently on disjoint partition
    shards (stateless scrapers, e.g. a Prometheus-style sampler) should set
    ``parallel_safe = True`` to let the fetcher manager fan out; samplers
    with cross-partition state must leave it False (the default) and
    receive the whole assignment in one call.
    """

    parallel_safe: bool = False

    def get_samples(self, assignment: SamplerAssignment) -> Samples: ...


class SyntheticWorkloadSampler:
    """Deterministic per-partition workload against a simulated cluster.

    Each partition gets a stable base rate drawn from its identity hash plus
    optional per-call jitter; broker metrics are derived by summing the
    leader/follower shares, so processor CPU attribution round-trips
    exactly in tests.
    """

    def __init__(self, cluster, *, base_bytes_in: float = 50.0,
                 fanout: float = 1.5, jitter: float = 0.0, seed: int = 0,
                 cpu_per_byte: float = 0.001,
                 broker_cpu_overrides: dict[int, float] | None = None):
        self.cluster = cluster
        self.base_bytes_in = base_bytes_in
        self.fanout = fanout
        self.jitter = jitter
        self.seed = seed
        self.cpu_per_byte = cpu_per_byte
        self.broker_cpu_overrides = broker_cpu_overrides or {}

    def _partition_rates(self, tp: tuple[str, int], end_ms: int):
        # crc32, not hash(): Python's str hash is salted per process, which
        # would make "deterministic" rates differ across restarts and break
        # sample-store replay consistency.
        import zlib
        digest = zlib.crc32(f"{self.seed}:{tp[0]}:{tp[1]}".encode())
        h = digest % 1000 / 1000.0
        rng = np.random.default_rng((digest + end_ms) % 2**31)
        wobble = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        bytes_in = self.base_bytes_in * (0.5 + h) * wobble
        bytes_out = bytes_in * self.fanout
        return bytes_in, bytes_out

    def get_samples(self, assignment: SamplerAssignment) -> Samples:
        infos = self.cluster.describe_partitions()
        t = assignment.end_ms
        psamples: list[PartitionMetricSample] = []
        by_broker_in: dict[int, float] = {}
        by_broker_out: dict[int, float] = {}
        by_broker_disk: dict[int, float] = {}
        for tp in assignment.partitions:
            info = infos.get(tp)
            if info is None:
                continue
            bytes_in, bytes_out = self._partition_rates(tp, t)
            s = PartitionMetricSample(tp[0], tp[1], t)
            s.record(KafkaMetric.LEADER_BYTES_IN, bytes_in)
            s.record(KafkaMetric.LEADER_BYTES_OUT, bytes_out)
            s.record(KafkaMetric.DISK_USAGE, info.size_mb)
            s.record(KafkaMetric.PRODUCE_RATE, bytes_in / 10.0)
            s.record(KafkaMetric.FETCH_RATE, bytes_out / 10.0)
            s.record(KafkaMetric.MESSAGE_IN_RATE, bytes_in / 100.0)
            s.record(KafkaMetric.REPLICATION_BYTES_IN_RATE,
                     bytes_in * max(len(info.replicas) - 1, 0))
            s.record(KafkaMetric.CPU_USAGE,
                     self.cpu_per_byte * (bytes_in + bytes_out))
            psamples.append(s)
            by_broker_in[info.leader] = by_broker_in.get(info.leader, 0.0) + bytes_in
            by_broker_out[info.leader] = (by_broker_out.get(info.leader, 0.0)
                                          + bytes_out)
            for b in info.replicas:
                by_broker_disk[b] = by_broker_disk.get(b, 0.0) + info.size_mb
                if b != info.leader:
                    by_broker_in[b] = by_broker_in.get(b, 0.0) + bytes_in
        bsamples: list[BrokerMetricSample] = []
        alive = self.cluster.describe_cluster()
        for b in assignment.brokers:
            if not alive.get(b, False):
                continue
            s = BrokerMetricSample(b, t)
            tot_in = by_broker_in.get(b, 0.0)
            tot_out = by_broker_out.get(b, 0.0)
            cpu = self.broker_cpu_overrides.get(
                b, self.cpu_per_byte * (tot_in + tot_out))
            s.record(BrokerMetric.CPU_USAGE, cpu)
            s.record(BrokerMetric.LEADER_BYTES_IN, tot_in)
            s.record(BrokerMetric.LEADER_BYTES_OUT, tot_out)
            s.record(BrokerMetric.DISK_USAGE, by_broker_disk.get(b, 0.0))
            metrics = self.cluster.broker_metrics(b)
            s.record(BrokerMetric.BROKER_LOG_FLUSH_TIME_MS_MEAN,
                     metrics.get("log_flush_time_ms", 0.0))
            bsamples.append(s)
        return Samples(psamples, bsamples)


class AgentTopicSampler:
    """Consume the L0 reporter agent's raw metric records and convert them to
    samples via the processor (ref CruiseControlMetricsReporterSampler.java:35
    polling the ``__CruiseControlMetrics`` topic at ``:93``).

    Parallel-safe via the two-phase protocol (the flagship ingestion path
    must fan out like the reference's fetcher threads,
    ``MetricFetcherManager.java:37``): the fetcher manager calls
    :meth:`prepare_round` once per round — one transport poll, one
    cross-broker fold in the processor — then ``get_samples`` per shard is
    a pure read over the prepared state, so N fetchers attribute N
    disjoint partition shards concurrently without double-counting broker
    or topic aggregates."""

    parallel_safe = True

    def __init__(self, transport, processor):
        self.transport = transport
        self.processor = processor
        self._round = None
        self._round_window: tuple[int, int] | None = None

    def prepare_round(self, start_ms: int, end_ms: int) -> None:
        records = self.transport.poll(start_ms, end_ms)
        self.processor.add_metrics(records)
        self._round = self.processor.prepare(start_ms, end_ms)
        self._round_window = (start_ms, end_ms)

    def get_samples(self, assignment: SamplerAssignment) -> Samples:
        window = (assignment.start_ms, assignment.end_ms)
        if self._round is None or self._round_window != window:
            # Direct (manager-less) use, or a window the manager never
            # prepared: ingest the window now (never serve a stale
            # round's samples) and emit with the single-shot contract
            # (all brokers; empty partition filter = everything).
            self.prepare_round(assignment.start_ms, assignment.end_ms)
            return self.processor.emit(self._round, assignment,
                                       include_brokers=True,
                                       empty_assignment_means_all=True)
        return self.processor.emit(self._round, assignment)
