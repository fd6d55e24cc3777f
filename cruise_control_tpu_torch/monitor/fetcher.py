"""Metric fetch fan-out (ref ``monitor/sampling/MetricFetcherManager.java:37``
and ``SamplingFetcher.java:31``).

Splits the partition universe into N shards and runs the sampler once per
shard — in a thread pool, like the reference's fetcher threads — then
funnels every shard's samples through the sample store and into the load
monitor's aggregators.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from .sampler import MetricSampler, SamplerAssignment, Samples
from .store import NoopSampleStore, SampleStore


class DefaultPartitionAssignor:
    """Splits the partition universe across fetcher shards (ref
    DefaultMetricSamplerPartitionAssignor — round-robin so every shard
    carries a representative topic mix). Pluggable via
    metric.sampler.partition.assignor.class."""

    def assign(self, partitions: list[tuple[str, int]],
               num_shards: int) -> list[list[tuple[str, int]]]:
        return [partitions[i::num_shards] for i in range(num_shards)]


class MetricFetcherManager:
    def __init__(self, sampler: MetricSampler, num_fetchers: int = 1,
                 store: SampleStore | None = None,
                 assignor: DefaultPartitionAssignor | None = None,
                 on_execution_store: SampleStore | None = None,
                 registry=None, max_retries: int = 0, tracer=None) -> None:
        from ..core.sensors import MetricRegistry
        from ..core.tracing import default_tracer
        self.tracer = tracer or default_tracer()
        self.sampler = sampler
        self.num_fetchers = max(1, num_fetchers)
        #: ref fetch.metric.samples.max.retry.count: transient sampler
        #: failures are retried this many times within one round before
        #: the round fails (each attempt still marks the failure meter).
        self.max_retries = max(0, max_retries)
        self.store = store or NoopSampleStore()
        self.assignor = assignor or DefaultPartitionAssignor()
        #: optional secondary store for samples taken during an ongoing
        #: execution (ref KafkaPartitionMetricSampleOnExecutionStore)
        self.on_execution_store = on_execution_store
        # ref the MetricFetcherManager sensor table (Sensors.md):
        # per-round fetch timer + failure rate.
        self.registry = registry or MetricRegistry()
        self._fetch_timer = self.registry.timer(
            "MetricFetcherManager.partition-samples-fetcher-timer")
        self._fetch_failures = self.registry.meter(
            "MetricFetcherManager.partition-samples-fetcher-failure-rate")

    def fetch(self, partitions: list[tuple[str, int]], brokers: list[int],
              start_ms: int, end_ms: int) -> Samples:
        """One sampling round across all shards (ref
        fetchMetricsFor... methods).

        Sharding only applies to samplers that declare ``parallel_safe``:
        samplers with cross-partition state (the agent-topic sampler's
        processor buffer, the synthetic sampler's per-broker sums) must see
        the whole assignment in one call or they would race / double-count.
        """
        with self._fetch_timer.time(), \
                self.tracer.span("monitor.fetch-samples",
                                 partitions=len(partitions),
                                 brokers=len(brokers)):
            for attempt in range(self.max_retries + 1):
                try:
                    merged = self._fetch(partitions, brokers, start_ms,
                                         end_ms)
                    break
                except Exception:
                    self._fetch_failures.mark()
                    if attempt == self.max_retries:
                        raise
            # Persistence sits OUTSIDE the retried section: a store
            # failure after a successful write must not re-store the
            # round (replay would double-count the window's load) — but
            # it still marks the failure meter (round failed either way).
            try:
                self.store.store_samples(merged)
                if self.on_execution_store is not None:
                    self.on_execution_store.store_samples(merged)
            except Exception:
                self._fetch_failures.mark()
                raise
            return merged

    def _fetch(self, partitions: list[tuple[str, int]], brokers: list[int],
               start_ms: int, end_ms: int) -> Samples:
        parallel_safe = getattr(self.sampler, "parallel_safe", False)
        n = self.num_fetchers if parallel_safe else 1
        # Two-phase samplers (the agent-topic path) isolate their
        # cross-partition state once per round so the per-shard calls
        # below are pure reads.
        prepare = getattr(self.sampler, "prepare_round", None)
        if prepare is not None:
            prepare(start_ms, end_ms)
        shard_parts = self.assignor.assign(partitions, n)
        shards = [SamplerAssignment(partitions=shard_parts[i],
                                    brokers=(brokers if i == 0 else []),
                                    start_ms=start_ms, end_ms=end_ms)
                  for i in range(n)]
        if n == 1:
            results = [self.sampler.get_samples(shards[0])]
        else:
            with ThreadPoolExecutor(max_workers=n) as pool:
                results = list(pool.map(self.sampler.get_samples, shards))
        merged = Samples([], [])
        for r in results:
            merged.partition_samples.extend(r.partition_samples)
            merged.broker_samples.extend(r.broker_samples)
        return merged
