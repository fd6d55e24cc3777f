"""The load monitor: metric ingestion -> cluster model factory (port of
``cruise_control_tpu/monitor/monitor.py``).

Rebuild of ``monitor/LoadMonitor.java:78``. Owns the partition/broker
windowed aggregators, the capacity resolver, and the metadata source (the
cluster admin client — same SPI the executor uses); ``cluster_model()``
(ref ``:439``) aggregates the retained windows, checks the caller's
completeness requirements, attributes per-replica loads, and flattens
everything into a ``FlatClusterModel`` on the port's device (the card
unless the caller asks for the CPU).

Window semantics: each partition's expected utilization is the mean over
its valid aggregated windows (the vectorized equivalent of
``Load.expectedUtilizationFor`` averaging ``AggregatedMetricValues`` rows);
the per-window arrays are preserved on the result for the /load endpoint
and for anomaly detection percentiles.

The host arrays the assemblers build are the reference's, bit for bit; on
the dense pipeline a :class:`~..model.resident.ResidentClusterState` turns
each build into a full upload, a delta scatter (KF) or a no-op. A device
mesh has no counterpart on one GPU (K15): ``mesh`` raises.
"""

from __future__ import annotations

import copy
import logging
import threading
from dataclasses import dataclass

import numpy as np

from ..core.aggregator import (AggregationGranularity, AggregationOptions,
                               Extrapolation, MetricSampleAggregator,
                               MetricSampleCompleteness,
                               NotEnoughValidWindowsError)
from ..core.metricdef import (KafkaMetric, broker_metric_def,
                              partition_metric_def)
from ..config.capacity import (BrokerCapacityConfigResolver,
                               FixedCapacityResolver)
from ..model.spec import BrokerSpec, ClusterSpec, PartitionSpec, flatten_spec
from ..utils.device import resolve_device
from .requirements import ModelCompletenessRequirements
from .sampler import Samples

LOG = logging.getLogger(__name__)


class NotEnoughValidWindowsException(NotEnoughValidWindowsError):
    """Alias with the reference's exception name."""


class StaleClusterModelError(NotEnoughValidWindowsException):
    """An executing (non-dryrun) operation would act on a stale-served
    model: the topology it describes predates the sample dropout, so
    reassignments computed from it may target dead brokers or undo
    post-cache changes. Dryrun/read paths serve stale models flagged;
    execution refuses them (``KafkaCruiseControl.allow_stale_execution``
    overrides)."""


@dataclass
class MonitorConfig:
    """Subset of MonitorConfig constants (ref config/constants/MonitorConfig:
    num.partition.metrics.windows=5, partition.metrics.window.ms=3600000,
    min.samples.per.partition.metrics.window=1, broker variants)."""

    num_windows: int = 5
    window_ms: int = 3_600_000
    min_samples_per_window: int = 1
    num_broker_windows: int = 20
    broker_window_ms: int = 300_000
    min_samples_per_broker_window: int = 1
    max_allowed_extrapolations_per_partition: int = 5
    max_allowed_extrapolations_per_broker: int = 5
    #: follower CPU as a fraction of the leader's attributed CPU (ref
    #: ModelUtils leader/follower CPU estimation).
    follower_cpu_ratio: float = 0.5
    #: default completeness floor for cluster_model() calls that pass no
    #: explicit requirements (ref min.valid.partition.ratio; the served
    #: path wires the config value — 0.95 — while direct library
    #: construction keeps 0.0 so toy models stay buildable).
    min_valid_partition_ratio: float = 0.0
    #: monitor.dense.pipeline: build the cluster model through the dense
    #: whole-pool path (one [E, M, W] aggregation + whole-array flat-model
    #: gathers). False selects the retained per-entity reference path —
    #: kept for parity testing, not for production scale.
    dense_pipeline: bool = True
    #: graceful degradation under sample dropouts (ref
    #: monitor.serve.stale.on.incomplete): when the live window history
    #: no longer meets completeness, serve the last good model — flagged
    #: ``stale`` and metered — instead of failing every proposal path.
    #: Library default False (toy models should fail loudly); the served
    #: stack wires the config key (default True).
    serve_stale_on_incomplete: bool = False
    #: how old a cached model may get before stale-serving gives up and
    #: the completeness error propagates after all (ref
    #: monitor.max.stale.model.age.ms)
    max_stale_model_age_ms: int = 3_600_000
    #: monitor.resident.state: keep the canonical cluster model resident
    #: on device and apply metric-only cycles as compact delta scatters
    #: (model/resident.py); structural changes bump the resident epoch
    #: and fall back to one full rebuild + upload. Dense-pipeline only —
    #: the per-entity reference path always uploads in full.
    resident_state: bool = True
    #: partition-axis pad multiple (model.partition.pad.multiple): the
    #: padded partition count is the next multiple of this, trading
    #: recompiles on partition churn against padded-row HBM waste. At 1M
    #: partitions a coarse (e.g. power-of-two) bucket can waste near 2x
    #: device memory, so the multiple is an explicit knob with a
    #: padding-waste budget watching it (docs/scaling.md).
    partition_pad_multiple: int = 128
    #: broker-axis pad multiple (model.broker.pad.multiple).
    broker_pad_multiple: int = 8


@dataclass
class LoadMonitorState:
    """Serialized into /state (ref LoadMonitorState.java)."""

    state: str
    num_valid_windows: int
    num_total_windows: int
    valid_partition_ratio: float
    num_monitored_partitions: int
    generation: int

    def to_json(self) -> dict:
        return {"state": self.state,
                "numValidWindows": self.num_valid_windows,
                "numTotalWindows": self.num_total_windows,
                "validPartitionsRatio": self.valid_partition_ratio,
                "numMonitoredPartitions": self.num_monitored_partitions,
                "generation": self.generation}


class ClusterModelResult:
    """A flattened model + everything the API layers want alongside it.

    On the dense pipeline, ``spec`` (the per-partition object graph) and
    ``partition_windows`` are built lazily on first access: the serving
    path (optimizer) consumes only the flat arrays, while the object
    consumers (/partition_load, spec mutators, tests) pay the O(P) Python
    cost only when they actually ask.
    """

    def __init__(self, model, metadata, completeness, window_times_ms,
                 generation, *, spec: ClusterSpec | None = None,
                 spec_factory=None,
                 partition_windows: dict | None = None,
                 partition_windows_factory=None):
        #: True when this result was served from the monitor's last-good
        #: cache because the live history missed completeness (sample
        #: dropouts) — consumers may act on it but should surface the flag
        self.stale = False
        #: non-None marks a HYPOTHETICAL result (a what-if scenario
        #: transform of the live model, labeled with the scenario name).
        #: Scenario results must never reach live-cluster consumers: the
        #: proposal cache rejects them outright (ProposalCache.store /
        #: _compute). The monitor itself always emits None here.
        self.scenario_label: str | None = None
        self.model = model                  # FlatClusterModel
        self.metadata = metadata            # ClusterMetadata
        self.completeness = completeness
        self.window_times_ms = window_times_ms
        self.generation = generation
        self._spec = spec
        self._spec_factory = spec_factory
        self._partition_windows = partition_windows
        self._partition_windows_factory = partition_windows_factory

    @property
    def spec(self) -> ClusterSpec:
        if self._spec is None:
            self._spec = self._spec_factory()
        return self._spec

    @property
    def partition_windows(self) -> dict[tuple[str, int], np.ndarray]:
        """(topic, partition) -> [num_metrics, num_windows] window values."""
        if self._partition_windows is None:
            self._partition_windows = self._partition_windows_factory()
        return self._partition_windows


class LoadMonitor:
    """ref LoadMonitor.java:78."""

    def __init__(self, admin, config: MonitorConfig | None = None,
                 capacity_resolver: BrokerCapacityConfigResolver | None = None,
                 rack_by_broker: dict[int, str] | None = None,
                 broker_set_resolver=None,
                 max_concurrent_model_builds: int = 2,
                 registry=None, tracer=None, collector=None,
                 admin_retry=None, sleep_ms=None, now_ms=None,
                 mesh=None, device=None) -> None:
        from ..core.runtime_obs import default_collector
        from ..core.sensors import (LOAD_MONITOR_SENSOR, MetricRegistry)
        from ..core.tracing import default_tracer
        self.admin = admin
        self.config = config or MonitorConfig()
        self.capacity_resolver = capacity_resolver or FixedCapacityResolver()
        self.rack_by_broker = rack_by_broker or {}
        #: optional BrokerSetResolver feeding BrokerSetAwareGoal
        self.broker_set_resolver = broker_set_resolver
        #: span tracer (None = process default): cluster_model() emits
        #: nested monitor.cluster-model → monitor.aggregate →
        #: monitor.model-build spans
        self.tracer = tracer or default_tracer()
        #: device-runtime ledger (None = process default): every dense
        #: model build feeds padding-waste ratios host-side (zero device
        #: syncs — the counts are known before the upload), and the model
        #: upload itself is metered in FlatClusterModel.from_numpy.
        self.collector = collector or default_collector()
        c = self.config
        self.partition_aggregator = MetricSampleAggregator(
            c.num_windows, c.window_ms, c.min_samples_per_window,
            partition_metric_def(), entity_group_fn=lambda tp: tp[0],
            tracer=self.tracer)
        self.broker_aggregator = MetricSampleAggregator(
            c.num_broker_windows, c.broker_window_ms,
            c.min_samples_per_broker_window, broker_metric_def(),
            tracer=self.tracer)
        #: bounds concurrent model builds (ref the model-generation
        #: semaphore LoadMonitor.java:94,396); thread-safety of ingest lives
        #: inside MetricSampleAggregator's own lock.
        self._model_semaphore = threading.Semaphore(max_concurrent_model_builds)
        #: optional shared RetryPolicy for the admin reads inside model
        #: builds (serve.py wires the admin.retry.* policy; the chaos
        #: harness passes its engine clock) — None = single attempt, the
        #: library default, so toy stacks keep exact-call semantics.
        self._admin_retry = admin_retry
        self._admin_sleep_ms = sleep_ms
        #: clock the retry policy's overall deadline budget is measured
        #: on (admin.retry.deadline.ms) — the chaos harness passes its
        #: engine clock alongside the engine sleep so deadline cuts
        #: replay byte-identically.
        self._admin_now_ms = now_ms
        self.registry = registry or MetricRegistry()
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh has no counterpart on one GPU (K15); pass "
                "device= instead")
        #: where models are built: None = the card (raises without CUDA),
        #: "cpu" only when asked
        self.device = resolve_device(device)
        from ..model.resident import ResidentClusterState
        #: device-resident model state (None when disabled or on the
        #: reference pipeline): the dense assembler routes every build
        #: through it so metric-only cycles become delta scatters instead
        #: of full uploads. Sensors land on this monitor's registry
        #: (``ResidentState.*``).
        self.resident = (
            ResidentClusterState(registry=self.registry,
                                 collector=self.collector,
                                 tracer=self.tracer, device=self.device)
            if (c.resident_state and c.dense_pipeline) else None)
        #: replication opt-in (facade.attach_replication_channel): when
        #: the local sample history cannot satisfy a model build, serve
        #: the stream-fed resident model instead of failing the read —
        #: the follower serving path (:meth:`_serve_resident`).
        self.serve_from_resident = False
        # ref LoadMonitor.java:101 cluster-model-creation-timer; the
        # valid-windows / monitored-partitions gauges mirror
        # LoadMonitor.java:104-110 sensor registrations.
        self._model_timer = self.registry.timer(MetricRegistry.name(
            LOAD_MONITOR_SENSOR, "cluster-model-creation-timer"))
        self.registry.gauge(
            MetricRegistry.name(LOAD_MONITOR_SENSOR,
                                "total-monitored-windows"),
            self.partition_aggregator.num_available_windows)
        self.registry.gauge(
            MetricRegistry.name(LOAD_MONITOR_SENSOR,
                                "num-monitored-partitions"),
            lambda: len(self.partition_aggregator.all_entities()))
        # Stale-model degradation bookkeeping: the last successfully-built
        # result (timestamped) + visibility for served-stale events.
        self._last_good: tuple[int, ClusterModelResult] | None = None
        self._last_model_stale = False
        self._stale_served = self.registry.meter(MetricRegistry.name(
            LOAD_MONITOR_SENSOR, "stale-models-served"))
        self._admin_retries = self.registry.meter(MetricRegistry.name(
            LOAD_MONITOR_SENSOR, "admin-retry-rate"))
        #: structural model-validation issues observed at build time
        #: (model.flat.validation_issue_counts over the pre-upload numpy
        #: arrays) — marked per issue so a corrupted admin snapshot shows
        #: on /metrics instead of living in a dict only tests read.
        self._validation_issues = self.registry.meter(MetricRegistry.name(
            LOAD_MONITOR_SENSOR, "flat-model-validation-issues"))
        self.registry.gauge(
            MetricRegistry.name(LOAD_MONITOR_SENSOR, "last-model-stale"),
            lambda: int(self._last_model_stale))
        # Remaining rows of the documented LoadMonitor sensor catalog
        # (Sensors.md): topology health derived from ONE short-TTL admin
        # snapshot per scrape — describe_partitions is O(P x replicas)
        # against a real cluster, and a /metrics read hits all four
        # gauges back-to-back.
        self._topology_cache: tuple[float, dict] | None = None
        for sensor in ("num-topics", "brokers-with-replicas",
                       "dead-brokers-with-replicas",
                       "has-partitions-with-isr-greater-than-replicas"):
            self.registry.gauge(
                MetricRegistry.name(LOAD_MONITOR_SENSOR, sensor),
                (lambda key=sensor: self._topology_snapshot()[key]))

    def _admin_read(self, fn):
        """Admin reads inside model builds ride the shared retry policy
        when one is wired (serve.py / chaos harness): a transient timeout
        on describe_partitions must not fail a whole proposal path.
        Retries are metered (`admin-retry-rate`) and logged; without a
        policy the call is a plain single attempt."""
        if self._admin_retry is None:
            return fn()
        from ..executor.kafka_admin import RETRYABLE_ADMIN_ERRORS

        def on_retry(attempt, delay_ms, exc):
            self._admin_retries.mark()
            LOG.warning(
                "monitor admin read %s failed transiently (%s: %s); "
                "retry %d in %d ms", fn.__name__, type(exc).__name__, exc,
                attempt + 1, delay_ms)
        return self._admin_retry.call(fn, retry_on=RETRYABLE_ADMIN_ERRORS,
                                      sleep_ms=self._admin_sleep_ms,
                                      now_ms=self._admin_now_ms,
                                      on_retry=on_retry)

    def _topology_snapshot(self, ttl_s: float = 5.0) -> dict:
        import time as _time
        now = _time.monotonic()
        if self._topology_cache is not None:
            stamp, snap = self._topology_cache
            if now - stamp < ttl_s:
                return snap
        parts = self.admin.describe_partitions()
        alive = self.admin.describe_cluster()
        hosting = {b for info in parts.values() for b in info.replicas}
        snap = {
            "num-topics": len({t for t, _p in parts}),
            "brokers-with-replicas": len(hosting),
            "dead-brokers-with-replicas": sum(
                1 for b in hosting if not alive.get(b, False)),
            # The documented semantics: MORE ISR entries than replicas
            # (a metadata anomaly), not "ISR outside the replica list".
            "has-partitions-with-isr-greater-than-replicas": int(any(
                len(info.isr) > len(info.replicas)
                for info in parts.values())),
        }
        self._topology_cache = (now, snap)
        return snap

    # -------------------------------------------------------------- ingest
    @staticmethod
    def _ingest_batch(aggregator: MetricSampleAggregator, samples) -> None:
        """One vectorized ingest per batch: one lock acquisition and one
        scatter instead of a per-sample add loop (the dense path of
        ``add_samples_dense``, bit-identical to scalar ingest)."""
        if not samples:
            return
        if len(samples) == 1:
            aggregator.add_sample(samples[0].to_aggregator_sample())
            return
        num_metrics = aggregator.num_metrics
        values = np.full((len(samples), num_metrics), np.nan)
        times = np.empty(len(samples), np.int64)
        entities = []
        for i, s in enumerate(samples):
            entities.append(s.entity)
            times[i] = s.time_ms
            for metric_id, value in s.values.items():
                values[i, metric_id] = value
        aggregator.add_samples_dense(entities, times, values)

    def add_samples(self, samples: Samples) -> None:
        self._ingest_batch(self.partition_aggregator,
                           samples.partition_samples)
        self._ingest_batch(self.broker_aggregator, samples.broker_samples)

    @property
    def generation(self) -> int:
        """Model generation: bumps when aggregation windows roll (the
        proposal cache's staleness key, ref ModelGeneration)."""
        return self.partition_aggregator.generation

    def seed_generation(self, generation: int) -> None:
        """Snapshot restore: resume the pre-crash generation numbering
        (monotonic raise — see MetricSampleAggregator.seed_generation)
        so the restored proposal cache is generation-valid until real
        sample ingest rolls a window."""
        self.partition_aggregator.seed_generation(generation)

    def retain_current_topology(self) -> None:
        """Drop aggregator state for partitions no longer in the cluster
        (ref LoadMonitor's aggregator cleaner :813)."""
        tps = set(self.admin.describe_partitions())
        self.partition_aggregator.retain_entities(tps)
        self.broker_aggregator.retain_entities(
            set(self.admin.describe_cluster()))

    # --------------------------------------------------------------- reads
    def meets_completeness_requirements(
            self, requirements: ModelCompletenessRequirements,
            now_ms: int) -> bool:
        """ref LoadMonitor.meetCompletenessRequirements (:655)."""
        try:
            completeness = self._aggregate(now_ms, requirements).completeness
        except NotEnoughValidWindowsError:
            return False
        return requirements.met_by(completeness)

    def state(self, now_ms: int) -> LoadMonitorState:
        try:
            result = self._aggregate(
                now_ms, ModelCompletenessRequirements(min_required_num_windows=0))
            valid_ratio = result.completeness.valid_entity_ratio
            valid_windows = len(result.completeness.valid_windows)
        except NotEnoughValidWindowsError:
            valid_ratio, valid_windows = 0.0, 0
        return LoadMonitorState(
            state="RUNNING",
            num_valid_windows=valid_windows,
            num_total_windows=self.partition_aggregator.num_available_windows(),
            valid_partition_ratio=valid_ratio,
            num_monitored_partitions=len(
                self.partition_aggregator.all_entities()),
            generation=self.generation)

    def _aggregate(self, now_ms: int,
                   requirements: ModelCompletenessRequirements,
                   partitions=None):
        interested = set(partitions if partitions is not None
                         else self.admin.describe_partitions())
        options = AggregationOptions(
            min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
            min_valid_windows=requirements.min_required_num_windows,
            max_allowed_extrapolations_per_entity=
                self.config.max_allowed_extrapolations_per_partition,
            granularity=(AggregationGranularity.ENTITY_GROUP
                         if requirements.include_all_topics
                         else AggregationGranularity.ENTITY),
            interested_entities=interested)
        return self.partition_aggregator.aggregate(
            0, now_ms, options, use_dense=self.config.dense_pipeline)

    def cluster_model(self, now_ms: int,
                      requirements: ModelCompletenessRequirements | None = None,
                      *, populate_replica_placement_only: bool = False
                      ) -> ClusterModelResult:
        """Build the flattened cluster model (ref LoadMonitor.clusterModel
        :439). Raises NotEnoughValidWindowsError when the sample history
        cannot satisfy ``requirements``."""
        requirements = requirements or ModelCompletenessRequirements(
            min_monitored_partitions_percentage=(
                self.config.min_valid_partition_ratio))
        with self._model_semaphore, self._model_timer.time(), \
                self.tracer.span("monitor.cluster-model") as sp:
            try:
                result = self._build_model(now_ms, requirements,
                                           populate_replica_placement_only)
            except NotEnoughValidWindowsException:
                stale = self._serve_stale(now_ms, requirements)
                if stale is None:
                    stale = self._serve_resident(now_ms, requirements)
                if stale is None:
                    raise
                sp.set(stale=True,
                       generation=stale.generation)
                return stale
            # Window contents stay "valid" no matter how old they are (the
            # aggregator only rolls on ingest), so completeness alone
            # cannot see a total sample dropout — age the history against
            # the clock as well.
            result.stale = self._history_is_stale(now_ms)
            self._last_model_stale = result.stale
            if result.stale:
                self._stale_served.mark()
                LOG.warning(
                    "sample history has fallen behind the clock at t=%d "
                    "(newest window end %s); serving stale-flagged model",
                    now_ms, self._newest_window_end_ms())
            elif not populate_replica_placement_only:
                # Placement-only models skip load data; caching one would
                # degrade a later stale serve to zero loads silently.
                self._last_good = (now_ms, result)
            sp.set(partitions=len(result.metadata.partition_keys),
                   generation=result.generation)
            return result

    @property
    def last_model_stale(self) -> bool:
        """Whether the most recently served model was stale-flagged (the
        ``last-model-stale`` gauge)."""
        return self._last_model_stale

    def history_stale(self, now_ms: int) -> bool:
        """Whether live sample flow is broken right now (newest completed
        window ended more than two windows ago). The facade's execution
        gate asks this at execution time: a total dropout freezes the
        model generation, so cached proposals can stay generation-valid
        without any model build ever flagging staleness."""
        return self._history_is_stale(now_ms)

    def _newest_window_end_ms(self) -> int | None:
        times = self.partition_aggregator.available_window_times()
        return max(times) + self.config.window_ms if times else None

    def _history_is_stale(self, now_ms: int) -> bool:
        """True when the newest completed partition window ended more than
        TWO full windows before ``now_ms`` — i.e. at least two whole
        windows of samples never arrived. One missed window is scheduling
        jitter (a slow sampling round, a compile pause); two is a real
        dropout/fetcher outage."""
        newest_end = self._newest_window_end_ms()
        return (newest_end is not None
                and now_ms - newest_end > 2 * self.config.window_ms)

    def _serve_stale(self, now_ms: int,
                     requirements: ModelCompletenessRequirements,
                     ) -> ClusterModelResult | None:
        """Graceful degradation on sample dropouts: hand back the last
        good model — flagged ``stale``, metered, logged — instead of
        failing the caller, for as long as the cache stays inside
        ``max_stale_model_age_ms`` AND the cached model satisfies the
        caller's completeness requirements (a strict-requirements request
        must not be answered by a cache built under weaker ones). Returns
        None otherwise (the completeness error then propagates as
        before)."""
        if not self.config.serve_stale_on_incomplete \
                or self._last_good is None:
            return None
        built_ms, result = self._last_good
        if now_ms - built_ms > self.config.max_stale_model_age_ms:
            return None
        if not requirements.met_by(result.completeness):
            return None
        LOG.warning(
            "sample history below completeness at t=%d; serving stale "
            "model built at t=%d (age %d ms, generation %d)", now_ms,
            built_ms, now_ms - built_ms, result.generation)
        self._stale_served.mark()
        self._last_model_stale = True
        # Flag a shallow copy: the cached object may still be held by a
        # caller who received it fresh — never flip .stale under them.
        result = copy.copy(result)
        result.stale = True
        return result

    def _serve_resident(self, now_ms: int,
                        requirements) -> "ClusterModelResult | None":
        """Follower serving path (core/replication.py): a stream-fed
        replica has NO local sample history — the replicated
        device-resident model is its serving state. Build the structural
        planes from the local admin view (placement-only: zero-load,
        resident mirrors untouched) and substitute the resident model's
        arrays, so /load, /partition_load and friends serve the
        leader's streamed numbers. The result is stale-flagged: reads
        are bounded by the replication staleness contract instead of
        local completeness, and the stale-execution gate keeps refusing
        to ACT on it. Assumes leader and replica watch the SAME cluster
        (identical sorted partition keys — true by construction for
        replicas of one serving plane); a topology drift shows up as a
        shape mismatch and falls through to the completeness error."""
        res = self.resident
        if not self.serve_from_resident or res is None \
                or res.model is None:
            return None
        try:
            result = self._build_model(now_ms, requirements, True)
        except Exception:
            return None
        model = res.model
        if (tuple(model.replica_broker.shape)
                != tuple(result.model.replica_broker.shape)):
            LOG.warning(
                "resident-serve refused: replicated model shape %s != "
                "local admin-derived shape %s (topology drift?)",
                tuple(model.replica_broker.shape),
                tuple(result.model.replica_broker.shape))
            return None
        result.model = model
        # Patch the replicated loads into the lazy spec view: without
        # this, /partition_load and other spec consumers would read the
        # placement-only build's zero loads.
        base_factory = result._spec_factory

        def patched_spec():
            spec = base_factory()
            lead = model.leader_load.cpu().numpy()
            foll = model.follower_load.cpu().numpy()
            for i, p in enumerate(spec.partitions):
                p.leader_load = tuple(float(x) for x in lead[i])
                p.follower_load = tuple(float(x) for x in foll[i])
            return spec

        result._spec_factory = patched_spec
        result._spec = None
        result.stale = True
        self._stale_served.mark()
        self._last_model_stale = True
        LOG.debug("serving resident-backed model (replication follower "
                  "path): generation %d, epoch %d", result.generation,
                  res.epoch)
        return result

    def _build_model(self, now_ms, requirements, placement_only):
        partitions = self._admin_read(self.admin.describe_partitions)
        alive = self._admin_read(self.admin.describe_cluster)
        result = None
        if not placement_only:
            with self.tracer.span("monitor.aggregate"):
                try:
                    result = self._aggregate(now_ms, requirements,
                                             partitions)
                except NotEnoughValidWindowsError as e:
                    raise NotEnoughValidWindowsException(str(e)) from None
            if not requirements.met_by(result.completeness):
                raise NotEnoughValidWindowsException(
                    f"completeness {result.completeness.valid_entity_ratio:.2f} "
                    f"/ {len(result.completeness.valid_windows)} windows does "
                    f"not meet {requirements}")

        offline_dirs_fn = getattr(self.admin, "offline_logdirs", None)
        offline_dirs = offline_dirs_fn() if offline_dirs_fn is not None else {}
        brokers: list[BrokerSpec] = []
        for broker_id, is_alive in sorted(alive.items()):
            rack = self.rack_by_broker.get(broker_id, f"rack-{broker_id}")
            cap = self.capacity_resolver.capacity_for_broker(
                rack, f"host-{broker_id}", broker_id)
            broker_set = (self.broker_set_resolver.broker_set_for(broker_id)
                          if self.broker_set_resolver is not None else None)
            brokers.append(BrokerSpec(
                broker_id=broker_id, rack=rack, capacity=cap.as_vector(),
                alive=is_alive, broker_set=broker_set,
                broken_disk=bool(offline_dirs.get(broker_id))))

        # Per-replica offline marks beyond dead brokers (failed logdirs) —
        # ref Replica.isCurrentOffline covering bad-disk replicas.
        offline_fn = getattr(self.admin, "offline_replicas", None)
        extra_offline = offline_fn() if offline_fn is not None else set()
        dense = self.config.dense_pipeline and (result is None
                                                or result.dense is not None)
        with self.tracer.span("monitor.model-build", dense=dense):
            if dense:
                return self._assemble_dense(partitions, alive, brokers,
                                            result, extra_offline)
            return self._assemble_reference(partitions, alive, brokers,
                                            result, extra_offline)

    def _assemble_reference(self, partitions, alive, brokers, result,
                            extra_offline) -> ClusterModelResult:
        """The retained per-partition reference assembler (spec objects +
        flatten_spec), used when ``dense_pipeline`` is off and by the
        dense result's lazy ``spec`` property."""
        pspecs, windows, window_times = self._partition_specs(
            partitions, alive, result, extra_offline)
        spec = ClusterSpec(brokers=brokers, partitions=pspecs)
        model, metadata = flatten_spec(
            spec,
            partition_pad_multiple=self.config.partition_pad_multiple,
            broker_pad_multiple=self.config.broker_pad_multiple,
            device=self.device)
        # Padding accounting from shape metadata + the spec (no device
        # read); the structural-issue meter lives on the dense path only.
        self.collector.observe_padding(
            partitions=len(metadata.partition_keys),
            partitions_padded=model.num_partitions_padded,
            brokers=len(metadata.broker_ids),
            brokers_padded=model.num_brokers_padded,
            replica_slots_used=sum(len(p.replicas) for p in pspecs),
            replica_slots_total=(model.num_partitions_padded
                                 * model.max_replication_factor))
        return ClusterModelResult(
            model=model, metadata=metadata,
            completeness=(result.completeness if result is not None
                          else MetricSampleCompleteness(
                              generation=self.generation)),
            window_times_ms=window_times, generation=self.generation,
            spec=spec, partition_windows=windows)

    def _partition_specs(self, partitions, alive, result, extra_offline):
        """Per-partition object-graph population (ref LoadMonitor
        clusterModel's createReplica/setReplicaLoad walk)."""
        c = self.config
        pspecs: list[PartitionSpec] = []
        windows: dict[tuple[str, int], np.ndarray] = {}
        window_times: list[int] = []
        for tp, info in sorted(partitions.items()):
            leader_load = (0.0, 0.0, 0.0, float(info.size_mb))
            follower_load = None
            if result is not None:
                vae = result.entity_values.get(tp)
                valid_cols = [j for j, e in enumerate(vae.extrapolations)
                              if e is not Extrapolation.NO_VALID_EXTRAPOLATION
                              ] if vae is not None else []
                if vae is not None and valid_cols:
                    windows[tp] = vae.values
                    window_times = vae.window_times_ms
                    # Per-metric ValueComputingStrategy (ref
                    # KafkaMetricDef.java:43-46 + ModelUtils.java:162
                    # expectedUtilizationFor): CPU/NW_IN/NW_OUT are the AVG
                    # over valid windows; DISK is the LATEST valid window —
                    # disk usage is a level, not a rate, so averaging old
                    # windows would understate a growing partition and hide
                    # a burst from the capacity goals. Valid windows only —
                    # invalid windows are zero-filled columns that would
                    # silently dilute the load.
                    mean = vae.values[:, valid_cols].mean(axis=1)
                    latest = vae.values[:, valid_cols[-1]]
                    cpu = float(mean[KafkaMetric.CPU_USAGE])
                    nw_in = float(mean[KafkaMetric.LEADER_BYTES_IN])
                    nw_out = float(mean[KafkaMetric.LEADER_BYTES_OUT])
                    disk = float(latest[KafkaMetric.DISK_USAGE])
                    leader_load = (cpu, nw_in, nw_out, disk)
                    follower_load = (cpu * c.follower_cpu_ratio, nw_in, 0.0,
                                     disk)
            offline = [b for b in info.replicas
                       if not alive.get(b, False)
                       or (tp[0], tp[1], b) in extra_offline]
            # Slot 0 of the flat model is the leader positionally; the admin
            # tracks leadership separately and it diverges from replicas[0]
            # after failover/elections — reorder leader-first.
            replicas = list(info.replicas)
            if info.leader in replicas and replicas[0] != info.leader:
                replicas = [info.leader,
                            *[b for b in replicas if b != info.leader]]
            pspecs.append(PartitionSpec(
                topic=tp[0], partition=tp[1], replicas=replicas,
                leader_load=leader_load, follower_load=follower_load,
                offline_replicas=offline,
                # The admin's stored order IS Kafka's preferred order; when
                # the current leader drifted from it, PLE can now see that.
                preferred_replicas=list(info.replicas)))
        return pspecs, windows, window_times

    def _assemble_dense(self, partitions, alive, brokers, result,
                        extra_offline) -> ClusterModelResult:
        """Whole-array flat-model construction (the dense pipeline).

        One fused pass extracts partition attributes from the admin's
        object graph into flat arrays; replica placement, leader-first
        rotation, offline marks, and expected-utilization loads are then
        whole-array operations — the loads gathered straight from the
        ``DenseAggregate`` cube instead of E ``entity_values`` lookups.
        ``spec`` / ``partition_windows`` stay available as lazy views.
        """
        from ..model.flat import FlatClusterModel
        from ..model.spec import _round_up, flatten_brokers

        c = self.config
        ba = flatten_brokers(brokers,
                             broker_pad_multiple=c.broker_pad_multiple)
        bindex = ba.broker_index
        Bpad = ba.padded
        keys = sorted(partitions)
        P = len(keys)
        infos = [partitions[k] for k in keys]

        rep_counts = np.fromiter((len(i.replicas) for i in infos),
                                 np.int64, P)
        total = int(rep_counts.sum())
        try:
            rep_idx = np.fromiter((bindex[b] for i in infos
                                   for b in i.replicas), np.int64, total)
        except KeyError as e:
            raise ValueError(
                f"partition references unknown broker {e.args[0]}"
            ) from None
        leader_idx = np.fromiter((bindex.get(i.leader, -1) for i in infos),
                                 np.int64, P)
        sizes = np.fromiter((i.size_mb for i in infos), np.float64, P)
        topic_index: dict[str, int] = {}
        ptopic_real = np.fromiter(
            (topic_index.setdefault(t, len(topic_index)) for t, _ in keys),
            np.int64, P)
        partition_index = {k: i for i, k in enumerate(keys)}

        R = max(int(rep_counts.max()) if P else 1, 1)
        Ppad = _round_up(P, c.partition_pad_multiple)
        sentinel = Bpad
        rb = np.full((Ppad, R), sentinel, np.int32)
        if total:
            rep_rows = np.repeat(np.arange(P), rep_counts)
            starts = np.concatenate(([0], np.cumsum(rep_counts)[:-1]))
            rep_cols = np.arange(total) - np.repeat(starts, rep_counts)
            rb[rep_rows, rep_cols] = rep_idx
            srt = np.sort(rb[:P], axis=1)
            dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < sentinel)
            bad = np.nonzero(dup.any(axis=1))[0]
            if bad.size:
                raise ValueError(
                    f"partition {keys[int(bad[0])]}: duplicate replica "
                    "brokers")

        # Slot 0 is the leader positionally; leadership diverges from
        # replicas[0] after failover — rotate leader-first, preserving
        # the followers' relative (= preferred) order.
        pref_pos = np.tile(np.arange(R, dtype=np.int32), (Ppad, 1))
        if P:
            is_lead = rb[:P] == leader_idx[:, None]
            pos = is_lead.argmax(axis=1)
            rot = is_lead.any(axis=1) & (pos != 0)
            rrows = np.nonzero(rot)[0]
            if rrows.size:
                idx = np.arange(R)[None, :]
                src = np.where((idx >= 1) & (idx <= pos[rrows, None]),
                               idx - 1, idx)
                rb[rrows] = np.take_along_axis(rb[rrows], src, axis=1)
                rb[rrows, 0] = leader_idx[rrows]
                psrc = src.astype(np.int32)
                psrc[:, 0] = pos[rrows]
                pref_pos[rrows] = psrc

        alive_ext = np.append(ba.alive, True)    # sentinel slot never offline
        offline = np.zeros((Ppad, R), bool)
        if P:
            offline[:P] = (rb[:P] < sentinel) & ~alive_ext[rb[:P]]
        for (t, pi, b) in extra_offline:
            row = partition_index.get((t, pi))
            bi = bindex.get(b)
            if row is None or bi is None:
                continue
            offline[row, rb[row] == bi] = True

        # Loads: expected utilization per partition by whole-array gathers
        # from the dense aggregate (AVG over valid windows for CPU/NW,
        # LATEST valid window for DISK — see _partition_specs for the
        # per-metric ValueComputingStrategy rationale).
        lead_np = np.zeros((P, 4))
        lead_np[:, 3] = sizes
        foll_np = None
        window_times: list[int] = []
        d = result.dense if result is not None else None
        if d is not None and d.window_times_ms and P:
            no_valid = Extrapolation.NO_VALID_EXTRAPOLATION.value
            hv = (d.extrapolations != no_valid).any(axis=1)
            erow = np.fromiter((d.row_index.get(k, -1) for k in keys),
                               np.int64, P)
            er = np.where(erow >= 0, erow, 0)
            validw = (d.extrapolations[er] != no_valid) & (erow >= 0)[:, None]
            nval = validw.sum(axis=1)
            has = nval > 0
            vals = d.values[er]                               # [P, M, W]
            mean = ((vals * validw[:, None, :]).sum(axis=2)
                    / np.maximum(nval, 1)[:, None])
            Wn = d.extrapolations.shape[1]
            last = Wn - 1 - np.argmax(validw[:, ::-1], axis=1)
            latest = np.take_along_axis(
                vals, last[:, None, None], axis=2)[:, :, 0]
            cpu = np.where(has, mean[:, KafkaMetric.CPU_USAGE], 0.0)
            nw_in = np.where(has, mean[:, KafkaMetric.LEADER_BYTES_IN], 0.0)
            nw_out = np.where(has, mean[:, KafkaMetric.LEADER_BYTES_OUT],
                              0.0)
            disk = np.where(has, latest[:, KafkaMetric.DISK_USAGE], sizes)
            lead_np = np.column_stack([cpu, nw_in, nw_out, disk])
            foll_np = np.column_stack([cpu * c.follower_cpu_ratio, nw_in,
                                       np.zeros(P), disk])
            if hv.any():
                window_times = d.window_times_ms
        if foll_np is None:
            foll_np = lead_np.copy()
            foll_np[:, 0] *= c.follower_cpu_ratio
            foll_np[:, 2] = 0.0

        lead_load = np.zeros((Ppad, 4), np.float32)
        foll_load = np.zeros((Ppad, 4), np.float32)
        lead_load[:P] = lead_np
        foll_load[:P] = foll_np
        ptopic = np.full(Ppad, -1, np.int32)
        ptopic[:P] = ptopic_real
        pvalid = np.zeros(Ppad, bool)
        pvalid[:P] = True

        # Structural validation + padding accounting on the PRE-UPLOAD
        # numpy arrays: metering every build costs vectorized host math
        # only — no device sync, no per-partition Python loop.
        from ..model.flat import validation_issue_counts
        issues = validation_issue_counts(rb, pvalid, ba.valid)
        num_issues = sum(issues.values())
        if num_issues:
            self._validation_issues.mark(num_issues)
            LOG.warning("flat-model validation issues at build: %s",
                        {k: v for k, v in issues.items() if v})
        self.collector.observe_padding(
            partitions=P, partitions_padded=Ppad,
            brokers=len(ba.broker_ids), brokers_padded=Bpad,
            replica_slots_used=total, replica_slots_total=Ppad * R)

        arrays = dict(
            replica_broker=rb, leader_load=lead_load,
            follower_load=foll_load, partition_topic=ptopic,
            partition_valid=pvalid, replica_offline=offline,
            replica_pref_pos=pref_pos, broker_capacity=ba.capacity,
            broker_rack=ba.rack, broker_host=ba.host,
            broker_set=ba.broker_set, broker_alive=ba.alive,
            broker_new=ba.new, broker_demoted=ba.demoted,
            broker_broken_disk=ba.broken, broker_valid=ba.valid)
        if self.resident is not None and result is not None:
            # Resident path: metric-only cycles upload a compact load
            # delta and reuse the device-resident structural buffers;
            # anything else bumps the epoch and full-rebuilds. The arrays
            # above are freshly built every cycle, so handing ownership
            # to the resident state is safe. Placement-only builds
            # (result is None — /load?capacity_only) bypass the resident
            # state entirely: their zero load planes would clobber the
            # mirrors and turn the next real cycle into a full-size
            # "delta" (the same reason _last_good never caches them).
            model = self.resident.update(arrays)
        else:
            model = FlatClusterModel.from_numpy(device=self.device, **arrays)
        from ..model.spec import ClusterMetadata
        metadata = ClusterMetadata(
            broker_ids=ba.broker_ids, broker_index=bindex,
            topics=list(topic_index), topic_index=topic_index,
            partition_keys=keys, partition_index=partition_index,
            racks=ba.racks, hosts=ba.hosts, broker_sets=ba.broker_sets)

        def spec_factory():
            pspecs, _w, _t = self._partition_specs(partitions, alive,
                                                   result, extra_offline)
            return ClusterSpec(brokers=brokers, partitions=pspecs)

        def pw_factory():
            if d is None or not d.window_times_ms or not P:
                return {}
            return {k: d.values[r] for k, r in zip(keys, erow)
                    if r >= 0 and hv[r]}

        return ClusterModelResult(
            model=model, metadata=metadata,
            completeness=(result.completeness if result is not None
                          else MetricSampleCompleteness(
                              generation=self.generation)),
            window_times_ms=window_times, generation=self.generation,
            spec_factory=spec_factory,
            partition_windows_factory=pw_factory)

    def broker_window_stats(self, now_ms: int) -> dict[int, np.ndarray]:
        """Per-broker [num_metrics, num_valid_windows] aggregates (feeds
        slow-broker and metric-anomaly detection). Invalid windows are
        zero-filled columns in the raw aggregate — dropping them here keeps
        a merely-missed sampling round from reading as a metric collapse."""
        try:
            result = self.broker_aggregator.aggregate(
                0, now_ms, AggregationOptions(min_valid_windows=0),
                use_dense=self.config.dense_pipeline)
        except NotEnoughValidWindowsError:
            return {}
        out: dict[int, np.ndarray] = {}
        if result.dense is not None:
            valid = (result.dense.extrapolations
                     != Extrapolation.NO_VALID_EXTRAPOLATION.value)
            for i, entity in enumerate(result.dense.entities):
                if valid[i].any():
                    out[entity] = result.dense.values[i][:, valid[i]]
            return out
        for entity, vae in result.entity_values.items():
            cols = [j for j, e in enumerate(vae.extrapolations)
                    if e is not Extrapolation.NO_VALID_EXTRAPOLATION]
            if cols:
                out[entity] = vae.values[:, cols]
        return out
