"""Windowed metric sample aggregation.

Rebuild of the reference's core aggregator (``monitor/sampling/aggregator/
MetricSampleAggregator.java:84`` with ``RawMetricValues.java``,
``MetricSampleCompleteness.java``, ``AggregationOptions.java``): raw samples
are rolled into fixed-width time windows per entity (partition or broker),
with extrapolation for windows that have too few samples, and completeness
accounting that gates model generation downstream.

Unlike the reference's per-entity object graph, each entity's raw window
state is a set of numpy ring buffers (``[num_windows+1, num_metrics]``), and
aggregation emits dense ``[num_entities, num_metrics, num_windows]`` arrays
ready to be flattened into the device-side cluster model.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from collections.abc import Mapping
from typing import Callable, Hashable

import numpy as np

from .metricdef import AggregationFunction, MetricDef


class Extrapolation(enum.Enum):
    """Per-window extrapolation applied when samples are insufficient.

    Mirrors ``Extrapolation.java``: NONE means the window had enough samples;
    the others record how the gap was filled (and count against
    ``max_allowed_extrapolations_per_entity``).
    """

    NONE = 0
    AVG_AVAILABLE = 1
    AVG_ADJACENT = 2
    FORCED_INSUFFICIENT = 3
    NO_VALID_EXTRAPOLATION = 4


#: Extrapolation decoded by its integer code (the dense path stores codes
#: in an ``int8[E, W]`` matrix; views decode lazily through this table).
EXTRAPOLATION_BY_CODE = tuple(Extrapolation)


class NotEnoughValidWindowsError(RuntimeError):
    """Raised when fewer valid windows exist than the caller requires
    (ref MetricSampleAggregator.aggregate -> NotEnoughValidWindowsException)."""


@dataclass(frozen=True)
class MetricSample:
    """One raw sample: an entity, a sample time, and a metric-id->value map."""

    entity: Hashable
    sample_time_ms: int
    values: Mapping[int, float]
    entity_group: Hashable | None = None


class AggregationGranularity(enum.Enum):
    """ref AggregationOptions.Granularity: whether one invalid entity
    invalidates just itself or its whole entity group (topic)."""

    ENTITY = "entity"
    ENTITY_GROUP = "entity_group"


@dataclass
class AggregationOptions:
    min_valid_entity_ratio: float = 0.0
    min_valid_entity_group_ratio: float = 0.0
    min_valid_windows: int = 1
    max_allowed_extrapolations_per_entity: int = 5
    granularity: AggregationGranularity = AggregationGranularity.ENTITY
    interested_entities: set[Hashable] | None = None


@dataclass
class MetricSampleCompleteness:
    """ref MetricSampleCompleteness.java: which windows are valid and how
    much of the entity space they cover."""

    generation: int
    valid_windows: list[int] = field(default_factory=list)
    valid_entity_ratio_by_window: dict[int, float] = field(default_factory=dict)
    valid_entity_group_ratio_by_window: dict[int, float] = field(default_factory=dict)
    valid_entities: set[Hashable] = field(default_factory=set)
    valid_entity_groups: set[Hashable] = field(default_factory=set)
    num_total_entities: int = 0

    @property
    def valid_entity_ratio(self) -> float:
        if not self.num_total_entities:
            return 0.0
        return len(self.valid_entities) / self.num_total_entities


@dataclass
class ValuesAndExtrapolations:
    """Aggregated values for one entity: ``[num_metrics, num_windows]`` plus
    the extrapolation applied per window (ref ValuesAndExtrapolations.java)."""

    values: np.ndarray
    extrapolations: list[Extrapolation]
    window_times_ms: list[int]


@dataclass
class DenseAggregate:
    """The whole-pool aggregation result as dense arrays.

    One ``[num_entities, num_metrics, num_windows]`` value cube plus a
    per-window extrapolation-code matrix, in a single stable entity order
    (``entities[i]`` owns row ``i``; ``row_index`` inverts that). Downstream
    model construction gathers straight out of these arrays — the
    ``entity_values`` dict API on :class:`MetricSampleAggregationResult`
    is a lazy per-entity view over the same memory.
    """

    entities: list[Hashable]
    row_index: dict[Hashable, int]
    values: np.ndarray          # float64[E, M, W]
    extrapolations: np.ndarray  # int8[E, W], Extrapolation codes
    window_valid: np.ndarray    # bool[E, W] (pre-demotion validity)
    window_indices: list[int]
    window_times_ms: list[int]


class _LazyEntityValues(Mapping):
    """``entity -> ValuesAndExtrapolations`` view over a DenseAggregate.

    Keeps the dict API every existing caller uses (``get``/``[]``/
    iteration/``len``) without materializing E per-entity objects: each
    access builds one lightweight wrapper whose ``values`` is a row view
    into the dense cube."""

    __slots__ = ("_dense",)

    def __init__(self, dense: DenseAggregate) -> None:
        self._dense = dense

    def __getitem__(self, entity: Hashable) -> ValuesAndExtrapolations:
        row = self._dense.row_index[entity]
        return ValuesAndExtrapolations(
            values=self._dense.values[row],
            extrapolations=[EXTRAPOLATION_BY_CODE[c]
                            for c in self._dense.extrapolations[row]],
            window_times_ms=self._dense.window_times_ms)

    def __iter__(self):
        return iter(self._dense.entities)

    def __len__(self) -> int:
        return len(self._dense.entities)

    def __contains__(self, entity: Hashable) -> bool:
        return entity in self._dense.row_index


@dataclass
class MetricSampleAggregationResult:
    generation: int
    valid_windows: list[int]
    entity_values: Mapping[Hashable, ValuesAndExtrapolations]
    completeness: MetricSampleCompleteness
    invalid_entities: set[Hashable]
    #: dense array view of the same aggregation (None on the retained
    #: per-entity reference path and on empty-window results)
    dense: DenseAggregate | None = None


class _RawStore:
    """Dense raw window state for ALL entities: one array pool instead of a
    per-entity object graph (the reference's per-entity
    ``RawMetricValues.java`` ring buffers, flattened to ``[entities, slots,
    metrics]`` so batch ingest is a handful of ``np.add.at`` scatters —
    the host-side analog of the device model's struct-of-arrays layout).
    Rows are assigned on first sight and recycled on retain/remove."""

    def __init__(self, num_slots: int, num_metrics: int,
                 initial_capacity: int = 256) -> None:
        self._num_slots = num_slots
        self._num_metrics = num_metrics
        self._rows: dict[Hashable, int] = {}
        self._free: list[int] = []
        self._alloc(initial_capacity)

    def _alloc(self, capacity: int) -> None:
        S, M = self._num_slots, self._num_metrics
        self.sums = np.zeros((capacity, S, M), np.float64)
        self.counts = np.zeros((capacity, S, M), np.int32)
        self.maxes = np.full((capacity, S, M), -np.inf, np.float64)
        self.latest_values = np.zeros((capacity, S, M), np.float64)
        self.latest_times = np.full((capacity, S, M), -1, np.int64)
        self.sample_counts = np.zeros((capacity, S), np.int32)

    @property
    def capacity(self) -> int:
        return self.sums.shape[0]

    def _grow(self, need: int) -> None:
        old = self.capacity
        new = max(old * 2, need)
        for name in ("sums", "counts", "maxes", "latest_values",
                     "latest_times", "sample_counts"):
            arr = getattr(self, name)
            grown = np.empty((new, *arr.shape[1:]), arr.dtype)
            grown[:old] = arr
            grown[old:] = (-np.inf if name == "maxes"
                           else -1 if name == "latest_times" else 0)
            setattr(self, name, grown)

    def row_for(self, entity: Hashable) -> int:
        row = self._rows.get(entity)
        if row is None:
            if self._free:
                row = self._free.pop()
            else:
                row = len(self._rows)
                if row >= self.capacity:
                    self._grow(row + 1)
            self._rows[entity] = row
        return row

    def rows_for(self, entities: list[Hashable]) -> np.ndarray:
        # Steady state (every entity already known — the every-round case
        # at LinkedIn scale): a plain list-comp over dict __getitem__ is
        # ~2x faster than fromiter over .get-with-default at 1M tuple
        # keys; only a miss (KeyError) drops to the allocating path.
        m = self._rows
        try:
            return np.asarray([m[e] for e in entities], np.int64)
        except KeyError:
            pass
        get = m.get
        out = np.fromiter((get(e, -1) for e in entities), np.int64,
                          len(entities))
        missing = out < 0
        idxs = np.nonzero(missing)[0]
        need = len(m) + len(idxs) - len(self._free)
        if need > self.capacity:
            self._grow(need)
        for i in idxs:
            out[i] = self.row_for(entities[i])
        return out

    def get_row(self, entity: Hashable) -> int | None:
        return self._rows.get(entity)

    def lookup_rows(self, entities: list[Hashable]) -> np.ndarray:
        """Row index per entity, ``-1`` for entities with no state.
        Read-only counterpart of :meth:`rows_for` (never allocates rows)."""
        get = self._rows.get
        return np.fromiter((get(e, -1) for e in entities), np.int64,
                           len(entities))

    def entities(self) -> set[Hashable]:
        return set(self._rows)

    def drop(self, entity: Hashable) -> bool:
        row = self._rows.pop(entity, None)
        if row is None:
            return False
        self.clear_slots(np.array([row]), slice(None))
        self._free.append(row)
        return True

    def clear_slots(self, rows, slot) -> None:
        self.sums[rows, slot] = 0.0
        self.counts[rows, slot] = 0
        self.maxes[rows, slot] = -np.inf
        self.latest_values[rows, slot] = 0.0
        self.latest_times[rows, slot] = -1
        self.sample_counts[rows, slot] = 0

    def clear_slot_all(self, slot) -> None:
        self.clear_slots(slice(None), slot)

    # ------------------------------------------------------------- ingest
    def add(self, row: int, slot: int, time_ms: int,
            values: Mapping[int, float]) -> None:
        for metric_id, value in values.items():
            self.sums[row, slot, metric_id] += value
            self.counts[row, slot, metric_id] += 1
            if value > self.maxes[row, slot, metric_id]:
                self.maxes[row, slot, metric_id] = value
            if time_ms >= self.latest_times[row, slot, metric_id]:
                self.latest_times[row, slot, metric_id] = time_ms
                self.latest_values[row, slot, metric_id] = value
        self.sample_counts[row, slot] += 1

    def add_batch(self, rows: np.ndarray, slots: np.ndarray,
                  times: np.ndarray, values: np.ndarray) -> None:
        """Vectorized ingest of N samples x all metrics: ``values`` is
        [N, num_metrics] (NaN = metric absent from the sample)."""
        present = ~np.isnan(values)
        vals = np.where(present, values, 0.0)
        # One sample per (row, slot) — the every-round case — allows plain
        # fancy-indexed accumulation, ~10x faster than the unbuffered
        # np.ufunc.at scatter; duplicates fall back to the exact scatter.
        S = self._num_slots
        unique_targets = (len(np.unique(rows * S + slots)) == len(rows))
        if unique_targets:
            tgt2 = (rows, slots)
            self.sums[tgt2] += vals
            self.counts[tgt2] += present.astype(np.int32)
            self.maxes[tgt2] = np.maximum(self.maxes[tgt2],
                                          np.where(present, values, -np.inf))
            self.sample_counts[tgt2] += 1
        else:
            np.add.at(self.sums, (rows, slots), vals)
            np.add.at(self.counts, (rows, slots), present.astype(np.int32))
            np.maximum.at(self.maxes, (rows, slots),
                          np.where(present, values, -np.inf))
            np.add.at(self.sample_counts, (rows, slots), 1)
        # Latest-wins. Unique targets: one sample per cell, so a direct
        # where() against the stored timestamps suffices (no ordering
        # needed). Duplicates: process in ascending time order so plain
        # indexed assignment leaves the batch's newest value in place —
        # then restore any pre-existing state that is newer still
        # (late-arriving batches must not regress LATEST metrics, matching
        # the scalar guard).
        if unique_targets:
            lt = self.latest_times[tgt2]                     # [N, M]
            upd = present & (times[:, None] >= lt)
            self.latest_values[tgt2] = np.where(
                upd, values, self.latest_values[tgt2])
            self.latest_times[tgt2] = np.where(upd, times[:, None], lt)
            return
        order = np.argsort(times, kind="stable")
        ro, so, po = rows[order], slots[order], present[order]
        idx_e, idx_m = np.nonzero(po)
        tgt = (ro[idx_e], so[idx_e], idx_m)
        prev_t = self.latest_times[tgt].copy()
        prev_v = self.latest_values[tgt].copy()
        self.latest_values[tgt] = values[order][idx_e, idx_m]
        self.latest_times[tgt] = times[order][idx_e]
        newer = prev_t > self.latest_times[tgt]
        if newer.any():
            keep = tuple(a[newer] for a in tgt)
            self.latest_times[keep] = prev_t[newer]
            self.latest_values[keep] = prev_v[newer]


class MetricSampleAggregator:
    """The windowed aggregator (ref MetricSampleAggregator.java:84).

    Thread-safe for concurrent ``add_sample`` / ``aggregate``. Window layout:
    ``num_windows`` stable windows plus one *current* (in-flight) window; the
    current window is never included in aggregation results (ref ``:193``
    aggregates only rolled-out windows). Every window roll-out bumps
    ``generation`` which downstream proposal caches key on
    (ref LongGenerationed.java).
    """

    def __init__(self, num_windows: int, window_ms: int, min_samples_per_window: int,
                 metric_def: MetricDef,
                 entity_group_fn: Callable[[Hashable], Hashable] | None = None,
                 tracer=None) -> None:
        if num_windows <= 0 or window_ms <= 0 or min_samples_per_window <= 0:
            raise ValueError("num_windows, window_ms, min_samples_per_window must be > 0")
        from .tracing import default_tracer
        #: span tracer: every aggregate() emits an ``aggregator.aggregate``
        #: span so model-build latency attributes between aggregation and
        #: flat-model assembly.
        self._tracer = tracer or default_tracer()
        self._num_windows = num_windows
        self._window_ms = window_ms
        self._min_samples = min_samples_per_window
        self._metric_def = metric_def
        self._num_metrics = metric_def.size()
        self._num_slots = num_windows + 1
        self._entity_group_fn = entity_group_fn or (lambda entity: entity)
        self._raw = _RawStore(self._num_slots, self._num_metrics)
        self._oldest_window_index = 0        # window index of slot window_index % slots
        self._current_window_index = 0
        self._initialized = False
        self._generation = 0
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ api
    @property
    def generation(self) -> int:
        # Deliberately lock-free: a single int attribute read is atomic
        # under the GIL and the counter is monotonic, so the serving
        # tier's generation-keyed cache reads never contend with ingest
        # holding the aggregator lock.
        return self._generation

    def seed_generation(self, generation: int) -> None:
        """Raise the generation counter to at least ``generation`` —
        snapshot restore (core/snapshot.py): a restarted process resumes
        the pre-crash numbering so a restored generation-keyed cache is
        valid until real ingest rolls a window, and every later bump is
        strictly greater than anything the pre-crash process issued."""
        with self._lock:
            self._generation = max(self._generation, int(generation))

    @property
    def window_ms(self) -> int:
        return self._window_ms

    @property
    def num_windows(self) -> int:
        return self._num_windows

    @property
    def num_metrics(self) -> int:
        return self._num_metrics

    def window_index(self, time_ms: int) -> int:
        return time_ms // self._window_ms

    def add_sample(self, sample: MetricSample) -> bool:
        """Add one sample; returns False if it falls before the retained range
        (ref addSample MetricSampleAggregator.java:141)."""
        with self._lock:
            index = self.window_index(sample.sample_time_ms)
            if not self._initialized:
                self._initialized = True
                self._current_window_index = index
                self._oldest_window_index = index
            if index > self._current_window_index:
                self._roll_out_to(index)
            if index < self._oldest_window_index:
                return False
            row = self._raw.row_for(sample.entity)
            self._raw.add(row, index % self._num_slots,
                          sample.sample_time_ms, sample.values)
            return True

    def add_samples_dense(self, entities: list[Hashable],
                          times_ms: np.ndarray,
                          values: np.ndarray) -> int:
        """Vectorized bulk ingest: N samples as parallel arrays —
        ``times_ms`` [N] int64, ``values`` [N, num_metrics] float64 with
        NaN marking absent metrics. The scalable ingest path for
        LinkedIn-scale sample volumes (the per-sample dict loop of
        ``add_sample`` costs hours at 1M partitions x windows); windows are
        rolled out in time order exactly as the scalar path would. Returns
        the number of samples retained."""
        times_ms = np.asarray(times_ms, np.int64)
        values = np.asarray(values, np.float64)
        with self._lock:
            windows = times_ms // self._window_ms
            if not self._initialized and len(windows):
                self._initialized = True
                start = int(windows.min())
                self._current_window_index = start
                self._oldest_window_index = start
            if len(windows) and int(windows.max()) > self._current_window_index:
                self._roll_out_to(int(windows.max()))
            keep = windows >= self._oldest_window_index
            if not keep.all():
                times_ms, values = times_ms[keep], values[keep]
                windows = windows[keep]
                entities = [e for e, k in zip(entities, keep) if k]
            if not len(windows):
                return 0
            rows = self._raw.rows_for(entities)
            self._raw.add_batch(rows, (windows % self._num_slots).astype(
                np.int64), times_ms, values)
            return len(windows)

    def retain_entities(self, entities: set[Hashable]) -> None:
        """Drop state for entities no longer in the cluster (ref retainEntities)."""
        with self._lock:
            removed = self._raw.entities() - entities
            for entity in removed:
                self._raw.drop(entity)
            if removed:
                self._generation += 1

    def remove_entities(self, entities: set[Hashable]) -> None:
        with self._lock:
            # Every entity must be dropped; an ``any(gen)`` would stop at
            # the first True and leave the rest of the pool populated, so
            # the no-short-circuit contract is structural here.
            dropped = False
            for entity in entities:
                if self._raw.drop(entity):
                    dropped = True
            if dropped:
                self._generation += 1

    def all_entities(self) -> set[Hashable]:
        with self._lock:
            return self._raw.entities()

    def num_available_windows(self) -> int:
        with self._lock:
            if not self._initialized:
                return 0
            return self._current_window_index - self._oldest_window_index

    def available_window_times(self) -> list[int]:
        with self._lock:
            return [w * self._window_ms
                    for w in range(self._oldest_window_index, self._current_window_index)]

    # ------------------------------------------------------------ aggregate
    @staticmethod
    def _sorted_entities(entities: set[Hashable]) -> list[Hashable]:
        # Entities are homogeneous per aggregator ((topic, partition)
        # tuples or int broker ids), so a plain sort works; ``key=repr``
        # would allocate a string per entity — a million strings per
        # aggregation round at LinkedIn scale. The fallback only exists
        # for exotic mixed-type entity spaces.
        try:
            return sorted(entities)
        except TypeError:
            return sorted(entities, key=repr)

    def aggregate(self, from_ms: int, to_ms: int,
                  options: AggregationOptions | None = None, *,
                  use_dense: bool = True) -> MetricSampleAggregationResult:
        """Aggregate rolled-out windows overlapping [from_ms, to_ms]
        (ref aggregate MetricSampleAggregator.java:193).

        ``use_dense=True`` (the default) computes the whole entity pool as
        one ``[E, M, W]`` array program; ``use_dense=False`` runs the
        retained per-entity reference implementation (kept for the
        dense/legacy parity property tests and as executable
        documentation of the ladder). Both produce identical results —
        bit-identical values, codes, and completeness."""
        options = options or AggregationOptions()
        with self._tracer.span("aggregator.aggregate",
                               dense=use_dense), self._lock:
            window_indices = [w for w in range(self._oldest_window_index,
                                               self._current_window_index)
                              if w * self._window_ms <= to_ms
                              and (w + 1) * self._window_ms > from_ms]
            # Interested entities with no samples at all still count: they are
            # invalid and sit in the completeness denominator (ref
            # MetricSampleAggregator peeks every interested entity; an
            # unmonitored partition must drag the valid-entity ratio down,
            # not silently vanish from it).
            entities = (self._raw.entities()
                        if options.interested_entities is None
                        else set(options.interested_entities))
            num_win = len(window_indices)
            completeness = MetricSampleCompleteness(generation=self._generation,
                                                    num_total_entities=len(entities))
            entity_values: dict[Hashable, ValuesAndExtrapolations] = {}
            invalid_entities: set[Hashable] = set()
            if num_win == 0:
                if options.min_valid_windows > 0:
                    raise NotEnoughValidWindowsError(
                        f"0 valid windows, {options.min_valid_windows} required "
                        f"(in range [{from_ms}, {to_ms}])")
                return MetricSampleAggregationResult(self._generation, [], {},
                                                     completeness, entities)

            entity_list = self._sorted_entities(entities)
            if use_dense:
                return self._aggregate_dense(entity_list, window_indices,
                                             options, completeness,
                                             from_ms, to_ms)

            valid_matrix = np.zeros((len(entities), num_win), dtype=bool)
            for i, entity in enumerate(entity_list):
                vae, window_valid = self._aggregate_entity(entity, window_indices, options)
                entity_values[entity] = vae
                valid_matrix[i] = window_valid
                if window_valid.all():
                    completeness.valid_entities.add(entity)
                else:
                    invalid_entities.add(entity)

            if options.granularity is AggregationGranularity.ENTITY_GROUP:
                # One invalid entity invalidates its whole group (ref
                # AggregationOptions.Granularity.ENTITY_GROUP): demote every
                # entity sharing a group with an invalid one.
                invalid_groups = {self._entity_group_fn(e) for e in invalid_entities}
                demoted = {e for e in completeness.valid_entities
                           if self._entity_group_fn(e) in invalid_groups}
                completeness.valid_entities -= demoted
                invalid_entities |= demoted

            self._fill_completeness(completeness, entity_list, valid_matrix,
                                    window_indices, options)
            if len(completeness.valid_windows) < options.min_valid_windows:
                raise NotEnoughValidWindowsError(
                    f"{len(completeness.valid_windows)} valid windows, "
                    f"{options.min_valid_windows} required "
                    f"(in range [{from_ms}, {to_ms}])")
            return MetricSampleAggregationResult(self._generation,
                                                 completeness.valid_windows,
                                                 entity_values, completeness,
                                                 invalid_entities)

    def _aggregate_dense(self, entity_list: list[Hashable],
                         window_indices: list[int],
                         options: AggregationOptions,
                         completeness: MetricSampleCompleteness,
                         from_ms: int, to_ms: int
                         ) -> MetricSampleAggregationResult:
        """The dense whole-pool aggregation: one ``[E, M, W]`` program.

        Replaces E invocations of :meth:`_aggregate_entity` with masked
        array selects over the ``_RawStore`` pool — window validity is one
        boolean matrix, the extrapolation ladder is four masks, and the
        per-entity extrapolation budget is a cumulative count along the
        window axis. Bit-identical to the reference path: the same
        elementwise operations run in the same order, just batched."""
        E, W = len(entity_list), len(window_indices)
        M, S = self._num_metrics, self._num_slots
        raw = self._raw
        rows = raw.lookup_rows(entity_list)
        present = rows >= 0
        rs = np.where(present, rows, 0)

        win = np.asarray(window_indices, np.int64)   # contiguous span
        slots = win % S

        # --- window values for every (entity, slot): [E, S, M] ----------
        # AVG everywhere first (one fused gather+divide), then the MAX /
        # LATEST metric columns are overwritten via np.ix_ open-mesh
        # gathers so only the needed columns are materialized.
        base = raw.sums[rs] / np.maximum(raw.counts[rs], 1)
        max_ids = [info.id for info in self._metric_def.all_metrics()
                   if info.strategy is AggregationFunction.MAX]
        latest_ids = [info.id for info in self._metric_def.all_metrics()
                      if info.strategy is AggregationFunction.LATEST]
        slot_range = np.arange(S)
        if max_ids:
            gm = raw.maxes[np.ix_(rs, slot_range, np.asarray(max_ids))]
            base[:, :, max_ids] = np.where(np.isfinite(gm), gm, 0.0)
        if latest_ids:
            base[:, :, latest_ids] = raw.latest_values[
                np.ix_(rs, slot_range, np.asarray(latest_ids))]

        # --- validity + the extrapolation ladder as masks ----------------
        sc_all = np.where(present[:, None], raw.sample_counts[rs], 0)
        scnt = sc_all[:, slots]
        valid0 = scnt >= self._min_samples                        # NONE
        half_min = max(1, self._min_samples // 2)
        avail = ~valid0 & (scnt >= half_min)                      # AVG_AVAILABLE

        # Neighbor qualification over the extended range [w0-1, wN+1]:
        # a neighbor must be inside retention AND fully sampled.
        ext_win = np.arange(win[0] - 1, win[-1] + 2)
        in_ret = ((ext_win >= self._oldest_window_index)
                  & (ext_win < self._current_window_index))
        ext_slots = ext_win % S
        nfull = (sc_all[:, ext_slots] >= self._min_samples) & in_ret[None, :]
        left_ok, right_ok = nfull[:, :W], nfull[:, 2:]
        adj = ~valid0 & ~avail & (left_ok | right_ok)             # AVG_ADJACENT
        forced = ~valid0 & ~avail & ~adj & (scnt > 0)             # FORCED_INSUFFICIENT

        # Budget: only windows where an extrapolation actually applies
        # burn it (ref maxAllowedExtrapolationsPerEntity accounting —
        # hopeless windows never consume budget). The reference's running
        # counter is an exclusive cumulative count along the window axis.
        burn = avail | adj | forced
        prior_burns = np.cumsum(burn, axis=1, dtype=np.int64) - burn
        allowed = prior_burns < options.max_allowed_extrapolations_per_entity
        window_valid = valid0 | (burn & allowed)

        codes = np.full((E, W), Extrapolation.NO_VALID_EXTRAPOLATION.value,
                        np.int8)
        codes[valid0] = Extrapolation.NONE.value
        codes[avail & allowed] = Extrapolation.AVG_AVAILABLE.value
        codes[adj & allowed] = Extrapolation.AVG_ADJACENT.value
        codes[forced & allowed] = Extrapolation.FORCED_INSUFFICIENT.value

        # --- values: own slot for NONE/AVAILABLE/FORCED, neighbor mean
        # for ADJACENT, zero for invalid windows -------------------------
        own = base[:, slots, :]                                   # [E, W, M]
        nmean_den = np.maximum(
            left_ok.astype(np.float64) + right_ok, 1.0)[:, :, None]
        adj_val = (base[:, ext_slots[:W], :] * left_ok[:, :, None]
                   + base[:, ext_slots[2:], :] * right_ok[:, :, None]
                   ) / nmean_den
        vals = np.where((codes == Extrapolation.AVG_ADJACENT.value)[:, :, None],
                        adj_val, own)
        vals = np.where(window_valid[:, :, None], vals, 0.0)
        values = np.ascontiguousarray(vals.transpose(0, 2, 1))    # [E, M, W]

        # --- entity/group validity + demotion ----------------------------
        entity_valid = window_valid.all(axis=1)
        gid_map: dict[Hashable, int] = {}
        group_fn = self._entity_group_fn
        gids = np.fromiter(
            (gid_map.setdefault(group_fn(e), len(gid_map))
             for e in entity_list), np.int64, E)
        G = len(gid_map)
        group_has_invalid = (np.bincount(gids[~entity_valid], minlength=G)
                             > 0) if G else np.zeros(0, bool)
        post_valid = entity_valid
        if options.granularity is AggregationGranularity.ENTITY_GROUP and E:
            # One invalid entity invalidates its whole group (ref
            # AggregationOptions.Granularity.ENTITY_GROUP).
            post_valid = entity_valid & ~group_has_invalid[gids]
        valid_rows = np.nonzero(post_valid)[0]
        invalid_rows = np.nonzero(~post_valid)[0]
        completeness.valid_entities = {entity_list[i] for i in valid_rows}
        invalid_entities = {entity_list[i] for i in invalid_rows}

        # --- completeness (vectorized _fill_completeness) ----------------
        num_entities = max(1, E)
        valid_per_window = window_valid.sum(axis=0)
        any_valid = window_valid.any(axis=0)
        if G:
            inv_per_gw = np.zeros((G, W), np.int64)
            np.add.at(inv_per_gw, gids, (~window_valid).astype(np.int64))
            inv_groups_per_window = (inv_per_gw > 0).sum(axis=0)
        else:
            inv_groups_per_window = np.zeros(W, np.int64)
        for j, w in enumerate(window_indices):
            ratio = float(valid_per_window[j]) / num_entities
            completeness.valid_entity_ratio_by_window[w] = ratio
            group_ratio = (1.0 - int(inv_groups_per_window[j]) / G
                           if G else 0.0)
            completeness.valid_entity_group_ratio_by_window[w] = group_ratio
            # A window with zero valid entities is never valid, even when
            # the configured ratio floor is 0.0.
            meets = (ratio >= options.min_valid_entity_ratio
                     and bool(any_valid[j]))
            if options.granularity is AggregationGranularity.ENTITY_GROUP:
                meets = meets and (group_ratio
                                   >= options.min_valid_entity_group_ratio)
            if meets:
                completeness.valid_windows.append(w)
        if G:
            completeness.valid_entity_groups = {
                g for g, i in gid_map.items() if not group_has_invalid[i]}

        if len(completeness.valid_windows) < options.min_valid_windows:
            raise NotEnoughValidWindowsError(
                f"{len(completeness.valid_windows)} valid windows, "
                f"{options.min_valid_windows} required "
                f"(in range [{from_ms}, {to_ms}])")
        dense = DenseAggregate(
            entities=entity_list,
            row_index={e: i for i, e in enumerate(entity_list)},
            values=values, extrapolations=codes, window_valid=window_valid,
            window_indices=list(window_indices),
            window_times_ms=[w * self._window_ms for w in window_indices])
        return MetricSampleAggregationResult(
            self._generation, completeness.valid_windows,
            _LazyEntityValues(dense), completeness, invalid_entities,
            dense=dense)

    def _aggregate_entity(self, entity: Hashable, window_indices: list[int],
                          options: AggregationOptions
                          ) -> tuple[ValuesAndExtrapolations, np.ndarray]:
        num_win = len(window_indices)
        values = np.zeros((self._num_metrics, num_win), dtype=np.float64)
        extrapolations = [Extrapolation.NONE] * num_win
        window_valid = np.zeros(num_win, dtype=bool)
        num_extrapolations = 0

        row = self._raw.get_row(entity)
        if row is None:
            # Interested entity with no samples: every window invalid.
            extrapolations = [Extrapolation.NO_VALID_EXTRAPOLATION] * num_win
            window_times = [w * self._window_ms for w in window_indices]
            return (ValuesAndExtrapolations(values, extrapolations,
                                            window_times), window_valid)

        base = self._compute_window_values(row)
        counts = self._raw.sample_counts[row]

        for j, w in enumerate(window_indices):
            slot = w % self._num_slots
            count = int(counts[slot])
            if count >= self._min_samples:
                values[:, j] = base[:, slot]
                window_valid[j] = True
                continue
            # Extrapolate (ref RawMetricValues extrapolation ladder). The
            # budget is only consumed when an extrapolation actually applies —
            # windows that end NO_VALID_EXTRAPOLATION never burn budget.
            if num_extrapolations >= options.max_allowed_extrapolations_per_entity:
                extrapolations[j] = Extrapolation.NO_VALID_EXTRAPOLATION
                continue
            half_min = max(1, self._min_samples // 2)
            if count >= half_min:
                values[:, j] = base[:, slot]
                extrapolations[j] = Extrapolation.AVG_AVAILABLE
                window_valid[j] = True
                num_extrapolations += 1
                continue
            prev_w, next_w = w - 1, w + 1
            neighbor_slots = [x % self._num_slots for x in (prev_w, next_w)
                              if self._oldest_window_index <= x < self._current_window_index
                              and counts[x % self._num_slots] >= self._min_samples]
            if neighbor_slots:
                values[:, j] = base[:, neighbor_slots].mean(axis=1)
                extrapolations[j] = Extrapolation.AVG_ADJACENT
                window_valid[j] = True
                num_extrapolations += 1
            elif count > 0:
                values[:, j] = base[:, slot]
                extrapolations[j] = Extrapolation.FORCED_INSUFFICIENT
                window_valid[j] = True
                num_extrapolations += 1
            else:
                extrapolations[j] = Extrapolation.NO_VALID_EXTRAPOLATION
        window_times = [w * self._window_ms for w in window_indices]
        return ValuesAndExtrapolations(values, extrapolations, window_times), window_valid

    def _compute_window_values(self, row: int) -> np.ndarray:
        """Apply each metric's aggregation strategy over raw per-slot state.

        Returns ``[num_metrics, num_slots]``.
        """
        raw = self._raw
        out = np.zeros((self._num_metrics, self._num_slots), dtype=np.float64)
        safe_counts = np.maximum(raw.counts[row], 1)
        avg = (raw.sums[row] / safe_counts).T
        maxes = np.where(np.isfinite(raw.maxes[row]), raw.maxes[row], 0.0).T
        latest = raw.latest_values[row].T
        for info in self._metric_def.all_metrics():
            if info.strategy is AggregationFunction.AVG:
                out[info.id] = avg[info.id]
            elif info.strategy is AggregationFunction.MAX:
                out[info.id] = maxes[info.id]
            else:
                out[info.id] = latest[info.id]
        return out

    def _fill_completeness(self, completeness: MetricSampleCompleteness,
                           entity_list: list[Hashable], valid_matrix: np.ndarray,
                           window_indices: list[int], options: AggregationOptions) -> None:
        num_entities = max(1, len(entity_list))
        groups = [self._entity_group_fn(entity) for entity in entity_list]
        unique_groups = set(groups)
        for j, w in enumerate(window_indices):
            ratio = float(valid_matrix[:, j].sum()) / num_entities
            completeness.valid_entity_ratio_by_window[w] = ratio
            invalid_groups = {groups[i] for i in range(len(entity_list))
                              if not valid_matrix[i, j]}
            group_ratio = (1.0 - len(invalid_groups) / len(unique_groups)
                           if unique_groups else 0.0)
            completeness.valid_entity_group_ratio_by_window[w] = group_ratio
            # A window with zero valid entities is never valid, even when the
            # configured ratio floor is 0.0 (otherwise a time-jump reset would
            # hand downstream an all-zero "complete" model).
            meets = ratio >= options.min_valid_entity_ratio and bool(
                valid_matrix[:, j].any())
            if options.granularity is AggregationGranularity.ENTITY_GROUP:
                meets = meets and group_ratio >= options.min_valid_entity_group_ratio
            if meets:
                completeness.valid_windows.append(w)
        for i, entity in enumerate(entity_list):
            if valid_matrix[i].all():
                completeness.valid_entity_groups.add(groups[i])
        completeness.valid_entity_groups -= {self._entity_group_fn(entity)
                                             for i, entity in enumerate(entity_list)
                                             if not valid_matrix[i].all()}

    # ------------------------------------------------------------- internal
    def _roll_out_to(self, new_current: int) -> None:
        steps = new_current - self._current_window_index
        if steps >= self._num_slots:
            for slot in range(self._num_slots):
                self._raw.clear_slot_all(slot)
            self._current_window_index = new_current
            self._oldest_window_index = new_current - self._num_windows
            self._generation += 1
            return
        for w in range(self._current_window_index + 1, new_current + 1):
            self._raw.clear_slot_all(w % self._num_slots)
        self._current_window_index = new_current
        self._oldest_window_index = max(self._oldest_window_index,
                                        new_current - self._num_windows)
        self._generation += 1
