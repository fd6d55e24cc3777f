"""Device-resident cluster state with incremental metric-delta ingest (port
of ``cruise_control_tpu/model/resident.py``).

:class:`ResidentClusterState` keeps the canonical model **resident on the
card** and splits updates into two regimes:

- **Metric-only cycles** (the steady state): the monitor's dense assembler
  produces the same host arrays it always did; this class diffs the load
  planes (``leader_load``/``follower_load``) against its host mirrors,
  uploads only the changed partition rows as ONE packed payload
  (``kernels.pack_delta_rows``: the row blocks, then the indices) in one
  host-to-device copy, and writes them with ONE launch of KF
  (``kernels.delta_row_scatter``), which copies the two planes into fresh
  ones with the rows in place; the next model serves those. Unchanged
  structural arrays — replica placement, topology masks, broker axes —
  are the same device tensors cycle after cycle. A cycle whose arrays are
  all unchanged uploads nothing at all (a ``noop``).
- **Structural cycles**: any change outside the load planes (broker
  add/remove/death, partition add/remove, leadership or placement drift,
  capacity/rack/broker-set change, padded-shape change) bumps the
  **epoch** and falls back to one full rebuild + upload.

Parity is by construction: the scatter writes the exact float32 rows the
full rebuild would have uploaded, so N delta cycles produce a model
bit-identical to a from-scratch build.

The payload holds exactly the changed rows. The reference pads it to
power-of-two row buckets so XLA compiles O(log P) programs; KF takes any
row count, so ``last_delta_bytes`` counts the unpadded payload and is
smaller than the reference's for the same cycle.

A model handed out by an earlier cycle keeps its loads, as the reference's
``.at[].set`` into fresh buffers does: KF is out of place (it reads the
planes and writes two new ``[P, 4]`` float32 planes, 640 KB at 20K
partitions), never writing planes a served model holds. On the card the
payload is packed into a pinned host buffer the state reuses, and copied
without blocking; before the host packs the next payload into it, it
waits on an event recorded after the previous copy. Memory note: the host
mirrors are the previous cycle's assembled arrays, kept by reference
(callers must not mutate arrays after passing them in).
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..kernels import delta_payload_words, delta_row_scatter, pack_delta_rows
from ..utils.device import resolve_device

LOG = logging.getLogger(__name__)

#: sensor group for the resident-state series (``ResidentState.*``).
RESIDENT_SENSOR = "ResidentState"

#: the two per-partition load planes the delta path may update; every
#: other ``from_numpy`` field is structural and forces an epoch bump.
METRIC_FIELDS = ("leader_load", "follower_load")


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Exact array equality (NaN == NaN), shape/dtype included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if np.issubdtype(a.dtype, np.floating):
        return bool(np.array_equal(a, b, equal_nan=True))
    return bool(np.array_equal(a, b))


def _changed_rows(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """bool[P] — rows whose values differ (NaN-aware, exact)."""
    eq = (new == old) | (np.isnan(new) & np.isnan(old))
    return ~eq.all(axis=1)


class ResidentClusterState:
    """Owns the device-side ``FlatClusterModel`` tensors + epoch counter.

    Thread-safe (the monitor allows concurrent model builds); one instance
    per monitor. ``update`` is the single write path — it returns the
    resident model the caller should serve. ``device=None`` means the card
    (raises without CUDA); only ``device="cpu"`` keeps the state on the CPU,
    where KF runs as its plain twin.
    """

    def __init__(self, *, registry=None, collector=None, tracer=None,
                 device=None, mesh=None) -> None:
        from ..core.runtime_obs import default_collector
        from ..core.sensors import MetricRegistry
        from ..core.tracing import default_tracer
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh has no counterpart on one GPU (K15)")
        self.device = resolve_device(device)
        self.collector = collector or default_collector()
        self.tracer = tracer or default_tracer()
        self.registry = registry or MetricRegistry()
        self._lock = threading.Lock()
        self._model = None                      # FlatClusterModel | None
        self._host: dict[str, np.ndarray] = {}  # host mirrors, by field
        #: bumps on every structural full rebuild; 0 = nothing resident yet
        self.epoch = 0
        #: counts every state-changing ingest (full rebuild or delta; a
        #: noop leaves it alone) — the contiguity chain replication frames
        #: carry: a replica applies a delta only when its own ingest_seq
        #: equals the delta's base.
        self.ingest_seq = 0
        #: replica-side deltas applied via :meth:`apply_delta`
        self.applied_deltas = 0
        #: leader-side capture log for the stream publisher; None until
        #: :meth:`enable_delta_capture` (the default path pays nothing).
        self._delta_log: list | None = None
        self._delta_log_limit = 0
        self._delta_overflow = False
        self.full_rebuilds = 0
        self.delta_cycles = 0
        self.noop_cycles = 0
        self.restores = 0
        self.last_update: str | None = None      # "full" | "delta" | "noop"
        self.last_delta_rows = 0
        self.last_delta_bytes = 0
        self.last_full_bytes = 0
        self._scatter = self.collector.track("resident.delta-ingest",
                                             delta_row_scatter)
        #: the pinned staging buffer of KF's payloads (card only), and the
        #: event recorded after the last copy out of it
        self._pinned: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None
        name = MetricRegistry.name
        g = RESIDENT_SENSOR
        self._full_counter = self.registry.counter(name(g, "full-rebuilds"))
        self._delta_counter = self.registry.counter(name(g, "delta-cycles"))
        self._noop_counter = self.registry.counter(name(g, "noop-cycles"))
        self.registry.gauge(name(g, "epoch"), lambda: self.epoch)
        self.registry.gauge(name(g, "last-delta-rows"),
                            lambda: self.last_delta_rows)
        self.registry.gauge(name(g, "last-delta-bytes"),
                            lambda: self.last_delta_bytes)

    # ------------------------------------------------------------- update
    def update(self, arrays: dict[str, np.ndarray]):
        """Fold one assembled cycle into the resident state.

        ``arrays`` is exactly the ``FlatClusterModel.from_numpy`` kwarg set
        the dense assembler produces (ownership transfers — the caller must
        not mutate them afterwards). Returns the resident
        ``FlatClusterModel``.
        """
        with self._lock, self.tracer.span("resident.update") as sp:
            structural = self._model is None or any(
                not _same(arrays[f], self._host[f])
                for f in arrays if f not in METRIC_FIELDS)
            if structural:
                self._full_rebuild(arrays)
            else:
                self._metric_delta(arrays)
            sp.set(update=self.last_update, epoch=self.epoch,
                   rows=self.last_delta_rows)
            return self._model

    def _full_rebuild(self, arrays: dict[str, np.ndarray]) -> None:
        from .flat import FlatClusterModel
        self.epoch += 1
        self.ingest_seq += 1
        if self._delta_log is not None:
            # A structural rebuild cannot ship as a delta: drop the pending
            # entries and leave a marker so the publisher tells followers
            # to resync from the next snapshot.
            self._delta_log.clear()
            self._delta_log.append({"structural": True,
                                    "ingest": self.ingest_seq,
                                    "epoch": self.epoch})
        self.full_rebuilds += 1
        self._full_counter.inc()
        self._model = FlatClusterModel.from_numpy(device=self.device,
                                                  **arrays)
        self._host = dict(arrays)
        self.last_update = "full"
        self.last_delta_rows = 0
        self.last_delta_bytes = 0
        self.last_full_bytes = sum(int(a.nbytes) for a in arrays.values())
        LOG.info("resident state epoch %d: full rebuild (%d bytes uploaded)",
                 self.epoch, self.last_full_bytes)

    def _upload(self, idx: np.ndarray, lead_rows: np.ndarray,
                foll_rows: np.ndarray) -> torch.Tensor:
        """KF's packed payload on the state's device, uploaded in one copy
        (on the card: packed into the pinned staging buffer, copied without
        blocking)."""
        if self.device.type != "cuda":
            return torch.from_numpy(pack_delta_rows(idx, lead_rows,
                                                    foll_rows))
        n = delta_payload_words(*lead_rows.shape)
        if self._copied is not None:
            # the previous payload must have left the buffer before the
            # host writes this one over it
            self._copied.synchronize()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(n, dtype=torch.float32,
                                       pin_memory=True)
        pack_delta_rows(idx, lead_rows, foll_rows, out=self._pinned.numpy())
        payload = self._pinned[:n].to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return payload

    def _scatter_rows(self, idx: np.ndarray, lead_rows: np.ndarray,
                      foll_rows: np.ndarray) -> int:
        """Upload one payload and write it with KF into fresh planes,
        served by a new model (a model handed out earlier keeps its
        planes); returns the bytes uploaded."""
        payload = self._upload(idx, lead_rows, foll_rows)
        nbytes = payload.numel() * payload.element_size()
        self.collector.record_h2d(nbytes)
        lead, foll = self._scatter(self._model.leader_load,
                                   self._model.follower_load, payload)
        self._model = self._model.replace(leader_load=lead, follower_load=foll)
        return int(nbytes)

    def _metric_delta(self, arrays: dict[str, np.ndarray]) -> None:
        lead, foll = arrays["leader_load"], arrays["follower_load"]
        changed = (_changed_rows(lead, self._host["leader_load"])
                   | _changed_rows(foll, self._host["follower_load"]))
        rows = np.nonzero(changed)[0]
        if rows.size == 0:
            self.noop_cycles += 1
            self._noop_counter.inc()
            self.last_update = "noop"
            self.last_delta_rows = 0
            self.last_delta_bytes = 0
            return
        idx = rows.astype(np.int32)
        lead_rows = np.ascontiguousarray(lead[rows])
        foll_rows = np.ascontiguousarray(foll[rows])
        nbytes = self._scatter_rows(idx, lead_rows, foll_rows)
        self._host["leader_load"] = lead
        self._host["follower_load"] = foll
        base = self.ingest_seq
        self.ingest_seq += 1
        if self._delta_log is not None:
            # The payload arrays are freshly built and never mutated after
            # the scatter — safe to share by reference.
            self._delta_log.append({
                "structural": False, "baseIngest": base,
                "ingest": self.ingest_seq, "epoch": self.epoch,
                "idx": idx, "lead": lead_rows, "foll": foll_rows})
            while len(self._delta_log) > self._delta_log_limit:
                self._delta_log.pop(0)
                self._delta_overflow = True
        self.delta_cycles += 1
        self._delta_counter.inc()
        self.last_update = "delta"
        self.last_delta_rows = int(rows.size)
        self.last_delta_bytes = nbytes

    # ------------------------------------------------- delta streaming
    def enable_delta_capture(self, limit: int = 64) -> None:
        """Start logging metric-delta payloads for the replication
        publisher. ``limit`` bounds host memory: overflow drops the oldest
        entries and flags the drain, which the publisher turns into a
        follower resync marker."""
        with self._lock:
            self._delta_log_limit = int(limit)
            if self._delta_log is None:
                self._delta_log = []

    def drain_deltas(self) -> tuple[list, bool]:
        """``(entries, overflowed)``: the captured delta entries since the
        last drain (ownership transfers to the caller). Entries are
        ingest-chained dicts — see ``_metric_delta`` / ``_full_rebuild``
        for the two shapes."""
        with self._lock:
            if self._delta_log is None:
                return [], False
            entries, self._delta_log = self._delta_log, []
            overflow, self._delta_overflow = self._delta_overflow, False
            return entries, overflow

    def apply_delta(self, entry: dict) -> bool:
        """Replica-side ingest of one streamed delta entry: write the rows
        into the resident planes (KF) and the host mirrors, exactly as the
        leader's ``_metric_delta`` did. Applies ONLY when contiguous (same
        epoch, ``baseIngest`` equals this replica's ``ingest_seq``) —
        anything else returns False and the caller must resync from a full
        snapshot; a divergent model is never served."""
        with self._lock:
            if (self._model is None or entry.get("structural")
                    or int(entry.get("epoch", -1)) != self.epoch
                    or int(entry.get("baseIngest", -1)) != self.ingest_seq):
                return False
            idx = np.ascontiguousarray(entry["idx"], np.int32)
            lead_rows = np.ascontiguousarray(
                entry["lead"], self._host["leader_load"].dtype)
            foll_rows = np.ascontiguousarray(
                entry["foll"], self._host["follower_load"].dtype)
            self._scatter_rows(idx, lead_rows, foll_rows)
            # Host mirrors are replaced wholesale, never mutated in place
            # (snapshot export shares them by reference).
            for field, rows_arr in (("leader_load", lead_rows),
                                    ("follower_load", foll_rows)):
                mirror = self._host[field].copy()
                mirror[idx] = rows_arr
                self._host[field] = mirror
            self.ingest_seq = int(entry["ingest"])
            self.applied_deltas += 1
            self.delta_cycles += 1
            self._delta_counter.inc()
            self.last_update = "delta"
            self.last_delta_rows = int(idx.size)
            return True

    # -------------------------------------------------- snapshot/restore
    def export_state(self) -> tuple[int, dict[str, np.ndarray]] | None:
        """``(epoch, host mirrors)`` for the crash-safe snapshot, or None
        before the first full rebuild. The mirrors are returned by
        reference — they are never mutated in place."""
        with self._lock:
            if self._model is None:
                return None
            return self.epoch, dict(self._host)

    def restore(self, epoch: int, arrays: dict[str, np.ndarray], *,
                ingest_seq: int | None = None) -> None:
        """Rebuild the resident device tensors from a snapshot's host
        mirrors (the reference's ``export_state`` mirrors are accepted as
        they are). The epoch resumes at ``max(saved, current)`` so
        post-restore structural changes still bump monotonically. Counts as
        a ``restore``, not a full rebuild."""
        from .flat import FlatClusterModel
        with self._lock, self.tracer.span("resident.restore"):
            self._model = FlatClusterModel.from_numpy(device=self.device,
                                                      **arrays)
            self._host = dict(arrays)
            self.epoch = max(self.epoch, int(epoch))
            if ingest_seq is not None:
                # Rejoining a replication stream: the snapshot pins the
                # contiguity chain position the next delta must extend.
                self.ingest_seq = int(ingest_seq)
            if self._delta_log is not None:
                self._delta_log.clear()
                self._delta_overflow = False
            self.restores += 1
            self.last_update = "restore"
            self.last_delta_rows = 0
            self.last_delta_bytes = 0
            self.last_full_bytes = sum(int(a.nbytes)
                                       for a in arrays.values())
            LOG.info("resident state restored from snapshot (epoch %d, "
                     "%d bytes uploaded)", self.epoch, self.last_full_bytes)

    # ------------------------------------------------------------ warmup
    def warmup(self) -> bool:
        """Load the kernel library and launch KF once on an all-dropped
        payload (one row at index P, uploaded as every payload is; its
        planes are dropped — no state change), so the first real
        metric-only cycle builds and loads nothing. No-op (returns False)
        before the first full rebuild."""
        with self._lock, self.collector.warming():
            if self._model is None:
                return False
            lead = self._model.leader_load
            P, C = lead.shape
            rows = np.zeros((1, C), np.float32)
            self._scatter(lead, self._model.follower_load,
                          self._upload(np.array([P], np.int32), rows, rows))
            return True

    # ------------------------------------------------------------- reads
    # Deliberately lockless: an observability scrape must never block
    # behind an in-flight structural rebuild. Reads are single attribute
    # loads (GIL-atomic).
    @property
    def model(self):
        """The resident :class:`FlatClusterModel` (None before the first
        build/restore)."""
        return self._model

    def invalidate(self) -> None:
        """Drop the resident tensors; the next update is a full rebuild
        (epoch bump)."""
        with self._lock:
            self._model = None
            self._host = {}

    def to_json(self) -> dict:
        """The ``resident`` section of ``/devicestats`` (lockless)."""
        model = self._model
        out = {
            "epoch": self.epoch,
            "ingestSeq": self.ingest_seq,
            "appliedDeltas": self.applied_deltas,
            "fullRebuilds": self.full_rebuilds,
            "deltaCycles": self.delta_cycles,
            "noopCycles": self.noop_cycles,
            "restores": self.restores,
            "lastUpdate": self.last_update,
            "lastDeltaRows": self.last_delta_rows,
            "lastDeltaBytes": self.last_delta_bytes,
            "lastFullBytes": self.last_full_bytes,
        }
        if model is not None:
            out["shapes"] = {
                "partitionsPadded": model.num_partitions_padded,
                "brokersPadded": model.num_brokers_padded,
                "maxReplicationFactor": model.max_replication_factor,
            }
        return out
