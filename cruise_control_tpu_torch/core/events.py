"""Control-plane flight recorder: the causal decision journal.

The span tracer (core/tracing.py) answers "where did the latency go" and
the sensor registry (core/sensors.py) answers "how often"; neither
answers the operator's first question after an incident: **what did the
control plane decide, and why**. This module adds that axis: a
thread-safe bounded ring of structured :class:`Event` records — one per
control-plane *decision* (here: a fleet member's health transitions) —
with:

- **Causality chains.** Every event may name a ``cause`` seq, so the
  degraded → quarantined → readmitting chain reads as a linked list.
- **Trace linkage.** Events capture the recording thread's current
  SpanTracer span id.
- **Zero device syncs.** Appends read the host clock only.

``enabled = False`` turns the whole journal into a no-op — an A/B
switch, mirroring :class:`~cruise_control_tpu_torch.core.tracing.
SpanTracer`. The reference's JSONL segment persistence, replication
(``export_delta``/``apply_remote``), ``configure`` and Chrome-trace export
come with the served stack that calls them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable

from .sensors import MetricRegistry

#: sensor group for the journal series (``EventJournal.*``).
EVENT_SENSOR = "EventJournal"

#: the closed category set — one striped counter per category is
#: pre-created at construction so the Prometheus family set is stable
#: (merged-scrape lint asserts HELP-completeness against it).
CATEGORIES = ("propose", "optimizer", "execute", "election", "replication",
              "admission", "detector", "snapshot", "slo", "fleet")

#: severity ladder, least to most severe (the /history ``severity``
#: filter is a minimum-severity cut).
SEVERITIES = ("info", "warn", "error")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


class Event:
    """One recorded decision (immutable once appended)."""

    __slots__ = ("seq", "ts_ms", "perf_s", "category", "action", "severity",
                 "epoch", "span_id", "cause", "node", "detail")

    def __init__(self, seq: int, ts_ms: int, perf_s: float, category: str,
                 action: str, severity: str, epoch: int | None,
                 span_id: int | None, cause: int | None, node: str | None,
                 detail: dict | None) -> None:
        self.seq = seq
        self.ts_ms = ts_ms
        self.perf_s = perf_s
        self.category = category
        self.action = action
        self.severity = severity
        self.epoch = epoch
        self.span_id = span_id
        self.cause = cause
        self.node = node
        self.detail = detail

    def to_json(self) -> dict:
        return {"seq": self.seq, "tsMs": self.ts_ms,
                "category": self.category, "action": self.action,
                "severity": self.severity, "epoch": self.epoch,
                "spanId": self.span_id, "cause": self.cause,
                "node": self.node, "detail": self.detail}


class EventJournal:
    """Thread-safe bounded decision ring.

    ``capacity`` bounds memory (oldest events drop, counted);
    ``enabled`` turns :meth:`record` into a no-op (the overhead A/B
    switch); ``categories`` restricts recording to a subset (the
    per-category enable — None records everything)."""

    def __init__(self, capacity: int = 4096, *,
                 registry: MetricRegistry | None = None,
                 tracer=None, node: str | None = None,
                 categories: Iterable[str] | None = None,
                 now_ms: Callable[[], int] | None = None) -> None:
        self.capacity = int(capacity)
        self.enabled = True
        self.node = node
        self.categories = (frozenset(categories)
                           if categories is not None else None)
        self.tracer = tracer
        self._now_ms = now_ms or (lambda: int(time.time() * 1000))
        self._perf = time.perf_counter
        self._ring: "deque[Event]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self.registry = registry or MetricRegistry()
        name = MetricRegistry.name
        g = EVENT_SENSOR
        # Pre-created per-category/per-severity striped counters: the
        # record hot path never creates sensors (registry mutations
        # invalidate the scrape render cache) and the family set is
        # scrape-stable from construction.
        self._cat_counters = {
            c: self.registry.striped_counter(name(g, f"events-{c}"))
            for c in CATEGORIES}
        self._sev_counters = {
            s: self.registry.striped_counter(name(g, f"severity-{s}"))
            for s in SEVERITIES}
        self.registry.gauge(name(g, "last-seq"), lambda: self._seq)
        self.registry.gauge(name(g, "dropped"), lambda: self._dropped)

    # ----------------------------------------------------------- recording
    def record(self, category: str, action: str, *,
               severity: str = "info", cause: int | None = None,
               epoch: int | None = None,
               detail: dict | None = None) -> int | None:
        """Append one decision. Returns the assigned seq (the handle a
        later event passes as ``cause``), or None when disabled or the
        category is filtered out. Host-clock only — zero device syncs."""
        if not self.enabled:
            return None
        if category not in CATEGORIES:
            raise ValueError(f"unknown event category {category!r} "
                             f"(known: {CATEGORIES})")
        if self.categories is not None and category not in self.categories:
            return None
        if severity not in SEVERITIES:
            severity = "info"
        span_id = (self.tracer.current_span_id()
                   if self.tracer is not None else None)
        ts_ms = self._now_ms()
        perf_s = self._perf()
        with self._lock:
            self._seq += 1
            seq = self._seq
            if len(self._ring) >= self.capacity:
                self._dropped += 1
            self._ring.append(Event(seq, ts_ms, perf_s, category, action,
                                    severity, epoch, span_id, cause,
                                    self.node, detail))
        # Striped counters: lock-free inc, outside the ring lock.
        self._cat_counters[category].inc()
        self._sev_counters[severity].inc()
        return seq

    # -------------------------------------------------------------- reads
    @property
    def last_seq(self) -> int:
        return self._seq

    @property
    def dropped(self) -> int:
        return self._dropped

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._ring)

    def query(self, *, categories: Iterable[str] | None = None,
              min_severity: str | None = None, since_seq: int = 0,
              limit: int = 256) -> list[Event]:
        """Filtered read, newest-last. ``categories`` is an exact-match
        set; ``min_severity`` is a floor on the severity ladder;
        ``since_seq`` is exclusive; ``limit`` keeps the newest rows."""
        cats = frozenset(categories) if categories else None
        floor = _SEV_RANK.get(min_severity, 0) if min_severity else 0
        out = [e for e in self.events()
               if e.seq > since_seq
               and (cats is None or e.category in cats)
               and _SEV_RANK[e.severity] >= floor]
        return out[-max(int(limit), 0):]
