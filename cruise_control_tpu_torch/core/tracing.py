"""Span tracer: end-to-end pipeline tracing for the monitor → model →
optimize → execute loop.

The sensor registry (:mod:`core.sensors`) answers "how long do proposals
take on average"; it cannot answer "where did THIS proposal's latency go".
This module adds the missing axis: a thread-safe bounded ring buffer of
nested :class:`Span` records with a context-manager/decorator API, exported
as Chrome trace-event JSON (loadable in Perfetto / ``chrome://tracing``)
through the ``/trace`` endpoint and embedded in ``/state?substates=tracing``.

Design constraints:

- **Zero device syncs.** Spans only read the host clock
  (``time.perf_counter``); device-side search telemetry rides the
  optimizer's existing end-of-chain host fetch and is attached to spans as
  attributes after the fact (see ``analyzer/optimizer.py``).
- **Registry integration.** Every finished span also feeds a
  :class:`~cruise_control_tpu_torch.core.sensors.Timer` named ``Span.<name>`` in
  the tracer's registry, so span populations surface on ``/metrics`` as
  Prometheus summary series without separate bookkeeping.
- **Reconstructed children.** Work that is unobservable from the host mid
  flight (the fused goal-chain walk: one device dispatch for G goals) is
  recorded after completion via :meth:`SpanTracer.record` with explicit
  start/parent — the per-goal child spans are rebuilt from the single-sync
  duration list.
- **Cross-thread wiring.** The active-span stack is thread-local; an async
  operation's worker thread starts its own root (the API layer wraps user
  tasks in a ``task.<endpoint>`` span), so every thread's spans nest
  correctly in its own Chrome-trace row.

One process-wide default tracer (:func:`default_tracer`) keeps wiring
optional: every subsystem accepts ``tracer=None`` and falls back to it, the
same way subsystems default to a private ``MetricRegistry``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Callable

from .sensors import MetricRegistry

#: sensor group for span-fed timers (``Span.<span-name>``).
SPAN_SENSOR_GROUP = "Span"


class Span:
    """One finished span (immutable once recorded)."""

    __slots__ = ("span_id", "parent_id", "name", "start_s", "duration_s",
                 "thread_id", "thread_name", "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 start_s: float, duration_s: float, thread_id: int,
                 thread_name: str, attrs: dict) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = start_s
        self.duration_s = duration_s
        self.thread_id = thread_id
        self.thread_name = thread_name
        self.attrs = attrs

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def to_json(self) -> dict:
        return {"spanId": self.span_id, "parentId": self.parent_id,
                "name": self.name,
                "startS": round(self.start_s, 6),
                "durationMs": round(self.duration_s * 1e3, 3),
                "thread": self.thread_name,
                "attributes": dict(self.attrs)}


class _ActiveSpan:
    """Context-manager handle for an in-flight span. ``set(**attrs)``
    attaches attributes before (or after) exit; exceptions are recorded as
    an ``error`` attribute and re-raised."""

    __slots__ = ("tracer", "name", "span_id", "parent_id", "start_s",
                 "attrs", "_finished")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict) -> None:
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id: int | None = None
        self.start_s = 0.0
        self._finished = False

    def set(self, **attrs) -> "_ActiveSpan":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        stack = self.tracer._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.start_s = self.tracer._now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = self.tracer._now() - self.start_s
        stack = self.tracer._stack()
        # Pop self even if an inner span leaked (defensive unwinding).
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        if not self._finished:
            self._finished = True
            self.tracer._finish(self.name, self.start_s, duration,
                                self.parent_id, self.attrs,
                                span_id=self.span_id)
        return False


class _NoopSpan:
    """Shared do-nothing handle served while the tracer is disabled."""

    __slots__ = ()
    span_id = None
    parent_id = None
    start_s = 0.0

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class SpanTracer:
    """Thread-safe bounded ring buffer of nested spans.

    ``capacity`` bounds memory: the buffer keeps the most recent spans and
    silently drops the oldest (``dropped_spans`` counts them). ``enabled``
    turns the whole tracer into a no-op — the bench's overhead A/B switch.
    """

    def __init__(self, capacity: int = 8192,
                 registry: MetricRegistry | None = None,
                 now: Callable[[], float] | None = None) -> None:
        from collections import deque
        self.capacity = int(capacity)
        self.registry = registry or MetricRegistry()
        self.enabled = True
        self._now = now or time.perf_counter
        self._epoch = self._now()
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # ------------------------------------------------------------ recording
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> "_ActiveSpan | _NoopSpan":
        """``with tracer.span("optimizer.walk", mode="fused") as sp: ...``"""
        if not self.enabled:
            return _NOOP
        return _ActiveSpan(self, name, attrs)

    def traced(self, name: str | None = None):
        """Decorator form: ``@tracer.traced("monitor.train")``."""
        def deco(fn):
            import functools
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(span_name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def record(self, name: str, duration_s: float, *,
               start_s: float | None = None,
               parent_id: int | None | str = "current",
               attrs: dict | None = None) -> None:
        """Record an already-finished span — the reconstruction path for
        work with no observable host-side boundaries (per-goal slices of a
        fused device walk, executor task lifecycles stamped by the task
        tracker's clock). ``parent_id="current"`` (default) parents under
        this thread's active span; pass an explicit id (or None) to attach
        elsewhere."""
        if not self.enabled:
            return
        if parent_id == "current":
            stack = self._stack()
            parent_id = stack[-1].span_id if stack else None
        if start_s is None:
            start_s = self._now() - duration_s
        self._finish(name, start_s, duration_s, parent_id, attrs or {},
                     span_id=next(self._ids))

    def current_span_id(self) -> int | None:
        stack = self._stack()
        return stack[-1].span_id if stack else None

    def _finish(self, name, start_s, duration_s, parent_id, attrs,
                span_id=None) -> None:
        thread = threading.current_thread()
        span = Span(span_id if span_id is not None else next(self._ids),
                    parent_id, name, start_s, max(duration_s, 0.0),
                    thread.ident or 0, thread.name, attrs)
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._dropped += 1
            self._spans.append(span)
        # Outside the buffer lock: the timer has its own.
        self.registry.timer(MetricRegistry.name(
            SPAN_SENSOR_GROUP, name)).update(span.duration_s)

    # -------------------------------------------------------------- reading
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped_spans(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def to_json(self, limit: int = 256) -> dict:
        """Bounded recent-span snapshot for ``/state?substates=tracing``."""
        spans = self.spans()
        return {"numSpans": len(spans),
                "droppedSpans": self._dropped,
                "capacity": self.capacity,
                "spans": [s.to_json() for s in spans[-limit:]]}

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (the ``/trace`` payload): complete
        ("X") events in microseconds relative to the tracer's epoch, plus
        thread-name metadata events — loadable as-is in Perfetto or
        ``chrome://tracing``."""
        pid = os.getpid()
        events: list[dict] = []
        seen_threads: dict[int, str] = {}
        for s in sorted(self.spans(), key=lambda s: s.start_s):
            seen_threads.setdefault(s.thread_id, s.thread_name)
            events.append({
                "name": s.name, "ph": "X", "cat": "cruise-control",
                "ts": round((s.start_s - self._epoch) * 1e6, 3),
                "dur": round(s.duration_s * 1e6, 3),
                "pid": pid, "tid": s.thread_id,
                "args": {**s.attrs, "spanId": s.span_id,
                         "parentId": s.parent_id}})
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": tname}}
                for tid, tname in sorted(seen_threads.items())]
        return {"displayTimeUnit": "ms", "traceEvents": meta + events}


#: process-wide default (the analog of the reference threading ONE
#: Dropwizard registry through every constructor): subsystems built with
#: ``tracer=None`` share it, so one /trace dump covers the whole loop.
_DEFAULT = SpanTracer()


def default_tracer() -> SpanTracer:
    return _DEFAULT
