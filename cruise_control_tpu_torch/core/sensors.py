"""Self-metric sensors: the framework's own observability registry.

Rebuild of the reference's Dropwizard ``MetricRegistry`` usage — a registry
threaded through every subsystem constructor (ref
``KafkaCruiseControl.java:112``, ``GoalOptimizer.java:128``
``proposal-computation-timer``, ``LoadMonitor.java:101``
``cluster-model-creation-timer``, ``Executor.java:256-420`` execution
gauges/timers, ``AnomalyDetectorManager.java:183-216`` balancedness and
self-healing sensors, ``ExecutionTaskTracker.java:103-122`` per-state task
gauges) — exposed over HTTP instead of JMX: ``/metrics`` serves a
Prometheus-style text exposition and ``/state`` embeds the JSON snapshot.

Sensor types mirror the Dropwizard quartet:

- :class:`Counter` — monotonically increasing count.
- :class:`Meter` — count + event rate over a sliding window (ref Dropwizard
  ``Meter``'s one-minute rate; here an exact sliding-window rate, not an
  EWMA — simpler, and exact for the test clock).
- :class:`Timer` — durations with count/mean/max and streaming quantiles
  over a bounded reservoir.
- :class:`Gauge` — a callable read at scrape time (ref dropwizard
  ``Gauge<T>`` lambdas registered at constructor time).

All sensors are thread-safe; reads never block writers for long.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def count(self) -> int:
        return self._value

    def to_json(self) -> dict:
        return {"type": "counter", "count": self._value}


class StripedCounter(Counter):
    """Lock-free ``inc``: each thread owns a private cell (only the owner
    thread read-modify-writes it, so the CPython ``+=`` race vanishes
    without a lock); reads sum the stripes at scrape time. Renders as a
    plain counter family — striping changes the write path, never the
    scrape surface."""

    __slots__ = ("_stripes",)

    def __init__(self) -> None:
        super().__init__()
        self._stripes: dict[int, list[int]] = {}

    def inc(self, n: int = 1) -> None:
        ident = threading.get_ident()
        cell = self._stripes.get(ident)
        if cell is None:
            self._stripes[ident] = cell = [0]
        cell[0] += n

    @property
    def count(self) -> int:
        return self._value + sum(c[0] for c in list(self._stripes.values()))

    def to_json(self) -> dict:
        return {"type": "counter", "count": self.count}


class Meter:
    """Count + sliding-window rate (events/s over the last ``window_s``)."""

    __slots__ = ("_count", "_events", "_window_s", "_lock", "_now")

    def __init__(self, window_s: float = 60.0,
                 now: Callable[[], float] | None = None) -> None:
        self._count = 0
        self._events: list[tuple[float, int]] = []
        self._window_s = window_s
        self._lock = threading.Lock()
        self._now = now or time.monotonic

    def mark(self, n: int = 1) -> None:
        now = self._now()
        with self._lock:
            self._count += n
            self._events.append((now, n))
            cutoff = now - self._window_s
            while self._events and self._events[0][0] < cutoff:
                self._events.pop(0)

    @property
    def count(self) -> int:
        return self._count

    def rate(self) -> float:
        now = self._now()
        cutoff = now - self._window_s
        with self._lock:
            total = sum(n for t, n in self._events if t >= cutoff)
        return total / self._window_s

    def to_json(self) -> dict:
        return {"type": "meter", "count": self._count,
                "rate_per_s": round(self.rate(), 6)}


class StripedMeter(Meter):
    """Meter whose ``mark`` takes no lock: marks land on a per-thread
    deque (``deque.append`` is atomic; only the scrape side pops), and
    every read drains the stripes into the base meter under its lock.
    N request threads marking one request-rate meter stop serializing on
    the meter's ``Lock`` — contention moves to the scrape, which is rare.
    Renders identically to :class:`Meter` (same families)."""

    __slots__ = ("_stripes",)

    def __init__(self, window_s: float = 60.0,
                 now: Callable[[], float] | None = None) -> None:
        super().__init__(window_s, now)
        self._stripes: dict[int, deque] = {}

    def mark(self, n: int = 1) -> None:
        ident = threading.get_ident()
        d = self._stripes.get(ident)
        if d is None:
            self._stripes[ident] = d = deque()
        d.append((self._now(), n))

    def _drain_locked(self) -> None:
        for d in list(self._stripes.values()):
            while True:
                try:
                    t, n = d.popleft()
                except IndexError:
                    break
                self._count += n
                self._events.append((t, n))
        cutoff = self._now() - self._window_s
        if self._events and self._events[0][0] < cutoff:
            # Stripes drain slightly out of order; filter, don't pop-front.
            self._events = [(t, n) for t, n in self._events if t >= cutoff]

    @property
    def count(self) -> int:
        with self._lock:
            self._drain_locked()
            return self._count

    def rate(self) -> float:
        now = self._now()
        cutoff = now - self._window_s
        with self._lock:
            self._drain_locked()
            total = sum(n for t, n in self._events if t >= cutoff)
        return total / self._window_s

    def to_json(self) -> dict:
        rate = self.rate()                      # drains the stripes
        return {"type": "meter", "count": self._count,
                "rate_per_s": round(rate, 6)}


class Timer:
    """Duration sensor: count / mean / max / quantiles over a bounded
    reservoir (most recent ``reservoir`` observations)."""

    __slots__ = ("_count", "_sum", "_max", "_reservoir", "_cap", "_lock")

    def __init__(self, reservoir: int = 1024) -> None:
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._reservoir: list[float] = []
        self._cap = reservoir
        self._lock = threading.Lock()

    def update(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += seconds
            self._max = max(self._max, seconds)
            if len(self._reservoir) >= self._cap:
                self._reservoir.pop(0)
            self._reservoir.append(seconds)

    def time(self):
        """Context manager: ``with timer.time(): ...``"""
        return _TimerContext(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean_s(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._reservoir:
                return 0.0
            data = sorted(self._reservoir)
        idx = min(int(q * len(data)), len(data) - 1)
        return data[idx]

    def to_json(self) -> dict:
        return {"type": "timer", "count": self._count,
                "mean_s": round(self.mean_s, 6),
                "max_s": round(self._max, 6),
                "p50_s": round(self.quantile(0.50), 6),
                "p95_s": round(self.quantile(0.95), 6),
                "p99_s": round(self.quantile(0.99), 6)}


class StripedTimer(Timer):
    """Timer whose ``update`` takes no lock (per-thread deques, drained
    into the base reservoir on any read — see :class:`StripedMeter`).
    Renders identically to :class:`Timer` (same summary family)."""

    __slots__ = ("_stripes",)

    def __init__(self, reservoir: int = 1024) -> None:
        super().__init__(reservoir)
        self._stripes: dict[int, deque] = {}

    def update(self, seconds: float) -> None:
        ident = threading.get_ident()
        d = self._stripes.get(ident)
        if d is None:
            self._stripes[ident] = d = deque()
        d.append(seconds)

    def _flush(self) -> None:
        with self._lock:
            for d in list(self._stripes.values()):
                while True:
                    try:
                        seconds = d.popleft()
                    except IndexError:
                        break
                    self._count += 1
                    self._sum += seconds
                    self._max = max(self._max, seconds)
                    if len(self._reservoir) >= self._cap:
                        self._reservoir.pop(0)
                    self._reservoir.append(seconds)

    @property
    def count(self) -> int:
        self._flush()
        return self._count

    @property
    def mean_s(self) -> float:
        self._flush()
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        self._flush()
        return super().quantile(q)

    def to_json(self) -> dict:
        self._flush()
        return super().to_json()


class _TimerContext:
    __slots__ = ("_timer", "_start")

    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.update(time.perf_counter() - self._start)
        return False


class Gauge:
    """Callable read at scrape time (ref Dropwizard ``Gauge<T>``).
    Scrape errors surface as None rather than failing the whole report."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def value(self):
        try:
            return self._fn()
        except Exception:
            return None

    def to_json(self) -> dict:
        return {"type": "gauge", "value": self.value()}


def _family_names(base: str, s: object) -> tuple[str, ...]:
    """Rendered Prometheus family names for a sensor at a given base."""
    if isinstance(s, Counter):
        return (f"{base}_total",)
    if isinstance(s, Meter):
        return (f"{base}_total", f"{base}_rate")
    if isinstance(s, Timer):
        return (f"{base}_seconds",)
    return (base,)


def _flatten_names(items: list[tuple[str, object]]) -> list[str]:
    """Per-item unique ``cc_`` series base (positional — aligned with
    ``items``).

    Flattening maps every non-alphanumeric to ``_``, so distinct dotted
    names can collide (``A.b-c`` and ``A.b.c`` both flatten to
    ``cc_A_b_c``) — and a merged multi-registry scrape can even carry
    the SAME dotted name twice (two fleet members' monitors). Both used
    to emit duplicate ``# TYPE`` blocks, an exposition-format violation.
    Uniqueness is enforced positionally on the RENDERED family names
    (kind suffixes included: a Counter ``A.b`` and a Gauge ``A.b.total``
    both render family ``cc_A_b_total``), disambiguated deterministically
    (sorted input order) with a numeric suffix. Suffix-deduped families
    are format-legal but unattributable — fleet scrapes must namespace
    per-cluster registries instead (:class:`NamespacedRegistry`;
    tests/prom_lint.py's ``forbid_unlabeled_duplicates`` rejects the
    suffix form)."""
    assigned: set[str] = set()
    out: list[str] = []
    for name, s in items:
        base = "cc_" + "".join(ch if (ch.isalnum() or ch == "_") else "_"
                               for ch in name)
        candidate, i = base, 1
        while any(f in assigned for f in _family_names(candidate, s)):
            i += 1
            candidate = f"{base}_{i}"
        assigned.update(_family_names(candidate, s))
        out.append(candidate)
    return out


def _render_exposition(items: list[tuple[str, object]],
                       flat: list[str] | None = None) -> str:
    """Prometheus text exposition over sorted (dotted name, sensor) pairs —
    the ONE renderer behind both ``MetricRegistry.expose_text`` and the
    composite view (so merged registries cannot emit duplicate ``# TYPE``
    blocks either). Every series family carries a ``# HELP`` line naming
    the original dotted sensor. ``flat`` lets callers reuse a cached
    :func:`_flatten_names` result (the merge/sort/flatten structure is
    the expensive scrape half; values are always read live)."""
    if flat is None:
        flat = _flatten_names(items)
    lines: list[str] = []

    def family(series: str, dotted: str, kind: str) -> None:
        lines.append(f"# HELP {series} sensor {dotted}")
        lines.append(f"# TYPE {series} {kind}")

    for (name, s), base in zip(items, flat):
        if isinstance(s, Counter):
            family(f"{base}_total", name, "counter")
            lines.append(f"{base}_total {s.count}")
        elif isinstance(s, Meter):
            family(f"{base}_total", name, "counter")
            lines.append(f"{base}_total {s.count}")
            family(f"{base}_rate", name, "gauge")
            lines.append(f"{base}_rate {s.rate():.6f}")
        elif isinstance(s, Timer):
            family(f"{base}_seconds", name, "summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(f"{base}_seconds{{quantile=\"{q}\"}} "
                             f"{s.quantile(q):.6f}")
            lines.append(f"{base}_seconds_count {s.count}")
            lines.append(f"{base}_seconds_sum {s._sum:.6f}")
        elif isinstance(s, Gauge):
            v = s.value()
            if v is None:
                continue
            try:
                rendered = f"{base} {float(v):.6f}"
            except (TypeError, ValueError):
                continue        # non-numeric gauges are dropped
            family(base, name, "gauge")
            lines.append(rendered)
    return "\n".join(lines) + "\n"


class MetricRegistry:
    """Named sensor registry (ref ``com.codahale.metrics.MetricRegistry``).

    Names follow the reference's dotted ``<group>.<sensor>`` convention,
    e.g. ``GoalOptimizer.proposal-computation-timer``. ``timer``/``meter``/
    ``counter`` are get-or-create (idempotent); ``gauge`` re-registration
    replaces the callable (matching ``register``'s last-wins usage for
    refreshed lambdas).
    """

    def __init__(self) -> None:
        self._sensors: dict[str, object] = {}
        self._lock = threading.Lock()
        #: bumps on every STRUCTURAL change (new sensor, replaced gauge).
        #: Values changing does not count — the exposition render cache
        #: keys on this to reuse the merge/flatten structure while still
        #: reading every value live at scrape time.
        self._mutations = 0
        self._render_cache: tuple | None = None

    @property
    def mutation_count(self) -> int:
        return self._mutations

    @staticmethod
    def name(group: str, sensor: str) -> str:
        return f"{group}.{sensor}"

    def _get_or_create(self, name: str, factory, kind) -> object:
        with self._lock:
            s = self._sensors.get(name)
            if s is None:
                s = factory()
                self._sensors[name] = s
                self._mutations += 1
            elif not isinstance(s, kind):
                raise TypeError(
                    f"sensor {name!r} already registered as "
                    f"{type(s).__name__}")
            return s

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def striped_counter(self, name: str) -> StripedCounter:
        return self._get_or_create(name, StripedCounter, StripedCounter)

    def meter(self, name: str, window_s: float = 60.0,
              now: Callable[[], float] | None = None) -> Meter:
        return self._get_or_create(
            name, lambda: Meter(window_s, now), Meter)

    def striped_meter(self, name: str, window_s: float = 60.0,
                      now: Callable[[], float] | None = None) -> StripedMeter:
        return self._get_or_create(
            name, lambda: StripedMeter(window_s, now), StripedMeter)

    def timer(self, name: str) -> Timer:
        return self._get_or_create(name, Timer, Timer)

    def striped_timer(self, name: str) -> StripedTimer:
        return self._get_or_create(name, StripedTimer, StripedTimer)

    def gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        with self._lock:
            g = Gauge(fn)
            self._sensors[name] = g
            self._mutations += 1
            return g

    def get(self, name: str):
        return self._sensors.get(name)

    def names(self) -> list[str]:
        return sorted(self._sensors)

    def snapshot(self) -> list[tuple[str, object]]:
        """Locked point-in-time (dotted name, sensor) list — the public
        merge surface the composite view renders from."""
        with self._lock:
            return sorted(self._sensors.items())

    # -------------------------------------------------------------- export
    def to_json(self) -> dict:
        """{name: sensor-json} snapshot for ``/state``."""
        with self._lock:
            items = list(self._sensors.items())
        return {name: s.to_json() for name, s in sorted(items)}

    def expose_text(self) -> str:
        """Prometheus-style text exposition for ``/metrics``.

        Sensor names are flattened to ``cc_<group>_<sensor>`` (collisions
        disambiguated — see :func:`_flatten_names`); timers emit
        ``_count``/``_sum`` and quantile series (a summary), meters
        ``_total`` and ``_rate``, counters ``_total``, gauges the bare
        name. Every family carries ``# HELP`` and exactly one ``# TYPE``.

        The merge/sort/flatten structure is cached and invalidated by the
        registry's mutation counter, so steady-state scrapes only format
        values — they stop re-sorting and re-deduplicating family names
        every time (the Prometheus-scrape hot path).
        """
        muts = self._mutations
        cache = self._render_cache
        if cache is not None and cache[0] == muts:
            items, flat = cache[1], cache[2]
        else:
            items = self.snapshot()
            flat = _flatten_names(items)
            self._render_cache = (muts, items, flat)
        return _render_exposition(items, flat)


class CompositeRegistry:
    """Read-only merged view over several registries, resolved at scrape
    time. The facade exposes one of these spanning its wired subsystems, so
    two independently constructed stacks in one process never share sensor
    state (each subsystem defaults to its own private registry) while
    ``/metrics`` and ``/state?substates=sensors`` still see everything.
    Subsystem sensor names are group-prefixed, so merges cannot collide."""

    def __init__(self, sources: Callable[[], list[MetricRegistry]]) -> None:
        self._raw_sources = sources
        self._render_cache: tuple | None = None

    def _sources(self) -> list[MetricRegistry]:
        # Dedupe by identity: subsystems wired with ONE shared registry
        # (the reference's single-registry pattern) must not emit every
        # series once per subsystem.
        out: list[MetricRegistry] = []
        for reg in self._raw_sources():
            if all(reg is not seen for seen in out):
                out.append(reg)
        return out

    def get(self, name: str):
        for reg in self._sources():
            s = reg.get(name)
            if s is not None:
                return s
        return None

    @property
    def mutation_count(self) -> int:
        """Structural-change key over every source (len guards source
        attach/detach; per-source counters only grow, so the sum plus the
        count detects any structural change)."""
        sources = self._sources()
        return len(sources) + sum(
            getattr(reg, "mutation_count", 0) for reg in sources)

    def names(self) -> list[str]:
        out: set[str] = set()
        for reg in self._sources():
            out.update(reg.names())
        return sorted(out)

    def to_json(self) -> dict:
        out: dict = {}
        for reg in self._sources():
            out.update(reg.to_json())
        return dict(sorted(out.items()))

    def expose_text(self) -> str:
        # Merge THEN render once: per-registry concatenation would emit a
        # second ``# TYPE`` block whenever two registries carry the same
        # sensor name (first writer wins, matching get()). Duck-typed
        # registries without the snapshot() merge surface (a nested
        # composite, a custom extra_registries entry) keep the old
        # concatenation behavior rather than breaking the scrape.
        #
        # The merged structure (sorted items + flattened family names) is
        # cached against the sources' mutation counters, so a /metrics
        # scrape of a quiet fleet re-renders values but never re-merges,
        # re-sorts, or re-deduplicates hundreds of families per request.
        sources = self._sources()
        snap_sources = [r for r in sources
                        if getattr(r, "snapshot", None) is not None]
        foreign = [r for r in sources
                   if getattr(r, "snapshot", None) is None]
        key = tuple(getattr(r, "mutation_count", -1) for r in snap_sources)
        cache = self._render_cache
        if (cache is not None and cache[0] == key and -1 not in key
                and len(cache[1]) == len(snap_sources)
                and all(a is b for a, b in zip(cache[1], snap_sources))):
            items, flat = cache[2], cache[3]
        else:
            merged: dict[str, object] = {}
            for reg in snap_sources:
                for name, s in reg.snapshot():
                    merged.setdefault(name, s)
            items = sorted(merged.items())
            flat = _flatten_names(items)
            self._render_cache = (key, list(snap_sources), items, flat)
        return _render_exposition(items, flat) + "".join(
            r.expose_text() for r in foreign)


class NamespacedRegistry:
    """Read-only prefix view over a registry: every dotted sensor name
    renders as ``<prefix>.<name>``.

    The fleet layer's scrape problem: registries from multiple
    ``LoadMonitor``/``ProposalCache`` instances (one per member cluster)
    carry IDENTICAL group-prefixed names, so a merged exposition used to
    fall back to ``_flatten_names``' numeric-suffix disambiguation
    (``cc_LoadMonitor_..._2``) — unlabeled duplicates nobody can
    attribute to a cluster. Wrapping each member's registries in a
    ``NamespacedRegistry(reg, cluster_id)`` renders
    ``cc_<cluster>_LoadMonitor_...`` instead; ``tests/prom_lint.py``'s
    ``forbid_unlabeled_duplicates`` rejects the un-namespaced form.

    ``get``/``names`` resolve PREFIXED names (the merge surface); the
    inner registry keeps answering its own un-prefixed names for the
    subsystem that owns it.
    """

    def __init__(self, inner, prefix: str) -> None:
        if not prefix:
            raise ValueError("NamespacedRegistry requires a prefix")
        self.inner = inner
        self.prefix = prefix

    @property
    def mutation_count(self) -> int:
        return getattr(self.inner, "mutation_count", 0)

    def _wrap(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def snapshot(self) -> list[tuple[str, object]]:
        return [(self._wrap(n), s) for n, s in self.inner.snapshot()]

    def get(self, name: str):
        pre = f"{self.prefix}."
        if not name.startswith(pre):
            return None
        return self.inner.get(name[len(pre):])

    def names(self) -> list[str]:
        return sorted(self._wrap(n) for n in self.inner.names())

    def to_json(self) -> dict:
        return {self._wrap(n): s.to_json()
                for n, s in self.inner.snapshot()}

    def expose_text(self) -> str:
        return _render_exposition(self.snapshot())


#: Sensor group names (ref CruiseControlMetrics sensor name constants).
GOAL_OPTIMIZER_SENSOR = "GoalOptimizer"
LOAD_MONITOR_SENSOR = "LoadMonitor"
EXECUTOR_SENSOR = "Executor"
ANOMALY_DETECTOR_SENSOR = "AnomalyDetector"
USER_TASKS_SENSOR = "UserTaskManager"
