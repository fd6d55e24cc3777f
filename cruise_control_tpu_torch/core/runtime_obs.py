"""Device runtime observability: build events, memory/padding, and
host<->device transfer accounting (port of
``cruise_control_tpu/core/runtime_obs.py``).

The reference counts XLA compilations. The port compiles no programs at
run time; what stalls a cycle in its place are its own events:

- **Build events.** A kernel-library build (``nvcc`` runs) or load (the
  cached library is opened), which ``kernels.load_library`` reports to the
  default collector through :meth:`DeviceStatsCollector.record_library`.
  Each is a :class:`CompileEvent` (trigger ``cold`` the first time a
  program name is seen, ``aot-warmup`` inside
  :meth:`DeviceStatsCollector.warming`, ``signature-change`` for a repeat
  of an already-built name), so a cycle that loads the library after
  ``warmup`` shows as a compile event. A goal chain's CUDA-graph capture
  (``analyzer/graph_loop.py``, one a chain and state signature) is
  reported through :meth:`DeviceStatsCollector.record_capture` as a
  compile event with cache ``capture``; a warm call captures nothing. The
  reference's
  ``lower``/``aot_compile`` entry points have no counterpart here.
- **Dispatch counts.** :meth:`DeviceStatsCollector.track` wraps a callable
  (a kernel wrapper) and counts its dispatches per program name.
- **Transfer accounting.** ``record_h2d``/``record_d2h`` counters fed by the
  known boundary crossings (``FlatClusterModel.from_numpy`` uploads, the
  resident state's delta payloads); :meth:`DeviceStatsCollector.cycle`
  brackets one cycle and snapshots the per-cycle deltas.
- **Device memory.** ``memory_snapshot`` reads ``torch.cuda``'s allocator
  (``memory_allocated``/``memory_stats``); on a process that never touched
  the card only the host-side fields are filled.
- **Padding waste.** :meth:`DeviceStatsCollector.observe_padding` (fed
  host-side by the monitor's assemblers) and ``padding_from_model``, with
  the reference's budgets and JSON keys.

One process-wide default collector (:func:`default_collector`) keeps wiring
optional, exactly like :func:`~.tracing.default_tracer`.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque

from .sensors import MetricRegistry

LOG = logging.getLogger(__name__)

#: sensor group for every collector-owned series (``DeviceRuntime.*``).
DEVICE_RUNTIME_SENSOR = "DeviceRuntime"

#: compile-event triggers (the taxonomy /devicestats reports).
TRIGGER_COLD = "cold"
TRIGGER_AOT = "aot-warmup"
TRIGGER_SIGNATURE = "signature-change"

#: program name of the kernel library's build/load events
KERNEL_LIBRARY_PROGRAM = "kernels.library"

_tls = threading.local()


class CompileEvent:
    """One observed kernel-library build or load, or a CUDA-graph capture
    (``cache`` says which: "build", "load" or "capture")."""

    __slots__ = ("program", "bucket", "trigger", "cache", "duration_s",
                 "time_s", "thread_name")

    def __init__(self, program: str, bucket: str, trigger: str, cache: str,
                 duration_s: float, time_s: float, thread_name: str) -> None:
        self.program = program
        self.bucket = bucket
        self.trigger = trigger
        self.cache = cache
        self.duration_s = duration_s
        self.time_s = time_s
        self.thread_name = thread_name

    def to_json(self) -> dict:
        return {"program": self.program, "shapeBucket": self.bucket,
                "trigger": self.trigger, "cache": self.cache,
                "durationMs": round(self.duration_s * 1e3, 3),
                "backendCompileMs": round(
                    self.duration_s * 1e3 if self.cache == "build" else 0.0,
                    3),
                "thread": self.thread_name}


class _ProgramStats:
    __slots__ = ("name", "compiles", "aot_compiles", "dispatches")

    def __init__(self, name: str) -> None:
        self.name = name
        self.compiles = 0
        self.aot_compiles = 0
        self.dispatches = 0

    def to_json(self) -> dict:
        return {"compiles": self.compiles, "aotCompiles": self.aot_compiles,
                "dispatches": self.dispatches}


class TrackedProgram:
    """Wrapper around one device callable: counts its dispatches under
    ``name``. Transparent: args and outputs pass straight through; a
    disabled collector reduces a call to one attribute check."""

    __slots__ = ("collector", "name", "fn")

    def __init__(self, collector: "DeviceStatsCollector", name: str,
                 fn) -> None:
        self.collector = collector
        self.name = name
        self.fn = fn

    def __call__(self, *args):
        out = self.fn(*args)
        if self.collector.enabled:
            self.collector._on_dispatch(self.name)
        return out


class DeviceStatsCollector:
    """The process's device-runtime ledger (see module docstring).

    Thread-safe; ``enabled = False`` turns every hook into a no-op.
    """

    def __init__(self, registry: MetricRegistry | None = None,
                 tracer=None, max_events: int = 256) -> None:
        from .tracing import default_tracer
        self.registry = registry or MetricRegistry()
        self.tracer = tracer or default_tracer()
        self.enabled = True
        self._lock = threading.Lock()
        self._programs: dict[str, _ProgramStats] = {}
        self._built: set[str] = set()
        self._events: deque[CompileEvent] = deque(maxlen=max_events)
        self._captures = 0
        self._epoch = time.perf_counter()
        self._h2d_bytes = 0
        self._d2h_bytes = 0
        self._last_cycle: dict | None = None
        #: bumps when an outermost cycle() records
        self.cycle_seq = 0
        self._padding: dict | None = None
        self._peak_live_bytes = 0
        self._peak_alloc_bytes = 0
        #: configured budgets (None = unenforced): padding waste as a max
        #: pct over the observed axes, device memory as peak bytes.
        self._padding_budget_pct: float | None = None
        self._hbm_budget_bytes: int | None = None
        name = MetricRegistry.name
        g = DEVICE_RUNTIME_SENSOR
        self._compile_counter = self.registry.counter(
            name(g, "compile-events"))
        self._recompile_counter = self.registry.counter(
            name(g, "recompile-events"))
        self._aot_counter = self.registry.counter(
            name(g, "aot-compile-events"))
        self._compile_timer = self.registry.timer(name(g, "compile-timer"))
        self._h2d_counter = self.registry.counter(
            name(g, "h2d-transfer-bytes"))
        self._d2h_counter = self.registry.counter(
            name(g, "d2h-transfer-bytes"))
        self.registry.gauge(name(g, "last-cycle-h2d-bytes"),
                            lambda: (self._last_cycle or {}).get("h2dBytes"))
        self.registry.gauge(name(g, "last-cycle-d2h-bytes"),
                            lambda: (self._last_cycle or {}).get("d2hBytes"))
        self.registry.gauge(
            name(g, "last-cycle-compile-events"),
            lambda: (self._last_cycle or {}).get("compileEvents"))
        self.registry.gauge(name(g, "device-live-bytes"),
                            lambda: self.memory_snapshot()["liveBytes"])
        self.registry.gauge(name(g, "device-peak-live-bytes"),
                            lambda: self._peak_live_bytes or None)
        self.registry.gauge(
            name(g, "padding-waste-partition-pct"),
            lambda: (self._padding or {}).get("partitionWastePct"))
        self.registry.gauge(
            name(g, "padding-waste-broker-pct"),
            lambda: (self._padding or {}).get("brokerWastePct"))
        self.registry.gauge(
            name(g, "padding-waste-replica-slot-pct"),
            lambda: (self._padding or {}).get("replicaSlotWastePct"))

    # -------------------------------------------------------- programs
    def track(self, name: str, fn) -> TrackedProgram:
        """Wrap a device callable under ``name``; its dispatches count into
        the program's ledger row."""
        self._stats(name)
        return TrackedProgram(self, name, fn)

    def _stats(self, name: str) -> _ProgramStats:
        with self._lock:
            st = self._programs.get(name)
            if st is None:
                st = self._programs[name] = _ProgramStats(name)
            return st

    def _on_dispatch(self, name: str) -> None:
        st = self._stats(name)
        with self._lock:
            st.dispatches += 1
        self.registry.counter(MetricRegistry.name(
            DEVICE_RUNTIME_SENSOR, f"program-{name}-dispatch-count")).inc()

    @contextlib.contextmanager
    def warming(self):
        """Events recorded inside count as ahead-of-time warmup
        (``aot-warmup``), not as cycle compiles."""
        depth = getattr(_tls, "warming", 0)
        _tls.warming = depth + 1
        try:
            yield
        finally:
            _tls.warming = depth

    def record_library(self, kind: str, seconds: float) -> None:
        """Record one kernel-library ``build`` or ``load``."""
        if self.enabled:
            self._on_compile(KERNEL_LIBRARY_PROGRAM, kind, seconds)

    def record_capture(self, program: str, seconds: float) -> None:
        """Record one CUDA-graph capture of ``program`` (a goal chain's
        segments at a new state signature, ``analyzer/graph_loop.py``)."""
        if self.enabled:
            with self._lock:
                self._captures += 1
            self._on_compile(program, "capture", seconds)

    def capture_count(self) -> int:
        """CUDA-graph captures recorded (every trigger)."""
        return self._captures

    def _on_compile(self, name: str, cache: str, duration_s: float) -> None:
        with self._lock:
            repeat = name in self._built
            self._built.add(name)
        if getattr(_tls, "warming", 0):
            trigger = TRIGGER_AOT
        elif repeat:
            trigger = TRIGGER_SIGNATURE
        else:
            trigger = TRIGGER_COLD
        aot = trigger == TRIGGER_AOT
        event = CompileEvent(
            program=name, bucket=cache, trigger=trigger, cache=cache,
            duration_s=duration_s,
            time_s=time.perf_counter() - self._epoch,
            thread_name=threading.current_thread().name)
        st = self._stats(name)
        with self._lock:
            self._events.append(event)
            if aot:
                st.aot_compiles += 1
            else:
                st.compiles += 1
        (self._aot_counter if aot else self._compile_counter).inc()
        if trigger == TRIGGER_SIGNATURE:
            self._recompile_counter.inc()
            LOG.warning("program %s built again (%s, %.2fs)", name, cache,
                        duration_s)
        self.registry.counter(MetricRegistry.name(
            DEVICE_RUNTIME_SENSOR, f"program-{name}-compile-count")).inc()
        self._compile_timer.update(duration_s)
        self.tracer.record(f"compile.{name}", duration_s,
                           attrs={"trigger": trigger, "cache": cache})

    # -------------------------------------------------------- transfers
    def record_h2d(self, nbytes: int) -> None:
        if not self.enabled or not nbytes:
            return
        with self._lock:
            self._h2d_bytes += int(nbytes)
        self._h2d_counter.inc(int(nbytes))

    def record_d2h(self, nbytes: int) -> None:
        if not self.enabled or not nbytes:
            return
        with self._lock:
            self._d2h_bytes += int(nbytes)
        self._d2h_counter.inc(int(nbytes))

    @contextlib.contextmanager
    def cycle(self, label: str = "propose"):
        """Bracket one logical cycle: on exit the h2d/d2h/compile deltas
        land in ``last_cycle`` (and its gauges). Reentrant per thread —
        only the outermost cycle records."""
        if not self.enabled:
            yield
            return
        depth = getattr(_tls, "cycle_depth", 0)
        _tls.cycle_depth = depth + 1
        if depth:
            try:
                yield
            finally:
                _tls.cycle_depth = depth
            return
        with self._lock:
            h2d0, d2h0 = self._h2d_bytes, self._d2h_bytes
        compiles0 = self.compile_count() + self.aot_compile_count()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _tls.cycle_depth = depth
            with self._lock:
                h2d, d2h = self._h2d_bytes - h2d0, self._d2h_bytes - d2h0
            self._last_cycle = {
                "label": label,
                "h2dBytes": h2d, "d2hBytes": d2h,
                "transferBytes": h2d + d2h,
                "compileEvents": (self.compile_count()
                                  + self.aot_compile_count() - compiles0),
                "durationMs": round((time.perf_counter() - t0) * 1e3, 3)}
            self.cycle_seq += 1

    @property
    def last_cycle(self) -> dict | None:
        return self._last_cycle

    # ----------------------------------------------------------- memory
    def memory_snapshot(self) -> dict:
        """Live/peak device memory from ``torch.cuda``'s caching allocator:
        ``liveBytes`` the bytes of live tensors, the allocator's reserved
        bytes as ``allocatorBytesInUse``. A process whose CUDA context was
        never created reports the keys with no device numbers (``source``
        "host")."""
        import torch
        live = peak_alloc = in_use = num_live = None
        source = "host"
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            live = int(torch.cuda.memory_allocated())
            num_live = int(stats.get("active.all.current", 0))
            in_use = int(torch.cuda.memory_reserved())
            peak_alloc = int(torch.cuda.max_memory_reserved())
            source = "torch.cuda"
            with self._lock:
                self._peak_live_bytes = max(self._peak_live_bytes, live)
                self._peak_alloc_bytes = max(self._peak_alloc_bytes,
                                             peak_alloc)
        return {"liveBytes": live, "numLiveArrays": num_live,
                "peakLiveBytes": self._peak_live_bytes or None,
                "maxDeviceLiveBytes": live,
                "peakDeviceLiveBytes": self._peak_live_bytes or None,
                "allocatorBytesInUse": in_use,
                "allocatorPeakBytes": peak_alloc,
                "source": source}

    # ---------------------------------------------------------- padding
    def observe_padding(self, *, partitions: int, partitions_padded: int,
                        brokers: int, brokers_padded: int,
                        replica_slots_used: int | None = None,
                        replica_slots_total: int | None = None) -> dict:
        """Record padding-waste ratios from host-side counts (the
        monitor's assemblers know them before any device upload)."""
        def waste(real, padded):
            if not padded:
                return 0.0
            return round(100.0 * (1.0 - real / padded), 3)
        padding = {
            "partitions": partitions, "partitionsPadded": partitions_padded,
            "partitionWastePct": waste(partitions, partitions_padded),
            "brokers": brokers, "brokersPadded": brokers_padded,
            "brokerWastePct": waste(brokers, brokers_padded),
        }
        if replica_slots_total:
            padding.update(
                replicaSlotsUsed=replica_slots_used,
                replicaSlotsTotal=replica_slots_total,
                replicaSlotWastePct=waste(replica_slots_used,
                                          replica_slots_total))
        self._padding = padding
        budget = self._padding_budget_pct
        if budget is not None:
            worst = max(padding["partitionWastePct"],
                        padding["brokerWastePct"])
            if worst > budget:
                LOG.warning(
                    "padding waste %.1f%% exceeds the configured budget "
                    "of %.1f%% (partitions %d/%d, brokers %d/%d) — "
                    "check the model.*.pad.multiple knobs", worst, budget,
                    partitions, partitions_padded, brokers, brokers_padded)
        return padding

    def padding_from_model(self, model) -> dict:
        """Padding waste straight from a ``FlatClusterModel``'s valid
        masks (reads them to the host — a test/debug surface)."""
        pvalid = model.partition_valid.cpu().numpy()
        bvalid = model.broker_valid.cpu().numpy()
        rvalid = model.replica_valid.cpu().numpy()
        return self.observe_padding(
            partitions=int(pvalid.sum()), partitions_padded=pvalid.size,
            brokers=int(bvalid.sum()), brokers_padded=bvalid.size,
            replica_slots_used=int(rvalid.sum()),
            replica_slots_total=int(rvalid.size))

    # ---------------------------------------------------------- budgets
    def set_budgets(self, *, padding_waste_pct: float | None = None,
                    hbm_bytes: int | None = None) -> None:
        """Configure the padding/memory budgets (0/None = unenforced)."""
        self._padding_budget_pct = padding_waste_pct or None
        self._hbm_budget_bytes = hbm_bytes or None

    def budget_status(self, *, refresh_memory: bool = False) -> dict:
        """Current standing against the configured budgets: the worst of
        the partition/broker padding axes, and the worst of the live and
        allocator peaks."""
        padding = self._padding or {}
        waste = None
        if padding:
            waste = max(padding.get("partitionWastePct") or 0.0,
                        padding.get("brokerWastePct") or 0.0)
        if refresh_memory:
            self.memory_snapshot()
        peak = max(self._peak_live_bytes, self._peak_alloc_bytes) or None
        out = {
            "paddingWastePct": waste,
            "paddingWasteBudgetPct": self._padding_budget_pct,
            "peakBytes": peak,
            "hbmBudgetBytes": self._hbm_budget_bytes,
        }
        out["paddingOverBudget"] = bool(
            self._padding_budget_pct is not None and waste is not None
            and waste > self._padding_budget_pct)
        out["hbmOverBudget"] = bool(
            self._hbm_budget_bytes is not None and peak is not None
            and peak > self._hbm_budget_bytes)
        return out

    # ------------------------------------------------------------ reads
    def compile_count(self) -> int:
        return self._compile_counter.count

    def recompile_count(self) -> int:
        return self._recompile_counter.count

    def aot_compile_count(self) -> int:
        return self._aot_counter.count

    def events(self) -> list[CompileEvent]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        """Cheap counter snapshot for before/after diffing (the
        zero-build-after-warmup gate's surface)."""
        with self._lock:
            h2d, d2h = self._h2d_bytes, self._d2h_bytes
        return {"compileEvents": self.compile_count(),
                "aotCompileEvents": self.aot_compile_count(),
                "recompileEvents": self.recompile_count(),
                "captureEvents": self.capture_count(),
                "h2dBytes": h2d, "d2hBytes": d2h}

    def to_json(self, recent_events: int = 64) -> dict:
        """The /devicestats payload."""
        with self._lock:
            programs = {name: st.to_json()
                        for name, st in sorted(self._programs.items())}
            events = list(self._events)[-recent_events:]
            h2d, d2h = self._h2d_bytes, self._d2h_bytes
        return {
            "enabled": self.enabled,
            "compile": {
                "totalEvents": self.compile_count(),
                "aotEvents": self.aot_compile_count(),
                "recompileEvents": self.recompile_count(),
                "byProgram": programs,
                "recentEvents": [e.to_json() for e in events],
            },
            "transfers": {
                "h2dBytesTotal": h2d,
                "d2hBytesTotal": d2h,
                "lastCycle": self._last_cycle,
            },
            "memory": self.memory_snapshot(),
            "padding": self._padding,
            "budget": self.budget_status(),
        }


#: process-wide default (the analog of default_tracer): subsystems built
#: with ``collector=None`` share it, so one /devicestats dump covers the
#: whole pipeline.
_DEFAULT = DeviceStatsCollector()


def default_collector() -> DeviceStatsCollector:
    return _DEFAULT
