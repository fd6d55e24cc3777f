"""Sampling task runner: the monitor's state machine + scheduled loop.

Rebuild of ``monitor/task/LoadMonitorTaskRunner.java:33`` with states
``NOT_STARTED / LOADING / RUNNING / SAMPLING / PAUSED / BOOTSTRAPPING``
(``:57-58``) and the bootstrap task (``BootstrapTask.java`` — replay a
historic range through the sampler to warm the aggregators).

Clock-driven rather than thread-scheduled: :meth:`maybe_run_sampling` is
called by the serving loop (or a timer thread) and fires when the sampling
interval elapsed — the same pattern the executor uses, keeping tests
wall-clock free.
"""

from __future__ import annotations

import enum
import threading

from .fetcher import MetricFetcherManager
from .monitor import LoadMonitor


class RunnerState(enum.Enum):
    NOT_STARTED = "NOT_STARTED"
    LOADING = "LOADING"
    RUNNING = "RUNNING"
    SAMPLING = "SAMPLING"
    PAUSED = "PAUSED"
    BOOTSTRAPPING = "BOOTSTRAPPING"
    TRAINING = "TRAINING"


class LoadMonitorTaskRunner:
    def __init__(self, monitor: LoadMonitor, fetcher: MetricFetcherManager,
                 sampling_interval_ms: int = 120_000) -> None:
        self.monitor = monitor
        self.fetcher = fetcher
        self.sampling_interval_ms = sampling_interval_ms
        self._state = RunnerState.NOT_STARTED
        self._lock = threading.RLock()
        self._last_sample_ms: int | None = None
        self._reason_for_pause: str | None = None

    @property
    def state(self) -> RunnerState:
        return self._state

    # ------------------------------------------------------------ lifecycle
    def start(self, now_ms: int, *, skip_loading: bool = False) -> int:
        """Replay persisted samples (LOADING) then enter RUNNING (ref
        LoadMonitor.startUp -> sample store loading). Returns #samples
        replayed."""
        with self._lock:
            if self._state is not RunnerState.NOT_STARTED:
                raise RuntimeError(f"already started ({self._state})")
            replayed = 0
            newest = 0
            if not skip_loading:
                self._state = RunnerState.LOADING
                samples = self.fetcher.store.load_samples()
                self.monitor.add_samples(samples)
                replayed = (len(samples.partition_samples)
                            + len(samples.broker_samples))
                if replayed:
                    newest = max(
                        s.time_ms
                        for s in (samples.partition_samples
                                  + samples.broker_samples))
            self._state = RunnerState.RUNNING
            if replayed:
                # Seed from the newest replayed sample so the first live
                # round starts where the store left off — otherwise it
                # re-covers [now-interval, now) and double-ingests samples
                # just replayed from that window (sample_counts inflate).
                # Clamped into [now - aggregator retention, now]: after a
                # long downtime the catch-up fetch is bounded by what the
                # windows can retain anyway (an uncapped range would be one
                # giant query — Prometheus rejects >11K points/series — and
                # a future timestamp from clock skew would stall sampling).
                c = self.monitor.config
                retention_ms = max(
                    c.num_windows * c.window_ms,
                    c.num_broker_windows * c.broker_window_ms)
                self._last_sample_ms = min(
                    max(newest, now_ms - retention_ms), now_ms)
            else:
                # Leave unset: the first maybe_run_sampling is immediately
                # due (the reference's sampling loop fetches right at
                # startup) and covers one interval back.
                self._last_sample_ms = None
            return replayed

    def pause(self, reason: str = "") -> None:
        """ref pauseSampling (PAUSE_SAMPLING endpoint)."""
        with self._lock:
            if self._state in (RunnerState.RUNNING, RunnerState.SAMPLING):
                self._state = RunnerState.PAUSED
                self._reason_for_pause = reason

    def resume(self, reason: str = "") -> None:
        with self._lock:
            if self._state is RunnerState.PAUSED:
                self._state = RunnerState.RUNNING
                self._reason_for_pause = None

    # ------------------------------------------------------------- sampling
    def maybe_run_sampling(self, now_ms: int) -> bool:
        """Run one sampling round if due; returns True when sampled."""
        with self._lock:
            if self._state is not RunnerState.RUNNING:
                return False
            if (self._last_sample_ms is not None
                    and now_ms - self._last_sample_ms < self.sampling_interval_ms):
                return False
            self._state = RunnerState.SAMPLING
        try:
            # First round covers one interval back: a [now, now) window
            # would be empty, so window-filtered samplers (the agent
            # pipeline, Prometheus range queries) could never deliver
            # their first records.
            start = (max(now_ms - self.sampling_interval_ms, 0)
                     if self._last_sample_ms is None
                     else self._last_sample_ms)
            partitions = sorted(self.monitor.admin.describe_partitions())
            brokers = sorted(self.monitor.admin.describe_cluster())
            samples = self.fetcher.fetch(partitions, brokers, start, now_ms)
            self.monitor.add_samples(samples)
            self._last_sample_ms = now_ms
            return True
        finally:
            with self._lock:
                if self._state is RunnerState.SAMPLING:
                    self._state = RunnerState.RUNNING

    def bootstrap(self, start_ms: int, end_ms: int,
                  step_ms: int | None = None) -> int:
        """Replay a historic range through the sampler to warm the window
        history (ref BootstrapTask.java; BOOTSTRAP endpoint). Returns the
        number of sampling rounds executed."""
        with self._lock:
            prev = self._state
            if prev is RunnerState.NOT_STARTED:
                raise RuntimeError("start() the runner before bootstrapping")
            if prev not in (RunnerState.RUNNING, RunnerState.PAUSED):
                raise RuntimeError(
                    f"cannot bootstrap while {prev.value} (a sampling or "
                    "bootstrap round is in flight)")
            self._state = RunnerState.BOOTSTRAPPING
        rounds = 0
        try:
            step = step_ms or self.sampling_interval_ms
            partitions = sorted(self.monitor.admin.describe_partitions())
            brokers = sorted(self.monitor.admin.describe_cluster())
            t = start_ms
            while t < end_ms:
                t_end = min(t + step, end_ms)
                samples = self.fetcher.fetch(partitions, brokers, t, t_end)
                self.monitor.add_samples(samples)
                t = t_end
                rounds += 1
            self._last_sample_ms = end_ms
            return rounds
        finally:
            with self._lock:
                if self._state is RunnerState.BOOTSTRAPPING:
                    self._state = prev

    def training(self):
        """Context manager marking a TRAIN run in the state machine (ref
        LoadMonitorTaskRunner.java:57-58 TRAINING state — sampling pauses
        while the regression trains, and resumes after)."""
        runner = self

        class _Training:
            def __enter__(self):
                with runner._lock:
                    self._prev = runner._state
                    if self._prev not in (RunnerState.RUNNING,
                                          RunnerState.PAUSED):
                        raise RuntimeError(
                            f"cannot train while {self._prev.value}")
                    runner._state = RunnerState.TRAINING
                return self

            def __exit__(self, *exc):
                with runner._lock:
                    if runner._state is RunnerState.TRAINING:
                        runner._state = self._prev
                return False

        return _Training()

    def state_json(self) -> dict:
        return {"state": self._state.value,
                "reasonOfLatestPauseOrResume": self._reason_for_pause,
                "lastSampleTimeMs": self._last_sample_ms}
