"""Fleet registry: the host side of the fleet control plane.

Port of ``cruise_control_tpu/fleet/registry.py``. Owns per-cluster
``LoadMonitor`` instances (the port's, on the card) and their
cluster-scoped ``ProposalCache``s, drives ONE shared tick that builds every
member's model, runs the fleet propose (and, on its configured cadence, the
fleet N-1 resilience sweep) through :class:`..fleet.FleetOptimizer`, hands
the per-cluster results back to each member's cache, and fans anomaly
detection out per cluster. ``summary_json``, ``stats_json`` and
``rebalance`` are the payloads of the reference's ``GET /fleet``, the
``fleet`` section of ``/devicestats`` and ``POST /fleet/rebalance``; the
REST routes themselves are not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..analyzer import OptimizationOptions
from ..analyzer.optimizer import OptimizationFailureError
from ..api.precompute import ProposalCache
from ..core.aggregator import NotEnoughValidWindowsError
from ..model.fleet import FleetModel
from .backends import CircuitBreaker, MemberHealth
from .budget import BudgetRequest, MoveBudgetCoordinator
from .engine import FleetOptimizer

LOG = logging.getLogger(__name__)


@dataclass
class FleetClusterHandle:
    """One registered cluster: its monitor, its cluster-scoped proposal
    cache, an optional per-cluster anomaly detector, its failure-domain
    state (endpoint backend + circuit breaker + health machine), and the
    registry's last per-cluster readouts."""

    cluster_id: str
    monitor: object
    cache: ProposalCache | None = None
    detector: object = None
    #: the member's RemoteBackend (fleet/backends.py) when its admin/
    #: sampler ride a per-cluster endpoint; None for in-process members
    backend: object = None
    #: per-member circuit breaker — shared with the backend when one is
    #: wired, so registry fetch outcomes and backend call outcomes feed
    #: ONE rolling window
    breaker: CircuitBreaker | None = None
    endpoint: str = ""
    health: str = MemberHealth.HEALTHY
    degraded_ticks: int = 0
    health_since_ms: int | None = None
    #: journal seq of the latest health transition (cause-chain anchor)
    health_seq: int | None = None
    ready: bool = False
    generation: int | None = None
    last_error: str | None = None
    last_risk: dict | None = None
    last_forecast: dict | None = None
    last_summary: dict = field(default_factory=dict)


class FleetRegistry:
    """One control plane, many clusters, one fleet propose per tick.

    Members register with their own ``LoadMonitor`` (each monitor keeps
    its private sample history and model generation); the shared tick
    builds every ready member's model (the members' resident device state
    and delta-ingest paths apply unchanged), stacks them into a
    :class:`FleetModel` shape bucket, and runs the fleet propose over
    every member, one after another on the card. Results land
    in each member's generation- AND cluster-keyed cache, so the
    members' ``/proposals`` reads stay cache hits with the same
    freshness machinery the single-cluster path uses.
    """

    def __init__(self, optimizer, *, max_clusters: int = 64,
                 broker_pad_multiple: int = 8,
                 partition_pad_multiple: int = 128,
                 risk_sweep_every: int = 1,
                 options: OptimizationOptions | None = None,
                 registry=None, tracer=None, collector=None,
                 now_ms=None, quarantine_after: int = 3,
                 fetch_workers: int = 4,
                 fetch_deadline_ms: int = 0, seed: int = 0,
                 breaker_window_ms: int = 60_000,
                 breaker_failures: int = 3, breaker_open_ms: int = 30_000,
                 journal=None, notifier=None,
                 budget: MoveBudgetCoordinator | None = None) -> None:
        from ..core.runtime_obs import default_collector
        from ..core.sensors import MetricRegistry
        from ..core.tracing import default_tracer
        self.max_clusters = max_clusters
        self.broker_pad_multiple = broker_pad_multiple
        self.partition_pad_multiple = partition_pad_multiple
        #: run the batched N-1 resilience sweep every Nth tick (0 = off).
        self.risk_sweep_every = risk_sweep_every
        #: the fleet tick is the members' background proposal refresher,
        #: so it computes with the cache's dry-run semantics: an
        #: unfixable hard goal is a cacheable finding, not an error to
        #: re-burn one fleet dispatch on every tick.
        self.options = options or OptimizationOptions(
            skip_hard_goal_check=True)
        self._now_ms = now_ms or (lambda: int(_time.time() * 1000))
        self.registry = registry or MetricRegistry()
        self.tracer = tracer or default_tracer()
        self.collector = collector or default_collector()
        self.engine = FleetOptimizer(optimizer,
                                     registry=self.registry,
                                     tracer=self.tracer,
                                     collector=self.collector)
        #: consecutive degraded ticks before a member quarantines
        #: (fleet.quarantine.after.ticks)
        self.quarantine_after = max(quarantine_after, 1)
        #: per-member fetch-round pool size (fleet.fetch.workers):
        #: 0 = fully serial fetches in registration order, the chaos
        #: harness's deterministic mode — threads racing a shared sim
        #: clock would make replays diverge
        self.fetch_workers = max(fetch_workers, 0)
        #: wall-clock cap per member fetch future (fleet.fetch.deadline
        #: .ms, pool mode only): a hung endpoint forfeits ITS tick while
        #: siblings proceed. 0 = unbounded (serial mode relies on the
        #: backend's per-call deadline instead).
        self.fetch_deadline_ms = fetch_deadline_ms
        self.seed = seed
        self.breaker_window_ms = breaker_window_ms
        self.breaker_failures = breaker_failures
        self.breaker_open_ms = breaker_open_ms
        #: flight recorder (core/events.py, ``fleet`` category) — health
        #: transitions journal with cause links; None = silent
        self.journal = journal
        #: anomaly notifier fed FLEET_MEMBER_QUARANTINED; None = silent
        self.notifier = notifier
        #: global move-budget coordinator (fleet/budget.py); None = no
        #: budget accounting
        self.budget = budget
        self._pool = (ThreadPoolExecutor(max_workers=self.fetch_workers,
                                         thread_name_prefix="fleet-fetch")
                      if self.fetch_workers > 0 else None)
        self._members: dict[str, FleetClusterHandle] = {}
        self._lock = threading.RLock()
        #: serializes whole ticks: the background ticker and a forced
        #: POST /fleet/rebalance must never run two fleet dispatches
        #: concurrently (duplicate device work + racing per-member
        #: readout writes).
        self._tick_lock = threading.Lock()
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        self.ticks = 0
        self.last_tick_ms: int | None = None
        self.last_bucket: dict | None = None
        name = MetricRegistry.name
        self._tick_timer = self.registry.timer(
            name("FleetRegistry", "tick-timer"))
        self._tick_errors = self.registry.meter(
            name("FleetRegistry", "tick-failure-rate"))
        self.registry.gauge(name("FleetRegistry", "clusters"),
                            lambda: len(self._members))
        self._degradations = self.registry.meter(
            name("FleetRegistry", "member-degradation-rate"))
        self._quarantines = self.registry.meter(
            name("FleetRegistry", "member-quarantine-rate"))
        self._readmissions = self.registry.meter(
            name("FleetRegistry", "member-readmission-rate"))
        self.registry.gauge(
            name("FleetRegistry", "quarantined-members"),
            lambda: sum(1 for h in list(self._members.values())
                        if h.health == MemberHealth.QUARANTINED))
        self.registry.gauge(
            name("FleetRegistry", "last-dispatch-ms"),
            lambda: (None if self.engine.last_dispatch_s is None
                     else round(self.engine.last_dispatch_s * 1e3, 3)))

    # ----------------------------------------------------------- members
    def register(self, cluster_id: str, monitor, *,
                 proposal_cache: ProposalCache | None = None,
                 detector=None, backend=None, endpoint: str = "",
                 breaker: CircuitBreaker | None = None
                 ) -> FleetClusterHandle:
        """Add a cluster. ``proposal_cache`` defaults to a fresh
        cluster-scoped cache over this monitor and the shared optimizer
        (pass the facade's cache for the local cluster so ``/proposals``
        serves fleet-computed results). The cache must carry this
        cluster's id — that scoping is what makes cross-serving
        impossible (``ProposalCache.store``). ``backend`` is the
        member's :class:`~.backends.RemoteBackend` when its admin rides
        a per-cluster endpoint; its breaker (or an explicit ``breaker``,
        or a fresh one seeded from the registry) becomes the member's
        health-machine breaker — one rolling window fed by both backend
        calls and registry fetch outcomes."""
        with self._lock:
            if cluster_id in self._members:
                raise ValueError(f"cluster {cluster_id!r} already "
                                 "registered")
            if len(self._members) >= self.max_clusters:
                raise ValueError(
                    f"fleet is full: {self.max_clusters} clusters "
                    "(fleet.max.clusters)")
            if proposal_cache is None:
                proposal_cache = ProposalCache(
                    monitor, self.engine.optimizer,
                    now_ms=self._now_ms, cache_id=cluster_id)
            elif proposal_cache.cache_id != cluster_id:
                raise ValueError(
                    f"proposal cache id {proposal_cache.cache_id!r} does "
                    f"not match cluster {cluster_id!r}")
            if breaker is None:
                breaker = getattr(backend, "breaker", None)
            if breaker is None:
                breaker = CircuitBreaker(
                    window_ms=self.breaker_window_ms,
                    failure_threshold=self.breaker_failures,
                    open_ms=self.breaker_open_ms,
                    seed=self.seed, name=cluster_id)
            if backend is not None and not endpoint:
                endpoint = getattr(backend, "endpoint", "")
            handle = FleetClusterHandle(cluster_id=cluster_id,
                                        monitor=monitor,
                                        cache=proposal_cache,
                                        detector=detector,
                                        backend=backend,
                                        breaker=breaker,
                                        endpoint=endpoint)
            self._members[cluster_id] = handle
            return handle

    @staticmethod
    def member_endpoints(config) -> dict[str, str]:
        """Resolve ``fleet.member.<id>.endpoint`` keys from a config's
        raw originals (the keys are dynamic — one per member — so they
        can't be predeclared in the definition table). Returns
        ``{member_id: endpoint}`` sorted by id; empty values are
        ignored."""
        out = {}
        prefix, suffix = "fleet.member.", ".endpoint"
        for key, val in config.originals().items():
            if key.startswith(prefix) and key.endswith(suffix):
                mid = key[len(prefix):-len(suffix)]
                if mid and val:
                    out[mid] = str(val)
        return dict(sorted(out.items()))

    def deregister(self, cluster_id: str) -> None:
        with self._lock:
            self._members.pop(cluster_id, None)

    @property
    def cluster_ids(self) -> list[str]:
        with self._lock:
            return list(self._members)

    def member(self, cluster_id: str) -> FleetClusterHandle:
        with self._lock:
            return self._members[cluster_id]

    def scrape_registries(self) -> list:
        """Cluster-namespaced views of every member's sensor registries
        for the merged ``/metrics`` exposition: families render as
        ``cc_<cluster>_LoadMonitor_...`` etc., so two members' identical
        sensor names never collapse into unlabeled numeric-suffix
        duplicates (tests/prom_lint.py rejects those)."""
        from ..core.sensors import NamespacedRegistry
        out = [self.registry]
        with self._lock:
            members = list(self._members.values())
        for h in members:
            reg = getattr(h.monitor, "registry", None)
            if reg is not None:
                out.append(NamespacedRegistry(reg, h.cluster_id))
            if h.cache is not None and h.cache.registry is not reg:
                # Cluster-scoped caches already carry the id in their
                # group name (ProposalCache.<id>.*) — no second prefix.
                out.append(h.cache.registry)
        return out

    # -------------------------------------------------------------- tick
    def tick(self, now_ms: int | None = None, *,
             force: bool = False) -> dict:
        """One fleet cycle: build every member's model; when ANY member's
        cache no longer answers its monitor generation (or ``force``),
        run the fleet propose for EVERY ready member — proposing only the
        stale subset would leave the others' risk readouts stale; then
        (on its cadence) the fleet N-1 risk sweep and the per-cluster
        anomaly fan-out. Ticks are
        serialized (the background ticker vs a forced
        ``/fleet/rebalance``). Returns the tick summary."""
        with self._tick_lock:
            return self._tick_locked(now_ms, force)

    # ------------------------------------------------- health transitions
    def _journal_health(self, h: FleetClusterHandle, action: str,
                        severity: str, detail: dict) -> int | None:
        if self.journal is None:
            return None
        return self.journal.record(
            "fleet", action, severity=severity, cause=h.health_seq,
            detail={"clusterId": h.cluster_id, "health": h.health,
                    "degradedTicks": h.degraded_ticks,
                    "breaker": (h.breaker.state if h.breaker else None),
                    **detail})

    def _on_fetch_ok(self, h: FleetClusterHandle, now: int,
                     result) -> None:
        prev = h.health
        h.ready = True
        h.last_error = None
        h.generation = result.generation
        h.degraded_ticks = 0
        if h.breaker is not None:
            h.breaker.record_success(now)
        if prev != MemberHealth.HEALTHY:
            h.health = MemberHealth.HEALTHY
            h.health_since_ms = now
            self._readmissions.mark()
            h.health_seq = self._journal_health(
                h, "member-readmitted", "info", {"from": prev})
            LOG.info("fleet[%s]: %s -> HEALTHY", h.cluster_id, prev)

    def _on_fetch_not_ready(self, h: FleetClusterHandle,
                            err: str) -> None:
        """The monitor has no servable model yet (completeness): a cold
        data plane behind a perfectly healthy endpoint. The member is
        skipped this tick (``ready: false``, ``lastError`` on
        ``/fleet``) without touching the breaker or the health machine —
        a cold cluster must never walk to QUARANTINED, and a READMITTING
        member warming back up must not be re-quarantined for it."""
        h.ready = False
        h.last_error = err

    def _on_fetch_fail(self, h: FleetClusterHandle, now: int,
                       err: str) -> None:
        h.ready = False
        h.last_error = err
        if h.breaker is not None:
            h.breaker.record_failure(now)
        if h.health == MemberHealth.READMITTING:
            # Readmission hysteresis: a member that fails its first
            # post-probe fetch goes straight back to QUARANTINED — it
            # must not flap through the healthy pool.
            self._quarantine(h, now, action="member-requarantined")
            return
        h.degraded_ticks += 1
        if h.health != MemberHealth.DEGRADED:
            h.health = MemberHealth.DEGRADED
            h.health_since_ms = now
            self._degradations.mark()
            h.health_seq = self._journal_health(
                h, "member-degraded", "warn", {"error": err})
        # The member is skipped THIS tick; its last-good proposals keep
        # serving but flip stale so the execution gate refuses them.
        if h.cache is not None and h.cache.mark_stale():
            LOG.warning("fleet[%s]: degraded (%s); cached proposals "
                        "stale-flagged", h.cluster_id, err)
        if h.degraded_ticks >= self.quarantine_after:
            self._quarantine(h, now)

    def _quarantine(self, h: FleetClusterHandle, now: int, *,
                    action: str = "member-quarantined") -> None:
        h.health = MemberHealth.QUARANTINED
        h.health_since_ms = now
        self._quarantines.mark()
        h.health_seq = self._journal_health(
            h, action, "error", {"error": h.last_error})
        if h.cache is not None:
            h.cache.mark_stale()
        if self.notifier is not None:
            from ..detector.anomalies import FleetMemberQuarantined
            anomaly = FleetMemberQuarantined(
                detected_ms=now, cluster_id=h.cluster_id,
                degraded_ticks=h.degraded_ticks,
                breaker_state=(h.breaker.state if h.breaker else ""),
                last_error=h.last_error, journal_seq=h.health_seq)
            try:
                self.notifier.on_anomaly(anomaly, now)
            except Exception:
                LOG.warning("fleet[%s]: quarantine notification failed",
                            h.cluster_id, exc_info=True)
        LOG.error("fleet[%s]: QUARANTINED after %d degraded ticks (%s)",
                  h.cluster_id, h.degraded_ticks, h.last_error)

    # ------------------------------------------------------- fetch rounds
    def _fetch_member(self, h: FleetClusterHandle, now: int):
        """One member's model build. The breaker gates the attempt
        (OPEN = fail fast without touching the endpoint; a due half-open
        probe is admitted) — its outcome is recorded by the health
        transition handlers, ONE record per tick, on top of whatever the
        member's backend recorded per admin call."""
        if h.breaker is not None and not h.breaker.allow(now):
            from .backends import CircuitOpenError
            raise CircuitOpenError(
                f"breaker {h.breaker.state} until probe at "
                f"{h.breaker.probe_at}")
        return h.monitor.cluster_model(now)

    def _fetch_round(self, active: list, now: int) -> list:
        """Fetch every active member's model: on the bounded pool when
        one is configured (a hung endpoint forfeits its tick at the
        fetch deadline while siblings' futures proceed), serially in
        registration order otherwise (the chaos mode — deterministic
        under a shared simulated clock). Returns ``[(handle, result |
        None, error | None, fault)]`` in registration order either way;
        ``fault`` is False for :class:`NotEnoughValidWindowsError` — a
        cold data plane, not an endpoint fault, so it must never feed
        the breaker or walk the member toward QUARANTINED."""
        if self._pool is None or len(active) <= 1:
            out = []
            for h in active:
                try:
                    out.append((h, self._fetch_member(h, now), None,
                                False))
                except NotEnoughValidWindowsError as e:
                    out.append((h, None, f"{type(e).__name__}: {e}",
                                False))
                except Exception as e:   # noqa: BLE001 — per-member
                    out.append((h, None, f"{type(e).__name__}: {e}",
                                True))
            return out
        futures = [(h, self._pool.submit(self._fetch_member, h, now))
                   for h in active]
        timeout = (self.fetch_deadline_ms / 1000.0
                   if self.fetch_deadline_ms else None)
        out = []
        for h, fut in futures:
            try:
                out.append((h, fut.result(timeout=timeout), None, False))
            except TimeoutError:
                fut.cancel()
                out.append((h, None,
                            f"fetch deadline {self.fetch_deadline_ms} "
                            "ms missed", True))
            except NotEnoughValidWindowsError as e:
                out.append((h, None, f"{type(e).__name__}: {e}", False))
            except Exception as e:   # noqa: BLE001 — per-member
                out.append((h, None, f"{type(e).__name__}: {e}", True))
        return out

    def _submit_probes(self, quarantined: list, now: int) -> list:
        """Start (or, serial mode, defer) the quarantined members' due
        half-open probe fetches. Returns ``[(handle, future | None)]``
        for :meth:`_collect_probes` — with a pool the probes genuinely
        overlap the device dispatch running between the two calls."""
        due = [h for h in quarantined
               if h.breaker is None or h.breaker.allow(now)]
        if self._pool is None:
            return [(h, None) for h in due]
        return [(h, self._pool.submit(h.monitor.cluster_model, now))
                for h in due]

    def _collect_probes(self, probes: list, now: int) -> None:
        for h, fut in probes:
            try:
                if fut is None:
                    h.monitor.cluster_model(now)
                else:
                    timeout = (self.fetch_deadline_ms / 1000.0
                               if self.fetch_deadline_ms else None)
                    fut.result(timeout=timeout)
            except NotEnoughValidWindowsError as e:
                # The endpoint answered; only the data plane is still
                # cold. Transport-level success: readmit below and let
                # the fetch rounds skip it (not-ready) until it warms.
                h.last_error = f"{type(e).__name__}: {e}"
            except Exception as e:   # noqa: BLE001 — probe failure
                h.last_error = f"{type(e).__name__}: {e}"
                if h.breaker is not None:
                    h.breaker.record_failure(now)
                continue
            if h.breaker is not None:
                h.breaker.record_success(now)
            h.health = MemberHealth.READMITTING
            h.health_since_ms = now
            h.health_seq = self._journal_health(
                h, "member-readmitting", "info", {})
            LOG.info("fleet[%s]: probe succeeded; READMITTING (rejoins "
                     "next tick)", h.cluster_id)

    def _allocate_budget(self, todo: list, now: int) -> None:
        """Draw this tick's move grants from the fleet-wide budget,
        urgency-weighted (hard-goal violations, then forecast
        time-to-breach). Grants land in each member's summary row."""
        requests = []
        for h, _r in todo:
            s = h.last_summary
            requests.append(BudgetRequest(
                cluster_id=h.cluster_id,
                requested=int(s.get("numMoves") or 0),
                hard_violations=len(s.get("violatedHardGoals") or ()),
                time_to_breach_ms=(h.last_forecast or {}).get(
                    "timeToBreachMs")))
        grants = self.budget.allocate(requests, now)
        for h, _r in todo:
            g = grants.get(h.cluster_id)
            if g is not None:
                h.last_summary["budget"] = g.to_json()

    def _tick_locked(self, now_ms: int | None, force: bool) -> dict:
        now = now_ms if now_ms is not None else self._now_ms()
        t0 = _time.monotonic()
        with self._lock:
            members = list(self._members.values())
        # Pin the engine's cluster-axis shape floor to the FULL fleet
        # size — quarantined members included — so a partial-readiness
        # or quarantine tick reports the full fleet's layout (padding
        # slots never run).
        self.engine.cluster_bucket_floor = len(members)
        active = [h for h in members
                  if h.health != MemberHealth.QUARANTINED]
        quarantined = [h for h in members
                       if h.health == MemberHealth.QUARANTINED]
        ready: list[tuple[FleetClusterHandle, object]] = []
        with self.tracer.span("fleet.tick", clusters=len(members)), \
                self.collector.cycle("fleet-tick"):
            for h, result, err, fault in self._fetch_round(active, now):
                if err is not None:
                    if fault:
                        self._on_fetch_fail(h, now, err)
                    else:
                        self._on_fetch_not_ready(h, err)
                    continue
                self._on_fetch_ok(h, now, result)
                ready.append((h, result))
            summary = {"clusters": len(members), "ready": len(ready),
                       "proposed": 0, "errors": 0, "skipped": 0,
                       "quarantined": len(quarantined)}
            # Half-open probes for quarantined members start here and
            # resolve after the dispatch — overlapped, so a probe into a
            # still-dead endpoint never extends the healthy siblings'
            # tick.
            probes = self._submit_probes(quarantined, now)
            if not ready:
                self._collect_probes(probes, now)
                self.ticks += 1
                self.last_tick_ms = now
                self._tick_timer.update(_time.monotonic() - t0)
                return summary
            need = force or any(h.cache is None or not h.cache.valid()
                                for h, _ in ready)
            todo = ready if need else []
            summary["skipped"] = len(ready) - len(todo)
            sweep_due = bool(self.risk_sweep_every
                             and self.ticks % self.risk_sweep_every == 0)
            if not todo and not sweep_due:
                # Nothing to compute: don't pay the fleet stack (pad +
                # device upload of every member's model) for a tick that
                # would use none of it.
                self._collect_probes(probes, now)
                self.ticks += 1
                self.last_tick_ms = now
                self._tick_timer.update(_time.monotonic() - t0)
                return summary
            fleet = FleetModel.stack(
                [(h.cluster_id, r.model, r.metadata, r.generation,
                  r.stale) for h, r in ready],
                broker_pad_multiple=self.broker_pad_multiple,
                partition_pad_multiple=self.partition_pad_multiple,
                device=self.engine.device)
            self.last_bucket = fleet.bucket
            if todo:
                results = self.engine.propose(fleet, self.options)
                for (h, r), res in zip(todo, results):
                    if isinstance(res, OptimizationFailureError):
                        h.last_error = str(res)
                        summary["errors"] += 1
                        res = res.result
                    h.last_summary = self._cluster_summary(h, res)
                    if h.cache is not None:
                        stored = h.cache.store(res,
                                               generation=r.generation,
                                               cache_id=h.cluster_id)
                        if not stored:
                            LOG.info(
                                "fleet[%s]: generation moved mid-"
                                "dispatch (%s -> %s); result dropped",
                                h.cluster_id, r.generation,
                                h.monitor.generation)
                    summary["proposed"] += 1
                if self.budget is not None:
                    self._allocate_budget(todo, now)
            self._collect_probes(probes, now)
            if sweep_due:
                try:
                    risks = self.engine.sweep_n1(fleet)
                except Exception:
                    LOG.warning("fleet N-1 sweep failed", exc_info=True)
                    self._tick_errors.mark()
                else:
                    by_id = {r["clusterId"]: r for r in risks}
                    for h, _ in ready:
                        if h.cluster_id in by_id:
                            h.last_risk = by_id[h.cluster_id]
            # Anomaly fan-out: each member's detector sweep runs on the
            # shared tick (AnomalyDetectorManager.run_once semantics) —
            # one scheduler, per-cluster detection and self-healing.
            for h, _ in ready:
                if h.detector is None:
                    continue
                try:
                    h.detector.run_once(now)
                except Exception:
                    LOG.warning("fleet[%s]: anomaly fan-out failed",
                                h.cluster_id, exc_info=True)
                    self._tick_errors.mark()
        self.ticks += 1
        self.last_tick_ms = now
        self._tick_timer.update(_time.monotonic() - t0)
        return summary

    def forecast_sweep(self, trajectories, now_ms: int | None = None
                       ) -> list[dict]:
        """Sweep projected load trajectories across EVERY ready member
        in one batched ``[C, S]`` dispatch (``FleetOptimizer.
        sweep_trajectories`` — the scenario axis composed with the
        cluster axis). ``trajectories`` is one
        :class:`~..whatif.TrajectoryScale` grid (each member's factors
        resolve against its own topics) or ``{cluster_id: grid}``.
        Per-member summaries land on the handles for ``/fleet``.
        Serialized with the background tick on the tick mutex — both
        paths dispatch on the shared engine and pin its cluster-axis
        shape floor."""
        now = now_ms if now_ms is not None else self._now_ms()
        with self._tick_lock:
            return self._forecast_sweep_locked(trajectories, now)

    def _forecast_sweep_locked(self, trajectories, now: int) -> list[dict]:
        with self._lock:
            members = list(self._members.values())
        self.engine.cluster_bucket_floor = len(members)
        ready = []
        for h in members:
            try:
                result = h.monitor.cluster_model(now)
            except Exception as e:
                h.ready = False
                h.last_error = f"{type(e).__name__}: {e}"
                continue
            h.ready = True
            h.last_error = None
            ready.append((h, result))
        if not ready:
            return []
        fleet = FleetModel.stack(
            [(h.cluster_id, r.model, r.metadata, r.generation, r.stale)
             for h, r in ready],
            broker_pad_multiple=self.broker_pad_multiple,
            partition_pad_multiple=self.partition_pad_multiple,
            device=self.engine.device)
        self.last_bucket = fleet.bucket
        summaries = self.engine.sweep_trajectories(fleet, trajectories)
        by_id = {s["clusterId"]: s for s in summaries}
        for h, _ in ready:
            if h.cluster_id in by_id:
                h.last_forecast = by_id[h.cluster_id]
        return summaries

    @staticmethod
    def _cluster_summary(h: FleetClusterHandle, res) -> dict:
        total = max(len(res.goal_results), 1)
        violated = [g.name for g in res.goal_results if not g.satisfied]
        return {
            # Documented in docs/fleet.md: the fraction of the chain's
            # goals currently satisfied — 1.0 is a fully balanced member.
            "balanceScore": round(1.0 - len(violated) / total, 4),
            "violatedGoals": violated,
            "violatedHardGoals": res.violated_hard_goals,
            "numProposals": len(res.proposals),
            "numMoves": res.num_moves,
            "staleModel": res.stale_model,
        }

    # -------------------------------------------------- background loop
    def start(self, tick_interval_s: float) -> None:
        """Background shared tick (fleet.tick.ms); idempotent."""
        if self._ticker is not None and self._ticker.is_alive():
            return
        stop = threading.Event()
        self._stop = stop

        def loop():
            while not stop.wait(tick_interval_s):
                try:
                    self.tick()
                except Exception:
                    LOG.warning("fleet tick failed", exc_info=True)
                    self._tick_errors.mark()

        self._ticker = threading.Thread(target=loop, daemon=True,
                                        name="fleet-tick")
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5)
            self._ticker = None
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    # ----------------------------------------------------------- surface
    def summary_json(self, now_ms: int | None = None) -> dict:
        """The ``GET /fleet`` payload: per-cluster balance score,
        freshness and risk, plus the shared bucket/dispatch readout."""
        now = now_ms if now_ms is not None else self._now_ms()
        with self._lock:
            members = list(self._members.values())
        clusters = []
        for h in members:
            row = {"clusterId": h.cluster_id,
                   "ready": h.ready,
                   "health": h.health,
                   "degradedTicks": h.degraded_ticks,
                   "healthSinceMs": h.health_since_ms,
                   "generation": h.generation,
                   "lastError": h.last_error,
                   **h.last_summary}
            if h.endpoint:
                row["endpoint"] = h.endpoint
            if h.breaker is not None:
                row["breaker"] = h.breaker.to_json()
            if h.backend is not None and hasattr(h.backend, "to_json"):
                row["backend"] = h.backend.to_json()
            if h.cache is not None:
                row["freshness"] = h.cache.freshness_json(now)
            if h.last_risk is not None:
                row["risk"] = h.last_risk
            if h.last_forecast is not None:
                row["forecast"] = {
                    "maxRisk": h.last_forecast.get("maxRisk"),
                    "riskiest": h.last_forecast.get("riskiest")}
            clusters.append(row)
        out = {"enabled": True,
               "numClusters": len(members),
               "quarantined": sum(
                   1 for h in members
                   if h.health == MemberHealth.QUARANTINED),
               "ticks": self.ticks,
               "lastTickMs": self.last_tick_ms,
               "bucket": self.last_bucket,
               "lastDispatchMs": (
                   None if self.engine.last_dispatch_s is None
                   else round(self.engine.last_dispatch_s * 1e3, 3)),
               "clusters": clusters}
        if self.budget is not None:
            out["budget"] = self.budget.to_json()
        return out

    def stats_json(self) -> dict:
        """The ``fleet`` section of ``/devicestats``: cluster count,
        current shape bucket, last dispatch wall clock, plus a
        per-member health/breaker map for fleet dashboards."""
        with self._lock:
            members = list(self._members.values())
        member_map = {}
        for h in members:
            m = {"health": h.health,
                 "degradedTicks": h.degraded_ticks,
                 "ready": h.ready}
            if h.endpoint:
                m["endpoint"] = h.endpoint
            if h.breaker is not None:
                m["breaker"] = h.breaker.state
            if h.backend is not None and hasattr(h.backend, "to_json"):
                m["backend"] = h.backend.to_json()
            member_map[h.cluster_id] = m
        out = {"clusterCount": len(members),
               "ticks": self.ticks,
               "bucket": self.last_bucket,
               "lastDispatchMs": (
                   None if self.engine.last_dispatch_s is None
                   else round(self.engine.last_dispatch_s * 1e3, 3)),
               "lastTickMs": self.last_tick_ms,
               "members": member_map}
        if self.budget is not None:
            out["budget"] = self.budget.to_json()
        return out

    def rebalance(self, now_ms: int | None = None) -> dict:
        """``POST /fleet/rebalance``: force one tick now (every member
        recomputes regardless of cache validity) and return the summary.
        Proposals land in the members' caches; EXECUTION stays a
        per-cluster decision through each cluster's own endpoints — a
        fleet-wide execute-everything switch is exactly the blast radius
        this layer exists to avoid."""
        tick = self.tick(now_ms, force=True)
        return {"tick": tick, **self.summary_json(now_ms)}
