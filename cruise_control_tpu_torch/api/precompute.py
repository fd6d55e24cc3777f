"""Proposal precompute + generation-keyed cache + freshness SLO loop.

Rebuild of the reference's background "train loop"
(``GoalOptimizer.run()`` ``GoalOptimizer.java:152-203``): a cached
optimization result serves ``GET /proposals`` and goal-violation-free
rebalances instantly; the cache is valid while the monitor's model
generation is unchanged (``:232-239``); readers either take the cache, or
block until the in-flight computation lands (``:304-352``), or force a
fresh computation (``ignore_proposal_cache``).

On top of generation keying, the cache tracks a **proposal-freshness
SLO** (``proposals.freshness.target.ms``): *lag* is how long the current
monitor generation has gone unanswered by the cache (0 while the cache is
generation-valid), *age* is how old the cached result itself is. The
background refresher ticks fast enough to keep lag under the target
(``min(interval, target/4)``) and recomputes the moment the generation
moves, so ``GET /proposals`` under concurrent traffic stays a
generation-checked cache read with bounded staleness; a recompute that
lands later than the target after the generation moved marks the
``ProposalCache.freshness-slo-breaches`` meter (and logs) — the signal
operators alert on. ``freshness-age-ms`` / ``freshness-lag-ms`` gauges
join the facade's scrape view.
"""

from __future__ import annotations

import logging
import threading
import time as _time

from ..analyzer import OptimizationOptions

LOG = logging.getLogger(__name__)


class CacheEntry:
    """Immutable published cache entry — the lock-free read surface.

    Writers build a fresh instance under the Condition and publish it
    with ONE attribute store (atomic under the GIL); readers grab the
    reference with one attribute load and get a consistent
    (result, generation, stamp, seq) tuple without ever touching the
    Condition. ``seq`` increments per publish, so render caches keyed on
    it notice a same-generation refill (a fleet tick re-store)."""

    __slots__ = ("result", "generation", "cached_at_ms", "seq")

    def __init__(self, result, generation, cached_at_ms, seq) -> None:
        object.__setattr__(self, "result", result)
        object.__setattr__(self, "generation", generation)
        object.__setattr__(self, "cached_at_ms", cached_at_ms)
        object.__setattr__(self, "seq", seq)

    def __setattr__(self, name, value):
        raise AttributeError("CacheEntry is immutable")


class ProposalCache:
    def __init__(self, monitor, optimizer, *,
                 options: OptimizationOptions | None = None,
                 registry=None, now_ms=None,
                 cache_id: str | None = None) -> None:
        from ..core.sensors import MetricRegistry
        self.monitor = monitor
        self.optimizer = optimizer
        #: cluster-scoped cache identity (fleet members): carried into
        #: the freshness gauge/meter names so two members' series never
        #: collide on one scrape, and enforced by :meth:`store` so a
        #: result computed for one cluster can never serve another —
        #: generation numbers are per-monitor counters, so two clusters
        #: can easily sit at the SAME generation int and generation
        #: keying alone cannot tell them apart. None = the single-cluster
        #: default (names unchanged).
        self.cache_id = cache_id
        # The cache is a dry-run measurement: a hard goal that cannot be
        # satisfied is a *cacheable finding* (served with its provision
        # verdict), not an error to re-burn compute on every refresh tick.
        # Readers that execute re-apply strict semantics (facade.rebalance).
        self.options = options or OptimizationOptions(
            skip_hard_goal_check=True)
        # Writer-side Condition: _compute/store/restore/invalidate and
        # BLOCKING readers (get() waiting on an in-flight compute) take
        # it; the hot read path never does — it reads ``_entry``.
        self._lock = threading.Condition()
        self._cached = None            # OptimizerResult
        self._cached_generation: int | None = None
        #: published immutable CacheEntry | None — ONE attribute read
        #: serves the lock-free fast path (peek/valid/get-when-warm).
        self._entry: CacheEntry | None = None
        self._entry_seq = 0
        self._computing = False
        self._refresher: threading.Thread | None = None
        self._stop = threading.Event()
        #: callbacks invoked (exception-safe) at the end of every
        #: refresh tick — the facade's render cache re-publishes its
        #: response snapshots here, off the serving hot path.
        self.on_tick: list = []
        self.num_computations = 0
        # ---- freshness SLO bookkeeping -------------------------------
        self._now_ms_fn = now_ms or (lambda: int(_time.time() * 1000))
        #: 0 disables the SLO (plain interval refresher, no breach
        #: accounting); serve.py wires proposals.freshness.target.ms.
        self.freshness_target_ms = 0
        self._cached_at_ms: int | None = None
        self._gen_seen: int | None = None
        self._gen_changed_at_ms: int | None = None
        #: high-water generation a breach was already marked for — one
        #: breach per unanswered generation, whether detected by a
        #: late-landing recompute or by the tick watching lag grow past
        #: the target (monotonic so a slow compute for an OLD generation
        #: landing after a newer one was marked cannot double-count)
        self._breach_marked_gen: int | None = None
        self.registry = registry or MetricRegistry()
        # Cluster-scoped sensor group: fleet members' freshness series
        # render as ProposalCache.<cache_id>.freshness-* so one merged
        # scrape over many members stays unambiguous.
        group = (f"ProposalCache.{cache_id}" if cache_id
                 else "ProposalCache")
        name = MetricRegistry.name
        self._breaches = self.registry.meter(
            name(group, "freshness-slo-breaches"))
        self.registry.gauge(name(group, "freshness-age-ms"),
                            self.freshness_age_ms)
        self.registry.gauge(name(group, "freshness-lag-ms"),
                            self.freshness_lag_ms)
        self.registry.gauge(name(group, "freshness-target-ms"),
                            lambda: self.freshness_target_ms or None)

    # ------------------------------------------------------------- reads
    def peek(self):
        """The cached OptimizerResult without blocking, recompute, or any
        lock (may be stale or None) — for gauges that must never trigger
        work and for the serving tier's hot path."""
        e = self._entry
        return e.result if e is not None else None

    def fast_entry(self) -> CacheEntry | None:
        """Lock-free generation-valid read: the published immutable entry
        when it answers the monitor's CURRENT generation, else None. The
        render cache serves ``GET /proposals`` off this — one attribute
        load plus one int compare, no Condition, no facade lock."""
        e = self._entry
        if e is not None and e.generation == self.monitor.generation:
            return e
        return None

    def valid(self) -> bool:
        """ref validCachedProposal GoalOptimizer.java:232-239 (lock-free:
        reads the published entry)."""
        return self.fast_entry() is not None

    def latest_entry(self) -> CacheEntry | None:
        """The newest published entry regardless of generation validity
        (lock-free; None when empty). The replication follower-serving
        path reads this: a stream-fed replica's generation advances with
        the leader's frames while its proposal entry only moves when the
        leader re-exports one, so generation-strict ``fast_entry`` would
        refuse an entry that is merely one export behind — the replica
        serves the newest replicated entry and lets the bounded-staleness
        contract (core/replication.py read_refusal) police its age."""
        return self._entry

    def _publish_locked(self) -> None:
        """Mirror the Condition-side fields into a fresh immutable entry
        (caller holds the Condition). One attribute store publishes."""
        if self._cached is None:
            self._entry = None
            return
        self._entry_seq += 1
        self._entry = CacheEntry(self._cached, self._cached_generation,
                                 self._cached_at_ms, self._entry_seq)

    def observe_generation(self, now_ms: int | None = None) -> None:
        """Stamp when the monitor's generation last moved — the anchor
        freshness lag is measured from. Called on every refresher tick
        and on freshness reads, so observation granularity is the tick."""
        gen = self.monitor.generation
        now = now_ms if now_ms is not None else self._now_ms_fn()
        with self._lock:
            if gen != self._gen_seen:
                self._gen_seen = gen
                self._gen_changed_at_ms = now

    def freshness_age_ms(self, now_ms: int | None = None) -> int | None:
        """Age of the cached result (None when empty) — how old the
        proposals a cache read would serve actually are."""
        now = now_ms if now_ms is not None else self._now_ms_fn()
        with self._lock:
            if self._cached is None or self._cached_at_ms is None:
                return None
            return max(int(now - self._cached_at_ms), 0)

    def freshness_lag_ms(self, now_ms: int | None = None) -> int | None:
        """How long the CURRENT generation has gone unanswered: 0 while
        the cache is generation-valid, else ms since the generation was
        observed to move (None before anything was ever observed). This
        is the number the SLO bounds."""
        now = now_ms if now_ms is not None else self._now_ms_fn()
        self.observe_generation(now)
        with self._lock:
            if (self._cached is not None
                    and self._cached_generation == self.monitor.generation):
                return 0
            if self._gen_changed_at_ms is None:
                return None
            return max(int(now - self._gen_changed_at_ms), 0)

    def freshness_json(self, now_ms: int | None = None) -> dict:
        """The ``proposalFreshness`` section of ``/devicestats``."""
        now = now_ms if now_ms is not None else self._now_ms_fn()
        return {"valid": self.valid(),
                "cacheId": self.cache_id,
                "ageMs": self.freshness_age_ms(now),
                "lagMs": self.freshness_lag_ms(now),
                "targetMs": self.freshness_target_ms or None,
                "computations": self.num_computations,
                "breaches": self._breaches.count}

    def get(self, now_ms: int, timeout_s: float = 60.0):
        """Serve the cached result, computing (or waiting on the in-flight
        computation) when stale (ref blocking read :304-352). A waiter whose
        in-flight computation fails takes over the computation itself (so
        the original error surfaces rather than a bogus timeout)."""
        # Warm fast path: one published-entry read. No Condition — N
        # concurrent readers of a generation-valid cache never serialize.
        e = self.fast_entry()
        if e is not None:
            return e.result
        deadline = _time.monotonic() + timeout_s
        while True:
            with self._lock:
                if self.valid():
                    return self._cached
                if self._computing:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0 or not self._lock.wait_for(
                            lambda: self.valid() or not self._computing,
                            timeout=remaining):
                        raise TimeoutError(
                            "proposal computation did not finish")
                    continue   # re-check: either valid now, or take over
                self._computing = True
            try:
                return self._compute(now_ms)
            finally:
                with self._lock:
                    self._computing = False
                    self._lock.notify_all()

    def _compute(self, now_ms: int):
        self.observe_generation(now_ms)
        gen = self.monitor.generation
        # Anchor breach lag to the generation THIS compute answers: the
        # generation (and its change stamp) may move again mid-compute.
        with self._lock:
            gen_changed0 = self._gen_changed_at_ms
        model_result = self.monitor.cluster_model(now_ms)
        # Belt-and-braces: the monitor only emits live results, but a
        # plugged monitor (or future refactor) handing a what-if scenario
        # transform here would poison every default-chain read until the
        # next generation bump — refuse outright.
        label = getattr(model_result, "scenario_label", None)
        if label:
            raise ValueError(
                f"proposal cache refuses scenario-modified model "
                f"{label!r}: only live monitor models may seed the cache")
        result = self.optimizer.optimize(model_result.model,
                                         model_result.metadata, self.options)
        if model_result.stale:
            # Carried to the facade's execution gate: cached proposals
            # computed from a stale-served model must not execute.
            from dataclasses import replace
            result = replace(result, stale_model=True)
        done_ms = self._now_ms_fn()
        with self._lock:
            had_cache = self._cached is not None
            self._cached = result
            self._cached_generation = gen
            self._cached_at_ms = done_ms
            self.num_computations += 1
            self._publish_locked()
            self._lock.notify_all()
            catch_up = (done_ms - gen_changed0
                        if gen_changed0 is not None else None)
        # Breach accounting: a previously-warm cache that took longer
        # than the target to catch the moved generation back up. The
        # first-ever fill (startup warm-in) is exempt — that cost is what
        # the startup pre-warm exists to hide. One breach per generation
        # (the tick path below may have marked this one already).
        if (self.freshness_target_ms and had_cache
                and catch_up is not None
                and catch_up > self.freshness_target_ms):
            self._mark_breach(gen, catch_up)
        return result

    def _mark_breach(self, gen: int, lag_ms: int) -> None:
        with self._lock:
            if (self._breach_marked_gen is not None
                    and gen <= self._breach_marked_gen):
                return
            self._breach_marked_gen = gen
        self._breaches.mark()
        LOG.warning(
            "proposal freshness SLO breach: generation %s unanswered "
            "%d ms after it appeared (target %d ms)", gen, lag_ms,
            self.freshness_target_ms)

    def store(self, result, *, generation: int,
              scenario_label: str | None = None,
              cache_id: str | None = None) -> bool:
        """Offer an externally computed OptimizerResult to the cache.

        The ONLY write path besides :meth:`_compute`, with three guards:

        - **scenario rejection** (hard error): results computed from a
          what-if scenario transform carry the scenario label and are
          refused outright — ``/simulate`` and the resilience detector's
          proactive sweeps can never poison the live-cluster cache.
        - **cluster scoping** (hard error): when this cache carries a
          ``cache_id`` (a fleet member), a result offered under a
          DIFFERENT id is a wiring bug — generation ints are
          per-monitor counters, so two clusters at the same generation
          would otherwise cross-serve each other's proposals silently.
          A result offered with no id at all is likewise refused on an
          id-scoped cache (the fleet tick always stamps its writes).
        - **generation keying** (soft reject): a result computed against
          any generation other than the monitor's CURRENT one is dropped
          (returns False) — by the time it arrives it describes a
          cluster that no longer exists.
        """
        if scenario_label:
            raise ValueError(
                f"proposal cache refuses scenario-modified result "
                f"{scenario_label!r}: only live-cluster optimizations "
                "may be cached")
        if self.cache_id is not None and cache_id != self.cache_id:
            raise ValueError(
                f"proposal cache {self.cache_id!r} refuses result "
                f"offered for cluster {cache_id!r}: fleet members must "
                "never cross-serve proposals")
        with self._lock:
            if generation != self.monitor.generation:
                return False
            self._cached = result
            self._cached_generation = generation
            self._cached_at_ms = self._now_ms_fn()
            self._publish_locked()
            self._lock.notify_all()
            return True

    def invalidate(self) -> None:
        with self._lock:
            self._cached = None
            self._cached_generation = None
            self._cached_at_ms = None
            self._entry = None

    def mark_stale(self) -> bool:
        """Republish the current entry force-flagged ``stale_model`` (the
        same degradation :meth:`restore_state` applies to a restored
        snapshot). The fleet registry calls this when a member degrades
        or quarantines: its last-good proposals keep SERVING (reads are
        bounded-staleness by design) but the stale-execution gate
        (facade._refuse_stale_execution) refuses to ACT on them until a
        live fetch rebuilds the model. Returns False when the cache is
        empty or already stale-flagged (idempotent)."""
        from dataclasses import replace
        with self._lock:
            if self._cached is None or self._cached.stale_model:
                return False
            self._cached = replace(self._cached, stale_model=True)
            self._publish_locked()
            return True

    # -------------------------------------------------- snapshot/restore
    def export_state(self) -> dict | None:
        """The cache entry + generation keying + freshness stamps for the
        crash-safe snapshot (core/snapshot.py); None when empty. The
        result object is immutable by convention (readers never mutate
        it), so it is exported by reference."""
        with self._lock:
            if self._cached is None:
                return None
            return {"result": self._cached,
                    "generation": self._cached_generation,
                    "cachedAtMs": self._cached_at_ms,
                    "numComputations": self.num_computations}

    def restore_state(self, state: dict) -> None:
        """Install a snapshot's cache entry. The restored result is
        force-flagged ``stale_model``: a restarted process may *serve* it
        immediately (reads are bounded-staleness by design) but must not
        *execute* it until a live model build confirms the topology — the
        stale-execution gate (facade._refuse_stale_execution) enforces
        exactly that, which is how a stale-snapshot restore trips the
        refusal instead of acting on a dead cluster's plan. Bypasses the
        ``store()`` guards deliberately: the caller (facade restore)
        already verified the snapshot's cluster identity and seeded the
        monitor generation to the snapshot's."""
        from dataclasses import replace
        result = replace(state["result"], stale_model=True)
        with self._lock:
            self._cached = result
            self._cached_generation = state["generation"]
            self._cached_at_ms = state["cachedAtMs"]
            self.num_computations = state.get("numComputations", 0)
            self._publish_locked()
            self._lock.notify_all()

    # ------------------------------------------- background refresh loop
    def refresh_once(self, now_ms_fn=None, *, compute: bool = True) -> bool:
        """One freshness tick: observe the generation, recompute when the
        cache no longer answers it. Returns True when a recompute ran
        (False on cache-valid ticks and on compute failures — monitor
        not ready / transient errors retry next tick, ref :160-167 skip
        states). ``compute=False`` is the watch-only form: full breach
        accounting, no recompute — for caches whose refills arrive from
        elsewhere (the fleet tick's batched store)."""
        fn = now_ms_fn or self._now_ms_fn
        now = fn()
        self.observe_generation(now)
        if self.valid():
            self._notify_tick()
            return False
        # A persistent compute failure is the WORST freshness outage:
        # mark the breach from the tick itself (once per generation) the
        # moment a previously-warm cache's lag exceeds the target — a
        # recompute that never lands must not keep the alerting meter
        # flat. Startup warm-in (nothing cached yet) stays exempt.
        if self.freshness_target_ms:
            lag = self.freshness_lag_ms(now)
            with self._lock:
                gen = self._gen_seen
                had_cache = self._cached is not None
            if (had_cache and gen is not None and lag is not None
                    and lag > self.freshness_target_ms):
                self._mark_breach(gen, lag)
        if not compute:
            self._notify_tick()
            return False
        try:
            self.get(fn())
            return True
        except Exception:
            return False
        finally:
            self._notify_tick()

    def _notify_tick(self) -> None:
        for cb in list(self.on_tick):
            try:
                cb()
            except Exception:          # pragma: no cover - defensive
                LOG.debug("proposal-cache on_tick hook failed",
                          exc_info=True)

    def start_refresher(self, interval_s: float, now_ms_fn, *,
                        freshness_target_ms: int = 0,
                        watch_only: bool = False) -> None:
        """ref the precompute thread started by KafkaCruiseControl.startUp
        (KafkaCruiseControl.java:225). With a freshness target the tick
        tightens to ``min(interval, target/4)`` so a generation bump is
        noticed (and recomputed) well inside the SLO window.

        ``watch_only``: keep the full freshness/breach accounting but
        never recompute — for fleet members, whose caches are refilled
        by the registry's batched tick (a second per-cluster compute
        racing it would just duplicate device work)."""
        if self._refresher is not None:
            return
        # Fresh stop event per start (stop() leaves the old one set):
        # a cache restarted after stop() must actually refresh again,
        # and an orphan loop from a timed-out join exits on its own
        # event at its next wait.
        stop = threading.Event()
        self._stop = stop
        self._now_ms_fn = now_ms_fn
        self.freshness_target_ms = int(freshness_target_ms or 0)
        tick = interval_s
        if self.freshness_target_ms > 0:
            tick = min(interval_s,
                       max(self.freshness_target_ms / 4000.0, 0.05))

        def loop():
            # Failure backoff: a compute that cannot land (monitor warming
            # in after restart — hours on 1h windows) must not be retried
            # at the tightened freshness tick; every attempt pays admin
            # describe sweeps before it can raise. Doubling up to the
            # plain interval restores the pre-SLO cadence under
            # persistent failure; any success (or a valid cache) snaps
            # back to the fast tick. (Watch-only loops never compute, so
            # they always tick fast — breach observation is cheap.)
            delay = tick
            while not stop.wait(delay):
                if self.refresh_once(now_ms_fn,
                                     compute=not watch_only) \
                        or watch_only or self.valid():
                    delay = tick
                else:
                    delay = min(max(delay * 2, tick), interval_s)

        self._refresher = threading.Thread(target=loop, daemon=True,
                                           name="proposal-precompute")
        self._refresher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout=5)
            self._refresher = None
