"""Per-member remote backends: the fleet's failure-domain boundary.

In-process fleet members sharing one fake admin/sampler let a single
slow or dead cluster endpoint stall the ONE shared tick that balances
every cluster. This module makes each member a
real failure domain: every admin/sampler call to a member's endpoint
rides a hard per-call deadline plus the shared ``core/retry.py`` policy,
and its outcome feeds a per-member :class:`CircuitBreaker`. The registry
(``fleet/registry.py``) turns breaker state + fetch outcomes into the
member health state machine (HEALTHY → DEGRADED → QUARANTINED →
READMITTING, :class:`MemberHealth`).

Everything here is deterministic under the chaos clock: the breaker's
half-open probe times jitter through ``deterministic_uniform`` keyed on
``(seed, open-episode)``, and the deadline accounting reads the SAME
injected ``now_ms`` the retry policy sleeps against — a chaos run
replayed from its seed walks byte-identical breaker transitions.
"""

from __future__ import annotations

import time as _time
from collections import deque

from ..core.retry import NO_RETRY, RetryPolicy, deterministic_uniform


class MemberHealth:
    """Per-member health states (registry state machine; docs/fleet.md
    §Failure domains)."""

    HEALTHY = "HEALTHY"
    DEGRADED = "DEGRADED"
    QUARANTINED = "QUARANTINED"
    READMITTING = "READMITTING"

    ALL = (HEALTHY, DEGRADED, QUARANTINED, READMITTING)


class CircuitOpenError(RuntimeError):
    """Fail-fast refusal: the member's breaker is OPEN and the half-open
    probe is not due yet. Deliberately NOT an ``AdminTimeoutError`` — a
    retry policy must never spin on a breaker that exists to shed load
    from a failing endpoint."""


class CallDeadlineExceeded(RuntimeError):
    """A backend call (including its retries) outran the hard per-call
    deadline (``fleet.call.deadline.ms``). Like :class:`CircuitOpenError`
    this is not retryable: the time budget is already spent."""


class CircuitBreaker:
    """Rolling-window circuit breaker with seeded half-open probes.

    CLOSED counts failures over a sliding ``window_ms``; at
    ``failure_threshold`` it trips OPEN and schedules ONE half-open probe
    at ``open_ms`` scaled into ``1 ± jitter`` by a deterministic draw
    keyed on the open-episode count (so replays probe at identical sim
    times, but repeated trips don't resonate with a periodic fault).
    ``allow()`` admits exactly one call per due probe (HALF_OPEN); a
    probe success closes the breaker, a probe failure re-opens it with a
    freshly-jittered probe time.
    """

    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"

    def __init__(self, *, window_ms: int = 60_000,
                 failure_threshold: int = 3, open_ms: int = 30_000,
                 jitter: float = 0.2, seed: int = 0,
                 name: str = "") -> None:
        self.window_ms = window_ms
        self.failure_threshold = max(failure_threshold, 1)
        self.open_ms = open_ms
        self.jitter = jitter
        self.seed = seed
        self.name = name
        self.state = self.CLOSED
        self._outcomes: deque[tuple[int, bool]] = deque()
        self.opened_at: int | None = None
        self.probe_at: int | None = None
        #: distinct OPEN episodes — keys the probe jitter draw AND feeds
        #: operator surfaces (a flapping endpoint shows as a high count).
        self.open_count = 0
        self._probe_inflight = False

    # ------------------------------------------------------------ window
    def _prune(self, now: int) -> None:
        floor = now - self.window_ms
        while self._outcomes and self._outcomes[0][0] < floor:
            self._outcomes.popleft()

    def failures_in_window(self, now: int) -> int:
        self._prune(now)
        return sum(1 for _, ok in self._outcomes if not ok)

    # ------------------------------------------------------- transitions
    def _trip_open(self, now: int) -> None:
        self.state = self.OPEN
        self.opened_at = now
        self.open_count += 1
        self._probe_inflight = False
        frac = deterministic_uniform(self.seed, "breaker-probe",
                                     self.name, self.open_count)
        scale = 1.0 + self.jitter * (2.0 * frac - 1.0)
        self.probe_at = now + max(int(self.open_ms * scale), 1)

    def record_success(self, now: int) -> None:
        self._outcomes.append((now, True))
        self._prune(now)
        if self.state in (self.OPEN, self.HALF_OPEN):
            # A successful probe (or an out-of-band success) heals the
            # breaker completely — the window restarts clean so one old
            # burst can't instantly re-trip it.
            self.state = self.CLOSED
            self._outcomes.clear()
            self.opened_at = None
            self.probe_at = None
            self._probe_inflight = False

    def record_failure(self, now: int) -> None:
        self._outcomes.append((now, False))
        self._prune(now)
        if self.state == self.HALF_OPEN:
            self._trip_open(now)   # probe failed: re-open, re-jitter
        elif (self.state == self.CLOSED
              and self.failures_in_window(now) >= self.failure_threshold):
            self._trip_open(now)

    def allow(self, now: int) -> bool:
        """Whether a call may proceed at ``now``. OPEN admits exactly one
        probe once ``probe_at`` is due (transitioning to HALF_OPEN)."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and self.probe_at is not None \
                and now >= self.probe_at:
            self.state = self.HALF_OPEN
            self._probe_inflight = True
            return True
        if self.state == self.HALF_OPEN and not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def to_json(self) -> dict:
        return {"state": self.state,
                "failuresInWindow": len([1 for _, ok in self._outcomes
                                         if not ok]),
                "openCount": self.open_count,
                "openedAt": self.opened_at,
                "probeAt": self.probe_at}


class RemoteBackend:
    """Admin/sampler proxy for ONE fleet member's endpoint.

    Wraps every callable attribute of ``target`` (the member's admin or
    sampler client) so that a call (a) fails fast with
    :class:`CircuitOpenError` while the member's breaker is open, (b)
    rides the shared retry policy on the member's clock, (c) is charged
    against the hard per-call deadline — a call whose total elapsed time
    (retries included) exceeds ``call_deadline_ms`` records a breaker
    failure and raises :class:`CallDeadlineExceeded` — and (d) feeds its
    outcome to the breaker either way. Non-callable attributes pass
    through untouched.
    """

    #: attributes served from the proxy itself, never the target
    _OWN = ("member_id", "endpoint", "breaker", "retry",
            "call_deadline_ms", "calls", "failures", "fast_fails",
            "deadline_misses")

    def __init__(self, member_id: str, target, *,
                 endpoint: str = "", breaker: CircuitBreaker | None = None,
                 retry: RetryPolicy = NO_RETRY,
                 call_deadline_ms: int = 0, retry_on: tuple = (),
                 now_ms=None, sleep_ms=None) -> None:
        self.member_id = member_id
        self.endpoint = endpoint
        self.breaker = breaker or CircuitBreaker(name=member_id)
        self.retry = retry
        self.call_deadline_ms = call_deadline_ms
        self._retry_on = retry_on
        self._target = target
        self._now_ms = now_ms or (lambda: int(_time.monotonic() * 1000))
        self._sleep_ms = sleep_ms
        self.calls = 0
        self.failures = 0
        self.fast_fails = 0
        self.deadline_misses = 0

    def _wrap(self, fn):
        def call(*args, **kwargs):
            start = self._now_ms()
            if not self.breaker.allow(start):
                self.fast_fails += 1
                raise CircuitOpenError(
                    f"member {self.member_id!r} breaker is "
                    f"{self.breaker.state} (probe at "
                    f"{self.breaker.probe_at})")
            self.calls += 1
            try:
                out = self.retry.call(fn, *args, retry_on=self._retry_on,
                                      sleep_ms=self._sleep_ms,
                                      now_ms=self._now_ms, **kwargs)
            except Exception:
                self.failures += 1
                self.breaker.record_failure(self._now_ms())
                raise
            end = self._now_ms()
            if self.call_deadline_ms \
                    and end - start > self.call_deadline_ms:
                # The answer arrived too late to be useful: charge the
                # breaker and refuse it, so a slow-but-alive endpoint
                # degrades exactly like a dead one (deterministic on the
                # injected clock — no wall-clock race).
                self.deadline_misses += 1
                self.failures += 1
                self.breaker.record_failure(end)
                raise CallDeadlineExceeded(
                    f"member {self.member_id!r} call {fn.__name__} took "
                    f"{end - start} ms > deadline "
                    f"{self.call_deadline_ms} ms")
            self.breaker.record_success(end)
            return out
        call.__name__ = getattr(fn, "__name__", "call")
        return call

    def __getattr__(self, name):
        # Only fires for attributes not found on the proxy instance
        # itself (member_id, breaker, ... resolve normally).
        attr = getattr(self._target, name)
        if not callable(attr):
            return attr
        return self._wrap(attr)

    def to_json(self) -> dict:
        return {"endpoint": self.endpoint or None,
                "calls": self.calls,
                "failures": self.failures,
                "fastFails": self.fast_fails,
                "deadlineMisses": self.deadline_misses,
                "breaker": self.breaker.to_json()}
