"""Shared retry-with-exponential-backoff+jitter policy.

The reference retries transient admin failures ad hoc per call site
(``ExecutorAdminUtils`` list-reassignment attempts, the sample fetcher's
``fetch.metric.samples.max.retry.count``); this module is the ONE policy
object the executor's setup/poll/abort paths and the facade's admin reads
share, so backoff behavior is tuned (and tested) in a single place.

Design constraints, driven by the chaos harness:

- **Deterministic.** Jitter derives from a hash of ``(seed, attempt)``,
  never from global RNG state or wall clock — a chaos run replayed from
  the same seed produces byte-identical retry schedules.
- **Clock-agnostic.** Sleeping goes through a caller-provided ``sleep_ms``
  (the executor passes its simulated clock), so retried paths stay
  wall-clock free under test.
- **Classification stays at the call site.** ``retry_on`` names the
  retryable exception types; anything else propagates immediately. The
  admin layer's :data:`~cruise_control_tpu_torch.executor.kafka_admin.
  RETRYABLE_ADMIN_ERRORS` is the canonical tuple for admin RPCs.
"""

from __future__ import annotations

import time as _time
import zlib
from dataclasses import dataclass


def deterministic_uniform(seed: int, *key) -> float:
    """Deterministic uniform [0, 1) draw keyed off ``(seed, *key)`` — the
    ONE seeded-draw primitive retry jitter and the chaos engine share, so
    replay determinism cannot drift between the two."""
    h = zlib.crc32(":".join(str(k) for k in (seed, *key)).encode())
    return (h % 10_000) / 10_000.0


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded, deterministic jitter.

    Attempt ``i`` (0-based) that fails retryably sleeps
    ``min(backoff_ms * multiplier**i, max_backoff_ms)`` scaled by
    ``1 ± jitter`` before attempt ``i+1``; after ``max_attempts`` total
    attempts the last exception propagates.
    """

    max_attempts: int = 3
    backoff_ms: int = 100
    backoff_multiplier: float = 2.0
    max_backoff_ms: int = 10_000
    #: fractional jitter band: delay is scaled into [1-j, 1+j]
    jitter: float = 0.2
    #: default jitter seed for calls that don't pass one. 0 (replayable)
    #: for chaos/test policies; production wiring (constants.py) seeds
    #: per process so fleet instances decorrelate their retry waves
    #: instead of re-colliding in sync after a shared controller hiccup.
    seed: int = 0
    #: overall wall-clock budget across ALL attempts of one ``call``
    #: (admin.retry.deadline.ms). Attempts are bounded but elapsed time
    #: is not: a slow-FAILING endpoint can stretch any per-call deadline
    #: through the backoff sleeps. When the budget would be exceeded by
    #: the next backoff, the last exception propagates instead of
    #: sleeping. 0 = unbounded (the pre-existing behavior).
    deadline_ms: int = 0

    def delay_ms(self, attempt: int, seed: int | None = None) -> int:
        """Backoff before the attempt AFTER 0-based ``attempt``."""
        base = min(self.backoff_ms * self.backoff_multiplier ** attempt,
                   float(self.max_backoff_ms))
        frac = deterministic_uniform(
            self.seed if seed is None else seed, attempt)
        scale = 1.0 + self.jitter * (2.0 * frac - 1.0)
        return max(int(base * scale), 0)

    def call(self, fn, *args, retry_on: tuple = (), sleep_ms=None,
             on_retry=None, seed: int | None = None, now_ms=None,
             **kwargs):
        """Invoke ``fn(*args, **kwargs)`` under this policy.

        ``on_retry(attempt, delay_ms, exc)`` fires before each backoff
        sleep (meters/logs hook); a non-``retry_on`` exception — or the
        final retryable one — propagates unchanged. ``now_ms`` is the
        clock the ``deadline_ms`` budget is measured on: pass the same
        simulated clock as ``sleep_ms`` so chaos replays of a
        deadline-cut retry ladder stay byte-identical (defaults to the
        process monotonic clock).
        """
        if sleep_ms is None:
            sleep_ms = lambda ms: _time.sleep(ms / 1000.0)  # noqa: E731
        if now_ms is None:
            now_ms = lambda: int(_time.monotonic() * 1000)  # noqa: E731
        attempts = max(self.max_attempts, 1)
        start = now_ms() if self.deadline_ms else 0
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except retry_on as exc:
                if attempt == attempts - 1:
                    raise
                delay = self.delay_ms(attempt, seed)
                if self.deadline_ms:
                    elapsed = now_ms() - start
                    if elapsed + delay > self.deadline_ms:
                        # Sleeping would overshoot the budget; the call
                        # has already consumed its wall-clock allowance.
                        raise
                if on_retry is not None:
                    on_retry(attempt, delay, exc)
                sleep_ms(delay)


#: Retry disabled: one attempt, no sleeps — call sites keep the shared
#: shape while an operator opts out (admin.retry.max.attempts=1).
NO_RETRY = RetryPolicy(max_attempts=1)
