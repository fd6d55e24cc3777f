"""Global move-budget coordinator: one fleet-wide movement allowance.

N clusters healing at once each execute within their OWN concurrency
caps, but the caps don't compose: simultaneous heals multiply into the
shared network/ops capacity behind every cluster (the cross-cluster
mirrors, the shared object store, the on-call). The coordinator hands
out per-tick move/leadership grants from ONE configurable fleet-wide
budget (``fleet.move.budget.per.tick``), weighted by per-member urgency:
hard-goal violations first, then time-to-breach from the PR-13 capacity
forecast. Unspent budget carries over (bounded by
``fleet.budget.carry.max.ticks`` ticks' worth) so a quiet tick buys a
burst later instead of evaporating.

Allocation is deterministic: members sort by (hard violations desc,
time-to-breach asc, cluster id), weights are pure arithmetic on the
request fields, and leftover units distribute one-by-one in sort order —
the same requests always produce the same grants, which the chaos
replay gate relies on. Grants, denials, and carry-over are metered and
journaled (``fleet`` category) per tick.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BudgetRequest:
    """One member's ask for this tick."""

    cluster_id: str
    #: moves the member's current proposal set wants to execute
    requested: int
    #: hard-goal violations outstanding (primary urgency key)
    hard_violations: int = 0
    #: forecast time-to-breach in ms (secondary urgency key; None = no
    #: projected breach)
    time_to_breach_ms: int | None = None


@dataclass(frozen=True)
class BudgetGrant:
    cluster_id: str
    requested: int
    granted: int
    urgency: float

    @property
    def denied(self) -> int:
        return self.requested - self.granted

    def to_json(self) -> dict:
        return {"requested": self.requested, "granted": self.granted,
                "denied": self.denied,
                "urgency": round(self.urgency, 4)}


class MoveBudgetCoordinator:
    """Per-tick urgency-weighted grants from one fleet-wide budget."""

    def __init__(self, *, budget_per_tick: int = 0,
                 carry_max_ticks: int = 2, registry=None,
                 journal=None) -> None:
        #: 0 = unbudgeted: every request is granted in full (the
        #: coordinator still meters, so turning a budget on later starts
        #: from observed demand).
        self.budget_per_tick = max(budget_per_tick, 0)
        self.carry_max = self.budget_per_tick * max(carry_max_ticks, 0)
        self.carry = 0
        self.journal = journal
        self.ticks = 0
        self.total_granted = 0
        self.total_denied = 0
        self.last_grants: dict[str, BudgetGrant] = {}
        self._granted_meter = self._denied_meter = None
        if registry is not None:
            from ..core.sensors import MetricRegistry
            name = MetricRegistry.name
            self._granted_meter = registry.meter(
                name("FleetBudget", "moves-granted-rate"))
            self._denied_meter = registry.meter(
                name("FleetBudget", "moves-denied-rate"))
            registry.gauge(name("FleetBudget", "carry-over"),
                           lambda: self.carry)

    @staticmethod
    def urgency(req: BudgetRequest) -> float:
        """Pure urgency score: each outstanding hard violation adds a
        full unit; a projected breach adds up to one more unit scaling
        inversely with how far out it is (a breach 1 minute away ≈ +0.5,
        one an hour away ≈ +0.02)."""
        score = 1.0 + req.hard_violations
        if req.time_to_breach_ms is not None:
            score += 1.0 / (1.0 + req.time_to_breach_ms / 60_000.0)
        return score

    def allocate(self, requests: list[BudgetRequest],
                 now_ms: int = 0) -> dict[str, BudgetGrant]:
        """Grant this tick's budget across ``requests``. Returns grants
        keyed by cluster id (every requester gets an entry, possibly
        granted=0)."""
        self.ticks += 1
        if not requests:
            self.last_grants = {}
            return {}
        ordered = sorted(
            requests,
            key=lambda r: (-r.hard_violations,
                           float("inf") if r.time_to_breach_ms is None
                           else r.time_to_breach_ms,
                           r.cluster_id))
        if self.budget_per_tick <= 0:
            grants = {r.cluster_id: BudgetGrant(r.cluster_id, r.requested,
                                                r.requested,
                                                self.urgency(r))
                      for r in ordered}
            return self._finish(grants, now_ms, unbudgeted=True)
        available = self.budget_per_tick + self.carry
        weights = {r.cluster_id: self.urgency(r) for r in ordered}
        total_w = sum(weights[r.cluster_id] for r in ordered
                      if r.requested > 0) or 1.0
        granted = {}
        for r in ordered:
            share = int(available * weights[r.cluster_id] / total_w) \
                if r.requested > 0 else 0
            granted[r.cluster_id] = min(share, r.requested)
        spent = sum(granted.values())
        # Leftover (rounding remainders + capped shares) distributes
        # one-by-one in priority order to members still short — the
        # deterministic largest-need pass.
        leftover = available - spent
        progress = True
        while leftover > 0 and progress:
            progress = False
            for r in ordered:
                if leftover <= 0:
                    break
                if granted[r.cluster_id] < r.requested:
                    granted[r.cluster_id] += 1
                    leftover -= 1
                    progress = True
        self.carry = min(leftover, self.carry_max)
        grants = {r.cluster_id: BudgetGrant(r.cluster_id, r.requested,
                                            granted[r.cluster_id],
                                            weights[r.cluster_id])
                  for r in ordered}
        return self._finish(grants, now_ms, unbudgeted=False)

    def _finish(self, grants: dict[str, BudgetGrant], now_ms: int,
                *, unbudgeted: bool) -> dict[str, BudgetGrant]:
        tick_granted = sum(g.granted for g in grants.values())
        tick_denied = sum(g.denied for g in grants.values())
        self.total_granted += tick_granted
        self.total_denied += tick_denied
        self.last_grants = grants
        if self._granted_meter is not None:
            self._granted_meter.mark(tick_granted)
            self._denied_meter.mark(tick_denied)
        if self.journal is not None and grants:
            self.journal.record(
                "fleet", "budget-allocated",
                detail={"granted": tick_granted, "denied": tick_denied,
                        "carry": self.carry,
                        "budget": (None if unbudgeted
                                   else self.budget_per_tick),
                        "grants": {cid: g.to_json()
                                   for cid, g in grants.items()}})
        return grants

    def to_json(self) -> dict:
        return {"budgetPerTick": self.budget_per_tick or None,
                "carry": self.carry,
                "carryMax": self.carry_max,
                "ticks": self.ticks,
                "totalGranted": self.total_granted,
                "totalDenied": self.total_denied,
                "lastGrants": {cid: g.to_json()
                               for cid, g in self.last_grants.items()}}
