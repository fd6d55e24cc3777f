"""Kafka anomaly types (ref ``detector/KafkaAnomalyType.java:29``) and the
``KafkaAnomaly`` subclasses the port's callers reach: ``BrokerFailures``
and ``GoalViolations`` (the self-healing notifier's policy branches) and
``FleetMemberQuarantined`` (the fleet registry's health machine). The
other subclasses come with the detectors that raise them.

Each anomaly knows how to fix itself through the facade — the same
runnables the REST endpoints use (ref each anomaly's ``fix()`` invoking
Remove/Demote/Rebalance runnables with ``isTriggeredByAnomaly=true``).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field


class KafkaAnomalyType(enum.IntEnum):
    """Priority order: lower value = higher priority (ref
    KafkaAnomalyType.java:29)."""

    BROKER_FAILURE = 0
    MAINTENANCE_EVENT = 1
    DISK_FAILURE = 2
    METRIC_ANOMALY = 3
    TOPIC_ANOMALY = 4
    GOAL_VIOLATION = 5
    #: predicted (what-if) risk, not a live fault — low priority:
    #: every realized anomaly outranks a forecast
    BROKER_RISK = 6
    #: predicted capacity pressure from the load-trajectory forecast
    #: (forecast/detector.py) — like BROKER_RISK, a projection: lowest
    #: priority, provisioning evidence rather than a self-healing drain
    CAPACITY_FORECAST = 7
    #: a fleet member's endpoint walked DEGRADED → QUARANTINED
    #: (fleet/registry.py health state machine) — alert-only: the
    #: member's DATA plane may be perfectly healthy behind an
    #: unreachable endpoint, so the only safe "fix" is the registry's
    #: own half-open probe/readmission cycle, not a drain. Still a
    #: realized control-plane fault, so it outranks the SLO page below
    FLEET_MEMBER_QUARANTINED = 8
    #: SLO burn-rate breach from core/slo.py — an alerting signal about
    #: the control plane's own freshness, not a cluster fault: lowest
    #: priority of all so every real (or even projected) anomaly
    #: outranks it in the heal queue
    SLO_BREACH = 9


_ids = itertools.count()


@dataclass
class KafkaAnomaly:
    """ref KafkaAnomaly.java. ``fix`` returns True when a fix started."""

    detected_ms: int
    anomaly_id: str = field(default="", init=False)

    def __post_init__(self):
        self.anomaly_id = f"{type(self).__name__.lower()}-{next(_ids)}"

    anomaly_type: KafkaAnomalyType = KafkaAnomalyType.GOAL_VIOLATION

    def reason(self) -> str:
        return type(self).__name__

    def fix(self, facade) -> bool:
        raise NotImplementedError

    def still_valid(self, facade) -> bool:
        """Re-check against live cluster state before acting — a deferred
        anomaly may describe a condition that has since recovered."""
        return True

    def merge_from(self, other: "KafkaAnomaly") -> None:
        """Absorb a fresher detection of the same condition (the manager
        de-dups by reason but keeps the earliest queue entry so notifier
        time thresholds measure from first detection)."""

    def to_json(self) -> dict:
        return {"anomalyId": self.anomaly_id,
                "type": self.anomaly_type.name,
                "detectedMs": self.detected_ms,
                "description": self.reason()}


@dataclass
class BrokerFailures(KafkaAnomaly):
    """ref BrokerFailures.java."""

    failed_brokers: dict[int, int] = field(default_factory=dict)  # id -> since
    anomaly_type: KafkaAnomalyType = KafkaAnomalyType.BROKER_FAILURE

    def reason(self) -> str:
        return f"Brokers {sorted(self.failed_brokers)} failed"

    def still_valid(self, facade) -> bool:
        """Drop brokers that came back; a fully-recovered failure must not
        drain healthy brokers when its deferred fix finally fires."""
        alive = facade.admin.describe_cluster()
        self.failed_brokers = {b: t for b, t in self.failed_brokers.items()
                               if not alive.get(b, False)}
        return bool(self.failed_brokers)

    def merge_from(self, other: "KafkaAnomaly") -> None:
        if isinstance(other, BrokerFailures):
            # Keep the earliest failure time per broker; adopt new failures.
            for b, t in other.failed_brokers.items():
                self.failed_brokers[b] = min(
                    t, self.failed_brokers.get(b, t))

    def fix(self, facade) -> bool:
        res, exec_res = facade.remove_brokers(
            sorted(self.failed_brokers), dryrun=False,
            uuid=self.anomaly_id,
            goals=getattr(facade, "self_healing_goals", None))
        # No proposals == nothing left to move (already healed): success.
        return exec_res is None or exec_res.succeeded


@dataclass
class GoalViolations(KafkaAnomaly):
    """ref GoalViolations.java."""

    fixable_violations: list[str] = field(default_factory=list)
    unfixable_violations: list[str] = field(default_factory=list)
    anomaly_type: KafkaAnomalyType = KafkaAnomalyType.GOAL_VIOLATION

    def reason(self) -> str:
        return (f"Violated goals: fixable {self.fixable_violations}, "
                f"unfixable {self.unfixable_violations}")

    def fix(self, facade) -> bool:
        if not self.fixable_violations:
            return False
        # ref self.healing.goals: when configured, self-healing optimizes
        # with that chain instead of the default (serve.py validates it
        # covers the registered hard goals at startup).
        res, exec_res = facade.rebalance(
            dryrun=False, uuid=self.anomaly_id, ignore_proposal_cache=True,
            goals=getattr(facade, "self_healing_goals", None))
        return exec_res is None or exec_res.succeeded


@dataclass
class FleetMemberQuarantined(KafkaAnomaly):
    """A fleet member crossed the quarantine threshold: N consecutive
    degraded ticks (breaker open / fetch deadline missed / fetch error)
    and the registry excluded it from the fleet stack and dispatch
    (fleet/registry.py). Alert-only: ``fix()`` declines — readmission is
    the registry's own half-open probe → warm rebuild → rejoin cycle,
    and draining a cluster because its ENDPOINT is unreachable would
    punish a healthy data plane. ``journal_seq`` links the quarantine
    event in the flight recorder (``fleet`` category) for cause-chain
    forensics."""

    cluster_id: str = ""
    degraded_ticks: int = 0
    breaker_state: str = ""
    last_error: str | None = None
    journal_seq: int | None = None
    anomaly_type: KafkaAnomalyType = \
        KafkaAnomalyType.FLEET_MEMBER_QUARANTINED

    def reason(self) -> str:
        return (f"Fleet member {self.cluster_id!r} quarantined after "
                f"{self.degraded_ticks} degraded ticks (breaker "
                f"{self.breaker_state}; last error: {self.last_error})")

    def fix(self, facade) -> bool:
        return False   # alert-only: readmission is the registry's probe

    def to_json(self) -> dict:
        out = super().to_json()
        out["clusterId"] = self.cluster_id
        out["degradedTicks"] = self.degraded_ticks
        out["breakerState"] = self.breaker_state
        out["lastError"] = self.last_error
        out["journalSeq"] = self.journal_seq
        return out
