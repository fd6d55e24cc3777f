"""Anomaly notifiers — the self-healing policy layer (ref
``detector/notifier/AnomalyNotifier.java`` SPI and
``SelfHealingNotifier.java:59``).

For each anomaly the notifier decides FIX (self-heal now), CHECK (re-queue
and look again later), or IGNORE. The stock policy for broker failures:
alert after ``broker_failure_alert_threshold_ms`` (default 15 min,
``:69``), auto-fix after ``self_healing_threshold_ms`` (default 30 min,
``:70``) — grace for transient bounces. The reference's webhook
notifiers (Slack, MS Teams, Alerta) come with the detector manager that
sends through them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from .anomalies import (BrokerFailures, GoalViolations, KafkaAnomaly,
                        KafkaAnomalyType)


class AnomalyNotificationResult(enum.Enum):
    """ref AnomalyNotificationResult."""

    FIX = "FIX"
    CHECK = "CHECK"
    IGNORE = "IGNORE"


@dataclass
class NotificationAction:
    result: AnomalyNotificationResult
    delay_ms: int = 0


class AnomalyNotifier:
    """SPI (ref AnomalyNotifier.java:107)."""

    def on_anomaly(self, anomaly: KafkaAnomaly,
                   now_ms: int) -> NotificationAction:
        raise NotImplementedError

    def self_healing_enabled(self) -> dict[KafkaAnomalyType, bool]:
        raise NotImplementedError


class SelfHealingNotifier(AnomalyNotifier):
    """ref SelfHealingNotifier.java:59."""

    BROKER_FAILURE_ALERT_THRESHOLD_MS = 15 * 60 * 1000   # ref :69
    BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS = 30 * 60 * 1000   # ref :70

    def __init__(self, *, alert_threshold_ms: int | None = None,
                 self_healing_threshold_ms: int | None = None,
                 enabled: dict[KafkaAnomalyType, bool] | None = None,
                 alert_sink: Callable[[str, bool], None] | None = None):
        self.alert_threshold_ms = (
            self.BROKER_FAILURE_ALERT_THRESHOLD_MS
            if alert_threshold_ms is None else alert_threshold_ms)
        self.self_healing_threshold_ms = (
            self.BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS
            if self_healing_threshold_ms is None else self_healing_threshold_ms)
        self._enabled = {t: True for t in KafkaAnomalyType}
        if enabled:
            self._enabled.update(enabled)
        #: called with (message, is_autofix) — the Slack/Teams webhook slot
        self.alert_sink = alert_sink or (lambda msg, autofix: None)
        self.alerts: list[str] = []

    def self_healing_enabled(self) -> dict[KafkaAnomalyType, bool]:
        return dict(self._enabled)

    def set_self_healing_for(self, anomaly_type: KafkaAnomalyType,
                             value: bool) -> None:
        self._enabled[anomaly_type] = value

    def _alert(self, message: str, autofix: bool) -> None:
        self.alerts.append(message)
        self.alert_sink(message, autofix)

    def on_anomaly(self, anomaly: KafkaAnomaly,
                   now_ms: int) -> NotificationAction:
        atype = anomaly.anomaly_type
        if isinstance(anomaly, BrokerFailures):
            return self._on_broker_failure(anomaly, now_ms)
        if atype is KafkaAnomalyType.FLEET_MEMBER_QUARANTINED:
            # Alert-only regardless of the enabled map: the member's data
            # plane may be perfectly healthy behind an unreachable
            # endpoint — there is nothing a local fix could move, and the
            # registry's own readmission probes are the recovery path.
            self._alert(f"{atype.name}: {anomaly.reason()}", False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        if not self._enabled.get(atype, False):
            self._alert(f"{atype.name}: {anomaly.reason()} "
                        "(self-healing disabled)", False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        if atype is KafkaAnomalyType.METRIC_ANOMALY and not hasattr(
                anomaly, "slow_brokers"):
            # Plain metric anomalies alert only (ref onMetricAnomaly).
            self._alert(f"METRIC_ANOMALY: {anomaly.reason()}", False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        if (isinstance(anomaly, GoalViolations)
                and not anomaly.fixable_violations):
            # Nothing self-healing can do; alert + gauge territory (ref
            # onGoalViolation only fixes when there are fixable goals).
            self._alert(f"GOAL_VIOLATION (unfixable): {anomaly.reason()}",
                        False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        self._alert(f"{atype.name}: {anomaly.reason()} (self-healing)", True)
        return NotificationAction(AnomalyNotificationResult.FIX)

    def _on_broker_failure(self, anomaly: BrokerFailures,
                           now_ms: int) -> NotificationAction:
        """Graduated response (ref onBrokerFailure): wait, then alert, then
        auto-fix once the oldest failure crosses the threshold."""
        if not anomaly.failed_brokers:
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        earliest = min(anomaly.failed_brokers.values())
        alert_at = earliest + self.alert_threshold_ms
        fix_at = earliest + self.self_healing_threshold_ms
        if now_ms < alert_at:
            return NotificationAction(AnomalyNotificationResult.CHECK,
                                      delay_ms=alert_at - now_ms)
        if now_ms < fix_at:
            self._alert(f"BROKER_FAILURE: {anomaly.reason()}", False)
            if not self._enabled.get(KafkaAnomalyType.BROKER_FAILURE, False):
                return NotificationAction(AnomalyNotificationResult.IGNORE)
            return NotificationAction(AnomalyNotificationResult.CHECK,
                                      delay_ms=fix_at - now_ms)
        if not self._enabled.get(KafkaAnomalyType.BROKER_FAILURE, False):
            self._alert(f"BROKER_FAILURE: {anomaly.reason()} "
                        "(self-healing disabled)", False)
            return NotificationAction(AnomalyNotificationResult.IGNORE)
        self._alert(f"BROKER_FAILURE: {anomaly.reason()} (auto-fix)", True)
        return NotificationAction(AnomalyNotificationResult.FIX)
