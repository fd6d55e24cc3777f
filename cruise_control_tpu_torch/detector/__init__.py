"""Detector layer, as far as the port carries it: the anomaly types and
the self-healing notifier the fleet registry reports to, and the
provision verdict types (counterpart of ``cruise_control_tpu.detector``).
The detectors, their manager, the other anomaly types and the webhook
notifiers are not ported yet."""

from .anomalies import (BrokerFailures, FleetMemberQuarantined, GoalViolations,
                        KafkaAnomaly, KafkaAnomalyType)
from .notifier import (AnomalyNotificationResult, AnomalyNotifier,
                       NotificationAction, SelfHealingNotifier)
from .provisioner import (ProvisionRecommendation, ProvisionResponse,
                          ProvisionStatus)

__all__ = [
    "BrokerFailures", "FleetMemberQuarantined", "GoalViolations",
    "KafkaAnomaly", "KafkaAnomalyType", "AnomalyNotificationResult",
    "AnomalyNotifier", "NotificationAction", "SelfHealingNotifier",
    "ProvisionRecommendation", "ProvisionResponse", "ProvisionStatus",
]
