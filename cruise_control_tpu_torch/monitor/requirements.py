"""Model completeness requirements (ref
``monitor/ModelCompletenessRequirements.java``): the gate between "we have
some samples" and "the model is trustworthy enough to act on". Every goal
declares one; the optimizer request uses the strongest combination of its
goals' requirements (ref ``combine``)."""

from __future__ import annotations

from dataclasses import dataclass

from ..core.aggregator import MetricSampleCompleteness


@dataclass(frozen=True)
class ModelCompletenessRequirements:
    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def combine(self, other: "ModelCompletenessRequirements | None"
                ) -> "ModelCompletenessRequirements":
        """Strongest of the two (ref stronger())."""
        if other is None:
            return self
        return ModelCompletenessRequirements(
            min_required_num_windows=max(self.min_required_num_windows,
                                         other.min_required_num_windows),
            min_monitored_partitions_percentage=max(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            include_all_topics=self.include_all_topics or other.include_all_topics)

    def met_by(self, completeness: MetricSampleCompleteness) -> bool:
        """ref LoadMonitor.meetCompletenessRequirements (LoadMonitor.java:655)."""
        if len(completeness.valid_windows) < self.min_required_num_windows:
            return False
        if (completeness.valid_entity_ratio
                < self.min_monitored_partitions_percentage):
            return False
        return True

    def to_json(self) -> dict:
        return {"requiredNumWindows": self.min_required_num_windows,
                "minMonitoredPartitionsPercentage":
                    self.min_monitored_partitions_percentage,
                "includeAllTopics": self.include_all_topics}
