"""Metric sample holders (ref ``monitor/sampling/holder/PartitionMetricSample.java``
and ``BrokerMetricSample.java``).

A sample is a point-in-time metric vector for one entity. Partition entities
are ``(topic, partition)`` tuples (entity group = topic, matching the
reference's ENTITY_GROUP granularity); broker entities are broker ids.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.aggregator import MetricSample
from ..core.metricdef import BrokerMetric, KafkaMetric


@dataclass
class PartitionMetricSample:
    """Per-partition sample in model metric space (ref
    PartitionMetricSample.java)."""

    topic: str
    partition: int
    time_ms: int
    #: KafkaMetric id -> value
    values: dict[int, float] = field(default_factory=dict)

    def record(self, metric: KafkaMetric, value: float) -> None:
        self.values[int(metric)] = value

    @property
    def entity(self) -> tuple[str, int]:
        return (self.topic, self.partition)

    def to_aggregator_sample(self) -> MetricSample:
        return MetricSample(entity=self.entity, sample_time_ms=self.time_ms,
                            values=dict(self.values), entity_group=self.topic)

    def to_json(self) -> dict:
        return {"topic": self.topic, "partition": self.partition,
                "timeMs": self.time_ms,
                "values": {str(k): v for k, v in self.values.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "PartitionMetricSample":
        return cls(topic=d["topic"], partition=int(d["partition"]),
                   time_ms=int(d["timeMs"]),
                   values={int(k): float(v)
                           for k, v in d["values"].items()})


@dataclass
class BrokerMetricSample:
    """Per-broker sample (ref BrokerMetricSample.java)."""

    broker_id: int
    time_ms: int
    values: dict[int, float] = field(default_factory=dict)

    def record(self, metric: BrokerMetric, value: float) -> None:
        self.values[int(metric)] = value

    @property
    def entity(self) -> int:
        return self.broker_id

    def to_aggregator_sample(self) -> MetricSample:
        return MetricSample(entity=self.broker_id, sample_time_ms=self.time_ms,
                            values=dict(self.values))

    def to_json(self) -> dict:
        return {"brokerId": self.broker_id, "timeMs": self.time_ms,
                "values": {str(k): v for k, v in self.values.items()}}

    @classmethod
    def from_json(cls, d: dict) -> "BrokerMetricSample":
        return cls(broker_id=int(d["brokerId"]), time_ms=int(d["timeMs"]),
                   values={int(k): float(v)
                           for k, v in d["values"].items()})
