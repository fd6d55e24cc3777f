"""Metric definitions: name -> id -> aggregation strategy registry.

Mirrors the reference's ``metricdef/MetricDef.java`` (core) and
``monitor/metricdefinition/KafkaMetricDef.java:43-61``, which map raw metric
types onto the model-level metrics (CPU_USAGE, DISK_USAGE, LEADER_BYTES_IN,
...) each with an aggregation strategy (AVG / MAX / LATEST) and a
"toPredict" group used when several raw metrics fold into one model resource.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable


class AggregationFunction(enum.Enum):
    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


@dataclass(frozen=True)
class MetricInfo:
    name: str
    id: int
    strategy: AggregationFunction
    group: str | None = None


class MetricDef:
    """Registry mapping metric names to dense integer ids (ref MetricDef.java)."""

    def __init__(self) -> None:
        self._by_name: dict[str, MetricInfo] = {}
        self._by_id: list[MetricInfo] = []

    def define(self, name: str, strategy: AggregationFunction = AggregationFunction.AVG,
               group: str | None = None) -> "MetricDef":
        if name in self._by_name:
            raise ValueError(f"Metric {name!r} already defined")
        info = MetricInfo(name, len(self._by_id), strategy, group)
        self._by_name[name] = info
        self._by_id.append(info)
        return self

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def metric_info_by_id(self, metric_id: int) -> MetricInfo:
        return self._by_id[metric_id]

    def size(self) -> int:
        return len(self._by_id)

    def all_metrics(self) -> Iterable[MetricInfo]:
        return tuple(self._by_id)

    def names(self) -> tuple[str, ...]:
        return tuple(info.name for info in self._by_id)


# ---------------------------------------------------------------------------
# Kafka model-level metric defs (ref KafkaMetricDef.java)
# ---------------------------------------------------------------------------

class KafkaMetric(enum.IntEnum):
    """Model-level ("common") metric ids, dense, in registry order.

    The first four map 1:1 onto :class:`~cruise_control_tpu_torch.core.resources.Resource`
    axis order so a partition sample's resource vector is ``values[:4]``.
    """

    CPU_USAGE = 0
    LEADER_BYTES_IN = 1
    LEADER_BYTES_OUT = 2
    DISK_USAGE = 3
    PRODUCE_RATE = 4
    FETCH_RATE = 5
    MESSAGE_IN_RATE = 6
    REPLICATION_BYTES_IN_RATE = 7
    REPLICATION_BYTES_OUT_RATE = 8


def partition_metric_def() -> MetricDef:
    """Metric def for per-partition samples (ref KafkaMetricDef.commonMetricDef)."""
    definition = MetricDef()
    definition.define("CPU_USAGE", AggregationFunction.AVG, group="CPU")
    definition.define("LEADER_BYTES_IN", AggregationFunction.AVG, group="NW_IN")
    definition.define("LEADER_BYTES_OUT", AggregationFunction.AVG, group="NW_OUT")
    definition.define("DISK_USAGE", AggregationFunction.LATEST, group="DISK")
    definition.define("PRODUCE_RATE", AggregationFunction.AVG)
    definition.define("FETCH_RATE", AggregationFunction.AVG)
    definition.define("MESSAGE_IN_RATE", AggregationFunction.AVG)
    definition.define("REPLICATION_BYTES_IN_RATE", AggregationFunction.AVG)
    definition.define("REPLICATION_BYTES_OUT_RATE", AggregationFunction.AVG)
    return definition


class BrokerMetric(enum.IntEnum):
    """Model-level broker metric ids (subset of ref brokerMetricDef)."""

    CPU_USAGE = 0
    LEADER_BYTES_IN = 1
    LEADER_BYTES_OUT = 2
    DISK_USAGE = 3
    REPLICATION_BYTES_IN_RATE = 4
    REPLICATION_BYTES_OUT_RATE = 5
    BROKER_PRODUCE_REQUEST_RATE = 6
    BROKER_CONSUMER_FETCH_REQUEST_RATE = 7
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = 8
    BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT = 9
    BROKER_LOG_FLUSH_RATE = 10
    BROKER_LOG_FLUSH_TIME_MS_MEAN = 11
    BROKER_LOG_FLUSH_TIME_MS_999TH = 12


def broker_metric_def() -> MetricDef:
    definition = MetricDef()
    for metric in BrokerMetric:
        strategy = (AggregationFunction.LATEST if metric is BrokerMetric.DISK_USAGE
                    else AggregationFunction.AVG)
        definition.define(metric.name, strategy)
    return definition
