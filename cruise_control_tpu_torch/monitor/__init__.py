"""Monitor layer (port of ``cruise_control_tpu/monitor``): metric ingestion
-> cluster model factory.

Samplers (:mod:`.sampler`), sample persistence/replay (:mod:`.store`),
fetch fan-out (:mod:`.fetcher`), completeness gating (:mod:`.requirements`),
the load monitor itself (:mod:`.monitor`) and the sampling state machine
(:mod:`.task_runner`). The raw-metrics processor, the Prometheus sampler
and the native sample loader are not ported yet (ROADMAP queue 1 item 11).
"""

from .fetcher import MetricFetcherManager
from .monitor import (ClusterModelResult, LoadMonitor, LoadMonitorState,
                      MonitorConfig, NotEnoughValidWindowsException,
                      StaleClusterModelError)
from .requirements import ModelCompletenessRequirements
from .sampler import (AgentTopicSampler, MetricSampler, SamplerAssignment,
                      Samples, SyntheticWorkloadSampler)
from .samples import BrokerMetricSample, PartitionMetricSample
from .store import FileSampleStore, NoopSampleStore, SampleStore
from .task_runner import LoadMonitorTaskRunner, RunnerState

__all__ = [
    "MetricFetcherManager", "ClusterModelResult", "LoadMonitor",
    "LoadMonitorState", "MonitorConfig", "NotEnoughValidWindowsException",
    "StaleClusterModelError", "ModelCompletenessRequirements",
    "AgentTopicSampler", "MetricSampler", "SamplerAssignment", "Samples",
    "SyntheticWorkloadSampler", "BrokerMetricSample", "PartitionMetricSample",
    "FileSampleStore", "NoopSampleStore", "SampleStore",
    "LoadMonitorTaskRunner", "RunnerState",
]
