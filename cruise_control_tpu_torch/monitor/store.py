"""Sample persistence: the checkpoint/resume mechanism (port of
``cruise_control_tpu/monitor/store.py``).

Rebuild of ``monitor/sampling/KafkaSampleStore.java:68`` (the reference
stores every sample in two compacted Kafka topics and replays them on
startup, so a restarted server regains its N-hour metrics window without
re-sampling). Here the durable medium is an append-only JSONL file pair;
the SPI is the same store/replay contract (``SampleStore.java``). Replay
parses each line in Python: the port has no native columnar loader.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Protocol

from .sampler import Samples
from .samples import BrokerMetricSample, PartitionMetricSample

LOG = logging.getLogger(__name__)


class SampleStore(Protocol):
    """ref SampleStore.java:96."""

    def store_samples(self, samples: Samples) -> None: ...

    def load_samples(self) -> Samples: ...

    def close(self) -> None: ...


class NoopSampleStore:
    """ref NoopSampleStore: persistence disabled."""

    def store_samples(self, samples: Samples) -> None:
        pass

    def load_samples(self) -> Samples:
        return Samples([], [])

    def close(self) -> None:
        pass


class FileSampleStore:
    """Append-only JSONL files, one line per sample (the file-backed
    equivalent of the two sample-store topics,
    ``partition.metric.sample.store.topic`` / ``broker.metric.sample.store.
    topic`` ``KafkaSampleStore.java:93-94``)."""

    def __init__(self, directory: str, *,
                 retention_ms: int | None = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._retention_ms = retention_ms
        #: records skipped on replay because the line would not parse —
        #: a crash mid-append leaves a torn trailing line; it used to
        #: poison the whole replay (one json.loads error killed the
        #: LOADING state). Metered here, surfaced via the warning log.
        self.skipped_records = 0
        self._lock = threading.Lock()
        self._pfile = open(os.path.join(directory, "partition_samples.jsonl"),
                           "a", encoding="utf-8")
        self._bfile = open(os.path.join(directory, "broker_samples.jsonl"),
                           "a", encoding="utf-8")

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            for s in samples.partition_samples:
                self._pfile.write(json.dumps(s.to_json()) + "\n")
            for s in samples.broker_samples:
                self._bfile.write(json.dumps(s.to_json()) + "\n")
            self._pfile.flush()
            self._bfile.flush()

    def load_samples(self) -> Samples: ...

    def close(self) -> None: ...


class NoopSampleStore:
    """ref NoopSampleStore: persistence disabled."""

    def store_samples(self, samples: Samples) -> None:
        pass

    def load_samples(self) -> Samples:
        return Samples([], [])

    def close(self) -> None:
        pass


class FileSampleStore:
    """Append-only JSONL files, one line per sample (the file-backed
    equivalent of the two sample-store topics,
    ``partition.metric.sample.store.topic`` / ``broker.metric.sample.store.
    topic`` ``KafkaSampleStore.java:93-94``)."""

    def __init__(self, directory: str, *,
                 retention_ms: int | None = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._retention_ms = retention_ms
        #: records skipped on replay because the line would not parse —
        #: a crash mid-append leaves a torn trailing line; it used to
        #: poison the whole replay (one json.loads error killed the
        #: LOADING state). Metered here, surfaced via the warning log.
        self.skipped_records = 0
        self._lock = threading.Lock()
        self._pfile = open(os.path.join(directory, "partition_samples.jsonl"),
                           "a", encoding="utf-8")
        self._bfile = open(os.path.join(directory, "broker_samples.jsonl"),
                           "a", encoding="utf-8")

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            for s in samples.partition_samples:
                self._pfile.write(json.dumps(s.to_json()) + "\n")
            for s in samples.broker_samples:
                self._bfile.write(json.dumps(s.to_json()) + "\n")
            self._pfile.flush()
            self._bfile.flush()

    def load_samples_dense(self):
        """Columnar replay: the partition side parsed by the native
        scanner (sidecar/libsample_loader.so) straight into
        ``add_samples_dense``-shaped arrays; broker samples (small) stay
        object-parsed. Returns ``((entities, times, values),
        broker_samples)`` or ``None`` when the native loader is
        unavailable or refuses the file — callers then use
        :meth:`load_samples`."""
        from ..core.metricdef import partition_metric_def
        from . import native_loader
        with self._lock:
            self._pfile.flush()
            self._bfile.flush()
            block = native_loader.load_partition_samples_dense(
                os.path.join(self._dir, "partition_samples.jsonl"),
                partition_metric_def().size())
            if block is None:
                return None
            bsamples = self._read(
                os.path.join(self._dir, "broker_samples.jsonl"),
                BrokerMetricSample.from_json)
        entities, times, values = block
        latest = max(int(times.max()) if len(times) else 0,
                     max((s.time_ms for s in bsamples), default=0))
        if self._retention_ms is not None:
            horizon = latest - self._retention_ms
            keep = times >= horizon
            entities = [e for e, k in zip(entities, keep) if k]
            times, values = times[keep], values[keep]
            bsamples = [s for s in bsamples if s.time_ms >= horizon]
        return (entities, times, values), bsamples, latest

    def load_samples(self) -> Samples:
        """Replay everything retained (ref KafkaSampleStore loadSamples -> the
        LOADING monitor state)."""
        with self._lock:
            self._pfile.flush()
            self._bfile.flush()
            psamples = self._read(os.path.join(self._dir,
                                               "partition_samples.jsonl"),
                                  PartitionMetricSample.from_json)
            bsamples = self._read(os.path.join(self._dir,
                                               "broker_samples.jsonl"),
                                  BrokerMetricSample.from_json)
        latest = max([s.time_ms for s in psamples + bsamples], default=0)
        if self._retention_ms is not None:
            horizon = latest - self._retention_ms
            psamples = [s for s in psamples if s.time_ms >= horizon]
            bsamples = [s for s in bsamples if s.time_ms >= horizon]
        return Samples(psamples, bsamples)

    def _read(self, path: str, parse):
        out = []
        if not os.path.exists(path):
            return out
        skipped = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                # Crash-tolerance: a process dying mid-append leaves a
                # torn trailing line (and, on weirder filesystems, a
                # NUL-padded hole). Skip + meter the unparseable record
                # instead of failing the whole replay — losing one
                # sample is noise; losing N hours of history repays the
                # entire warm-in.
                try:
                    out.append(parse(json.loads(line)))
                except (ValueError, KeyError, TypeError):
                    skipped += 1
        if skipped:
            self.skipped_records += skipped
            LOG.warning(
                "sample replay from %s skipped %d unparseable record(s) "
                "(torn append from a crash mid-write; replay continues "
                "with the remaining history)", path, skipped)
        return out

    def close(self) -> None:
        with self._lock:
            self._pfile.close()
            self._bfile.close()
