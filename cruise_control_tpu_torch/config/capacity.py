"""Broker capacity resolution (ref ``config/BrokerCapacityConfigResolver``
SPI and ``BrokerCapacityConfigFileResolver.java:149``).

Reads the reference's own ``capacity.json`` formats:

- plain: ``{"brokerCapacities": [{"brokerId": "-1", "capacity":
  {"DISK": "100000", "CPU": "100", "NW_IN": "10000", "NW_OUT": "10000"}}]}``
  (broker id -1 = default for unlisted brokers);
- JBOD: ``DISK`` is a dict of logdir path -> MB (``capacityJBOD.json``);
- cores: ``CPU`` given as ``{"num.cores": N}`` (``capacityCores.json``),
  normalized to percent like the reference.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Protocol

from ..core.resources import Resource

DEFAULT_CAPACITY = {Resource.CPU: 100.0, Resource.NW_IN: 10_000.0,
                    Resource.NW_OUT: 10_000.0, Resource.DISK: 100_000.0}


@dataclass
class BrokerCapacityInfo:
    """ref BrokerCapacityInfo.java: total capacity + optional per-logdir
    breakdown + estimation flag."""

    capacity: dict[Resource, float]
    disk_capacity_by_logdir: dict[str, float] | None = None
    num_cpu_cores: int = 1
    is_estimated: bool = False

    def as_vector(self) -> tuple[float, float, float, float]:
        return (self.capacity[Resource.CPU], self.capacity[Resource.NW_IN],
                self.capacity[Resource.NW_OUT], self.capacity[Resource.DISK])


class BrokerCapacityConfigResolver(Protocol):
    """SPI (ref BrokerCapacityConfigResolver.java)."""

    def capacity_for_broker(self, rack: str, host: str,
                            broker_id: int) -> BrokerCapacityInfo: ...


@dataclass
class FixedCapacityResolver:
    """Same capacity for every broker (tests / synthetic benches)."""

    capacity: dict[Resource, float] = field(
        default_factory=lambda: dict(DEFAULT_CAPACITY))

    def capacity_for_broker(self, rack, host, broker_id) -> BrokerCapacityInfo:
        return BrokerCapacityInfo(dict(self.capacity), is_estimated=True)


class FileCapacityResolver:
    """ref BrokerCapacityConfigFileResolver reading capacity.json."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        self._default: BrokerCapacityInfo | None = None
        self._by_id: dict[int, BrokerCapacityInfo] = {}
        for entry in doc["brokerCapacities"]:
            broker_id = int(entry["brokerId"])
            info = self._parse(entry)
            if broker_id == -1:
                self._default = info
            else:
                self._by_id[broker_id] = info

    @staticmethod
    def _parse(entry: dict) -> BrokerCapacityInfo:
        cap = entry["capacity"]
        disk = cap["DISK"]
        logdirs = None
        if isinstance(disk, dict):
            logdirs = {d: float(v) for d, v in disk.items()}
            disk_total = sum(logdirs.values())
        else:
            disk_total = float(disk)
        cpu = cap["CPU"]
        cores = 1
        if isinstance(cpu, dict):
            cores = int(cpu["num.cores"])
            cpu_total = 100.0 * cores
        else:
            cpu_total = float(cpu)
        return BrokerCapacityInfo(
            capacity={Resource.CPU: cpu_total,
                      Resource.NW_IN: float(cap["NW_IN"]),
                      Resource.NW_OUT: float(cap["NW_OUT"]),
                      Resource.DISK: disk_total},
            disk_capacity_by_logdir=logdirs, num_cpu_cores=cores)

    def capacity_for_broker(self, rack, host, broker_id) -> BrokerCapacityInfo:
        info = self._by_id.get(broker_id, self._default)
        if info is None:
            raise ValueError(
                f"no capacity for broker {broker_id} and no default (-1) entry")
        return info
