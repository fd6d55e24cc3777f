"""Broker-set resolution (port of ``cruise_control_tpu/config/brokersets.py``,
host-only; ref ``config/BrokerSetResolver`` SPI +
``BrokerSetFileResolver`` reading ``config/brokerSets.json``, the
``ModuloBasedBrokerSetAssignmentPolicy`` for unassigned brokers, and
``TopicNameHashBrokerSetMappingPolicy`` assigning topics to sets) — the
data source behind ``BrokerSetAwareGoal``."""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np


class BrokerSetResolver(Protocol):
    """SPI (ref BrokerSetResolver.java)."""

    def broker_set_for(self, broker_id: int) -> str | None: ...

    def all_sets(self) -> list[str]: ...


@dataclass
class StaticBrokerSetResolver:
    """Explicit broker-id -> set mapping."""

    by_broker: dict[int, str] = field(default_factory=dict)

    def broker_set_for(self, broker_id: int) -> str | None:
        return self.by_broker.get(broker_id)

    def all_sets(self) -> list[str]:
        return sorted(set(self.by_broker.values()))


class FileBrokerSetResolver:
    """ref BrokerSetFileResolver: reads the reference's brokerSets.json
    format (``{"brokerSets": [{"brokerSetId": "...", "brokerIds": [...]}]}``)."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        self._by_broker: dict[int, str] = {}
        self._sets: list[str] = []
        for entry in doc["brokerSets"]:
            set_id = str(entry["brokerSetId"])
            self._sets.append(set_id)
            for b in entry["brokerIds"]:
                self._by_broker[int(b)] = set_id

    def broker_set_for(self, broker_id: int) -> str | None:
        return self._by_broker.get(broker_id)

    def all_sets(self) -> list[str]:
        return list(self._sets)


def modulo_assignment(broker_id: int, sets: list[str]) -> str:
    """ref ModuloBasedBrokerSetAssignmentPolicy: place brokers the resolver
    doesn't know about deterministically."""
    return sets[broker_id % len(sets)]


def topic_set_by_name_hash(topic: str, sets: list[str]) -> str:
    """ref TopicNameHashBrokerSetMappingPolicy (stable digest, not Python's
    salted hash)."""
    return sets[zlib.crc32(topic.encode()) % len(sets)]


def topic_set_array(topics: list[str], set_names: list[str],
                    explicit: dict[str, str] | None = None) -> np.ndarray:
    """i32[T] — each topic's broker-set index (for BrokerSetAwareGoal),
    explicit mapping first, name-hash policy otherwise."""
    index = {s: i for i, s in enumerate(set_names)}
    out = np.full(len(topics), -1, np.int32)
    for t_i, topic in enumerate(topics):
        name = (explicit or {}).get(topic) or (
            topic_set_by_name_hash(topic, set_names) if set_names else None)
        if name is not None and name in index:
            out[t_i] = index[name]
    return out


class ModuloAssignmentPolicy:
    """Pluggable form of :func:`modulo_assignment` (ref
    ModuloBasedBrokerSetAssignmentPolicy — the
    broker.set.assignment.policy.class default)."""

    def assign(self, broker_id: int, sets: list[str]) -> str:
        return modulo_assignment(broker_id, sets)


class TopicHashAssignmentPolicy:
    """Pluggable form of :func:`topic_set_by_name_hash` (ref
    TopicNameHashBrokerSetMappingPolicy — the
    replica.to.broker.set.mapping.policy.class default)."""

    def map_topic(self, topic: str, sets: list[str]) -> str:
        return topic_set_by_name_hash(topic, sets)
