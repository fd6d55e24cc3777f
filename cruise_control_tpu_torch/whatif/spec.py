"""Declarative what-if scenario specs.

Copy of ``cruise_control_tpu/whatif/spec.py`` (host-only; numpy).

Each scenario describes ONE hypothetical edit of the live cluster; the
engine materializes a *batch* of them as per-scenario parameter arrays
stacked along a leading ``S`` axis and applies them as pure array
transforms on device (see ``engine.py``). Specs are plain frozen
dataclasses with a JSON round-trip (``parse_scenarios`` /
``Scenario.to_json``) so the ``/simulate`` endpoint and the resilience
detector share one vocabulary.

Scenario types:

- :class:`BrokerLoss` — brokers die; leadership fails over to the best
  alive replica (preferred order), surviving followers on the dead
  brokers go offline. :func:`n1_sweep` / :func:`n2_sweep` expand into
  every single / pairwise loss.
- :class:`BrokerAdd` — new empty brokers join (each on a fresh rack),
  capacity defaulting to the alive-broker mean.
- :class:`CapacityResize` — scale broker capacity (all brokers or a
  subset, all resources or one) — models hardware changes or revised
  capacity estimates.
- :class:`LoadScale` — multiply partition load (uniform or per-topic,
  all four resources) — models traffic growth.
- :class:`TopicAdd` — a new topic with projected per-partition load,
  placed round-robin over alive brokers.
- :class:`TrajectoryScale` — per-topic load factors at one forecast
  (horizon, quantile) point: the materialized form of a fitted load
  trajectory (forecast/engine.py). A ``{"type": "forecast", ...}``
  request resolves through the server's forecast engine into exactly
  this spec, so the JSON echo of a forecast sweep round-trips.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

RESOURCE_KEYS = ("cpu", "nwIn", "nwOut", "disk")


@dataclass(frozen=True)
class Scenario:
    """Base scenario. ``name`` is the stable label used in reports."""

    @property
    def name(self) -> str:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class BrokerLoss(Scenario):
    """Brokers ``brokers`` (ids) die simultaneously."""

    brokers: tuple[int, ...]

    @property
    def name(self) -> str:
        return "loss:" + ",".join(str(b) for b in self.brokers)

    def to_json(self) -> dict:
        return {"type": "broker_loss", "brokers": list(self.brokers)}


@dataclass(frozen=True)
class BrokerAdd(Scenario):
    """``count`` new empty brokers join. ``capacity`` (CPU, NW_IN, NW_OUT,
    DISK) defaults to the mean capacity of alive brokers; each added
    broker lands on its own fresh rack (growth normally adds failure
    domains — a pessimistic same-rack add can be modeled by combining
    with CapacityResize instead)."""

    count: int
    capacity: tuple[float, float, float, float] | None = None

    @property
    def name(self) -> str:
        return f"add:{self.count}"

    def to_json(self) -> dict:
        out: dict = {"type": "broker_add", "count": self.count}
        if self.capacity is not None:
            out["capacity"] = list(self.capacity)
        return out


@dataclass(frozen=True)
class CapacityResize(Scenario):
    """Scale broker capacity by ``factor``: every broker when ``brokers``
    is None, one resource when ``resource`` (cpu|nwIn|nwOut|disk) is
    given, all four otherwise."""

    factor: float
    brokers: tuple[int, ...] | None = None
    resource: str | None = None

    @property
    def name(self) -> str:
        scope = ("all" if self.brokers is None
                 else ",".join(str(b) for b in self.brokers))
        res = self.resource or "all"
        return f"resize:{scope}:{res}:{self.factor:g}"

    def to_json(self) -> dict:
        out: dict = {"type": "capacity_resize", "factor": self.factor}
        if self.brokers is not None:
            out["brokers"] = list(self.brokers)
        if self.resource is not None:
            out["resource"] = self.resource
        return out


@dataclass(frozen=True)
class LoadScale(Scenario):
    """Multiply partition load (all four resources) by ``factor`` —
    uniformly, or only for the named ``topics``."""

    factor: float
    topics: tuple[str, ...] | None = None

    @property
    def name(self) -> str:
        scope = "all" if self.topics is None else ",".join(self.topics)
        return f"load:{scope}:{self.factor:g}"

    def to_json(self) -> dict:
        out: dict = {"type": "load_scale", "factor": self.factor}
        if self.topics is not None:
            out["topics"] = list(self.topics)
        return out


@dataclass(frozen=True)
class TopicAdd(Scenario):
    """A new topic with ``partitions`` partitions at replication factor
    ``rf``, each with projected ``leader_load`` (CPU, NW_IN, NW_OUT,
    DISK). Follower load defaults to the standard derivation (half the
    leader CPU, full NW_IN replication, no NW_OUT, same DISK). Replicas
    are placed round-robin over alive brokers — the question answered is
    "does the cluster have room", not "what is the optimal placement"."""

    topic: str
    partitions: int
    rf: int
    leader_load: tuple[float, float, float, float]
    follower_load: tuple[float, float, float, float] | None = None

    @property
    def name(self) -> str:
        return f"topic:{self.topic}:{self.partitions}x{self.rf}"

    def derived_follower_load(self) -> tuple[float, ...]:
        if self.follower_load is not None:
            return tuple(self.follower_load)
        cpu, nw_in, _nw_out, disk = self.leader_load
        return (0.5 * cpu, nw_in, 0.0, disk)

    def to_json(self) -> dict:
        out: dict = {"type": "topic_add", "topic": self.topic,
                     "partitions": self.partitions, "rf": self.rf,
                     "leaderLoad": list(self.leader_load)}
        if self.follower_load is not None:
            out["followerLoad"] = list(self.follower_load)
        return out


@dataclass(frozen=True)
class TrajectoryScale(Scenario):
    """Per-topic load factors at one projected (horizon, quantile)
    point. ``factors`` carries (topic, factor) pairs from a fitted
    forecast; topics without an entry scale by ``default_factor``
    (1.0 = unchanged). Topics that disappeared since the fit are
    skipped at materialization — a stale forecast entry must degrade,
    not 400 a sweep of the live cluster."""

    horizon_ms: int
    quantile: float
    factors: tuple[tuple[str, float], ...] = ()
    default_factor: float = 1.0
    label: str = "forecast"

    @property
    def name(self) -> str:
        return (f"{self.label}:+{_fmt_horizon(self.horizon_ms)}"
                f":p{int(round(self.quantile * 100))}")

    def to_json(self) -> dict:
        out: dict = {"type": "trajectory_scale",
                     "horizonMs": self.horizon_ms,
                     "quantile": self.quantile,
                     "factors": {t: f for t, f in self.factors}}
        if self.default_factor != 1.0:
            out["defaultFactor"] = self.default_factor
        if self.label != "forecast":
            out["label"] = self.label
        return out


def _fmt_horizon(horizon_ms: int) -> str:
    """Compact horizon label: 3600000 -> "1h", 90000 -> "90s"."""
    s = horizon_ms / 1000.0
    for width, unit in ((86400, "d"), (3600, "h"), (60, "m")):
        if s >= width and s % width == 0:
            return f"{int(s // width)}{unit}"
    return f"{s:g}s"


# ---------------------------------------------------------------- sweeps

def n1_sweep(broker_ids: list[int]) -> list[BrokerLoss]:
    """Every single-broker loss — the resilience detector's bread and
    butter: S = len(broker_ids) scenarios, scored in one device program."""
    return [BrokerLoss(brokers=(b,)) for b in broker_ids]


def n2_sweep(broker_ids: list[int]) -> list[BrokerLoss]:
    """Every pairwise loss (S = n*(n-1)/2) — correlated-failure coverage;
    quadratic, so callers gate it behind the slow tier."""
    return [BrokerLoss(brokers=(a, b))
            for a, b in itertools.combinations(broker_ids, 2)]


def _host(arr) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return arr.cpu().numpy() if hasattr(arr, "cpu") else np.asarray(arr)


def alive_broker_ids(model, metadata) -> list[int]:
    """Broker ids currently alive+valid in a flat model — the sweep
    population (dead brokers are already-realized scenarios)."""
    alive = _host(model.broker_alive) & _host(model.broker_valid)
    return [metadata.broker_ids[i]
            for i in range(len(metadata.broker_ids)) if alive[i]]


# ----------------------------------------------------------- JSON parsing

_PARSERS = {}


def _parser(type_name):
    def deco(fn):
        _PARSERS[type_name] = fn
        return fn
    return deco


def _ids(raw, what: str) -> tuple[int, ...]:
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ValueError(f"{what}: 'brokers' must be a non-empty list")
    try:
        return tuple(int(b) for b in raw)
    except (TypeError, ValueError):
        raise ValueError(f"{what}: broker ids must be integers, got {raw!r}")


def _load4(raw, what: str) -> tuple[float, float, float, float]:
    if not isinstance(raw, (list, tuple)) or len(raw) != 4:
        raise ValueError(f"{what}: want 4 numbers (CPU, NW_IN, NW_OUT, "
                         f"DISK), got {raw!r}")
    return tuple(float(x) for x in raw)


@_parser("broker_loss")
def _parse_loss(obj: dict) -> BrokerLoss:
    return BrokerLoss(brokers=_ids(obj.get("brokers"), "broker_loss"))


@_parser("broker_add")
def _parse_add(obj: dict) -> BrokerAdd:
    count = int(obj.get("count", 1))
    if count < 1:
        raise ValueError("broker_add: count must be >= 1")
    cap = obj.get("capacity")
    return BrokerAdd(count=count,
                     capacity=None if cap is None
                     else _load4(cap, "broker_add"))


@_parser("capacity_resize")
def _parse_resize(obj: dict) -> CapacityResize:
    factor = float(obj["factor"])
    if factor <= 0:
        raise ValueError("capacity_resize: factor must be > 0")
    res = obj.get("resource")
    if res is not None and res not in RESOURCE_KEYS:
        raise ValueError(f"capacity_resize: resource {res!r} not in "
                         f"{RESOURCE_KEYS}")
    brokers = obj.get("brokers")
    return CapacityResize(factor=factor,
                          brokers=None if brokers is None
                          else _ids(brokers, "capacity_resize"),
                          resource=res)


@_parser("load_scale")
def _parse_scale(obj: dict) -> LoadScale:
    factor = float(obj["factor"])
    if factor < 0:
        raise ValueError("load_scale: factor must be >= 0")
    topics = obj.get("topics")
    if topics is not None and (not isinstance(topics, (list, tuple))
                               or not topics):
        raise ValueError("load_scale: 'topics' must be a non-empty list")
    return LoadScale(factor=factor,
                     topics=None if topics is None else tuple(topics))


@_parser("topic_add")
def _parse_topic(obj: dict) -> TopicAdd:
    partitions = int(obj.get("partitions", 1))
    rf = int(obj.get("rf", 1))
    if partitions < 1 or rf < 1:
        raise ValueError("topic_add: partitions and rf must be >= 1")
    fl = obj.get("followerLoad")
    return TopicAdd(topic=str(obj.get("topic", "whatif-topic")),
                    partitions=partitions, rf=rf,
                    leader_load=_load4(obj.get("leaderLoad"), "topic_add"),
                    follower_load=None if fl is None
                    else _load4(fl, "topic_add"))


@_parser("trajectory_scale")
def _parse_trajectory(obj: dict) -> TrajectoryScale:
    horizon_ms = int(obj.get("horizonMs", 0))
    if horizon_ms < 0:
        raise ValueError("trajectory_scale: horizonMs must be >= 0")
    quantile = float(obj.get("quantile", 0.5))
    if not 0.0 < quantile < 1.0:
        raise ValueError("trajectory_scale: quantile must be in (0, 1)")
    raw = obj.get("factors", {})
    if not isinstance(raw, dict):
        raise ValueError("trajectory_scale: 'factors' must be an object "
                         "{topic: factor}")
    factors = []
    for t, f in sorted(raw.items()):
        f = float(f)
        if f < 0:
            raise ValueError(
                f"trajectory_scale: factor for topic {t!r} must be >= 0")
        factors.append((str(t), f))
    default = float(obj.get("defaultFactor", 1.0))
    if default < 0:
        raise ValueError("trajectory_scale: defaultFactor must be >= 0")
    return TrajectoryScale(horizon_ms=horizon_ms, quantile=quantile,
                           factors=tuple(factors), default_factor=default,
                           label=str(obj.get("label", "forecast")))


def parse_scenarios(payload: dict, broker_ids: list[int],
                    forecaster=None) -> list[Scenario]:
    """Parse a ``/simulate`` request payload into scenario specs.

    Accepts either ``{"sweep": "N1"|"N2"}`` (expanded over
    ``broker_ids``) or ``{"scenarios": [{"type": ...}, ...]}``.
    Raises ``ValueError`` (HTTP 400) on anything malformed — validation
    happens before any device work is scheduled.

    ``forecaster`` resolves ``{"type": "forecast", "horizonMs": ...,
    "quantile": ...}`` scenario sources into concrete
    :class:`TrajectoryScale` specs from the server's fitted forecasts
    (``KafkaCruiseControl.simulate`` wires the forecast engine's
    ``trajectory_scenario``); without one, forecast sources are a
    validation error.
    """
    sweep = payload.get("sweep")
    raw = payload.get("scenarios")
    if (sweep is None) == (raw is None):
        raise ValueError(
            "simulate requires exactly one of 'sweep' (N1|N2) or "
            "'scenarios' (a list of scenario objects)")
    if sweep is not None:
        sweep = str(sweep).upper()
        if sweep == "N1":
            return n1_sweep(broker_ids)
        if sweep == "N2":
            return n2_sweep(broker_ids)
        raise ValueError(f"unknown sweep {sweep!r} (want N1 or N2)")
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ValueError("'scenarios' must be a non-empty list")
    out = []
    for i, obj in enumerate(raw):
        if not isinstance(obj, dict):
            raise ValueError(f"scenario #{i} is not an object: {obj!r}")
        if obj.get("type") == "forecast":
            # Forecast scenario source: resolved against the server's
            # fitted per-topic forecasts into a TrajectoryScale, so the
            # response echoes the concrete factors it scored (and that
            # echo round-trips through the trajectory_scale parser).
            if forecaster is None:
                raise ValueError(
                    f"scenario #{i}: 'forecast' scenarios need a fitted "
                    "forecast source (forecast.enabled on the server)")
            if "horizonMs" not in obj:
                raise ValueError(
                    f"scenario #{i}: forecast requires horizonMs")
            horizon_ms = int(obj["horizonMs"])
            if horizon_ms < 0:
                raise ValueError(
                    f"scenario #{i}: forecast horizonMs must be >= 0")
            quantile = float(obj.get("quantile", 0.9))
            if not 0.0 < quantile < 1.0:
                raise ValueError(
                    f"scenario #{i}: forecast quantile must be in (0, 1)")
            out.append(forecaster(horizon_ms, quantile))
            continue
        parser = _PARSERS.get(obj.get("type"))
        if parser is None:
            raise ValueError(
                f"scenario #{i}: unknown type {obj.get('type')!r}; "
                f"supported: {sorted(_PARSERS) + ['forecast']}")
        out.append(parser(obj))
    return out
