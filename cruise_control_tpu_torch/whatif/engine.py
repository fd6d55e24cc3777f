"""What-if engine: materialize scenario batches and score them on the card.

Port of ``cruise_control_tpu/whatif/engine.py``. A scenario batch becomes
five per-scenario parameter arrays stacked on a leading ``S`` axis
(dead-broker mask, added-broker mask, capacity scale, partition load
scale, partition enable mask), and the whole batch is scored at once:

    transform (kill/add/resize/scale/enable + leadership failover, KD)
      -> init_state / build_context over the [S, ...] batch
         (one ordered segment sum per float aggregate for all S, KB)
      -> KX's violation rows over the goal chain ([S, G])
      -> headroom / pressure / availability reductions

with no Python loop over scenarios: the kernel launches of a sweep do not
depend on S. Unlike the reference, the scenario axis is not padded: its
padding only served XLA's compile buckets, and eager PyTorch compiles
nothing.

Leadership failover mirrors Kafka's election: the alive, non-offline
replica with the lowest *preferred-order* position becomes the leader;
partitions with no electable replica are counted unavailable. Dead brokers
keep their residual load (invisible to the alive-masked goal reductions):
the scored state is the cluster immediately after failover.

The fleet form (:func:`make_fleet_scenario_scorer`) scores a ``[C, S]``
grid of scenarios over C stacked clusters the same way, with one KJ launch
for every placement (``fleet/engine.py``'s sweeps).

Not ported: the reference's ``mesh`` argument (one GPU; the mesh-less path
is ``parallel/sharding.py``) and its ``registry``/``tracer``/``collector``
sensors (the port has none yet; ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..analyzer.constraint import BalancingConstraint
from ..analyzer.state import build_context, init_state
from ..core.resources import NUM_RESOURCES
from ..kernels import (ViolationTable, fleet_scenario_failover,
                       scenario_failover, violation_rows)
from ..model.flat import FlatClusterModel
from ..parallel.batching import pad_model_to, round_up
from ..utils.device import resolve_device
from ..utils.ordered import fma
from .spec import (BrokerAdd, BrokerLoss, CapacityResize, LoadScale,
                   RESOURCE_KEYS, Scenario, TopicAdd, TrajectoryScale)

#: risk-score shape constants (documented in docs/whatif.md): the four
#: component terms combine as 1 - prod(1 - term), each term in [0, 1].
_RISK_HARD_W = 0.9     # any violated hard goal dominates
_RISK_SOFT_W = 0.3     # soft violations alone cap at moderate risk
_RISK_PRESSURE_W = 0.7  # capacity pressure ramps 70% -> 130% of usable
_RISK_PRESSURE_LO = 0.7
_RISK_PRESSURE_SPAN = 0.6


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def violated_matrix(viol: np.ndarray, vscale: np.ndarray) -> np.ndarray:
    """Boolean violated-goal matrix with the same ulp-aware cutoff as
    ``GoalResult.satisfied``: a broker landing exactly on a float32-summed
    capacity limit is not a violation."""
    return viol > (1e-6 + 1e-6 * vscale)


def risk_scores(hard_frac: np.ndarray, soft_frac: np.ndarray,
                pressure: np.ndarray, unavailable: np.ndarray,
                valid_parts: np.ndarray) -> np.ndarray:
    """Composite [0, 1] risk (documented in docs/whatif.md): hard/soft
    violation fractions, capacity-pressure ramp, and availability combine
    as ``1 - prod(1 - term)``."""
    pressure_term = np.clip(
        (pressure - _RISK_PRESSURE_LO) / _RISK_PRESSURE_SPAN, 0.0, 1.0)
    avail_term = np.where(
        unavailable > 0,
        np.minimum(0.9 + 0.1 * unavailable / valid_parts, 1.0), 0.0)
    return 1.0 - ((1.0 - _RISK_HARD_W * hard_frac)
                  * (1.0 - _RISK_SOFT_W * soft_frac)
                  * (1.0 - _RISK_PRESSURE_W * pressure_term)
                  * (1.0 - avail_term))


@dataclass
class ScenarioOutcome:
    """One scenario's scorecard (everything host-side numbers)."""

    scenario: Scenario
    risk: float
    violated_goals: list[str]
    violated_hard_goals: list[str]
    capacity_pressure: float          # max alive util / usable capacity
    unavailable_partitions: int       # no electable replica post-failover
    offline_replicas: int
    #: per-resource post-scenario headroom: remaining usable capacity
    #: (absolute, summed over alive brokers, floored at 0) and the worst
    #: single broker's headroom fraction
    headroom: dict = field(default_factory=dict)
    #: broker id (or "new-<row>") with the least headroom fraction
    worst_broker: object = None

    def to_json(self) -> dict:
        return {"scenario": self.scenario.to_json(),
                "name": self.scenario.name,
                "risk": round(self.risk, 4),
                "violatedGoals": self.violated_goals,
                "violatedHardGoals": self.violated_hard_goals,
                "capacityPressure": round(self.capacity_pressure, 4),
                "unavailablePartitions": self.unavailable_partitions,
                "offlineReplicas": self.offline_replicas,
                "headroom": self.headroom,
                "worstBroker": self.worst_broker}


@dataclass
class WhatIfReport:
    outcomes: list[ScenarioOutcome]
    goals: list[str]
    duration_s: float
    stale_model: bool = False

    @property
    def num_scenarios(self) -> int:
        return len(self.outcomes)

    def riskiest(self) -> ScenarioOutcome | None:
        return max(self.outcomes, key=lambda o: o.risk, default=None)

    def to_json(self) -> dict:
        worst = self.riskiest()
        return {"numScenarios": self.num_scenarios,
                "goals": self.goals,
                "durationMs": round(self.duration_s * 1e3, 3),
                "staleModel": self.stale_model,
                "riskiest": None if worst is None else worst.scenario.name,
                "maxRisk": 0.0 if worst is None else round(worst.risk, 4),
                "scenarios": [o.to_json() for o in self.outcomes]}


@dataclass
class _Batch:
    """Materialized scenario batch: a staged template model (added-broker
    rows and projected-topic rows pre-written into padding) plus the
    per-scenario parameter arrays, one row per scenario."""

    template: FlatClusterModel
    dead: np.ndarray        # bool[S, B]
    add: np.ndarray         # bool[S, B]
    cap_scale: np.ndarray   # f32[S, B, 4]
    pscale: np.ndarray      # f32[S, P]
    pvalid: np.ndarray      # bool[S, P]
    new_broker_rows: dict[int, int]   # padding row -> scenario index
    #: distinct staged (TopicAdd) topics, ids metadata.num_topics + k
    num_staged_topics: int = 0


class WhatIfEngine:
    """Batched hypothetical-topology scorer.

    ``goals`` default to the analyzer's default chain (the reference's
    16 goals); the engine binds them per metadata exactly like the
    optimizer. ``device=None`` means the card and raises without
    one; ``device="cpu"`` runs every kernel's plain twin.
    """

    def __init__(self, goals=None, constraint: BalancingConstraint | None = None,
                 *, device=None,
                 # Model re-pad buckets for scenarios that outgrow the
                 # live model's padding slack (BrokerAdd/TopicAdd) — the
                 # same multiples the model builder pads with.
                 partition_pad_multiple: int = 128,
                 broker_pad_multiple: int = 8,
                 # Covers a full N-2 pairwise sweep up to 128 brokers;
                 # per-scenario [S, P] planes scale the footprint.
                 max_scenarios: int = 8192) -> None:
        from ..analyzer.goals import default_goals
        self.device = resolve_device(device)
        self.constraint = constraint or BalancingConstraint()
        self.goals = (goals if goals is not None
                      else default_goals(self.constraint))
        self.partition_pad_multiple = partition_pad_multiple
        self.broker_pad_multiple = broker_pad_multiple
        self.max_scenarios = max_scenarios

    # ------------------------------------------------------------- public
    def sweep(self, model: FlatClusterModel, metadata, scenarios,
              *, stale_model: bool = False) -> WhatIfReport:
        """Score ``scenarios`` against the live model; returns the report.
        The input model is never written."""
        if not scenarios:
            raise ValueError("sweep requires at least one scenario")
        if len(scenarios) > self.max_scenarios:
            raise ValueError(
                f"{len(scenarios)} scenarios exceed the engine cap of "
                f"{self.max_scenarios} (raise max_scenarios or split the "
                "sweep)")
        t0 = time.monotonic()
        batch = self._materialize(model, metadata, scenarios)
        goals = [g.bind(metadata) for g in self.goals]
        score = make_scenario_scorer(
            goals, self.constraint.capacity_threshold,
            num_topics=metadata.num_topics + batch.num_staged_topics)
        out = score(*self._place_batch(batch))
        (viol, vscale, headroom, hfrac, pressure, unavailable,
         n_offline) = (_host(t) for t in out)
        return self._build_report(
            scenarios, goals, metadata, batch, viol, vscale, headroom,
            hfrac, pressure, unavailable, n_offline, t0, stale_model)

    def warmup(self, model: FlatClusterModel, metadata,
               num_scenarios: int = 1) -> None:
        """One sweep of no-op scenarios (kernels built, caches filled)."""
        self.sweep(model, metadata,
                   [LoadScale(factor=1.0)] * max(num_scenarios, 1))

    def transformed(self, model: FlatClusterModel, metadata, scenarios
                    ) -> list[FlatClusterModel]:
        """The post-transform hypothetical models, one per scenario —
        debug/test surface (the sweep itself never unstacks them)."""
        batch = self._materialize(model, metadata, scenarios)
        stacked, _has_alive = scenario_transform(*self._place_batch(batch))
        return [FlatClusterModel(**{name: t[i] for name, t in
                                    vars(stacked).items()})
                for i in range(len(scenarios))]

    def _place_batch(self, batch: _Batch):
        """The scorer's argument tuple: the template (already on the
        device) and the per-scenario parameter planes, uploaded."""
        dev = batch.template.device
        return (batch.template,) + tuple(
            torch.from_numpy(a).to(dev) for a in
            (batch.dead, batch.add, batch.cap_scale, batch.pscale,
             batch.pvalid))

    # ---------------------------------------------------------- host side
    def _materialize(self, model: FlatClusterModel, metadata,
                     scenarios) -> _Batch:
        """Expand scenario specs into the staged template + per-scenario
        parameter arrays (all host-side numpy; one device upload each)."""
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, the engine "
                             f"runs on {self.device}")
        S = len(scenarios)

        bvalid = _host(model.broker_valid)
        pvalid0 = _host(model.partition_valid)
        adds = [s for s in scenarios if isinstance(s, BrokerAdd)]
        topic_adds = [s for s in scenarios if isinstance(s, TopicAdd)]
        need_b = sum(s.count for s in adds)
        need_p = sum(s.partitions for s in topic_adds)
        need_r = max([s.rf for s in topic_adds], default=0)
        model = _ensure_padding(model, int((~bvalid).sum()), need_b,
                                int((~pvalid0).sum()), need_p, need_r,
                                partition_pad_multiple=
                                self.partition_pad_multiple,
                                broker_pad_multiple=self.broker_pad_multiple)
        bvalid = _host(model.broker_valid)
        balive = _host(model.broker_alive)
        pvalid0 = _host(model.partition_valid)
        B = model.num_brokers_padded
        P, R = model.replica_broker.shape
        free_b = list(np.nonzero(~bvalid)[0])
        free_p = list(np.nonzero(~pvalid0)[0])
        alive_rows = np.nonzero(bvalid & balive)[0]

        dead = np.zeros((S, B), bool)
        add = np.zeros((S, B), bool)
        cap_scale = np.ones((S, B, NUM_RESOURCES), np.float32)
        pscale = np.ones((S, P), np.float32)
        pvalid = np.tile(pvalid0, (S, 1))

        # Staged template arrays (copies only when something needs
        # staging).
        capacity = rack = host = rb = ll = fl = ptopic = None
        new_broker_rows: dict[int, int] = {}
        if adds:
            capacity = _host(model.broker_capacity).copy()
            rack = _host(model.broker_rack).copy()
            host = _host(model.broker_host).copy()
            mean_cap = capacity[alive_rows].mean(axis=0) if len(alive_rows) \
                else np.zeros(NUM_RESOURCES, np.float32)
            next_rack = int(rack[bvalid].max(initial=-1)) + 1
            next_host = int(host[bvalid].max(initial=-1)) + 1
        if topic_adds:
            rb = _host(model.replica_broker).copy()
            ll = _host(model.leader_load).copy()
            fl = _host(model.follower_load).copy()
            ptopic = _host(model.partition_topic).copy()
        partition_topic = _host(model.partition_topic)

        topic_add_idx = 0
        for s_i, scn in enumerate(scenarios):
            if isinstance(scn, BrokerLoss):
                for bid in scn.brokers:
                    row = metadata.broker_index.get(bid)
                    if row is None:
                        raise ValueError(
                            f"broker_loss: unknown broker id {bid}")
                    dead[s_i, row] = True
            elif isinstance(scn, BrokerAdd):
                for _ in range(scn.count):
                    row = free_b.pop(0)
                    add[s_i, row] = True
                    new_broker_rows[row] = s_i
                    capacity[row] = np.asarray(
                        scn.capacity if scn.capacity is not None
                        else mean_cap, np.float32)
                    rack[row] = next_rack
                    host[row] = next_host
                    next_rack += 1
                    next_host += 1
            elif isinstance(scn, CapacityResize):
                rows = (slice(None) if scn.brokers is None else
                        [self._broker_row(metadata, b, "capacity_resize")
                         for b in scn.brokers])
                if scn.resource is None:
                    cap_scale[s_i, rows, :] *= scn.factor
                else:
                    cap_scale[s_i, rows,
                              RESOURCE_KEYS.index(scn.resource)] *= \
                        scn.factor
            elif isinstance(scn, LoadScale):
                if scn.topics is None:
                    pscale[s_i, :] *= scn.factor
                else:
                    tids = []
                    for t in scn.topics:
                        tid = metadata.topic_index.get(t)
                        if tid is None:
                            raise ValueError(
                                f"load_scale: unknown topic {t!r}")
                        tids.append(tid)
                    sel = np.isin(partition_topic, tids)
                    pscale[s_i, sel] *= scn.factor
            elif isinstance(scn, TrajectoryScale):
                pscale[s_i, :] *= trajectory_pscale_row(
                    scn, metadata.topic_index, partition_topic)
            elif isinstance(scn, TopicAdd):
                if scn.rf > len(alive_rows):
                    raise ValueError(
                        f"topic_add: rf {scn.rf} exceeds the "
                        f"{len(alive_rows)} alive brokers")
                lead = np.asarray(scn.leader_load, np.float32)
                foll = np.asarray(scn.derived_follower_load(), np.float32)
                tid = metadata.num_topics + topic_add_idx
                topic_add_idx += 1
                for k in range(scn.partitions):
                    row = free_p.pop(0)
                    pvalid[s_i, row] = True
                    rb[row, :] = B
                    for r in range(scn.rf):
                        rb[row, r] = alive_rows[(k + r) % len(alive_rows)]
                    ll[row] = lead
                    fl[row] = foll
                    ptopic[row] = tid
            else:
                raise ValueError(f"unknown scenario type {type(scn)}")

        dev = model.device
        replaced = {}
        if adds:
            replaced.update(broker_capacity=capacity, broker_rack=rack,
                            broker_host=host)
        if topic_adds:
            replaced.update(replica_broker=rb, leader_load=ll,
                            follower_load=fl, partition_topic=ptopic)
        template = model.replace(**{k: torch.from_numpy(v).to(dev)
                                    for k, v in replaced.items()})
        return _Batch(template=template, dead=dead, add=add,
                      cap_scale=cap_scale, pscale=pscale, pvalid=pvalid,
                      new_broker_rows=new_broker_rows,
                      num_staged_topics=len(topic_adds))

    @staticmethod
    def _broker_row(metadata, bid: int, what: str) -> int:
        row = metadata.broker_index.get(bid)
        if row is None:
            raise ValueError(f"{what}: unknown broker id {bid}")
        return row

    def _build_report(self, scenarios, goals, metadata, batch,
                      viol, vscale, headroom, hfrac, pressure, unavailable,
                      n_offline, t0, stale_model) -> WhatIfReport:
        hard = np.array([g.hard for g in goals], bool)
        violated = violated_matrix(viol, vscale)
        n_hard = max(int(hard.sum()), 1)
        n_soft = max(int((~hard).sum()), 1)
        hard_frac = violated[:, hard].sum(axis=1) / n_hard
        soft_frac = violated[:, ~hard].sum(axis=1) / n_soft
        unavailable = unavailable.astype(int)
        valid_parts = batch.pvalid.sum(axis=1).clip(min=1)
        risk = risk_scores(hard_frac, soft_frac, pressure, unavailable,
                           valid_parts)

        def broker_label(row: int):
            if row in batch.new_broker_rows:
                return f"new-{row}"
            if row < len(metadata.broker_ids):
                return metadata.broker_ids[row]
            return int(row)

        outcomes = []
        for i, scn in enumerate(scenarios):
            names = [g.name for g, v in zip(goals, violated[i]) if v]
            hard_names = [g.name for g, v, h in zip(goals, violated[i],
                                                    hard) if v and h]
            hf = hfrac[i]                       # [B, 4], inf on non-alive
            per_res = {}
            for r, key in enumerate(RESOURCE_KEYS):
                col = hf[:, r]
                finite = np.isfinite(col)
                per_res[key] = {
                    "remaining": round(
                        float(np.clip(headroom[i, :, r], 0.0, None).sum()),
                        3),
                    "minBrokerFrac": round(float(col[finite].min()), 4)
                    if finite.any() else None}
            min_per_broker = hf.min(axis=1)
            worst_row = int(np.argmin(
                np.where(np.isfinite(min_per_broker), min_per_broker,
                         np.inf)))
            outcomes.append(ScenarioOutcome(
                scenario=scn,
                risk=float(risk[i]),
                violated_goals=names,
                violated_hard_goals=hard_names,
                capacity_pressure=float(pressure[i]),
                unavailable_partitions=int(unavailable[i]),
                offline_replicas=int(n_offline[i]),
                headroom=per_res,
                worst_broker=broker_label(worst_row)))
        return WhatIfReport(outcomes=outcomes,
                            goals=[g.name for g in goals],
                            duration_s=time.monotonic() - t0,
                            stale_model=stale_model)


def _ensure_padding(model: FlatClusterModel, spare_b: int, need_b: int,
                    spare_p: int, need_p: int, need_r: int, *,
                    partition_pad_multiple: int = 128,
                    broker_pad_multiple: int = 8) -> FlatClusterModel:
    """Re-pad the model (host-side) when the scenario batch needs more
    padding broker rows / partition rows / replica slots than the live
    model carries (BrokerAdd / TopicAdd beyond the pad slack)."""
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape
    new_B = (B if need_b <= spare_b
             else round_up(B + need_b - spare_b, broker_pad_multiple))
    new_P = (P if need_p <= spare_p
             else round_up(P + need_p - spare_p, partition_pad_multiple))
    new_R = max(R, need_r)
    return pad_model_to(model, new_B, new_P, new_R)


def trajectory_pscale_row(scn: TrajectoryScale, topic_index: dict,
                          partition_topic: np.ndarray) -> np.ndarray:
    """One scenario's ``[P]`` partition load-scale plane from a
    :class:`TrajectoryScale` spec: ``default_factor`` everywhere, each
    forecast topic's factor on its partitions. Topics no longer in the
    live metadata are skipped (a stale forecast entry degrades, never
    errors)."""
    row = np.full(partition_topic.shape, scn.default_factor, np.float32)
    for topic, factor in scn.factors:
        tid = topic_index.get(topic)
        if tid is None:
            continue
        row[partition_topic == tid] = factor
    return row


def scenario_transform(model: FlatClusterModel, dead, add, cap_scale,
                       pscale, pvalid):
    """``(model, dead[S, B], add[S, B], cap_scale[S, B, 4], pscale[S, P],
    pvalid[S, P]) -> (batched model, has_alive[S, P])`` — every
    scenario's topology edit at once. The batched model carries a leading
    ``[S]`` axis on every field (fields no scenario edits are expanded
    views of the template's). Placements and failover come from one KD
    launch; ``model``'s placement may itself be ``[S, P, R]`` (one per
    scenario, as the move scheduler's boundary audit passes it)."""
    S = dead.shape[0]
    rb, pref, off, has_alive = scenario_failover(
        model.replica_broker, model.replica_offline, model.replica_pref_pos,
        model.broker_valid, model.broker_alive, dead, add, pvalid)

    def shared(t):
        return t.expand((S,) + tuple(t.shape))

    batched = FlatClusterModel(
        replica_broker=rb, leader_load=model.leader_load * pscale[..., None],
        follower_load=model.follower_load * pscale[..., None],
        partition_topic=shared(model.partition_topic),
        partition_valid=pvalid, replica_offline=off, replica_pref_pos=pref,
        broker_capacity=model.broker_capacity * cap_scale,
        broker_rack=shared(model.broker_rack),
        broker_host=shared(model.broker_host),
        broker_set=shared(model.broker_set),
        broker_alive=(model.broker_alive | add) & ~dead,
        broker_new=model.broker_new | add,
        broker_demoted=shared(model.broker_demoted),
        broker_broken_disk=shared(model.broker_broken_disk),
        broker_valid=model.broker_valid | add)
    return batched, has_alive


def make_scenario_scorer(goals, capacity_threshold, *, num_topics: int):
    """Build the batch scorer ``score(model, dead, add, cap_scale, pscale,
    pvalid) -> (viol[S, G], vscale[S, G], headroom[S, B, 4],
    hfrac[S, B, 4], pressure[S], unavailable[S], n_offline[S])`` —
    transform + init_state/build_context + violation stack + headroom
    reductions over the whole ``[S, ...]`` batch. One definition for the
    what-if sweep and the move scheduler's boundary audit."""
    body = _batch_scorer(goals, capacity_threshold, num_topics)

    def score(model, dead, add, cap_scale, pscale, pvalid):
        return body(*scenario_transform(model, dead, add, cap_scale, pscale,
                                        pvalid))

    return score


def fleet_scenario_transform(stacked: FlatClusterModel, dead, add,
                             cap_scale, pscale, pvalid):
    """``(stacked [C, ...] model, dead[C, S, B], add[C, S, B],
    cap_scale[C, S, B, 4], pscale[C, S, P], pvalid[C, P]) -> (batched
    model, has_alive[C·S, P])`` — the fleet form of
    :func:`scenario_transform`: every scenario of every cluster at once,
    the batched model's rows ordered (cluster, scenario). Placements and
    failover come from one KJ launch over the ``[C, S]`` grid; each
    cluster's own fields expand over its S scenarios."""
    C, S = dead.shape[:2]
    rb, pref, off, has_alive = fleet_scenario_failover(
        stacked.replica_broker, stacked.replica_offline,
        stacked.replica_pref_pos, stacked.broker_valid, stacked.broker_alive,
        dead, add, pvalid)

    def rows(t):                    # [C, S, ...] -> [C·S, ...]
        return t.reshape((C * S,) + tuple(t.shape[2:]))

    def per_cluster(t):             # [C, ...] -> [C·S, ...]
        return rows(t[:, None].expand((C, S) + tuple(t.shape[1:])))

    batched = FlatClusterModel(
        replica_broker=rows(rb),
        leader_load=rows(stacked.leader_load[:, None] * pscale[..., None]),
        follower_load=rows(stacked.follower_load[:, None]
                           * pscale[..., None]),
        partition_topic=per_cluster(stacked.partition_topic),
        partition_valid=per_cluster(pvalid),
        replica_offline=rows(off), replica_pref_pos=rows(pref),
        broker_capacity=rows(stacked.broker_capacity[:, None] * cap_scale),
        broker_rack=per_cluster(stacked.broker_rack),
        broker_host=per_cluster(stacked.broker_host),
        broker_set=per_cluster(stacked.broker_set),
        broker_alive=rows((stacked.broker_alive[:, None] | add) & ~dead),
        broker_new=rows(stacked.broker_new[:, None] | add),
        broker_demoted=per_cluster(stacked.broker_demoted),
        broker_broken_disk=per_cluster(stacked.broker_broken_disk),
        broker_valid=rows(stacked.broker_valid[:, None] | add))
    return batched, rows(has_alive)


def make_fleet_scenario_scorer(goals, capacity_threshold, *,
                               num_topics: int):
    """The fleet form of :func:`make_scenario_scorer`: ``score(stacked,
    dead, add, cap_scale, pscale, pvalid)`` over ``[C, ...]`` clusters and
    ``[C, S, ...]`` scenario planes returns the same seven outputs with a
    ``[C, S]`` leading shape. The batch scores as C·S rows through the
    one scoring body the what-if sweep runs (one KB launch per aggregate
    for all rows), after one KJ launch for every placement."""
    body = _batch_scorer(goals, capacity_threshold, num_topics)

    def score(stacked, dead, add, cap_scale, pscale, pvalid):
        C, S = dead.shape[:2]
        out = body(*fleet_scenario_transform(stacked, dead, add, cap_scale,
                                             pscale, pvalid))
        return tuple(t.reshape((C, S) + tuple(t.shape[1:])) for t in out)

    return score


def _batch_scorer(goals, capacity_threshold, num_topics: int):
    """``body(m, has_alive)``: init_state/build_context, the violation
    stack and the headroom reductions over a transformed ``[N, ...]``
    scenario batch."""
    goals = tuple(goals)
    viol_rows = ViolationTable(goals)
    needs_tlc = any(g.uses_topic_leader_counts for g in goals)
    needs_topics = needs_tlc or any(g.uses_topic_counts for g in goals)

    def body(m, has_alive):
        state = init_state(
            m, with_topic_counts=num_topics if needs_topics else None,
            with_topic_leader_counts=needs_tlc)
        ctx = build_context(m, with_weight_range=False)
        viol, vscale = violation_rows(viol_rows, state, ctx, True)
        B = m.num_brokers_padded
        util = state.util[:, :B]
        cap_thr = torch.tensor(capacity_threshold, dtype=torch.float32,
                               device=util.device)
        usable = m.broker_capacity * cap_thr
        alive = (m.broker_alive & m.broker_valid)[..., None]
        room = torch.clamp(usable, min=1e-9)
        # usable - util: the reference's program contracts the product
        # and the subtraction into one FMA.
        headroom = torch.where(alive, fma(m.broker_capacity, cap_thr, -util),
                               0.0)
        hfrac = torch.where(alive, 1.0 - util / room, float("inf"))
        pressure = torch.where(alive, util / room, 0.0).amax(dim=(1, 2))
        unavailable = (m.partition_valid & ~has_alive).sum(dim=1)
        n_offline = (m.replica_offline & (m.replica_broker < B)).sum(
            dim=(1, 2))
        return viol, vscale, headroom, hfrac, pressure, unavailable, \
            n_offline

    return body
