"""Goal kernels — the reference's goal catalog as vectorized cost functions.

Port of ``cruise_control_tpu/analyzer/goals.py``: the helpers, the
parametric :class:`IntervalGoal` with both bulk drains and its candidate
generators, the capacity, distribution, leader and potential-NW_OUT goals
built on it, and the bespoke goals — rack awareness and its even-spread
relaxations, per-topic replica balance, per-topic leader minimums, broker
sets and preferred leaders — with the default chain, the registry and the
kafka-assigner set. Each goal is four functions over the :mod:`state` tensors —
``violation`` (scalar residual, 0 == satisfied), ``propose`` (candidate
batch), ``delta`` (per-candidate residual change), ``accepts`` (acceptance
once the goal was optimized earlier in the chain) — plus the engine's
``collective_guard``, which an apply round on the card runs as a row of KQ
(``kernels.round_guards``, ``guard_row``); the methods here are its twin.

Exactness: tie-break noise comes from the port's threefry stream, sorts and
top-k are stable, float sums and prefix sums run in the reference's order
(:mod:`..utils.ordered`), and every out-of-range index of the reference
(clamped gathers, dropped scatters) is an explicit mask here. In KQ's
twin the interval goals' collective guards sum their flows through KC
(``kernels.net_broker_flow``) and the topic-cell guards through KK
(``kernels.cell_net_flow``).

A ``propose`` is its generators around KU's ``top_k``
(``kernels.top_k``, ``lax.top_k``'s order): the source priorities
(KO's for an interval goal's flow moves, else KR's,
``kernels.replica_priority``, a row kind a form), the destinations (KO's
match, or KS's, ``kernels.dest_select``) and one KT launch
(``kernels.assemble_candidates``) that builds every candidate of the
proposal's parts; each goal's ``priority_base`` is the twin of its KR
base. A replica drain round is KZ (``kernels.drain_order``: the quota and
the slots' order), KP (``kernels.bulk_drain_fill``) and KT; a leadership
drain round KAA (``kernels.leadership_drain``) and KT. ``_shed_quota``,
``_segment_cum_before`` and ``_capacity_budget_cap`` are their twins'
steps.
"""

from __future__ import annotations

import fnmatch

import numpy as np
import torch

from .. import _random
from ..config.brokersets import topic_set_array
from ..core.resources import Resource
from ..kernels import (Part, ViolationTable, assemble_candidates,
                       bulk_drain_fill, cell_net_flow, dest_select,
                       drain_order, flow_match, flow_priority,
                       grid_source_plain, interval_planes, leadership_drain,
                       net_broker_flow, ordered_segment_sum,
                       replica_priority, shortlist_source_plain, top_k,
                       top_k_plain)
from ..model.flat import MOVE_INTER_BROKER, MOVE_LEADERSHIP, MOVE_SWAP
from ..utils.ordered import (fma, scan_sum, topic_cell_sum, tree_sum,
                              tree_sum_last, violation_row_sum)
from .constraint import BalancingConstraint, SearchConfig
from .state import (Candidates, SearchContext, SearchState, metric_deltas,
                    metric_values, METRIC_LEADER_COUNT, METRIC_LEADER_NW_IN,
                    METRIC_POTENTIAL_NW_OUT, METRIC_REPLICA_COUNT)

# Candidate priorities are composed as TIER + weight-in-[0,1) + noise.
_TIER_ASSIST = 0.0    # below-average source helping fill a deficit
_TIER_EXCESS = 4.0    # source broker above its upper bound
_TIER_OFFLINE = 8.0   # offline replica: must move (self-healing)
_NEG = float("-inf")
_INF = float("inf")


def _zeros_per_scenario(ctx: SearchContext) -> torch.Tensor:
    """float32 zeros of the state's scenario shape (0-dim unbatched)."""
    return torch.zeros(ctx.broker_alive.shape[:-1], dtype=torch.float32,
                       device=ctx.broker_alive.device)


def _noise(key, shape, scale):
    """float32 ``scale * uniform(key, shape)``, drawn in one launch."""
    return _random.affine(key, shape, scale, 0.0)


def _plus_noise(base: torch.Tensor, key, scale: float) -> torch.Tensor:
    """``base + scale * uniform(key, base.shape)`` as the reference's
    compiled program computes it: the noise's product and the add
    contract into one FMA (no ``where`` stands between them)."""
    return fma(scale, _random.uniform(key, tuple(base.shape)), base)


def _unit01(x: torch.Tensor, mask: torch.Tensor | None = None):
    """(q, finite): finite (optionally masked-in) values scaled into [0, 1]
    by their min and max; ``_norm01 = where(finite, q * 0.99, 0)``."""
    if mask is not None:
        x = torch.where(mask, x, float("nan"))
    finite = torch.isfinite(x)
    xmin = torch.where(finite, x, _INF).amin()
    xmax = torch.where(finite, x, _NEG).amax()
    span = torch.clamp(xmax - xmin, min=1e-12)
    return (x - xmin) / span, finite


def _norm01(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scale finite (optionally masked-in) values into [0, 0.99]; everything
    else maps to 0."""
    q, finite = _unit01(x, mask)
    return torch.where(finite, q * 0.99, 0.0)


def replica_weight(metric, leader_load: torch.Tensor,
                   follower_load: torch.Tensor, R: int) -> torch.Tensor:
    """``IntervalGoal._replica_weight`` of a goal balancing ``metric``:
    the [*L, P, R] preference among replicas (slot 0 the leader's loads,
    the other slots the follower's) from a context's ``[*L, P, 4]`` loads;
    kernels.py's weight range holds its min and max a context."""
    which, res = metric
    is_leader = (torch.arange(R, device=leader_load.device) == 0)[:, None]
    if which == "potential":
        return torch.broadcast_to(
            leader_load[..., :, None, Resource.NW_OUT],
            (*leader_load.shape[:-1], R))
    load = torch.where(is_leader, leader_load[..., :, None, :],
                       follower_load[..., :, None, :])
    if which == "util":
        return load[..., int(res)]
    # count-style goals: prefer cheap-to-move (small disk) replicas
    return -load[..., Resource.DISK]


def _tier_plus_norm01(tier: float, q: torch.Tensor,
                      finite: torch.Tensor) -> torch.Tensor:
    """``tier + _norm01(x)`` with the one rounding the reference's compiled
    program gives it (the product and the tier add contract into an FMA)."""
    return torch.where(finite, fma(q, 0.99, tier), tier + 0.0)


def _segment_cum_before(weights: torch.Tensor, keys: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Per-element cumulative weight of EARLIER same-key elements, for
    key-sorted inputs."""
    cum = scan_sum(weights)
    per_key = ordered_segment_sum(weights, keys, num_segments)
    offset = scan_sum(per_key) - per_key
    return cum - weights - offset[keys]


def _capacity_budget_cap(budget: torch.Tensor, per_unit_max: torch.Tensor,
                         constraint: BalancingConstraint,
                         broker_capacity: torch.Tensor,
                         util: torch.Tensor) -> torch.Tensor:
    """Cap per-broker intake budgets by every resource's capacity headroom
    divided by the batch-MAX per-unit load, so one bulk round cannot
    collectively exceed a capacity hard-goal."""
    for res in range(4):
        headroom = fma(constraint.capacity_threshold[res],
                       broker_capacity[:, res], -util[:, res])
        cap_units = torch.clamp(headroom, min=0.0) / torch.clamp(
            per_unit_max[res], min=1e-9)
        budget = torch.minimum(budget, 0.9 * cap_units)
    return torch.clamp(budget, min=0.0)


def _legal_dest_argmax(state: SearchState, ctx: SearchContext,
                       p: torch.Tensor, score: torch.Tensor):
    """(dst[K], ok[K]) — per-candidate best destination from a [K, B1]
    score, masking barred destinations and brokers already hosting the
    partition."""
    K, B1 = score.shape
    row = state.rb[p]                                              # [K, R]
    host_mask = torch.zeros((K, B1), dtype=torch.bool, device=score.device)
    host_mask.scatter_(1, row, True)            # sentinel column B is in range
    masked = torch.where(host_mask | ~ctx.dest_allowed[None, :], _NEG, score)
    dst = torch.argmax(masked, dim=1)
    ok = torch.isfinite(masked.amax(dim=1))
    return dst, ok


def _top_replica_dest_grid(state: SearchState, ctx: SearchContext, key,
                           cfg: SearchConfig, replica_priority: torch.Tensor,
                           dest_priority: torch.Tensor) -> Candidates:
    """The shared top-K replicas x top-D destinations generator over
    explicit base priorities ([P, R] and [B1]), in the twins' transforms;
    the goals reach it through KR and KS (:func:`_grid_part`)."""
    P, R = replica_priority.shape
    K = min(cfg.num_replica_candidates, P * R)
    D = min(cfg.num_dest_candidates, dest_priority.shape[0])
    krep, kdst = _random.subkeys(key)
    rp = grid_source_plain(state, ctx, replica_priority, krep, cfg)
    rvals, ridx = top_k_plain(rp.reshape(-1), K)
    dvals, didx = top_k_plain(shortlist_source_plain(ctx, dest_priority,
                                                     kdst, cfg), D)
    return assemble_candidates(state, ctx, [Part(
        "grid", idx=ridx, vals=rvals, didx=didx, dvals=dvals)])


def _grid_part(goal, state: SearchState, ctx: SearchContext, key,
               cfg: SearchConfig, kind: str, plane: str = "count") -> Part:
    """The grid of top-K replicas (KR's ``kind``, then the top-k) x top-D
    destinations (KS's short-list of ``plane``)."""
    P, R = state.rb.shape
    K = min(cfg.num_replica_candidates, P * R)
    D = min(cfg.num_dest_candidates, ctx.broker_alive.shape[0])
    krep, kdst = _random.subkeys(key)
    rp = replica_priority(kind, goal, state, ctx, (krep,), cfg)[0]
    rvals, ridx = top_k(rp.reshape(-1), K)
    dvals, didx = dest_select("shortlist", goal, state, ctx, (kdst,), cfg,
                              plane=plane, n=D)
    return Part("grid", idx=ridx, vals=rvals, didx=didx, dvals=dvals)


def _leadership_part(goal, state: SearchState, ctx: SearchContext, key,
                     cfg: SearchConfig, kind: str, **planes) -> Part:
    """Top-K leadership transfers (slot r > 0 becoming leader) by KR's
    priority ``kind``."""
    P, R = state.rb.shape
    K = min(cfg.num_replica_candidates, P * R)
    pr = replica_priority(kind, goal, state, ctx, (key,), cfg, **planes)[0]
    vals, idx = top_k(pr.reshape(-1), K)
    return Part("leadership", idx=idx, vals=vals)


class GoalKernel:
    """Base goal. Subclasses are stateless; all data flows through args."""

    name: str = "goal"
    hard: bool = False
    uses_topic_counts: bool = False
    uses_topic_leader_counts: bool = False
    supports_bulk_drain: bool = False

    def violation(self, state: SearchState, ctx: SearchContext) -> torch.Tensor:
        """Scalar residual (``[S]`` for a state with a leading scenario
        axis; broker reductions run on the last axis)."""
        raise NotImplementedError

    def violation_scale(self, state: SearchState,
                        ctx: SearchContext) -> torch.Tensor:
        """Magnitude the violation's float32 rounding error scales with
        (0 for count-based goals, whose arithmetic is exact)."""
        return _zeros_per_scenario(ctx)

    def propose(self, state: SearchState, ctx: SearchContext, key,
                cfg: SearchConfig) -> Candidates:
        raise NotImplementedError

    def delta(self, state: SearchState, ctx: SearchContext,
              c: Candidates) -> torch.Tensor:
        raise NotImplementedError

    def accepts(self, state: SearchState, ctx: SearchContext,
                c: Candidates) -> torch.Tensor:
        raise NotImplementedError

    def receptive_dest(self, state: SearchState,
                       ctx: SearchContext) -> torch.Tensor:
        """bool[B1] — brokers that can receive a replica without this
        (previously-optimized) goal likely rejecting the action."""
        return torch.ones_like(ctx.broker_alive)

    def steer_row(self):
        """This goal's row of KV's table (``kernels.SteerTable``), the
        twin of :meth:`receptive_dest`: ``{"kind": "everywhere"}`` where
        it is every broker, None where KV has no form for it. A class that
        overrides ``receptive_dest`` overrides this too."""
        if type(self).receptive_dest is GoalKernel.receptive_dest:
            return dict(kind="everywhere")
        return None

    def eligibility_row(self):
        """This goal's row of KN's goal table (``kernels.GoalChecks``): a
        dict of ``kernels._GoalRow``'s fields, ``kind`` one of
        ``kernels.ROW_KINDS`` and ``aux`` a bound array the row reads;
        None for a goal KN has no row kind for."""
        return None

    def violation_row(self):
        """This goal's row of KX's table (``kernels.ViolationTable``): the
        twin of :meth:`violation` and :meth:`violation_scale`, the fields
        of :meth:`eligibility_row` (an interval goal's with the program
        its fused row reads); None where KX has no row for it."""
        return self.eligibility_row()

    def collective_guard(self, state: SearchState, ctx: SearchContext,
                         c: Candidates, earlier: torch.Tensor
                         ) -> torch.Tensor | None:
        """ok[N] — whether each candidate keeps this goal's bounds when
        applied together with every earlier candidate flagged in
        ``earlier`` ([N, N] bool). ``None`` opts out (the engine then
        serializes shared-broker pairs). The twin of this goal's row of
        KQ (``kernels.round_guards``): a class that overrides it overrides
        :meth:`guard_row` too."""
        return None

    def guard_row(self):
        """This goal's row of KQ's guard table (``kernels.GuardTable``): a
        dict with ``kind`` one of ``kernels.GUARD_KINDS`` (and for the
        interval and topic kinds the fields of :meth:`eligibility_row`),
        ``{"kind": "local"}`` for a partition-local guard (no row), None
        where KQ has no kind for this goal's guard. The default guard
        serializes shared brokers."""
        if type(self).collective_guard is GoalKernel.collective_guard:
            return dict(kind="serialize")
        return None

    def bind(self, metadata) -> "GoalKernel":
        return self

    def bind_signature(self):
        return None

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"


class IntervalGoal(GoalKernel):
    """Keep ``metric[b]`` within [lower, upper] on every alive broker."""

    #: 'replica' | 'leadership' | 'both'
    actions: str = "replica"
    #: when True the goal only caps the upper side (capacity-style)
    upper_only: bool = False

    def __init__(self, name: str, metric, *, hard: bool,
                 constraint: BalancingConstraint):
        self.name = name
        self.metric = metric
        self.hard = hard
        self.constraint = constraint

    # -- bounds ----------------------------------------------------------
    def bounds(self, state: SearchState, ctx: SearchContext):
        """Return (lower, upper): [B1] tensors or 0-dim tensors."""
        raise NotImplementedError

    def _avg_bounds(self, state: SearchState, ctx: SearchContext, t: float,
                    *, integer: bool = False, upper_only: bool = False):
        """avg-over-alive-brokers bounds: [avg*(2-t), avg*t] (widened to
        +-1 unit around the average for integer-count goals); 0-dim, or
        ``[S, 1]`` for a state with a leading scenario axis."""
        values = metric_values(state, self.metric)
        total = tree_sum_last(torch.where(ctx.broker_valid, values, 0.0))
        n = torch.clamp(ctx.broker_alive.sum(-1), min=1)
        avg = total / n
        if avg.dim():
            avg = avg[..., None]
        upper = avg * t
        lower = (torch.full_like(avg, _NEG) if upper_only
                 else avg * (2.0 - t))
        if integer:
            upper = torch.maximum(upper, torch.ceil(avg))
            if not upper_only:
                lower = torch.minimum(lower, torch.floor(avg))
        return lower, upper

    def _bounds_b1(self, state, ctx):
        values = metric_values(state, self.metric)
        lower, upper = self.bounds(state, ctx)
        return (values, torch.broadcast_to(lower, values.shape),
                torch.broadcast_to(upper, values.shape))

    def _cap_column(self):
        """(capacity column index, threshold) when the upper bound is their
        per-broker product, else None."""
        return None

    def _cap_factor(self, ctx):
        """(capacity column, threshold) when the upper bound is their
        per-broker product, else None."""
        column = self._cap_column()
        if column is None:
            return None
        res, thr = column
        return ctx.broker_capacity[..., res], thr

    def _minus_upper(self, x, up, ctx):
        """``x - upper`` over all brokers. Where the upper bound is
        capacity * threshold, the reference's compiled program contracts
        the product and the subtraction into one FMA; the port rounds once
        too. (Per-candidate gathers of the upper bound read the rounded
        product, so they subtract plainly.)"""
        factor = self._cap_factor(ctx)
        if factor is None:
            return x - up
        col, thr = factor
        return fma(-col, thr, x)

    def _upper_minus(self, x, up, ctx):
        """``upper - x`` over all brokers (see :meth:`_minus_upper`)."""
        factor = self._cap_factor(ctx)
        if factor is None:
            return up - x
        col, thr = factor
        return fma(col, thr, -x)

    def metric_code(self) -> int:
        """The metric as the goal-pass kernels name it: a util column 0-3,
        replica count 4, leader count 5, potential NW_OUT 6, leader NW_IN
        7."""
        which, res = self.metric
        if which == "util":
            return int(res)
        return {"count": 4, "leaders": 5, "potential": 6,
                "leader_nw_in": 7}[which]

    def _row(self, form: str, t: float, *, integer: bool = False,
             hard_cap: bool = False):
        """A row of KN's goal table: bounds ``form`` 'average' ([avg *
        (2 - t), avg * t]), 'capacity' (the capacity column times t) or
        'constant' (t); ``hard_cap``: CapacityGoal's acceptance."""
        column = self._cap_column()
        return dict(kind="hard_cap" if hard_cap else "interval",
                    metric=self.metric_code(),
                    form=("average", "capacity", "constant").index(form),
                    upper_only=self.upper_only, integer=integer,
                    cap_col=column[0] if form == "capacity" else 0,
                    t=t, lower=2.0 - t)

    # -- shared machinery ------------------------------------------------
    def _penalty(self, values, lower, upper, alive, ctx=None):
        """Per-broker bound violation; ``ctx`` marks full-broker arrays
        (see :meth:`_minus_upper`), None per-candidate gathers."""
        over = torch.clamp(values - upper if ctx is None
                           else self._minus_upper(values, upper, ctx),
                           min=0.0)
        under = 0.0 if self.upper_only else torch.clamp(lower - values,
                                                        min=0.0)
        return torch.where(alive, over + under, 0.0)

    def violation(self, state, ctx):
        values = metric_values(state, self.metric)
        lower, upper = self.bounds(state, ctx)
        penalty = self._penalty(values, lower, upper, ctx.broker_alive, ctx)
        return violation_row_sum(penalty, self._row_program(ctx))

    def _row_program(self, ctx) -> str:
        """What XLA's fused violation row reads, which picks LLVM's loop
        (``utils/ordered.py``, ``ROW_LOOPS``): a [B1] plane (counts,
        potential, leaders' NW_IN) or a column of ``util``, against scalar
        bounds, a scalar upper bound only, or a per-broker capacity
        bound."""
        return self._program(self._cap_factor(ctx) is not None)

    def _program(self, capacity: bool) -> str:
        """:meth:`_row_program` of a goal whose upper bound is (or is not)
        a capacity column times a threshold."""
        which, res = self.metric
        plane = which != "util"
        if capacity:
            if plane:
                return "plane-capacity"
            return ("cpu-capacity" if int(res) == int(Resource.CPU)
                    else "column-capacity")
        if self.upper_only:
            if not plane:
                return "column-upper"
            return ("counts-upper" if which in ("count", "leaders")
                    else "plane-upper")
        return "plane" if plane else "column"

    def violation_row(self):
        """The fields of :meth:`eligibility_row` and the program its fused
        violation row reads (:meth:`_row_program`)."""
        row = self.eligibility_row()
        if row is None:
            return None
        return dict(row, program=self._program(row["form"] == 1))

    def violation_scale(self, state, ctx):
        which, _res = self.metric
        if which in ("count", "leaders"):
            return super().violation_scale(state, ctx)
        values = metric_values(state, self.metric)
        return tree_sum_last(torch.where(ctx.broker_valid, values.abs(),
                                         0.0))

    def delta(self, state, ctx, c):
        values, lo, up = self._bounds_b1(state, ctx)
        d_src, d_dst = metric_deltas(c, self.metric)
        a_src, a_dst = ctx.broker_alive[c.src], ctx.broker_alive[c.dst]
        before = (self._penalty(values[c.src], lo[c.src], up[c.src], a_src)
                  + self._penalty(values[c.dst], lo[c.dst], up[c.dst], a_dst))
        after = (self._penalty(values[c.src] + d_src, lo[c.src], up[c.src],
                               a_src)
                 + self._penalty(values[c.dst] + d_dst, lo[c.dst], up[c.dst],
                                 a_dst))
        return after - before

    def accepts(self, state, ctx, c):
        """Acceptance when previously optimized: the destination stays within
        its upper limit or no more loaded than the source ends up; the source
        symmetrically (ResourceDistributionGoal.actionAcceptance)."""
        values, lo, up = self._bounds_b1(state, ctx)
        d_src, d_dst = metric_deltas(c, self.metric)
        src_after = values[c.src] + d_src
        dst_after = values[c.dst] + d_dst
        dst_ok = ((d_dst <= 0) | (dst_after <= up[c.dst])
                  | (dst_after <= src_after))
        if self.upper_only:
            return dst_ok
        src_ok = ((d_src >= 0) | (src_after >= lo[c.src])
                  | (src_after >= dst_after))
        return dst_ok & src_ok

    def collective_guard(self, state, ctx, c, earlier):
        values, lo, up = self._bounds_b1(state, ctx)
        d_src, d_dst = metric_deltas(c, self.metric)
        net_src_lo, net_dst_hi, _ = net_broker_flow(c.src, c.dst, earlier,
                                                    d_src, d_dst)
        src_after = values[c.src] + net_src_lo + d_src   # lowest it can land
        dst_after = values[c.dst] + net_dst_hi + d_dst   # highest it can land
        dst_ok = ((net_dst_hi + d_dst <= 0) | (dst_after <= up[c.dst])
                  | (dst_after <= src_after))
        if self.upper_only:
            return dst_ok
        src_ok = ((net_src_lo + d_src >= 0) | (src_after >= lo[c.src])
                  | (src_after >= dst_after))
        return dst_ok & src_ok

    def guard_row(self):
        """The acceptance row's fields: its kind names the guard too (a
        ``hard_cap`` row's goal guards as :class:`CapacityGoal` does)."""
        return self.eligibility_row()

    def receptive_dest(self, state, ctx):
        values, _lo, up = self._bounds_b1(state, ctx)
        if self.metric[0] in ("count", "leaders"):
            return values + 1.0 <= up
        return values < up

    def steer_row(self):
        """The metric and upper bound of this goal's row of KN's table:
        :meth:`receptive_dest` tests the metric against that bound."""
        if type(self).receptive_dest is not IntervalGoal.receptive_dest:
            return None
        return self.eligibility_row()

    # -- bulk drain ------------------------------------------------------
    @property
    def supports_bulk_drain(self) -> bool:
        if self.actions == "replica" and self.metric[0] in ("count", "util"):
            return True
        return (self.actions in ("both", "leadership")
                and self.metric[0] in ("leaders", "leader_nw_in"))

    def _replica_drain_weight(self, ctx: SearchContext,
                              rb: torch.Tensor) -> torch.Tensor:
        """f32[P, R] — each replica's contribution to this goal's metric."""
        which, res = self.metric
        P, R = rb.shape
        if which == "count":
            return torch.ones((P, R), dtype=torch.float32, device=rb.device)
        is_leader = (torch.arange(R, device=rb.device) == 0)[None, :]
        return torch.where(is_leader, ctx.leader_load[:, int(res)][:, None],
                           ctx.follower_load[:, int(res)][:, None])

    def _leadership_drain_weight(self, ctx: SearchContext) -> torch.Tensor:
        which, _res = self.metric
        if which == "leaders":
            return torch.ones(ctx.partition_valid.shape, dtype=torch.float32,
                              device=ctx.partition_valid.device)
        assert which == "leader_nw_in", which
        return ctx.leader_load[:, int(Resource.NW_IN)]

    def bulk_drain(self, state: SearchState, ctx: SearchContext, key,
                   cfg: SearchConfig) -> Candidates:
        if self.actions == "replica":
            return self._replica_bulk_drain(state, ctx, key, cfg)
        return self._leadership_bulk_drain(state, ctx, key, cfg)

    def _shed_quota(self, values, lo, up, ctx):
        """(excess, deficit, quota, n_alive): over-upper excess (everything
        on dead brokers), under-lower deficit, and the shed quota — excess
        plus a pro-rata share of above-average surplus while deficits
        remain beyond what the excess can fill."""
        alive = ctx.broker_alive
        excess = torch.where(
            alive, torch.clamp(self._minus_upper(values, up, ctx), min=0.0),
            values)
        if self.upper_only:
            deficit = torch.zeros_like(values)
        else:
            deficit = torch.where(alive, torch.clamp(lo - values, min=0.0),
                                  0.0)
        n_alive = torch.clamp(alive.sum(), min=1)
        avg = tree_sum(torch.where(ctx.broker_valid, values, 0.0)) / n_alive
        need = torch.clamp(tree_sum(deficit) - tree_sum(excess), min=0.0)
        pool = torch.where(alive & (excess <= 0.0),
                           torch.clamp(values - avg, min=0.0), 0.0)
        scale = torch.clamp(need / torch.clamp(tree_sum(pool), min=1e-9),
                            max=1.0)
        quota = fma(pool, scale, excess)
        return excess, deficit, quota, n_alive

    def _replica_bulk_drain(self, state: SearchState, ctx: SearchContext,
                            key, cfg: SearchConfig) -> Candidates:
        """One round of vectorized excess-shedding: up to
        ``cfg.drain_batch`` partition-disjoint move candidates, sources
        ranked heaviest-first within each over-upper (or dead) broker,
        destinations assigned by a prefix-sum fill over receiver budgets
        (capped by the replica-count ceiling and every capacity hard goal):
        KZ (:meth:`drain_sort`), KP (``kernels.bulk_drain_fill``), KT."""
        p, r, dst, ok = bulk_drain_fill(self, state, ctx, cfg,
                                        *self.drain_sort(state, ctx, key))
        return assemble_candidates(state, ctx, [Part("move", p=p, r=r,
                                                     dst=dst, ok=ok)])

    def drain_sort(self, state: SearchState, ctx: SearchContext, key):
        """The replica drain up to its fill: (values, up, deficit, quota,
        order, flat_b, flat_w, flat_cand, flat_must) — the metric, its
        upper bound, the deficits and shed quotas [B1], and the flat [P, R]
        slots' order by (broker, must-first, weight-desc-with-noise), their
        brokers, weights, candidacy and mandatory moves. KZ
        (``kernels.drain_order``, ``csrc/drain_order.cu``); its twin
        ``kernels.drain_order_plain`` composes it in torch."""
        return drain_order(self, state, ctx, key)

    def _leadership_bulk_drain(self, state: SearchState, ctx: SearchContext,
                               key, cfg: SearchConfig) -> Candidates:
        """Bulk leadership transfers off over-upper leader brokers onto each
        partition's best-headroom follower broker (each weighing
        :meth:`_leadership_drain_weight`), with two quota passes (shed per
        source, intake per destination): KAA (``kernels.leadership_drain``,
        ``csrc/leadership_drain.cu``; its twin
        ``kernels.leadership_drain_plain``), then KT."""
        p, r, ok = leadership_drain(self, state, ctx, key, cfg)
        return assemble_candidates(state, ctx, [Part("leadership", p=p, r=r,
                                                     ok=ok)])

    # -- candidate generation -------------------------------------------
    def propose_planes(self, state, ctx):
        """(values, lo, up, excess, deficit) [B1] of a proposal: the metric,
        its bounds, the excess over the upper bound and the deficit under
        the lower one — one KY launch (``kernels.interval_planes``) from
        this goal's row; :meth:`plain_planes` is the goal's own form."""
        return interval_planes(self.planes_rows, state, ctx)

    @property
    def planes_rows(self) -> ViolationTable:
        """KY's one-row table of this goal, built at first use and kept by
        the goal: a proposal's captured graph reads its rows at every
        replay (a copy of the goal builds its own)."""
        rows = self.__dict__.get("_planes_rows")
        if rows is None or rows.goals[0] is not self:
            rows = self._planes_rows = ViolationTable([self])
        return rows

    def plain_planes(self, state, ctx):
        """:meth:`propose_planes` composed in torch from the goal's
        bounds."""
        values, lo, up = self._bounds_b1(state, ctx)
        alive = ctx.broker_alive
        # Load still parked on dead/invalid brokers also counts as excess.
        excess = torch.where(
            alive, torch.clamp(self._minus_upper(values, up, ctx), min=0.0),
            values)
        deficit = (torch.zeros_like(values) if self.upper_only else
                   torch.where(alive & torch.isfinite(lo),
                               torch.clamp(lo - values, min=0.0), 0.0))
        return values, lo, up, excess, deficit

    def propose(self, state, ctx, key, cfg):
        return self.generate(state, ctx, key, cfg,
                             *self.propose_planes(state, ctx))

    def generate(self, state, ctx, key, cfg, values, lo, up, excess,
                 deficit):
        """The proposal from its planes (:meth:`propose_planes`): the flow
        moves (KO), the swaps (KR) and the leadership transfers (KR), each
        around its top-k, assembled in that order by one KT launch."""
        planes = dict(values=values, lo=lo, up=up, excess=excess,
                      deficit=deficit)
        parts = []
        if self.actions in ("replica", "both"):
            kg, key = _random.subkeys(key)
            parts.append(self._flow_part(state, ctx, kg, cfg, **planes))
            if cfg.num_swap_candidates > 0 and self.metric[0] != "count":
                ks, key = _random.subkeys(key)
                parts.append(self._swap_part(state, ctx, ks, cfg, **planes))
        if self.actions in ("leadership", "both"):
            kl, key = _random.subkeys(key)
            parts.append(_leadership_part(self, state, ctx, kl, cfg,
                                          "interval_leadership",
                                          excess=excess, deficit=deficit))
        return assemble_candidates(state, ctx, parts)

    def _replica_metric_load(self, ctx: SearchContext, p: torch.Tensor,
                             r: torch.Tensor) -> torch.Tensor:
        """f32[N] — this goal's metric arriving at a destination when
        replica (p, r) moves there."""
        which, res = self.metric
        is_leader = r == 0
        if which == "util":
            return torch.where(is_leader, ctx.leader_load[p, int(res)],
                               ctx.follower_load[p, int(res)])
        if which == "count":
            return torch.ones(p.shape, dtype=torch.float32, device=p.device)
        if which == "leaders":
            return is_leader.to(torch.float32)
        if which == "potential":
            return ctx.leader_load[p, Resource.NW_OUT]
        return torch.where(is_leader, ctx.leader_load[p, Resource.NW_IN], 0.0)

    def _flow_part(self, state, ctx, key, cfg, values, lo, up, excess,
                   deficit) -> Part:
        """Flow-matched move candidates: top-K source replicas, each assigned
        its own destination by matching cumulative outgoing load against
        cumulative destination headroom (a greedy transportation plan) —
        KO's two launches (``kernels.flow_priority``, ``flow_match``)
        around the top-k."""
        P, R = state.rb.shape
        K = min(cfg.num_replica_candidates, P * R)
        krep, kdst = _random.subkeys(key)
        prio = flow_priority(self, state, ctx, krep, cfg, values, lo, up,
                             excess, deficit)
        vals, idx = top_k(prio.reshape(-1), K)
        p, r, dst, valid = flow_match(self, state, ctx, kdst, cfg, values,
                                      lo, up, deficit, vals, idx)
        return Part("move", p=p, r=r, dst=dst, ok=valid)

    def _flow_candidates(self, state, ctx, key, cfg, values, lo, up,
                         excess, deficit) -> Candidates:
        """The flow moves alone, as candidates."""
        return assemble_candidates(state, ctx, [self._flow_part(
            state, ctx, key, cfg, values, lo, up, excess, deficit)])

    def _swap_part(self, state, ctx, key, cfg, values, lo, up, excess,
                   deficit) -> Part:
        """Heavy-for-light replica swaps between over-upper and below-average
        brokers (ref ResourceDistributionGoal.java:689,779): the k-th
        heaviest eligible replica pairs with the k-th lightest, the pairing
        rotated by a random shift each iteration (KR's two planes, their
        top-k; KT draws the shift and rolls)."""
        P, R = state.rb.shape
        K = min(cfg.num_swap_candidates, P * R)
        kh, kl, kshift = _random.subkeys(key, 3)
        prio = replica_priority("interval_swap", self, state, ctx, (kh, kl),
                                cfg, values=values, lo=lo, up=up,
                                excess=excess, deficit=deficit)
        # both planes' top-k in one launch
        (hv, lv), (hidx, lidx) = top_k(prio.reshape(2, -1), K)
        return Part("swap", idx=hidx, vals=hv, idx2=lidx, vals2=lv,
                    shift=kshift)

    def _replica_weight(self, state: SearchState, ctx: SearchContext):
        """[P, R] preference among movable replicas on source brokers."""
        return replica_weight(self.metric, ctx.leader_load,
                              ctx.follower_load, state.rb.shape[-1])


class CapacityGoal(IntervalGoal):
    """Hard cap: util <= capacity * threshold (ref CapacityGoal.java)."""

    upper_only = True

    def __init__(self, resource: Resource, constraint: BalancingConstraint):
        name = {Resource.CPU: "CpuCapacityGoal",
                Resource.NW_IN: "NetworkInboundCapacityGoal",
                Resource.NW_OUT: "NetworkOutboundCapacityGoal",
                Resource.DISK: "DiskCapacityGoal"}[resource]
        super().__init__(name, ("util", resource), hard=True,
                         constraint=constraint)
        self.resource = resource
        self.actions = ("both" if resource in (Resource.CPU, Resource.NW_OUT)
                        else "replica")

    def bounds(self, state, ctx):
        thr = self.constraint.cap_threshold(self.resource)
        upper = ctx.broker_capacity[..., int(self.resource)] * thr
        return torch.full_like(upper, _NEG), upper

    def _cap_column(self):
        return (int(self.resource),
                self.constraint.cap_threshold(self.resource))

    def eligibility_row(self):
        return self._row("capacity", self._cap_column()[1], hard_cap=True)

    def accepts(self, state, ctx, c):
        # Hard semantics: never push a broker above its capacity ceiling;
        # a swap can carry net load INTO its source, so both sides count.
        values = metric_values(state, self.metric)
        _, upper = self.bounds(state, ctx)
        up = torch.broadcast_to(upper, values.shape)
        d_src, d_dst = metric_deltas(c, self.metric)
        dst_ok = (d_dst <= 0) | (values[c.dst] + d_dst <= up[c.dst])
        src_ok = (d_src <= 0) | (values[c.src] + d_src <= up[c.src])
        return dst_ok & src_ok

    def collective_guard(self, state, ctx, c, earlier):
        # Hard cap: with net flow included the gaining side(s) must stay
        # under the ceiling outright.
        values = metric_values(state, self.metric)
        _, upper = self.bounds(state, ctx)
        up = torch.broadcast_to(upper, values.shape)
        d_src, d_dst = metric_deltas(c, self.metric)
        _, net_dst_hi, src_hi = net_broker_flow(c.src, c.dst, earlier,
                                                d_src, d_dst)
        dst_after = values[c.dst] + net_dst_hi + d_dst
        dst_ok = (net_dst_hi + d_dst <= 0) | (dst_after <= up[c.dst])
        src_after = values[c.src] + src_hi + d_src
        src_ok = (src_hi + d_src <= 0) | (src_after <= up[c.src])
        return dst_ok & src_ok


class ResourceDistributionGoal(IntervalGoal):
    """Soft balance: util within avg*(2-t) .. avg*t over alive brokers."""

    def __init__(self, resource: Resource, constraint: BalancingConstraint):
        name = {Resource.CPU: "CpuUsageDistributionGoal",
                Resource.NW_IN: "NetworkInboundUsageDistributionGoal",
                Resource.NW_OUT: "NetworkOutboundUsageDistributionGoal",
                Resource.DISK: "DiskUsageDistributionGoal"}[resource]
        super().__init__(name, ("util", resource), hard=False,
                         constraint=constraint)
        self.resource = resource
        self.actions = ("both" if resource in (Resource.CPU, Resource.NW_OUT)
                        else "replica")

    def bounds(self, state, ctx):
        return self._avg_bounds(state, ctx,
                                self.constraint.balance_threshold(self.resource))

    def eligibility_row(self):
        return self._row("average",
                         self.constraint.balance_threshold(self.resource))


class ReplicaCapacityGoal(IntervalGoal):
    """Hard cap on replica count per broker (ref ReplicaCapacityGoal.java)."""

    upper_only = True

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("ReplicaCapacityGoal", METRIC_REPLICA_COUNT,
                         hard=True, constraint=constraint)

    def bounds(self, state, ctx):
        upper = torch.full(ctx.broker_capacity.shape[:-1],
                           float(self.constraint.max_replicas_per_broker),
                           dtype=torch.float32,
                           device=ctx.broker_capacity.device)
        return torch.full_like(upper, _NEG), upper

    accepts = CapacityGoal.accepts
    collective_guard = CapacityGoal.collective_guard

    def eligibility_row(self):
        return self._row("constant",
                         float(self.constraint.max_replicas_per_broker),
                         hard_cap=True)


class ReplicaDistributionGoal(IntervalGoal):
    """Soft balance of replica counts (ref ReplicaDistributionGoal.java)."""

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("ReplicaDistributionGoal", METRIC_REPLICA_COUNT,
                         hard=False, constraint=constraint)

    def bounds(self, state, ctx):
        return self._avg_bounds(state, ctx,
                                self.constraint.replica_balance_threshold,
                                integer=True)

    def eligibility_row(self):
        return self._row("average", self.constraint.replica_balance_threshold,
                         integer=True)


class LeaderReplicaDistributionGoal(IntervalGoal):
    """Soft balance of leader counts via leadership transfers, falling back
    to relocating leader replicas (ref LeaderReplicaDistributionGoal.java)."""

    actions = "both"

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("LeaderReplicaDistributionGoal", METRIC_LEADER_COUNT,
                         hard=False, constraint=constraint)

    def bounds(self, state, ctx):
        return self._avg_bounds(
            state, ctx, self.constraint.leader_replica_balance_threshold,
            integer=True)

    def eligibility_row(self):
        return self._row("average",
                         self.constraint.leader_replica_balance_threshold,
                         integer=True)


class LeaderBytesInDistributionGoal(IntervalGoal):
    """Cap leader bytes-in skew: leader NW_IN <= avg * threshold (ref
    LeaderBytesInDistributionGoal.java; upper side only)."""

    actions = "leadership"
    upper_only = True

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("LeaderBytesInDistributionGoal", METRIC_LEADER_NW_IN,
                         hard=False, constraint=constraint)

    def bounds(self, state, ctx):
        return self._avg_bounds(
            state, ctx, self.constraint.balance_threshold(Resource.NW_IN),
            upper_only=True)

    def eligibility_row(self):
        return self._row("average",
                         self.constraint.balance_threshold(Resource.NW_IN))


class PotentialNwOutGoal(IntervalGoal):
    """Keep potential (all-leaders) NW_OUT under the capacity ceiling (ref
    PotentialNwOutGoal.java)."""

    upper_only = True

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("PotentialNwOutGoal", METRIC_POTENTIAL_NW_OUT,
                         hard=False, constraint=constraint)

    def bounds(self, state, ctx):
        thr = self.constraint.cap_threshold(Resource.NW_OUT)
        upper = ctx.broker_capacity[..., int(Resource.NW_OUT)] * thr
        return torch.full_like(upper, _NEG), upper

    def _cap_column(self):
        return (int(Resource.NW_OUT),
                self.constraint.cap_threshold(Resource.NW_OUT))

    def eligibility_row(self):
        return self._row("capacity", self._cap_column()[1])


# ---------------------------------------------------------------------------
# Index helpers of the bespoke goals
# ---------------------------------------------------------------------------

def _jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row a JAX gather reads for ``idx`` along an axis of ``n``: a
    negative index counts from the end, then the index is clamped into
    [0, n) (padding partitions carry topic -1)."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _per_broker(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[..., idx]`` for a per-broker plane ``[*L, B1]`` and broker ids
    ``[*L, ...]`` with the same leading axes (unbatched: ``plane[idx]``)."""
    if plane.dim() == 1:
        return plane[idx]
    flat = idx.reshape(plane.shape[:-1] + (-1,))
    return torch.gather(plane, -1, flat).reshape(idx.shape)


def _kinds(c: Candidates):
    """(is_move, is_swap) bool[N]."""
    return c.kind == MOVE_INTER_BROKER, c.kind == MOVE_SWAP


def _ones(c: Candidates) -> torch.Tensor:
    return torch.ones(c.p.shape, dtype=torch.bool, device=c.p.device)


def _count_replicas_norm(state: SearchState) -> torch.Tensor:
    """``_norm01(-replica_count)``: emptier brokers first."""
    return _norm01(-state.replica_count.to(torch.float32))


class _DeviceMask:
    """A host array the goal was bound with, uploaded once per device."""

    def __init__(self, array):
        self.host = np.asarray(array)
        self._on = {}

    def on(self, device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._on[device] = t
        return t


# ---------------------------------------------------------------------------
# Rack awareness
# ---------------------------------------------------------------------------

class RackAwareGoal(GoalKernel):
    """No two replicas of a partition on the same rack (ref
    RackAwareGoal.java; hard)."""

    name = "RackAwareGoal"
    hard = True

    def _dup_mask(self, state: SearchState, ctx: SearchContext):
        """bool[P, R] — replica shares a rack with a lower slot's replica."""
        racks = _per_broker(ctx.broker_rack, state.rb)             # [P, R]
        valid = state.rb < ctx.num_brokers_padded
        R = racks.shape[-1]
        same = racks[..., :, None] == racks[..., None, :]          # [P, R, R]
        lower = torch.tril(torch.ones((R, R), dtype=torch.bool,
                                      device=racks.device), diagonal=-1)
        both = valid[..., :, None] & valid[..., None, :]
        return (same & lower & both).any(dim=-1)

    def violation(self, state, ctx):
        return self._dup_mask(state, ctx).sum(dim=(-2, -1)).to(torch.float32)

    def propose(self, state, ctx, key, cfg):
        return assemble_candidates(state, ctx, [_grid_part(
            self, state, ctx, key, cfg, "rack_aware")])

    def priority_base(self, kind, state, ctx):
        """KR's base of a replica sharing a rack with a lower slot's (its
        twin)."""
        return torch.where(self._dup_mask(state, ctx), 1.0, _NEG)

    def _dup_change(self, state, ctx, p, r, new_broker):
        """(before, after) count of same-rack pairs involving replica (p, r)
        when it relocates to ``new_broker`` (pairs, not booleans, so the
        delta agrees with the pairwise violation at any RF)."""
        row = state.rb[p]                                          # [N, R]
        racks = ctx.broker_rack[row]
        valid = row < ctx.num_brokers_padded
        R = racks.shape[-1]
        others = valid & (torch.arange(R, device=row.device)[None, :]
                          != r[:, None])
        my_rack = ctx.broker_rack[state.rb[p, r]]
        new_rack = ctx.broker_rack[new_broker]
        before = ((racks == my_rack[:, None]) & others).sum(dim=-1)
        after = ((racks == new_rack[:, None]) & others).sum(dim=-1)
        return before, after

    def delta(self, state, ctx, c):
        b1, a1 = self._dup_change(state, ctx, c.p, c.r, c.dst)
        b2, a2 = self._dup_change(state, ctx, c.p2, c.r2, c.src)
        d1 = (a1 - b1).to(torch.float32)
        d2 = (a2 - b2).to(torch.float32)
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, d1, torch.where(is_swap, d1 + d2, 0.0))

    def accepts(self, state, ctx, c):
        # An inter-broker move is rejected whenever the destination rack
        # already hosts another replica of the partition (no "was already
        # violating" relaxation, as RackAwareGoal.actionAcceptance).
        _, a1 = self._dup_change(state, ctx, c.p, c.r, c.dst)
        _, a2 = self._dup_change(state, ctx, c.p2, c.r2, c.src)
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, a1 == 0,
                           torch.where(is_swap, (a1 == 0) & (a2 == 0), True))

    def eligibility_row(self):
        return dict(kind="rack_aware")

    def collective_guard(self, state, ctx, c, earlier):
        # Partition-local: the engine already serializes shared rows.
        return _ones(c)

    def guard_row(self):
        return dict(kind="local")


def _count_distinct(values: torch.Tensor, size: int) -> torch.Tensor:
    """Number of distinct non-negative values below ``size`` along the last
    axis: one scatter-max into ``[..., size]`` flags, ids clamped into
    [0, size) (the reference's ``.at[clip(v)].max``)."""
    flags = torch.zeros(values.shape[:-1] + (size,), dtype=torch.int32,
                        device=values.device)
    flags = flags.scatter_reduce(-1, values.long().clamp(0, size - 1),
                                 (values >= 0).to(torch.int32), "amax")
    return flags.sum(dim=-1)


class RackAwareDistributionGoal(GoalKernel):
    """At most ``ceil(RF / num_alive_racks)`` replicas of a partition per
    rack (ref RackAwareDistributionGoal.java; hard): rack awareness
    relaxed for RF above the rack count."""

    name = "RackAwareDistributionGoal"
    hard = True

    def _limit(self, state: SearchState, ctx: SearchContext) -> torch.Tensor:
        B1 = ctx.broker_rack.shape[-1]
        alive_racks = torch.where(ctx.broker_alive, ctx.broker_rack.long(), -1)
        num_racks = torch.clamp(_count_distinct(alive_racks, B1), min=1)
        rf = (state.rb < ctx.num_brokers_padded).sum(dim=-1)         # [P]
        rf = rf.to(torch.float32) / num_racks.to(torch.float32)[..., None]
        return torch.ceil(rf).to(torch.int64)                        # [P]

    @staticmethod
    def _row_penalty(racks, valid, limit):
        """Per-partition excess: the sum over racks of max(0, n_rack -
        limit), carried by each rack group's first slot."""
        R = racks.shape[-1]
        same = ((racks[..., :, None] == racks[..., None, :])
                & valid[..., :, None] & valid[..., None, :])
        n = same.sum(dim=-1)                                         # [..., R]
        earlier = torch.tril(torch.ones((R, R), dtype=torch.bool,
                                        device=racks.device), diagonal=-1)
        first = valid & ~(same & earlier).any(dim=-1)
        excess = torch.clamp(n - limit[..., None], min=0)
        return torch.where(first, excess, 0).sum(dim=-1)

    def violation(self, state, ctx):
        racks = _per_broker(ctx.broker_rack, state.rb)
        valid = state.rb < ctx.num_brokers_padded
        pen = self._row_penalty(racks, valid, self._limit(state, ctx))
        return pen.sum(dim=-1).to(torch.float32)

    def propose(self, state, ctx, key, cfg):
        return assemble_candidates(state, ctx, [_grid_part(
            self, state, ctx, key, cfg, "rack_spread")])

    def priority_base(self, kind, state, ctx):
        """KR's base of a replica whose rack holds more of its partition's
        replicas than the limit (its twin)."""
        racks = ctx.broker_rack[state.rb]
        valid = state.rb < ctx.num_brokers_padded
        limit = self._limit(state, ctx)
        same = ((racks[:, :, None] == racks[:, None, :])
                & valid[:, :, None] & valid[:, None, :])
        n = same.sum(dim=-1)
        return torch.where(valid & (n > limit[:, None]), 1.0, _NEG)

    def _side_delta(self, state, ctx, limit, p, r, new_broker):
        """Partition p's penalty change when slot r relocates to
        ``new_broker``."""
        rb = state.rb[p]                                             # [N, R]
        R = rb.shape[-1]
        B = ctx.num_brokers_padded
        lim = limit[p]
        before = self._row_penalty(ctx.broker_rack[rb], rb < B, lim)
        rb2 = torch.where(torch.arange(R, device=rb.device)[None, :]
                          == r[:, None], new_broker[:, None], rb)
        after = self._row_penalty(ctx.broker_rack[rb2], rb2 < B, lim)
        return (after - before).to(torch.float32)

    def _side_deltas(self, state, ctx, c):
        limit = self._limit(state, ctx)
        return (self._side_delta(state, ctx, limit, c.p, c.r, c.dst),
                self._side_delta(state, ctx, limit, c.p2, c.r2, c.src))

    def delta(self, state, ctx, c):
        d1, d2 = self._side_deltas(state, ctx, c)
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, d1, torch.where(is_swap, d1 + d2, 0.0))

    def accepts(self, state, ctx, c):
        # Hard, per side: a swap may not buy p2's improvement with a new
        # violation on p.
        d1, d2 = self._side_deltas(state, ctx, c)
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, d1 <= 0,
                           torch.where(is_swap, (d1 <= 0) & (d2 <= 0), True))

    def eligibility_row(self):
        return dict(kind="rack_spread")

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)                                  # partition-local

    def guard_row(self):
        return dict(kind="local")


class KafkaAssignerEvenRackAwareGoal(RackAwareDistributionGoal):
    """Kafka-assigner mode's even-rack placement (ref
    kafkaassigner/KafkaAssignerEvenRackAwareGoal.java): the even-spread
    invariant of RackAwareDistributionGoal, reached by the batched
    search."""

    name = "KafkaAssignerEvenRackAwareGoal"
    hard = True


class KafkaAssignerDiskUsageDistributionGoal(ResourceDistributionGoal):
    """Kafka-assigner mode's disk-usage balance (ref
    kafkaassigner/KafkaAssignerDiskUsageDistributionGoal.java)."""

    def __init__(self, constraint: BalancingConstraint):
        super().__init__(Resource.DISK, constraint)
        self.name = "KafkaAssignerDiskUsageDistributionGoal"


# ---------------------------------------------------------------------------
# Topic-scoped goals: [T, B1] cell tables, guarded through KK
# ---------------------------------------------------------------------------

def _topic_rows(ctx: SearchContext, p: torch.Tensor, T: int):
    """(raw, gathered) topic of partition rows ``p``: the raw id (-1 on
    padding rows) names a cell in the collective guards, the gathered one
    is the table row the reference's gathers read."""
    raw = ctx.partition_topic[p].long()
    return raw, _jax_index(raw, T)


class TopicReplicaDistributionGoal(GoalKernel):
    """Per-topic replica counts balanced across alive brokers (ref
    TopicReplicaDistributionGoal.java; gap clamping per
    AnalyzerConfig.java:112-131)."""

    name = "TopicReplicaDistributionGoal"
    hard = False
    uses_topic_counts = True

    def __init__(self, constraint: BalancingConstraint):
        self.constraint = constraint

    def _bounds(self, state: SearchState, ctx: SearchContext):
        """(lower, upper) float32[T] (``[*L, T]`` batched)."""
        tc = state.topic_counts                                  # [T, B1]
        total = torch.where(ctx.broker_valid[..., None, :], tc, 0).sum(-1)
        n = torch.clamp(ctx.broker_alive.sum(-1), min=1)
        avg = total.to(torch.float32) / n.to(torch.float32)[..., None]
        cst = self.constraint
        gap = torch.clamp(avg * (cst.topic_replica_balance_threshold - 1.0),
                          float(cst.topic_replica_balance_min_gap),
                          float(cst.topic_replica_balance_max_gap))
        return torch.clamp(avg - gap, min=0.0), avg + gap

    @staticmethod
    def _penalty(counts, lower, upper, alive):
        c = counts.to(torch.float32)
        pen = torch.clamp(c - upper, min=0.0) + torch.clamp(lower - c, min=0.0)
        return torch.where(alive, pen, 0.0)

    def violation(self, state, ctx):
        lower, upper = self._bounds(state, ctx)
        pen = self._penalty(state.topic_counts, lower[..., None],
                            upper[..., None], ctx.broker_alive[..., None, :])
        return topic_cell_sum(pen)

    def propose(self, state, ctx, key, cfg):
        """The top-K replicas on cells above their topic's upper bound (KR),
        each scoring every broker by its own topic's deficit and the
        general headroom against the brokers already hosting the partition
        (KS); then, with swaps, heavy-for-light topic swaps with
        topic-matched pairing: each heavy replica picks the broker where its
        topic is scarcest and trades against that broker's light replica
        (KS: one a broker, the highest slot among the ties of a segment max
        of a uniform draw). One KT launch assembles both."""
        P, R = state.rb.shape
        K = min(cfg.num_replica_candidates, P * R)
        krep, kdst, kswap = _random.subkeys(key, 3)
        swaps = cfg.num_swap_candidates > 0
        kh, kl, kd = _random.subkeys(kswap, 3)
        prio, bounds = replica_priority("topic", self, state, ctx,
                                        (krep, kh) if swaps else (krep,), cfg)
        vals, idx = top_k(prio[0].reshape(-1), K)
        dst, ok = dest_select("topic_move_dest", self, state, ctx, (kdst,),
                              cfg, idx=idx, bounds=bounds)
        parts = [Part("move", idx=idx, vals=vals, dst=dst, ok=ok)]
        if swaps:
            hv, hidx = top_k(prio[1].reshape(-1),
                             min(cfg.num_swap_candidates, P * R))
            ok2, partner = dest_select("topic_swap_dest", self, state, ctx,
                                       (kl, kd), cfg, idx=hidx, bounds=bounds)
            parts.append(Part("topic_swap", idx=hidx, vals=hv, ok=ok2,
                              partner=partner))
        return assemble_candidates(state, ctx, parts)

    def _cell_deltas(self, ctx, c, T):
        """Per-candidate topic-count deltas on the four (topic, broker)
        cells a move or swap touches; a same-topic swap cancels."""
        is_move, is_swap = _kinds(c)
        m1 = (is_move | is_swap).to(torch.int32)       # topic of p: src -> dst
        m2 = is_swap.to(torch.int32)                   # topic of p2: dst -> src
        t1r, t1 = _topic_rows(ctx, c.p, T)
        t2r, t2 = _topic_rows(ctx, c.p2, T)
        same_t = t1r == t2r
        m2_t1 = torch.where(same_t, m2, 0)
        m2_t2 = torch.where(same_t, 0, m2)
        return (t1r, t1), (t2r, t2), m2_t1 - m1, m1 - m2_t1, m2_t2

    def delta(self, state, ctx, c):
        lower, upper = self._bounds(state, ctx)
        tc = state.topic_counts
        (_, t1), (_, t2), d_src_t1, d_dst_t1, m2 = self._cell_deltas(
            ctx, c, tc.shape[0])
        alive_s, alive_d = ctx.broker_alive[c.src], ctx.broker_alive[c.dst]

        def pen(t, b, alive, d):
            cell = tc[t, b]
            return (self._penalty(cell + d, lower[t], upper[t], alive)
                    - self._penalty(cell, lower[t], upper[t], alive))
        return (pen(t1, c.src, alive_s, d_src_t1)
                + pen(t1, c.dst, alive_d, d_dst_t1)
                + pen(t2, c.dst, alive_d, -m2)
                + pen(t2, c.src, alive_s, m2))

    def accepts(self, state, ctx, c):
        _, upper = self._bounds(state, ctx)
        tc = state.topic_counts
        (_, t1), (_, t2), d_src_t1, d_dst_t1, m2 = self._cell_deltas(
            ctx, c, tc.shape[0])
        # Whichever side gains a topic replica stays within the upper bound
        # or does not overtake the shrinking side.
        dst_t1_after = tc[t1, c.dst] + d_dst_t1
        ok1 = ((d_dst_t1 <= 0) | (dst_t1_after <= upper[t1])
               | (dst_t1_after <= tc[t1, c.src] + d_src_t1))
        src_t2_after = tc[t2, c.src] + m2
        ok2 = ((m2 <= 0) | (src_t2_after <= upper[t2])
               | (src_t2_after <= tc[t2, c.dst] - m2))
        return ok1 & ok2

    def eligibility_row(self):
        """The gap constants as :meth:`_bounds` forms them: ``threshold -
        1.0`` on the host, each rounded to float32 where it meets the
        float32 average."""
        cst = self.constraint
        return dict(kind="topic_replica",
                    t=cst.topic_replica_balance_threshold - 1.0,
                    lower=float(cst.topic_replica_balance_min_gap),
                    hi=float(cst.topic_replica_balance_max_gap))

    def collective_guard(self, state, ctx, c, earlier):
        # Net flow per (topic, broker) cell, cell id topic * B1 + broker:
        # candidates interact only where an earlier one moves a replica of
        # the same topic onto or off the same broker. One KK launch
        # evaluates the four one-sided queries: the gaining cells against
        # inflow, the shrinking cells of the escape clauses against outflow.
        _, upper = self._bounds(state, ctx)
        tc = state.topic_counts
        (t1r, t1), (t2r, t2), d_src_t1, d_dst_t1, m2 = self._cell_deltas(
            ctx, c, tc.shape[0])
        B1 = state.util.shape[0]
        cells = torch.stack([t1r * B1 + c.src, t1r * B1 + c.dst,
                             t2r * B1 + c.dst, t2r * B1 + c.src])   # [4, N]
        deltas = torch.stack([d_src_t1, d_dst_t1, -m2, m2]).to(torch.float32)
        inflow, outflow = deltas.clamp(min=0.0), deltas.clamp(max=0.0)
        net1, lo1, net2, lo2 = cell_net_flow(
            cells.reshape(2, 2, -1).flip(1).reshape(4, -1), cells,
            torch.stack([inflow, outflow, inflow, outflow]), earlier)
        after1 = tc[t1, c.dst].to(torch.float32) + net1 + d_dst_t1
        src1_lo = tc[t1, c.src].to(torch.float32) + lo1 + d_src_t1
        ok1 = ((net1 + d_dst_t1 <= 0) | (after1 <= upper[t1])
               | (after1 <= src1_lo))
        after2 = tc[t2, c.src].to(torch.float32) + net2 + m2
        src2_lo = tc[t2, c.dst].to(torch.float32) + lo2 - m2
        ok2 = ((net2 + m2 <= 0) | (after2 <= upper[t2])
               | (after2 <= src2_lo))
        return ok1 & ok2

    def guard_row(self):
        return self.eligibility_row()


class MinTopicLeadersPerBrokerGoal(GoalKernel):
    """Every alive broker must lead at least ``min_count`` partitions of each
    *interested* topic (ref MinTopicLeadersPerBrokerGoal.java; hard).
    Interested topics are configured by name pattern
    (``topics.with.min.leaders.per.broker``) and resolved at ``bind``; with
    none the goal is inactive (the reference default): violation 0, no
    candidates, every action accepted, and no [T, B1] state."""

    name = "MinTopicLeadersPerBrokerGoal"
    hard = True

    def __init__(self, constraint: BalancingConstraint, *,
                 interested_topics=None, topic_pattern: str | None = None,
                 min_count: int | None = None):
        self.constraint = constraint
        #: bool[T] topics the minimum applies to (None: inactive)
        self.interested_topics = (None if interested_topics is None
                                  else _DeviceMask(np.asarray(
                                      interested_topics, bool)))
        self.topic_pattern = (topic_pattern if topic_pattern is not None
                              else constraint.topics_with_min_leaders_per_broker)
        self.min_count = (min_count if min_count is not None
                          else constraint.min_topic_leaders_per_broker)
        active = interested_topics is not None
        self.uses_topic_counts = active
        self.uses_topic_leader_counts = active

    def bind(self, metadata) -> "MinTopicLeadersPerBrokerGoal":
        if self.interested_topics is not None or not self.topic_pattern:
            return self
        mask = np.array([fnmatch.fnmatch(t, self.topic_pattern)
                         for t in metadata.topics], bool)
        if not mask.any():
            return self
        return MinTopicLeadersPerBrokerGoal(
            self.constraint, interested_topics=mask,
            topic_pattern=self.topic_pattern, min_count=self.min_count)

    def bind_signature(self):
        mask = (None if self.interested_topics is None
                else self.interested_topics.host.tobytes())
        return (self.min_count, self.topic_pattern, mask)

    def _interested(self, device) -> torch.Tensor:
        return self.interested_topics.on(device)

    def _deficit(self, state: SearchState, ctx: SearchContext):
        """int[T, B1] (``[*L, T, B1]``) leaders still missing per cell."""
        tlc = state.topic_leader_counts
        d = torch.clamp(self.min_count - tlc, min=0)
        d = torch.where(ctx.broker_alive[..., None, :], d, 0)
        return torch.where(self._interested(tlc.device)[:, None], d, 0)

    def violation(self, state, ctx):
        if self.interested_topics is None:
            return _zeros_per_scenario(ctx)
        return self._deficit(state, ctx).sum(dim=(-2, -1)).to(torch.float32)

    def propose(self, state, ctx, key, cfg):
        if self.interested_topics is None:
            # An all-invalid batch keeps the engine's shapes uniform.
            return assemble_candidates(state, ctx, [_leadership_part(
                self, state, ctx, key, cfg, "no_leadership")])
        # Leadership transfers, then the fallback: leader replicas
        # relocated onto the brokers missing leaders.
        return assemble_candidates(state, ctx, [
            _leadership_part(self, state, ctx, key, cfg, "topic_leaders"),
            _grid_part(self, state, ctx, key, cfg, "topic_leaders_move",
                       plane="topic_leaders")])

    def priority_base(self, kind, state, ctx):
        """KR's bases (its twin): "topic_leaders" a slot r > 0 whose broker
        needs a leader of its topic, under a leader whose broker has
        surplus; "topic_leaders_move" that leader replica itself."""
        tlc = state.topic_leader_counts
        t_of_p = _jax_index(ctx.partition_topic, tlc.shape[0])
        surplus_src = (tlc[t_of_p, state.rb[:, 0]]
                       > self.min_count)[:, None]                  # [P, 1]
        if kind == "topic_leaders":
            deficit = self._deficit(state, ctx)                    # [T, B1]
            gain = deficit[t_of_p[:, None], state.rb] > 0          # [P, R]
            return torch.where(gain & surplus_src, 1.0, _NEG)
        slot0 = (torch.arange(state.rb.shape[1], device=tlc.device)
                 == 0)[None, :]
        return torch.where(slot0 & surplus_src, 1.0, _NEG)

    @staticmethod
    def _cell_delta(c):
        """Leadership of the candidate's topic arriving at dst (d1) and the
        swap counterpart's arriving at src (d2)."""
        is_lead = c.kind == MOVE_LEADERSHIP
        is_move, is_swap = _kinds(c)
        d1 = torch.where(is_lead | ((is_move | is_swap) & (c.r == 0)), 1, 0)
        d2 = torch.where(is_swap & (c.r2 == 0), 1, 0)
        return d1, d2

    def delta(self, state, ctx, c):
        if self.interested_topics is None:
            return torch.zeros(c.p.shape, dtype=torch.float32,
                               device=c.p.device)
        tlc = state.topic_leader_counts
        interested = self._interested(tlc.device)
        _, t1 = _topic_rows(ctx, c.p, tlc.shape[0])
        _, t2 = _topic_rows(ctx, c.p2, tlc.shape[0])
        d1, d2 = self._cell_delta(c)

        def pen(t, b, d):
            cell = tlc[t, b]
            active = ctx.broker_alive[b] & interested[t]
            before = torch.clamp(self.min_count - cell, min=0)
            after = torch.clamp(self.min_count - (cell + d), min=0)
            return torch.where(active, after - before, 0)
        out = (pen(t1, c.src, -d1) + pen(t1, c.dst, d1)
               + pen(t2, c.dst, -d2) + pen(t2, c.src, d2))
        return out.to(torch.float32)

    def accepts(self, state, ctx, c):
        # Hard: the losing cells may not sink below the minimum.
        if self.interested_topics is None:
            return _ones(c)
        tlc = state.topic_leader_counts
        interested = self._interested(tlc.device)
        _, t1 = _topic_rows(ctx, c.p, tlc.shape[0])
        _, t2 = _topic_rows(ctx, c.p2, tlc.shape[0])
        d1, d2 = self._cell_delta(c)

        def ok(t, b, d):
            active = interested[t] & ctx.broker_alive[b]
            return ~active | (d >= 0) | (tlc[t, b] + d >= self.min_count)
        return ok(t1, c.src, -d1) & ok(t2, c.dst, -d2)

    def eligibility_row(self):
        if self.interested_topics is None:
            return dict(kind="nothing")
        return dict(kind="topic_leaders", param=int(self.min_count),
                    aux=self.interested_topics)

    def collective_guard(self, state, ctx, c, earlier):
        if self.interested_topics is None:
            return _ones(c)
        # Pessimistic (outflow-only) prefix accounting on the two losing
        # cells, both queries in one KK launch.
        tlc = state.topic_leader_counts
        interested = self._interested(tlc.device)
        B1 = state.util.shape[0]
        t1r, t1 = _topic_rows(ctx, c.p, tlc.shape[0])
        t2r, t2 = _topic_rows(ctx, c.p2, tlc.shape[0])
        d1, d2 = self._cell_delta(c)
        cells = torch.stack([t1r * B1 + c.src, t2r * B1 + c.dst])  # losing
        outs = torch.stack([d1, d2]).to(torch.float32)
        net = cell_net_flow(cells, cells, outs.expand(2, 2, -1), earlier)

        def ok(t, b, net_out, d):
            active = interested[t] & ctx.broker_alive[b]
            after = tlc[t, b].to(torch.float32) - net_out - d
            return ~active | (d <= 0) | (after >= self.min_count)
        return (ok(t1, c.src, net[0], d1.to(torch.float32))
                & ok(t2, c.dst, net[1], d2.to(torch.float32)))

    def guard_row(self):
        if self.interested_topics is None:
            return dict(kind="local")
        return self.eligibility_row()


class BrokerSetAwareGoal(GoalKernel):
    """Replicas of a topic stay inside the topic's broker set (ref
    BrokerSetAwareGoal.java; hard). ``topic_set[T]`` comes from the
    broker-set mapping policy (:mod:`..config.brokersets`), the brokers'
    sets from the model; a topic or broker without a set (-1) is
    unconstrained, and a model without broker sets leaves the goal
    inactive."""

    name = "BrokerSetAwareGoal"
    hard = True

    def __init__(self, constraint: BalancingConstraint, *, topic_set=None):
        self.constraint = constraint
        #: int32[T] or None
        self.topic_set = (None if topic_set is None
                          else _DeviceMask(np.asarray(topic_set, np.int32)))

    def bind(self, metadata) -> "BrokerSetAwareGoal":
        if self.topic_set is not None or not metadata.broker_sets:
            return self
        return BrokerSetAwareGoal(self.constraint, topic_set=topic_set_array(
            metadata.topics, metadata.broker_sets))

    def bind_signature(self):
        return None if self.topic_set is None else self.topic_set.host.tobytes()

    def _want(self, ctx, p=None) -> torch.Tensor:
        """The broker set each partition row (or row ``p``) belongs in."""
        sets = self.topic_set.on(ctx.partition_topic.device)
        topic = ctx.partition_topic if p is None else ctx.partition_topic[p]
        return sets[_jax_index(topic, sets.shape[0])]

    def _mismatch(self, state, ctx) -> torch.Tensor:
        """bool[P, R] — replica sits outside its topic's broker set."""
        if self.topic_set is None:
            return torch.zeros(state.rb.shape, dtype=torch.bool,
                               device=state.rb.device)
        want = self._want(ctx)[..., None]                          # [P, 1]
        have = _per_broker(ctx.broker_set, state.rb)               # [P, R]
        valid = state.rb < ctx.num_brokers_padded
        return valid & (want >= 0) & (have >= 0) & (have != want)

    def violation(self, state, ctx):
        return self._mismatch(state, ctx).sum(dim=(-2, -1)).to(torch.float32)

    def propose(self, state, ctx, key, cfg):
        return assemble_candidates(state, ctx, [_grid_part(
            self, state, ctx, key, cfg, "broker_set")])

    def priority_base(self, kind, state, ctx):
        """KR's base of a replica outside its topic's broker set (its
        twin)."""
        return torch.where(self._mismatch(state, ctx), 1.0, _NEG)

    def _lands_outside(self, ctx, p, broker):
        """bool[N] — partition row p's replica would sit outside its set on
        ``broker``."""
        want = self._want(ctx, p)
        have = ctx.broker_set[broker]
        return (want >= 0) & (have >= 0) & (have != want)

    def delta(self, state, ctx, c):
        if self.topic_set is None:
            return torch.zeros(c.p.shape, dtype=torch.float32,
                               device=c.p.device)
        mism = self._mismatch(state, ctx)
        d1 = (self._lands_outside(ctx, c.p, c.dst).to(torch.float32)
              - mism[c.p, c.r].to(torch.float32))
        d2 = (self._lands_outside(ctx, c.p2, c.src).to(torch.float32)
              - mism[c.p2, c.r2].to(torch.float32))
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, d1, torch.where(is_swap, d1 + d2, 0.0))

    def accepts(self, state, ctx, c):
        if self.topic_set is None:
            return _ones(c)
        ok1 = ~self._lands_outside(ctx, c.p, c.dst)
        ok2 = ~self._lands_outside(ctx, c.p2, c.src)
        is_move, is_swap = _kinds(c)
        return torch.where(is_move, ok1, torch.where(is_swap, ok1 & ok2, True))

    def eligibility_row(self):
        if self.topic_set is None:
            return dict(kind="nothing")
        return dict(kind="broker_set", param=len(self.topic_set.host),
                    aux=self.topic_set)

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)                       # a per-replica property

    def guard_row(self):
        return dict(kind="local")


class PreferredLeaderElectionGoal(GoalKernel):
    """Make the original first replica the leader again (ref
    PreferredLeaderElectionGoal.java; used by DemoteBroker and the
    kafka-assigner mode)."""

    name = "PreferredLeaderElectionGoal"
    hard = False

    def violation(self, state, ctx):
        wrong = ctx.partition_valid & (state.pos[..., 0] != 0)
        return wrong.sum(dim=-1).to(torch.float32)

    def propose(self, state, ctx, key, cfg):
        return assemble_candidates(state, ctx, [_leadership_part(
            self, state, ctx, key, cfg, "preferred_leader")])

    def priority_base(self, kind, state, ctx):
        """KR's base (its twin): the slot holding the preferred replica,
        where the leader is not it."""
        return torch.where((state.pos == 0) & (state.pos[:, 0:1] != 0),
                           1.0, _NEG)

    def delta(self, state, ctx, c):
        is_lead = c.kind == MOVE_LEADERSHIP
        fixes = (state.pos[c.p, c.r] == 0) & (state.pos[c.p, 0] != 0)
        breaks = state.pos[c.p, 0] == 0
        return torch.where(is_lead, torch.where(
            fixes, -1.0, torch.where(breaks, 1.0, 0.0)), 0.0)

    def accepts(self, state, ctx, c):
        return _ones(c)

    def eligibility_row(self):
        return dict(kind="preferred_leader")

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)              # partition-local

    def guard_row(self):
        return dict(kind="local")


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------

def default_goals(constraint: BalancingConstraint | None = None
                  ) -> list[GoalKernel]:
    """The reference's default goal chain in priority order
    (``config/cruisecontrol.properties:96``)."""
    cst = constraint or BalancingConstraint()
    return [
        RackAwareGoal(),
        MinTopicLeadersPerBrokerGoal(cst),   # inactive until topics configured
        ReplicaCapacityGoal(cst),
        CapacityGoal(Resource.DISK, cst),
        CapacityGoal(Resource.NW_IN, cst),
        CapacityGoal(Resource.NW_OUT, cst),
        CapacityGoal(Resource.CPU, cst),
        ReplicaDistributionGoal(cst),
        PotentialNwOutGoal(cst),
        ResourceDistributionGoal(Resource.DISK, cst),
        ResourceDistributionGoal(Resource.NW_IN, cst),
        ResourceDistributionGoal(Resource.NW_OUT, cst),
        ResourceDistributionGoal(Resource.CPU, cst),
        TopicReplicaDistributionGoal(cst),
        LeaderReplicaDistributionGoal(cst),
        LeaderBytesInDistributionGoal(cst),
    ]


#: The default chain's names with each goal's hardness (the hard-goal audit
#: reads the hard ones).
DEFAULT_GOALS = tuple((g.name, g.hard) for g in default_goals())

GOAL_REGISTRY = {
    "RackAwareGoal": lambda cst: RackAwareGoal(),
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": lambda cst: CapacityGoal(Resource.DISK, cst),
    "NetworkInboundCapacityGoal": lambda cst: CapacityGoal(Resource.NW_IN, cst),
    "NetworkOutboundCapacityGoal": lambda cst: CapacityGoal(Resource.NW_OUT, cst),
    "CpuCapacityGoal": lambda cst: CapacityGoal(Resource.CPU, cst),
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "PotentialNwOutGoal": PotentialNwOutGoal,
    "DiskUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.DISK, cst),
    "NetworkInboundUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.NW_IN, cst),
    "NetworkOutboundUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.NW_OUT, cst),
    "CpuUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.CPU, cst),
    "TopicReplicaDistributionGoal": TopicReplicaDistributionGoal,
    "LeaderReplicaDistributionGoal": LeaderReplicaDistributionGoal,
    "LeaderBytesInDistributionGoal": LeaderBytesInDistributionGoal,
    "PreferredLeaderElectionGoal": lambda cst: PreferredLeaderElectionGoal(),
    "MinTopicLeadersPerBrokerGoal": MinTopicLeadersPerBrokerGoal,
    "BrokerSetAwareGoal": BrokerSetAwareGoal,
    "RackAwareDistributionGoal": lambda cst: RackAwareDistributionGoal(),
    "KafkaAssignerEvenRackAwareGoal":
        lambda cst: KafkaAssignerEvenRackAwareGoal(),
    "KafkaAssignerDiskUsageDistributionGoal":
        KafkaAssignerDiskUsageDistributionGoal,
}

#: Kafka-assigner mode's minimal goal set (ref analyzer/kafkaassigner/,
#: triggered by the kafka_assigner=true request parameter).
KAFKA_ASSIGNER_GOALS = ["KafkaAssignerEvenRackAwareGoal",
                        "KafkaAssignerDiskUsageDistributionGoal"]

#: Documented relaxations of registered hard goals: a chain carrying one of
#: the alternatives satisfies the strict form's audit.
HARD_GOAL_ALTERNATIVES = {
    "RackAwareGoal": ("RackAwareDistributionGoal",
                      "KafkaAssignerEvenRackAwareGoal"),
}


def short_goal_name(name: str) -> str:
    """A goal name without its package (the reference accepts both)."""
    return name.rsplit(".", 1)[-1]


def goals_by_name(names: list[str],
                  constraint: BalancingConstraint | None = None
                  ) -> list[GoalKernel]:
    cst = constraint or BalancingConstraint()
    out = []
    for n in names:
        short = short_goal_name(n)
        if short not in GOAL_REGISTRY:
            raise ValueError(f"unknown goal {n!r}")
        out.append(GOAL_REGISTRY[short](cst))
    return out
