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
``collective_guard``.

Exactness: tie-break noise comes from the port's threefry stream, sorts and
top-k are stable, float sums and prefix sums run in the reference's order
(:mod:`..utils.ordered`), and every out-of-range index of the reference
(clamped gathers, dropped scatters) is an explicit mask here. The
topic-cell collective guards run through KC's cell form, KK
(``kernels.cell_net_flow``).
"""

from __future__ import annotations

import fnmatch

import numpy as np
import torch

from .. import _random
from ..config.brokersets import topic_set_array
from ..core.resources import Resource
from ..kernels import cell_net_flow, net_broker_flow, ordered_segment_sum
from ..model.flat import MOVE_INTER_BROKER, MOVE_LEADERSHIP, MOVE_SWAP
from ..utils.ordered import (argsort, fma, lexsort, scan_sum, top_k,
                              topic_cell_sum, tree_sum, tree_sum_last,
                              violation_row_sum)
from .constraint import BalancingConstraint, SearchConfig
from .state import (Candidates, SearchContext, SearchState, concat_candidates,
                    make_leadership_candidates, make_move_candidates,
                    make_swap_candidates, metric_deltas, metric_values,
                    METRIC_LEADER_COUNT, METRIC_LEADER_NW_IN,
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
    """Shared candidate generator: top-K replicas x top-D destinations."""
    P, R = replica_priority.shape
    K = min(cfg.num_replica_candidates, P * R)
    D = min(cfg.num_dest_candidates, dest_priority.shape[0])
    krep, kdst = _random.subkeys(key)

    rp = torch.where(ctx.movable, replica_priority, _NEG)
    rp = torch.where(state.offline,
                     _TIER_OFFLINE + torch.clamp(
                         torch.where(torch.isfinite(rp), rp, 0.0), 0.0, 1.0),
                     rp)
    rp = rp + torch.where(torch.isfinite(rp),
                          _noise(krep, rp.shape, cfg.noise_scale), 0.0)
    rvals, ridx = top_k(rp.reshape(-1), K)
    p, r = ridx // R, ridx % R

    dp = torch.where(ctx.dest_allowed, dest_priority, _NEG)
    dp = dp + torch.where(torch.isfinite(dp),
                          _noise(kdst, dp.shape, cfg.noise_scale), 0.0)
    dvals, didx = top_k(dp, D)

    pg = torch.repeat_interleave(p, D)
    rg = torch.repeat_interleave(r, D)
    dg = didx.repeat(K)
    valid = (torch.repeat_interleave(torch.isfinite(rvals), D)
             & torch.isfinite(dvals).repeat(K))
    return make_move_candidates(state, ctx, pg, rg, dg, valid)


def _top_leadership(state: SearchState, ctx: SearchContext, key,
                    cfg: SearchConfig, priority: torch.Tensor) -> Candidates:
    """Top-K leadership-transfer candidates from a [P, R] priority grid
    (slot r>0 becoming leader)."""
    P, R = priority.shape
    K = min(cfg.num_replica_candidates, P * R)
    slot_ok = ((torch.arange(R, device=priority.device)[None, :] > 0)
               & ctx.leadership_movable[:, None])
    pr = torch.where(slot_ok, priority, _NEG)
    pr = pr + torch.where(torch.isfinite(pr),
                          _noise(key, pr.shape, cfg.noise_scale), 0.0)
    vals, idx = top_k(pr.reshape(-1), K)
    p, r = idx // R, idx % R
    return make_leadership_candidates(state, ctx, p, r, torch.isfinite(vals))


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

    def collective_guard(self, state: SearchState, ctx: SearchContext,
                         c: Candidates, earlier: torch.Tensor
                         ) -> torch.Tensor | None:
        """ok[N] — whether each candidate keeps this goal's bounds when
        applied together with every earlier candidate flagged in
        ``earlier`` ([N, N] bool). ``None`` opts out (the engine then
        serializes shared-broker pairs)."""
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

    def _cap_factor(self, ctx):
        """(capacity column, threshold) when the upper bound is their
        per-broker product, else None."""
        return None

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
        which, res = self.metric
        plane = which != "util"
        if self._cap_factor(ctx) is not None:
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

    def receptive_dest(self, state, ctx):
        values, _lo, up = self._bounds_b1(state, ctx)
        if self.metric[0] in ("count", "leaders"):
            return values + 1.0 <= up
        return values < up

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
        return self._leadership_bulk_drain(state, ctx, key, cfg,
                                           self._leadership_drain_weight(ctx))

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
        (capped by the replica-count ceiling and every capacity hard goal)."""
        N = cfg.drain_batch
        dev = state.rb.device
        values, lo, up = self._bounds_b1(state, ctx)
        alive = ctx.broker_alive
        excess, deficit, quota, n_alive = self._shed_quota(values, lo, up,
                                                           ctx)

        P, R = state.rb.shape
        B1 = values.shape[0]
        src_b = state.rb
        w = self._replica_drain_weight(ctx, state.rb)              # [P, R]
        cand = (ctx.movable & ((w > 0.0) | state.offline)
                & ((quota[src_b] > 0.0) | state.offline))

        # Sort by (broker, must-first, weight-desc-with-noise).
        noise = _random.affine(key, (P, R), 0.01, 1.0)
        flat_b = src_b.reshape(-1)
        flat_w = w.reshape(-1)
        flat_cand = cand.reshape(-1)
        flat_must = state.offline.reshape(-1) & flat_cand
        sort_w = torch.where(flat_cand, flat_w * noise.reshape(-1), -1.0)
        order = lexsort((-sort_w, ~flat_must, flat_b))
        sb = flat_b[order]
        smask = flat_cand[order]
        sw = torch.where(smask, flat_w[order], 0.0)
        smust = flat_must[order]

        # Shed while the broker's cumulative shed (before this replica) is
        # still below its quota; must-moves shed unconditionally.
        within_before = _segment_cum_before(sw, sb, B1)
        take = smask & ((within_before < quota[sb]) | smust)

        # Partition-disjoint: first taken slot per partition row only.
        sp = order // R
        pos = torch.arange(P * R, device=dev)
        first_pos = torch.full((P,), P * R, dtype=torch.int64,
                               device=dev).scatter_reduce(
            0, sp, torch.where(take, pos, P * R), reduce="amin")
        take = take & (first_pos[sp] == pos)

        grank = torch.cumsum(take, 0) - 1
        take = take & (grank < N)
        tw = torch.where(take, sw, 0.0)
        total_w = torch.clamp(tree_sum(tw), min=1e-9)
        n_take = torch.clamp(take.sum().to(torch.float32), min=1.0)

        budget = torch.where(alive & ctx.dest_allowed & ctx.broker_valid,
                             torch.clamp(self._upper_minus(values, up, ctx),
                                         min=0.0), 0.0)
        is_slot0 = (torch.arange(R, device=dev) == 0)[None, :, None]
        loads = torch.where(is_slot0, ctx.leader_load[:, None, :],
                            ctx.follower_load[:, None, :])         # [P, R, 4]
        sorted_loads = loads.reshape(-1, 4)[order]
        ratio = sorted_loads / torch.clamp(sw, min=1e-9)[:, None]
        per_unit_max = torch.where(take[:, None], ratio, 0.0).amax(dim=0)
        cst = self.constraint
        budget = _capacity_budget_cap(budget, per_unit_max, cst,
                                      ctx.broker_capacity, state.util)
        if self.metric[0] != "count":
            cnt = state.replica_count.to(torch.float32)
            cnt_total = tree_sum(torch.where(ctx.broker_valid, cnt, 0.0))
            cnt_avg = cnt_total / n_alive
            cnt_up = torch.maximum(cnt_avg * cst.replica_balance_threshold,
                                   torch.ceil(cnt_avg))
            mean_w = total_w / n_take
            budget = torch.minimum(
                budget, torch.clamp(cnt_up - cnt, min=0.0) * mean_w)
        budget = torch.clamp(budget, min=0.0)

        # Prefix-sum fill over DEFICIT-FIRST receivers.
        perm = argsort(-deficit)
        cum_budget = scan_sum(budget[perm])
        target = scan_sum(tw) - 0.5 * tw
        pos_in_perm = torch.searchsorted(cum_budget, target)
        dst = perm[torch.clamp(pos_in_perm, max=B1 - 1)]
        ok = take & (pos_in_perm < B1) & (target < cum_budget[B1 - 1])

        # Scatter into the fixed-size batch (slot = global rank); rows that
        # are not ok park in the discard slot N, which is sliced off.
        slot = torch.where(ok, grank, N)

        def scatter(vals, dtype):
            out = torch.zeros(N + 1, dtype=dtype, device=dev)
            return out.scatter_(0, slot, vals.to(dtype))[:N]
        return make_move_candidates(state, ctx,
                                    scatter(sp, torch.int64),
                                    scatter(order % R, torch.int64),
                                    scatter(dst, torch.int64),
                                    scatter(ok, torch.bool))

    def _leadership_bulk_drain(self, state: SearchState, ctx: SearchContext,
                               key, cfg: SearchConfig,
                               w_all: torch.Tensor) -> Candidates:
        """Bulk leadership transfers off over-upper leader brokers onto each
        partition's best-headroom follower broker, with two quota passes
        (shed per source, intake per destination)."""
        N = cfg.drain_batch
        dev = state.rb.device
        values, lo, up = self._bounds_b1(state, ctx)
        alive = ctx.broker_alive
        excess, deficit, quota, n_alive = self._shed_quota(values, lo, up,
                                                           ctx)
        budget_b = torch.where(alive & ctx.leader_dest_allowed
                               & ctx.broker_valid,
                               torch.clamp(self._upper_minus(values, up, ctx),
                                           min=0.0), 0.0)

        P, R = state.rb.shape
        B1 = values.shape[0]
        src = state.rb[:, 0]                                       # [P]
        w = torch.clamp(w_all, min=0.0)
        can = (ctx.leadership_movable & ctx.partition_valid & alive[src]
               & (quota[src] > 0.0) & (w > 0.0))

        fb = state.rb                                              # [P, R]
        slot_ok = ((torch.arange(R, device=dev) != 0)[None, :]
                   & (fb < B1 - 1) & alive[fb] & ctx.leader_dest_allowed[fb]
                   & ~state.offline)
        dscore = torch.where(slot_ok, budget_b[fb], _NEG)
        r_sel = torch.argmax(dscore, dim=1)
        has_dst = torch.isfinite(dscore.amax(dim=1))
        can = can & has_dst
        dstb = fb[torch.arange(P, device=dev), r_sel]

        noise = _random.affine(key, (P,), 0.01, 1.0)
        sort_w = torch.where(can, w * noise, -1.0)

        # Pass 1 — shed quota per source broker (heaviest transfers first).
        o1 = lexsort((-sort_w, src))
        sw1 = torch.where(can[o1], w[o1], 0.0)
        before1 = _segment_cum_before(sw1, src[o1], B1)
        t1_sorted = can[o1] & (before1 < quota[src[o1]])
        take1 = torch.zeros(P, dtype=torch.bool, device=dev)
        take1[o1] = t1_sorted

        # Aggregate hard-capacity cap, like the replica drain.
        dload = torch.clamp(ctx.leader_load - ctx.follower_load, min=0.0)
        ratio = dload / torch.clamp(w, min=1e-9)[:, None]
        per_unit_max = torch.where(take1[:, None], ratio, 0.0).amax(dim=0)
        budget_b = _capacity_budget_cap(budget_b, per_unit_max,
                                        self.constraint,
                                        ctx.broker_capacity, state.util)

        # Pass 2 — intake budget per destination broker.
        sort_w2 = torch.where(take1, w * noise, -1.0)
        o2 = lexsort((-sort_w2, dstb))
        sw2 = torch.where(take1[o2], w[o2], 0.0)
        before2 = _segment_cum_before(sw2, dstb[o2], B1)
        t2_sorted = take1[o2] & (before2 < budget_b[dstb[o2]])

        grank = torch.cumsum(t2_sorted, 0) - 1
        ok = t2_sorted & (grank < N)
        slot = torch.where(ok, grank, N)

        def scatter(vals, dtype):
            out = torch.zeros(N + 1, dtype=dtype, device=dev)
            return out.scatter_(0, slot, vals.to(dtype))[:N]
        return make_leadership_candidates(state, ctx,
                                          scatter(o2, torch.int64),
                                          scatter(r_sel[o2], torch.int64),
                                          scatter(ok, torch.bool))

    # -- candidate generation -------------------------------------------
    def propose(self, state, ctx, key, cfg):
        values, lo, up = self._bounds_b1(state, ctx)
        alive = ctx.broker_alive
        # Load still parked on dead/invalid brokers also counts as excess.
        excess = torch.where(
            alive, torch.clamp(self._minus_upper(values, up, ctx), min=0.0),
            values)
        deficit = (torch.zeros_like(values) if self.upper_only else
                   torch.where(alive & torch.isfinite(lo),
                               torch.clamp(lo - values, min=0.0), 0.0))

        parts = []
        if self.actions in ("replica", "both"):
            kg, key = _random.subkeys(key)
            parts.append(self._flow_candidates(state, ctx, kg, cfg, values,
                                               lo, up, excess, deficit))
            if cfg.num_swap_candidates > 0 and self.metric[0] != "count":
                ks, key = _random.subkeys(key)
                parts.append(self._swap_candidates(state, ctx, ks, cfg,
                                                   values, lo, up, excess,
                                                   deficit))
        if self.actions in ("leadership", "both"):
            src_b = state.rb[:, 0:1]                                # [P, 1]
            dst_b = state.rb                                        # [P, R]
            gain = _norm01(excess)[src_b] + _norm01(deficit)[dst_b]
            prio = torch.where((excess[src_b] > 0.0) | (deficit[dst_b] > 0.0),
                               gain, _NEG)
            kl, key = _random.subkeys(key)
            parts.append(_top_leadership(state, ctx, kl, cfg, prio))
        out = parts[0]
        for extra in parts[1:]:
            out = concat_candidates(out, extra)
        return out

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

    def _flow_candidates(self, state, ctx, key, cfg, values, lo, up,
                         excess, deficit):
        """Flow-matched move candidates: top-K source replicas, each assigned
        its own destination by matching cumulative outgoing load against
        cumulative destination headroom (a greedy transportation plan)."""
        P, R = state.rb.shape
        B1 = values.shape[0]
        dev = state.rb.device
        K = min(cfg.num_replica_candidates, P * R)
        krep, kdst = _random.subkeys(key)

        # --- source replicas: offline > excess-broker > deficit-assist tiers
        q, finite = _unit01(self._replica_weight(state, ctx))       # [P, R]
        src_b = state.rb
        any_deficit = (deficit > 0.0).any()
        mid = torch.where(torch.isfinite(lo), (lo + up) * 0.5, up * 0.5)
        assist = any_deficit & (values[src_b] > mid[src_b])
        prio = torch.where(excess[src_b] > 0.0,
                           _tier_plus_norm01(_TIER_EXCESS, q, finite),
                           torch.where(assist,
                                       _tier_plus_norm01(_TIER_ASSIST, q,
                                                         finite), _NEG))
        if self.metric[0] in ("leaders", "leader_nw_in"):
            prio = torch.where((torch.arange(R, device=dev) == 0)[None, :],
                               prio, _NEG)
        prio = torch.where(ctx.movable, prio, _NEG)
        prio = torch.where(state.offline,
                           _tier_plus_norm01(_TIER_OFFLINE, q, finite), prio)
        prio = prio + torch.where(torch.isfinite(prio),
                                  _noise(krep, prio.shape, cfg.noise_scale),
                                  0.0)
        vals, idx = top_k(prio.reshape(-1), K)
        p, r = idx // R, idx % R
        sel = torch.isfinite(vals)

        # --- destination matching by cumulative headroom (to the midpoint
        # for balance goals, the ceiling for capacity-style goals).
        ceiling = torch.where(ctx.dest_allowed,
                              torch.clamp(self._upper_minus(values, up, ctx),
                                          min=0.0), 0.0)
        if self.upper_only:
            headroom = ceiling
        else:
            to_mid = torch.where(ctx.dest_allowed,
                                 torch.clamp(mid - values, min=0.0), 0.0)
            headroom = torch.where((to_mid > 0.0).any(), to_mid, ceiling)
        dprio = torch.where(ctx.dest_allowed,
                            torch.where(deficit > 0.0, _TIER_EXCESS, 0.0)
                            + _norm01(headroom, ctx.dest_allowed), _NEG)
        dprio = dprio + torch.where(torch.isfinite(dprio),
                                    _noise(kdst, dprio.shape,
                                           cfg.noise_scale), 0.0)
        order = argsort(-dprio)                                     # [B1]
        cum_head = scan_sum(headroom[order])
        load = torch.where(sel, self._replica_metric_load(ctx, p, r), 0.0)
        cum_load = scan_sum(load) - 0.5 * load                      # midpoints
        slot = torch.searchsorted(cum_head, cum_load)
        covered = slot < B1
        matched = order[torch.clamp(slot, max=B1 - 1)]
        # Mandatory (offline) moves get a round-robin destination even when
        # no headroom is left.
        n_ok = torch.clamp(ctx.dest_allowed.sum(), min=1)
        fallback = order[torch.arange(K, device=dev) % n_ok]
        must = state.offline[p, r] & sel
        dst = torch.where(covered, matched, fallback)
        # Re-route candidates whose matched broker already hosts the
        # partition to their best legal destination.
        hosts_dst = (state.rb[p] == dst[:, None]).any(dim=1)
        alt, alt_ok = _legal_dest_argmax(
            state, ctx, p, torch.broadcast_to(dprio[None, :], (K, B1)))
        dst = torch.where(hosts_dst & alt_ok, alt, dst)
        valid = sel & (covered | must) & ctx.dest_allowed[dst]
        return make_move_candidates(state, ctx, p, r, dst, valid)

    def _swap_candidates(self, state, ctx, key, cfg, values, lo, up, excess,
                         deficit):
        """Heavy-for-light replica swaps between over-upper and below-average
        brokers (ref ResourceDistributionGoal.java:689,779): the k-th
        heaviest eligible replica pairs with the k-th lightest, the pairing
        rotated by a random shift each iteration."""
        P, R = state.rb.shape
        dev = state.rb.device
        K = min(cfg.num_swap_candidates, P * R)
        kh, kl, kshift = _random.subkeys(key, 3)
        q, finite = _unit01(self._replica_weight(state, ctx))       # [P, R]
        src_b = state.rb
        swappable = (ctx.movable & ~state.offline
                     & ctx.raw_dest_allowed[src_b])
        leader_scoped = self.metric[0] in ("leaders", "leader_nw_in")
        is_slot0 = (torch.arange(R, device=dev) == 0)[None, :]
        mid = torch.where(torch.isfinite(lo), (lo + up) * 0.5, up * 0.5)

        any_deficit = (deficit > 0.0).any()
        hmask = swappable & ((excess[src_b] > 0.0)
                             | (any_deficit & (values[src_b] > mid[src_b])))
        lmask = swappable & (values[src_b] < mid[src_b])
        if leader_scoped:
            hmask = hmask & is_slot0
            lmask = lmask & ~is_slot0
        hprio = torch.where(hmask, _tier_plus_norm01(_TIER_EXCESS, q, finite),
                            _NEG)
        hprio = hprio + torch.where(torch.isfinite(hprio),
                                    _noise(kh, hprio.shape, cfg.noise_scale),
                                    0.0)
        # 0.99 - w contracts too: 0.99 - q * 0.99 rounds once.
        light = torch.where(finite, fma(-q, 0.99, 0.99), 0.99 - 0.0)
        lprio = torch.where(lmask,
                            torch.where(deficit[src_b] > 0.0, _TIER_EXCESS,
                                        0.0) + light, _NEG)
        lprio = lprio + torch.where(torch.isfinite(lprio),
                                    _noise(kl, lprio.shape, cfg.noise_scale),
                                    0.0)
        hv, hidx = top_k(hprio.reshape(-1), K)
        lv, lidx = top_k(lprio.reshape(-1), K)
        shift = _random.randint(kshift, (), 0, K)
        rolled = (torch.arange(K, device=dev) - shift) % K         # jnp.roll
        lidx = lidx[rolled]
        lv = lv[rolled]
        p1, r1 = hidx // R, hidx % R
        p2, r2 = lidx // R, lidx % R
        valid = torch.isfinite(hv) & torch.isfinite(lv)
        return make_swap_candidates(state, ctx, p1, r1, p2, r2, valid)

    def _replica_weight(self, state: SearchState, ctx: SearchContext):
        """[P, R] preference among movable replicas on source brokers."""
        which, res = self.metric
        R = state.rb.shape[1]
        is_leader = (torch.arange(R, device=state.rb.device) == 0)[None, :]
        if which == "util":
            load = torch.where(is_leader[..., None],
                               ctx.leader_load[:, None, :],
                               ctx.follower_load[:, None, :])
            return load[..., int(res)]
        if which == "potential":
            return torch.broadcast_to(
                ctx.leader_load[:, None, Resource.NW_OUT], state.rb.shape)
        # count-style goals: prefer cheap-to-move (small disk) replicas
        disk = torch.where(is_leader[..., None], ctx.leader_load[:, None, :],
                           ctx.follower_load[:, None, :])[..., Resource.DISK]
        return -disk


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

    def _cap_factor(self, ctx):
        return (ctx.broker_capacity[..., int(self.resource)],
                self.constraint.cap_threshold(self.resource))

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


class ReplicaDistributionGoal(IntervalGoal):
    """Soft balance of replica counts (ref ReplicaDistributionGoal.java)."""

    def __init__(self, constraint: BalancingConstraint):
        super().__init__("ReplicaDistributionGoal", METRIC_REPLICA_COUNT,
                         hard=False, constraint=constraint)

    def bounds(self, state, ctx):
        return self._avg_bounds(state, ctx,
                                self.constraint.replica_balance_threshold,
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

    def _cap_factor(self, ctx):
        return (ctx.broker_capacity[..., int(Resource.NW_OUT)],
                self.constraint.cap_threshold(Resource.NW_OUT))


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
        prio = torch.where(self._dup_mask(state, ctx), 1.0, _NEG)
        return _top_replica_dest_grid(state, ctx, key, cfg, prio,
                                      _count_replicas_norm(state))

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

    def collective_guard(self, state, ctx, c, earlier):
        # Partition-local: the engine already serializes shared rows.
        return _ones(c)


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
        racks = ctx.broker_rack[state.rb]
        valid = state.rb < ctx.num_brokers_padded
        limit = self._limit(state, ctx)
        same = ((racks[:, :, None] == racks[:, None, :])
                & valid[:, :, None] & valid[:, None, :])
        n = same.sum(dim=-1)
        prio = torch.where(valid & (n > limit[:, None]), 1.0, _NEG)
        return _top_replica_dest_grid(state, ctx, key, cfg, prio,
                                      _count_replicas_norm(state))

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

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)                                  # partition-local


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
        lower, upper = self._bounds(state, ctx)
        tc = state.topic_counts.to(torch.float32)               # [T, B1]
        T, B1 = tc.shape
        alive = ctx.broker_alive[None, :]
        excess = torch.where(alive, torch.clamp(tc - upper[:, None], min=0.0),
                             tc)
        t_of_p = _jax_index(ctx.partition_topic, T)               # [P]
        src_excess = excess[t_of_p[:, None], state.rb]            # [P, R]
        q, finite = _unit01(src_excess)
        prio = torch.where(src_excess > 0.0,
                           _tier_plus_norm01(_TIER_EXCESS, q, finite), _NEG)
        prio = torch.where(ctx.movable, prio, _NEG)
        prio = torch.where(state.offline, _TIER_OFFLINE, prio)
        deficit = torch.where(alive, torch.clamp(lower[:, None] - tc, min=0.0),
                              0.0)

        # Per-candidate topic-aware destination: each short-listed replica
        # scores every broker by its own topic's deficit (+ general
        # headroom), masked against brokers already hosting the partition.
        P, R = state.rb.shape
        K = min(cfg.num_replica_candidates, P * R)
        krep, kdst, kswap = _random.subkeys(key, 3)
        prio = prio + torch.where(torch.isfinite(prio),
                                  _noise(krep, prio.shape, cfg.noise_scale),
                                  0.0)
        vals, idx = top_k(prio.reshape(-1), K)
        p, r = idx // R, idx % R
        sel = torch.isfinite(vals)
        base = (2.0 * _norm01(deficit[t_of_p[p]])
                + _count_replicas_norm(state)[None, :])
        score = _plus_noise(base, kdst, cfg.noise_scale)
        dst, ok = _legal_dest_argmax(state, ctx, p, score)
        out = make_move_candidates(state, ctx, p, r, dst, sel & ok)
        if cfg.num_swap_candidates > 0:
            out = concat_candidates(
                out, self._swap_candidates(state, ctx, kswap, cfg, upper))
        return out

    def _swap_candidates(self, state, ctx, key, cfg, upper):
        """Heavy-for-light topic swaps with topic-matched pairing: each
        heavy replica (cell above upper) picks the broker where its topic
        is scarcest and trades against that broker's light replica (one a
        broker: the highest slot among the ties of a segment max of a
        uniform draw)."""
        tc = state.topic_counts.to(torch.float32)               # [T, B1]
        T, B1 = tc.shape
        dev = tc.device
        t_of_p = _jax_index(ctx.partition_topic, T)
        P, R = state.rb.shape
        K = min(cfg.num_swap_candidates, P * R)
        src_b = state.rb
        swappable = (ctx.movable & ~state.offline
                     & ctx.raw_dest_allowed[src_b])
        src_over = torch.clamp(tc - upper[:, None], min=0.0)[t_of_p[:, None],
                                                             src_b]
        kh, kl, kd = _random.subkeys(key, 3)
        q, finite = _unit01(src_over)
        hprio = torch.where(swappable & (src_over > 0.0),
                            _tier_plus_norm01(_TIER_EXCESS, q, finite), _NEG)
        hprio = hprio + torch.where(torch.isfinite(hprio),
                                    _noise(kh, hprio.shape, cfg.noise_scale),
                                    0.0)
        hv, hidx = top_k(hprio.reshape(-1), K)
        p1, r1 = hidx // R, hidx % R
        t1 = t_of_p[p1]                                           # [K]

        # One light partner per broker: a segment max of a uniform draw
        # over in-bounds replicas, then the highest slot holding it. An
        # empty segment keeps the max's identity (-inf, INT32_MIN).
        light = (swappable & (src_over <= 0.0)).reshape(-1)
        lraw = torch.where(light, _random.uniform(kl, (P * R,)), _NEG)
        broker_of = src_b.reshape(-1)
        best_val = torch.full((B1,), _NEG, device=dev).scatter_reduce(
            0, broker_of, lraw, "amax")
        slots = torch.arange(P * R, device=dev)
        tied = torch.isfinite(lraw) & (lraw == best_val[broker_of])
        best_slot = torch.full((B1,), -2**31, dtype=torch.int64,
                               device=dev).scatter_reduce(
            0, broker_of, torch.where(tied, slots, -1), "amax")
        has_light = best_slot >= 0

        # Destination: the broker where the heavy candidate's topic is
        # scarcest and that offers a partner, masked against the raw
        # destination filter and the brokers hosting the partition.
        hosting = torch.zeros((K, B1), dtype=torch.bool, device=dev)
        hosting.scatter_(1, state.rb[p1], True)  # sentinel column B is in range
        scarcity = _norm01(-tc)[t1]                               # [K, B1]
        score = torch.where(
            has_light[None, :] & ctx.raw_dest_allowed[None, :] & ~hosting,
            _plus_noise(scarcity, kd, cfg.noise_scale), _NEG)
        dst = torch.argmax(score, dim=1)
        ok = torch.isfinite(score.amax(dim=1))
        partner = best_slot[dst]
        p2, r2 = partner // R, partner % R
        valid = torch.isfinite(hv) & ok & (partner >= 0)
        # An invalid pairing's partner may be negative: its row is the one
        # the reference's gathers read.
        return make_swap_candidates(state, ctx, p1, r1, _jax_index(p2, P),
                                    r2, valid)

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
            cells[[1, 0, 3, 2]], cells,
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
            return _top_leadership(state, ctx, key, cfg,
                                   torch.full(state.rb.shape, _NEG,
                                              device=state.rb.device))
        deficit = self._deficit(state, ctx)                        # [T, B1]
        tlc = state.topic_leader_counts
        t_of_p = _jax_index(ctx.partition_topic, tlc.shape[0])
        # Leadership transfers: slot r>0 whose broker needs a leader of
        # this topic, from a leader whose broker has surplus.
        surplus_src = (tlc[t_of_p, state.rb[:, 0]]
                       > self.min_count)[:, None]                  # [P, 1]
        gain = deficit[t_of_p[:, None], state.rb] > 0              # [P, R]
        prio = torch.where(gain & surplus_src, 1.0, _NEG)
        lead = _top_leadership(state, ctx, key, cfg, prio)
        # Fallback: relocate leader replicas onto deficit brokers.
        slot0 = (torch.arange(state.rb.shape[1], device=tlc.device)
                 == 0)[None, :]
        rprio = torch.where(slot0 & surplus_src, 1.0, _NEG)
        dest_prio = _norm01(deficit.sum(dim=0).to(torch.float32))
        moves = _top_replica_dest_grid(state, ctx, key, cfg, rprio, dest_prio)
        return concat_candidates(lead, moves)

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
        prio = torch.where(self._mismatch(state, ctx), 1.0, _NEG)
        return _top_replica_dest_grid(state, ctx, key, cfg, prio,
                                      _count_replicas_norm(state))

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

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)                       # a per-replica property


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
        # The slot holding the preferred replica, where the leader is not it.
        prio = torch.where((state.pos == 0) & (state.pos[:, 0:1] != 0),
                           1.0, _NEG)
        return _top_leadership(state, ctx, key, cfg, prio)

    def delta(self, state, ctx, c):
        is_lead = c.kind == MOVE_LEADERSHIP
        fixes = (state.pos[c.p, c.r] == 0) & (state.pos[c.p, 0] != 0)
        breaks = state.pos[c.p, 0] == 0
        return torch.where(is_lead, torch.where(
            fixes, -1.0, torch.where(breaks, 1.0, 0.0)), 0.0)

    def accepts(self, state, ctx, c):
        return _ones(c)

    def collective_guard(self, state, ctx, c, earlier):
        return _ones(c)              # partition-local


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
