"""Goal kernels — the reference's goal catalog as vectorized cost functions.

Port of ``cruise_control_tpu/analyzer/goals.py``, part A: the helpers, the
parametric :class:`IntervalGoal` with both bulk drains and its candidate
generators, and the capacity/distribution goals of the dry-run proposal
path. Each goal is four functions over the :mod:`state` tensors —
``violation`` (scalar residual, 0 == satisfied), ``propose`` (candidate
batch), ``delta`` (per-candidate residual change), ``accepts`` (acceptance
once the goal was optimized earlier in the chain) — plus the engine's
``collective_guard``.

Exactness: tie-break noise comes from the port's threefry stream, sorts and
top-k are stable, float sums and prefix sums run in the reference's order
(:mod:`..utils.ordered`), and every out-of-range index of the reference
(clamped gathers, dropped scatters) is an explicit mask here.
"""

from __future__ import annotations

import fnmatch

import torch

from .. import _random
from ..core.resources import Resource
from ..kernels import net_broker_flow, ordered_segment_sum
from ..model.flat import MOVE_INTER_BROKER, MOVE_LEADERSHIP, MOVE_SWAP
from ..utils.ordered import (argsort, fma, lane_row_sum, lexsort,
                              scan_sum, top_k, tree_sum, tree_sum_last)
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
    return scale * _random.uniform(key, shape)


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
    krep, kdst = _random.split(key)

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
        if penalty.dim() == 1 and self._cap_factor(ctx) is not None:
            # A per-broker capacity bound keeps XLA's unbatched fused row
            # sum in tree order.
            return tree_sum(penalty)
        # Against scalar bounds (and in the vmapped scorer) XLA vectorizes
        # the fused sum of a row of 24-32 brokers into eight lanes.
        return lane_row_sum(penalty)

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
        noise = fma(0.01, _random.uniform(key, (P, R)), 1.0)
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

        noise = fma(0.01, _random.uniform(key, (P,)), 1.0)
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
            kg, key = _random.split(key)
            parts.append(self._flow_candidates(state, ctx, kg, cfg, values,
                                               lo, up, excess, deficit))
            if cfg.num_swap_candidates > 0 and self.metric[0] != "count":
                ks, key = _random.split(key)
                parts.append(self._swap_candidates(state, ctx, ks, cfg,
                                                   values, lo, up, excess,
                                                   deficit))
        if self.actions in ("leadership", "both"):
            src_b = state.rb[:, 0:1]                                # [P, 1]
            dst_b = state.rb                                        # [P, R]
            gain = _norm01(excess)[src_b] + _norm01(deficit)[dst_b]
            prio = torch.where((excess[src_b] > 0.0) | (deficit[dst_b] > 0.0),
                               gain, _NEG)
            kl, key = _random.split(key)
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
        krep, kdst = _random.split(key)

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
        kh, kl, kshift = _random.split(key, 3)
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


#: ROADMAP item that ports the rest of the catalog
_PART_B = "ROADMAP Queue 1 item 8 (analyzer/goals.py part B)"


class MinTopicLeadersPerBrokerGoal(GoalKernel):
    """Every alive broker must lead at least ``min_count`` partitions of each
    *interested* topic (ref ``MinTopicLeadersPerBrokerGoal.java``; hard).

    Ported in its inactive form only — the reference default, with no
    interested topics — which is what the off-chain hard-goal audit meets:
    violation 0, no candidates, every action accepted. Binding a pattern
    that matches a topic raises until the active form lands."""

    name = "MinTopicLeadersPerBrokerGoal"
    hard = True

    def __init__(self, constraint: BalancingConstraint, *,
                 topic_pattern: str | None = None,
                 min_count: int | None = None):
        self.constraint = constraint
        self.topic_pattern = (topic_pattern if topic_pattern is not None
                              else constraint.topics_with_min_leaders_per_broker)
        self.min_count = (min_count if min_count is not None
                          else constraint.min_topic_leaders_per_broker)

    def bind(self, metadata) -> "MinTopicLeadersPerBrokerGoal":
        if not self.topic_pattern:
            return self
        if any(fnmatch.fnmatch(t, self.topic_pattern)
               for t in metadata.topics):
            raise NotImplementedError(
                f"{self.name} with interested topics (pattern "
                f"{self.topic_pattern!r}) is not yet ported: {_PART_B}")
        return self

    def bind_signature(self):
        return (self.min_count, self.topic_pattern, None)

    def violation(self, state, ctx):
        return _zeros_per_scenario(ctx)

    def propose(self, state, ctx, key, cfg):
        # An all-invalid batch keeps the engine's shapes uniform.
        return _top_leadership(state, ctx, key, cfg,
                               torch.full(state.rb.shape, _NEG,
                                          device=state.rb.device))

    def delta(self, state, ctx, c):
        return torch.zeros(c.p.shape, dtype=torch.float32, device=c.p.device)

    def accepts(self, state, ctx, c):
        return torch.ones(c.p.shape, dtype=torch.bool, device=c.p.device)

    def collective_guard(self, state, ctx, c, earlier):
        return torch.ones(c.p.shape, dtype=torch.bool, device=c.p.device)


#: The reference's default chain in priority order
#: (``config/cruisecontrol.properties:96``) with each goal's hardness.
DEFAULT_GOALS = (
    ("RackAwareGoal", True),
    ("MinTopicLeadersPerBrokerGoal", True),
    ("ReplicaCapacityGoal", True),
    ("DiskCapacityGoal", True),
    ("NetworkInboundCapacityGoal", True),
    ("NetworkOutboundCapacityGoal", True),
    ("CpuCapacityGoal", True),
    ("ReplicaDistributionGoal", False),
    ("PotentialNwOutGoal", False),
    ("DiskUsageDistributionGoal", False),
    ("NetworkInboundUsageDistributionGoal", False),
    ("NetworkOutboundUsageDistributionGoal", False),
    ("CpuUsageDistributionGoal", False),
    ("TopicReplicaDistributionGoal", False),
    ("LeaderReplicaDistributionGoal", False),
    ("LeaderBytesInDistributionGoal", False),
)

GOAL_REGISTRY = {
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": lambda cst: CapacityGoal(Resource.DISK, cst),
    "NetworkInboundCapacityGoal": lambda cst: CapacityGoal(Resource.NW_IN, cst),
    "NetworkOutboundCapacityGoal": lambda cst: CapacityGoal(Resource.NW_OUT, cst),
    "CpuCapacityGoal": lambda cst: CapacityGoal(Resource.CPU, cst),
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "DiskUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.DISK, cst),
    "NetworkInboundUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.NW_IN, cst),
    "NetworkOutboundUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.NW_OUT, cst),
    "CpuUsageDistributionGoal": lambda cst: ResourceDistributionGoal(Resource.CPU, cst),
    "MinTopicLeadersPerBrokerGoal": MinTopicLeadersPerBrokerGoal,
}

#: Catalog goals the reference registers that this port does not carry yet.
NOT_YET_PORTED = frozenset({
    "RackAwareGoal", "PotentialNwOutGoal", "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
    "PreferredLeaderElectionGoal", "BrokerSetAwareGoal",
    "RackAwareDistributionGoal", "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal"})

#: Documented relaxations of registered hard goals (names only: a chain
#: carrying an alternative satisfies the strict form's audit).
HARD_GOAL_ALTERNATIVES = {
    "RackAwareGoal": ("RackAwareDistributionGoal",
                      "KafkaAssignerEvenRackAwareGoal"),
}


def short_goal_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def goals_by_name(names: list[str],
                  constraint: BalancingConstraint | None = None
                  ) -> list[GoalKernel]:
    cst = constraint or BalancingConstraint()
    out = []
    for n in names:
        short = short_goal_name(n)
        if short in NOT_YET_PORTED:
            raise ValueError(f"goal {n!r} is not yet ported to "
                             f"cruise_control_tpu_torch: {_PART_B}")
        if short not in GOAL_REGISTRY:
            raise ValueError(f"unknown goal {n!r}")
        out.append(GOAL_REGISTRY[short](cst))
    return out


def default_goals(constraint: BalancingConstraint | None = None
                  ) -> list[GoalKernel]:
    """The reference's default chain. Raises ``ValueError`` until every
    member is ported (RackAwareGoal and the rest of part B)."""
    return goals_by_name([name for name, _hard in DEFAULT_GOALS], constraint)
