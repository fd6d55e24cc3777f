"""Search state: the analyzer's device-resident view of the cluster.

Port of ``cruise_control_tpu/analyzer/state.py``. The optimization state is
a dataclass of tensors with *incrementally maintained* broker aggregates:
applying a move touches two rows of each aggregate instead of re-reducing
the whole model.

Terminology:
- ``B1 = padded_brokers + 1``: broker-indexed tensors carry one trailing
  sentinel row for empty replica slots.
- A *candidate* is one potential balancing action (ref
  ``BalancingAction.java:20``), a struct-of-arrays scored elementwise.

Float32 aggregates are built and updated through the ordered segment sum
(KB), in the reference's scatter-add order; slot writes of candidates that
do not apply are routed to a discard row, never to an out-of-range index.
Index tensors are int64 inside the search (the model keeps int32).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..core.resources import NUM_RESOURCES, Resource
from ..kernels import ordered_segment_sum
from ..model.flat import (MOVE_INTER_BROKER, MOVE_LEADERSHIP, MOVE_SWAP,
                          FlatClusterModel, replica_loads)

# Metric selectors: which per-broker aggregate a goal balances/caps.
METRIC_CPU = ("util", Resource.CPU)
METRIC_NW_IN = ("util", Resource.NW_IN)
METRIC_NW_OUT = ("util", Resource.NW_OUT)
METRIC_DISK = ("util", Resource.DISK)
METRIC_REPLICA_COUNT = ("count", None)
METRIC_LEADER_COUNT = ("leaders", None)
METRIC_POTENTIAL_NW_OUT = ("potential", None)
METRIC_LEADER_NW_IN = ("leader_nw_in", None)


class _Replaceable:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class SearchContext(_Replaceable):
    """Immutable per-optimization inputs (loads, topology, option masks)."""

    leader_load: torch.Tensor        # f32[P, 4]
    follower_load: torch.Tensor      # f32[P, 4]
    partition_topic: torch.Tensor    # i32[P]
    partition_valid: torch.Tensor    # bool[P]
    broker_capacity: torch.Tensor    # f32[B1, 4] (sentinel row: 0)
    broker_rack: torch.Tensor        # i32[B1] (sentinel: -1)
    broker_set: torch.Tensor         # i32[B1] (sentinel: -1)
    broker_alive: torch.Tensor       # bool[B1]
    broker_valid: torch.Tensor       # bool[B1]
    dest_allowed: torch.Tensor       # bool[B1] — may receive replicas
    leader_dest_allowed: torch.Tensor  # bool[B1] — may receive leadership
    #: un-steered copy of dest_allowed (swaps ignore the engine's steering)
    raw_dest_allowed: torch.Tensor   # bool[B1]
    movable: torch.Tensor            # bool[P, R] — replica may be relocated
    leadership_movable: torch.Tensor  # bool[P]

    @property
    def num_brokers_padded(self) -> int:
        return self.broker_capacity.shape[-2] - 1


@dataclass
class SearchState(_Replaceable):
    """Optimization state, updated functionally (every apply returns a new
    state; the caller's tensors are never written)."""

    rb: torch.Tensor              # i64[P, R] replica -> broker (sentinel = empty)
    pos: torch.Tensor             # i64[P, R] preferred-order position per slot
    offline: torch.Tensor         # bool[P, R] replica must move
    util: torch.Tensor            # f32[B1, 4]
    replica_count: torch.Tensor   # i32[B1]
    leader_count: torch.Tensor    # i32[B1]
    potential_nw_out: torch.Tensor  # f32[B1]
    leader_nw_in: torch.Tensor    # f32[B1]
    topic_counts: torch.Tensor | None        # i32[T, B1] or None
    topic_leader_counts: torch.Tensor | None  # i32[T, B1] or None
    moves_applied: torch.Tensor   # i64 scalar — total actions applied so far


@dataclass
class Candidates(_Replaceable):
    """A batch of N candidate balancing actions (struct-of-arrays). Delta
    fields are signed from the destination's perspective; swaps carry the
    counterpart replica in (p2, r2), other kinds ``p2 == p``/``r2 == r``."""

    p: torch.Tensor            # i64[N] partition row
    r: torch.Tensor            # i64[N] replica slot
    p2: torch.Tensor           # i64[N] swap counterpart partition
    r2: torch.Tensor           # i64[N] swap counterpart slot
    src: torch.Tensor          # i64[N] source broker
    dst: torch.Tensor          # i64[N] destination broker
    kind: torch.Tensor         # i64[N]
    valid: torch.Tensor        # bool[N]
    must: torch.Tensor         # bool[N] moves an offline replica
    d_util_src: torch.Tensor   # f32[N, 4]
    d_util_dst: torch.Tensor   # f32[N, 4]
    d_cnt: torch.Tensor        # i32[N]
    d_lead: torch.Tensor       # i32[N]
    d_pot: torch.Tensor        # f32[N]
    d_lni: torch.Tensor        # f32[N]

    def take(self, idx: torch.Tensor) -> "Candidates":
        return Candidates(**{f.name: getattr(self, f.name)[idx]
                             for f in dataclasses.fields(self)})


def init_state(model: FlatClusterModel, *,
               with_topic_counts: int | None = None,
               with_topic_leader_counts: bool = False) -> SearchState:
    """Build the search state from a flat model (one full reduction; all
    later updates are incremental). ``rb``/``pos``/``offline`` are fresh
    tensors: the caller's model must survive to be diffed against the
    optimized placement.

    A model whose fields carry a leading scenario axis (``[S, P, R]``
    placements, ``[S, B, 4]`` capacities — the what-if batch) gives a
    state with the same leading axis: each float aggregate is one ordered
    segment sum with a batch axis, which adds every scenario's rows into
    its own B1 brokers in (partition, slot) order, the order of the
    reference's vmapped scatter-add. Topic counts (``[..., T, B1]``) come
    from each scenario's own placement and validity."""
    rb = model.replica_broker.long().clone()               # [..., P, R]
    lead = tuple(rb.shape[:-2])
    S = math.prod(lead)
    B = model.num_brokers_padded
    B1 = B + 1
    dev = model.device
    # KB's ids: the model's int32 brokers, one row of ids a scenario
    brokers = model.replica_broker.reshape(S, -1)           # [S, P*R]
    lead_brokers = model.replica_broker[..., 0].reshape(S, -1)
    loads = replica_loads(model).reshape(S, -1, NUM_RESOURCES)
    util = ordered_segment_sum(loads, brokers, B1).reshape(
        lead + (B1, NUM_RESOURCES))
    util[..., B, :] = 0.0

    scen = (torch.arange(S, device=dev) * B1).reshape(lead + (1, 1))
    seg = rb + scen                                         # [..., P, R]
    flat_idx = seg.reshape(-1)
    lead_idx = seg[..., 0].reshape(-1)
    valid = model.replica_valid
    counts = torch.zeros(S * B1, dtype=torch.int32, device=dev).index_add_(
        0, flat_idx, torch.ones_like(flat_idx, dtype=torch.int32)).reshape(
        lead + (B1,))
    counts[..., B] = 0
    leaders = torch.zeros(S * B1, dtype=torch.int32, device=dev).index_add_(
        0, lead_idx, model.partition_valid.reshape(-1).to(torch.int32)
    ).reshape(lead + (B1,))
    leaders[..., B] = 0
    pot = torch.where(valid, model.leader_load[..., None, Resource.NW_OUT],
                      0.0)
    potential = ordered_segment_sum(pot.reshape(S, -1), brokers,
                                    B1).reshape(lead + (B1,))
    potential[..., B] = 0.0
    lni = torch.where(model.partition_valid,
                      model.leader_load[..., Resource.NW_IN], 0.0)
    leader_nw_in = ordered_segment_sum(lni.reshape(S, -1), lead_brokers,
                                       B1).reshape(lead + (B1,))
    leader_nw_in[..., B] = 0.0

    topic_counts = None
    topic_leader_counts = None
    if with_topic_leader_counts and with_topic_counts is None:
        raise ValueError("with_topic_leader_counts requires the topic count "
                         "(pass with_topic_counts=num_topics)")
    if with_topic_counts is not None:
        # Integer scatter-adds are exact in any order. Each scenario adds
        # its own placement into its own [T, B1] table (flat offset
        # s * T * B1); padding partitions (topic -1) add nothing.
        T = with_topic_counts
        tscen = (torch.arange(S, device=dev) * (T * B1)).reshape(lead + (1,))
        topic = model.partition_topic.long()                # [..., P]
        tok = (topic >= 0) & (topic < T)
        ok = valid & tok[..., None]
        idx = torch.where(ok, (topic * B1 + tscen)[..., None] + rb, 0)
        tc = torch.zeros(S * T * B1, dtype=torch.int32,
                         device=dev).index_add_(
            0, idx.reshape(-1), ok.reshape(-1).to(torch.int32))
        topic_counts = tc.reshape(lead + (T, B1))
        topic_counts[..., B] = 0
        if with_topic_leader_counts:
            lok = model.partition_valid & tok
            lidx = torch.where(lok, topic * B1 + tscen + rb[..., 0], 0)
            tlc = torch.zeros(S * T * B1, dtype=torch.int32,
                              device=dev).index_add_(
                0, lidx.reshape(-1), lok.reshape(-1).to(torch.int32))
            topic_leader_counts = tlc.reshape(lead + (T, B1))
            topic_leader_counts[..., B] = 0

    pos = model.replica_pref_pos.long().clone()
    # A replica hosted on a dead (or padding) broker is offline whether or
    # not the model builder flagged it (ref Replica.isCurrentOffline).
    alive1 = torch.cat([model.broker_alive & model.broker_valid,
                        torch.zeros(lead + (1,), dtype=torch.bool,
                                    device=dev)], dim=-1)
    on_alive = torch.gather(alive1.reshape(S, B1), 1,
                            rb.reshape(S, -1)).reshape(rb.shape)
    offline = model.replica_offline | (valid & ~on_alive)
    return SearchState(rb=rb, pos=pos, offline=offline,
                       util=util, replica_count=counts, leader_count=leaders,
                       potential_nw_out=potential, leader_nw_in=leader_nw_in,
                       topic_counts=topic_counts,
                       topic_leader_counts=topic_leader_counts,
                       moves_applied=torch.zeros(lead, dtype=torch.int64,
                                                 device=dev))


def build_context(model: FlatClusterModel, *,
                  excluded_partitions: torch.Tensor | None = None,
                  excluded_brokers_for_replica_move: torch.Tensor | None = None,
                  excluded_brokers_for_leadership: torch.Tensor | None = None
                  ) -> SearchContext:
    """Assemble the immutable context. Exclusion masks follow
    ``OptimizationOptions`` semantics: replicas of excluded topics never move
    unless offline; excluded brokers never receive replicas / leadership.
    A model with a leading scenario axis gives a context with the same
    axis (the exclusion masks are then per broker or partition row, shared
    by every scenario)."""
    axis = model.replica_broker.dim() - 2        # the broker axis: 0 or 1

    def _pad1(arr, fill):
        shape = list(arr.shape)
        shape[axis] = 1
        return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                          device=arr.device)], dim=axis)

    alive = _pad1(model.broker_alive & model.broker_valid, False)
    bvalid = _pad1(model.broker_valid, False)
    capacity = _pad1(model.broker_capacity, 0.0)
    rack = _pad1(model.broker_rack, -1)
    bset = _pad1(model.broker_set, -1)

    def _pad_mask(mask):
        return torch.cat([mask, torch.ones(1, dtype=torch.bool,
                                           device=mask.device)])

    # Brokers with broken disks stay alive but may not RECEIVE replicas.
    dest = alive & ~_pad1(model.broker_broken_disk, True)
    if excluded_brokers_for_replica_move is not None:
        dest = dest & ~_pad_mask(excluded_brokers_for_replica_move)
    lead_dest = alive & ~_pad1(model.broker_demoted, True)
    if excluded_brokers_for_leadership is not None:
        lead_dest = lead_dest & ~_pad_mask(excluded_brokers_for_leadership)

    slot_valid = model.replica_valid
    if excluded_partitions is None:
        excluded_partitions = torch.zeros(model.num_partitions_padded,
                                          dtype=torch.bool,
                                          device=model.device)
    movable = slot_valid & ~excluded_partitions[:, None]
    leadership_movable = model.partition_valid & ~excluded_partitions

    return SearchContext(
        leader_load=model.leader_load, follower_load=model.follower_load,
        partition_topic=model.partition_topic,
        partition_valid=model.partition_valid,
        broker_capacity=capacity, broker_rack=rack, broker_set=bset,
        broker_alive=alive,
        broker_valid=bvalid, dest_allowed=dest,
        leader_dest_allowed=lead_dest, raw_dest_allowed=dest,
        movable=movable,
        leadership_movable=leadership_movable)


# ---------------------------------------------------------------------------
# Metric access
# ---------------------------------------------------------------------------

def metric_values(state: SearchState, metric) -> torch.Tensor:
    """f32[B1] (or [S, B1]) — current value of the balanced metric on
    every broker."""
    which, res = metric
    if which == "util":
        return state.util[..., int(res)]
    if which == "count":
        return state.replica_count.to(torch.float32)
    if which == "leaders":
        return state.leader_count.to(torch.float32)
    if which == "potential":
        return state.potential_nw_out
    if which == "leader_nw_in":
        return state.leader_nw_in
    raise ValueError(f"unknown metric {metric}")


def metric_deltas(cand: Candidates, metric):
    """(d_src, d_dst) f32[N] — metric change on source/destination rows."""
    which, res = metric
    if which == "util":
        return cand.d_util_src[..., int(res)], cand.d_util_dst[..., int(res)]
    if which == "count":
        d = cand.d_cnt.to(torch.float32)
        return -d, d
    if which == "leaders":
        d = cand.d_lead.to(torch.float32)
        return -d, d
    if which == "potential":
        return -cand.d_pot, cand.d_pot
    if which == "leader_nw_in":
        return -cand.d_lni, cand.d_lni
    raise ValueError(f"unknown metric {metric}")


# ---------------------------------------------------------------------------
# Candidate construction
# ---------------------------------------------------------------------------

def _full(like: torch.Tensor, value, dtype) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=dtype, device=like.device)


def make_move_candidates(state: SearchState, ctx: SearchContext,
                         p: torch.Tensor, r: torch.Tensor, dst: torch.Tensor,
                         valid: torch.Tensor) -> Candidates:
    """Inter-broker replica relocation candidates."""
    p, r, dst = p.long(), r.long(), dst.long()
    src = state.rb[p, r]
    is_leader = r == 0
    load = torch.where(is_leader[..., None], ctx.leader_load[p],
                       ctx.follower_load[p])                        # [N, 4]
    d_pot = ctx.leader_load[p, Resource.NW_OUT]
    d_lni = torch.where(is_leader, ctx.leader_load[p, Resource.NW_IN], 0.0)
    return Candidates(
        p=p, r=r, p2=p, r2=r, src=src, dst=dst,
        kind=_full(p, MOVE_INTER_BROKER, torch.int64), valid=valid,
        must=state.offline[p, r] & valid,
        d_util_src=-load, d_util_dst=load,
        d_cnt=_full(p, 1, torch.int32),
        d_lead=is_leader.to(torch.int32),
        d_pot=d_pot, d_lni=d_lni)


def make_leadership_candidates(state: SearchState, ctx: SearchContext,
                               p: torch.Tensor, r: torch.Tensor,
                               valid: torch.Tensor) -> Candidates:
    """Leadership transfer candidates: slot ``r`` becomes the leader."""
    p, r = p.long(), r.long()
    src = state.rb[p, 0]
    dst = state.rb[p, r]
    dload = ctx.leader_load[p] - ctx.follower_load[p]              # [N, 4]
    return Candidates(
        p=p, r=r, p2=p, r2=r, src=src, dst=dst,
        kind=_full(p, MOVE_LEADERSHIP, torch.int64), valid=valid,
        must=_full(p, False, torch.bool),
        d_util_src=-dload, d_util_dst=dload,
        d_cnt=_full(p, 0, torch.int32),
        d_lead=_full(p, 1, torch.int32),
        d_pot=_full(p, 0.0, torch.float32),
        d_lni=ctx.leader_load[p, Resource.NW_IN])


def make_swap_candidates(state: SearchState, ctx: SearchContext,
                         p1: torch.Tensor, r1: torch.Tensor,
                         p2: torch.Tensor, r2: torch.Tensor,
                         valid: torch.Tensor) -> Candidates:
    """Inter-broker replica *swap* candidates: replica (p1, r1) on ``src``
    trades places with replica (p2, r2) on ``dst`` (count-neutral)."""
    p1, r1, p2, r2 = p1.long(), r1.long(), p2.long(), r2.long()
    src = state.rb[p1, r1]
    dst = state.rb[p2, r2]
    lead1 = r1 == 0
    lead2 = r2 == 0
    load1 = torch.where(lead1[..., None], ctx.leader_load[p1],
                        ctx.follower_load[p1])
    load2 = torch.where(lead2[..., None], ctx.leader_load[p2],
                        ctx.follower_load[p2])
    net = load1 - load2              # arrives at dst; leaves src
    pot1 = ctx.leader_load[p1, Resource.NW_OUT]
    pot2 = ctx.leader_load[p2, Resource.NW_OUT]
    lni1 = torch.where(lead1, ctx.leader_load[p1, Resource.NW_IN], 0.0)
    lni2 = torch.where(lead2, ctx.leader_load[p2, Resource.NW_IN], 0.0)
    return Candidates(
        p=p1, r=r1, p2=p2, r2=r2, src=src, dst=dst,
        kind=_full(p1, MOVE_SWAP, torch.int64), valid=valid,
        must=_full(p1, False, torch.bool),
        d_util_src=-net, d_util_dst=net,
        d_cnt=_full(p1, 0, torch.int32),
        d_lead=lead1.to(torch.int32) - lead2.to(torch.int32),
        d_pot=pot1 - pot2,
        d_lni=lni1 - lni2)


def concat_candidates(a: Candidates, b: Candidates) -> Candidates:
    return Candidates(**{f.name: torch.cat([getattr(a, f.name),
                                            getattr(b, f.name)])
                         for f in dataclasses.fields(a)})


# ---------------------------------------------------------------------------
# Legality
# ---------------------------------------------------------------------------

def base_legality(state: SearchState, ctx: SearchContext,
                  c: Candidates) -> torch.Tensor:
    """bool[N]. Re-evaluable against a *changed* state: includes staleness
    checks (the slot still holds the broker captured at proposal time)."""
    row = state.rb[c.p]                                            # [N, R]
    slot_broker = state.rb[c.p, c.r]
    is_move = c.kind == MOVE_INTER_BROKER

    hosts_dst = (row == c.dst[..., None]).any(dim=-1)
    # Offline replicas are movable even when their topic is excluded.
    movable = ctx.movable[c.p, c.r] | state.offline[c.p, c.r]
    lead_dest_dst = ctx.leader_dest_allowed[c.dst]
    move_ok = (movable
               & (slot_broker == c.src)
               & ctx.dest_allowed[c.dst]
               & ~hosts_dst
               & (c.dst != c.src)
               # relocating the leader replica implies moving leadership too
               & ((c.r != 0) | lead_dest_dst))

    lead_ok = ((c.r > 0)
               & ctx.leadership_movable[c.p]
               & (state.rb[c.p, 0] == c.src)
               & (slot_broker == c.dst)
               & lead_dest_dst
               & ~state.offline[c.p, c.r])

    row2 = state.rb[c.p2]                                          # [N, R]
    hosts_src2 = (row2 == c.src[..., None]).any(dim=-1)
    movable2 = ctx.movable[c.p2, c.r2] | state.offline[c.p2, c.r2]
    swap_ok = (movable
               & movable2
               & (c.p != c.p2)
               & (slot_broker == c.src)
               & (state.rb[c.p2, c.r2] == c.dst)
               & (c.src != c.dst)
               & ctx.dest_allowed[c.dst]
               & ctx.dest_allowed[c.src]
               & ~hosts_dst
               & ~hosts_src2
               & ((c.r != 0) | lead_dest_dst)
               & ((c.r2 != 0) | ctx.leader_dest_allowed[c.src]))

    is_lead = c.kind == MOVE_LEADERSHIP
    return c.valid & torch.where(is_move, move_ok,
                                 torch.where(is_lead, lead_ok, swap_ok))


# ---------------------------------------------------------------------------
# Applying candidates
# ---------------------------------------------------------------------------

def apply_group(state: SearchState, ctx: SearchContext, c: Candidates,
                do: torch.Tensor) -> SearchState:
    """Apply a *partition-disjoint group* of candidates at once.

    Precondition (the engine's grouping): among candidates with
    ``do=True`` all partition rows (``p`` and swap counterpart ``p2``) are
    distinct. Slot writes of candidates with ``do=False`` go to a discard
    row ``P`` (sliced off), so they can never clobber a real update. Broker
    aggregates take every candidate's delta (zero when not applied) in
    candidate order — all source rows, then all destination rows — through
    the ordered segment sum, exactly the reference's two scatter-adds.
    """
    p, r = c.p, c.r
    is_move = (c.kind == MOVE_INTER_BROKER) & do
    is_lead = (c.kind == MOVE_LEADERSHIP) & do
    is_swap = (c.kind == MOVE_SWAP) & do
    mv = is_move | is_swap

    rb, pos, off = state.rb, state.pos, state.offline
    P, R = rb.shape
    pw = torch.where(do, p, P)
    cur_slot = rb[p, r]
    cur0 = rb[p, 0]
    new_slot = torch.where(mv, c.dst, cur0)
    new0 = torch.where(is_lead, cur_slot,
                       torch.where(mv & (r == 0), c.dst, cur0))
    rbx = torch.cat([rb, rb.new_zeros((1, R))])
    rbx[pw, r] = new_slot
    rbx[pw, 0] = new0
    p2w = torch.where(is_swap, c.p2, P)
    rbx[p2w, c.r2] = c.src

    pos_r, pos_0 = pos[p, r], pos[p, 0]
    posx = torch.cat([pos, pos.new_zeros((1, R))])
    posx[pw, r] = torch.where(is_lead, pos_0, pos_r)
    posx[pw, 0] = torch.where(is_lead, pos_r, pos_0)

    off_r, off_0 = off[p, r], off[p, 0]
    new_off_r = ~mv & torch.where(is_lead, off_0, off_r)
    new_off_0 = torch.where(is_lead, off_r, ~(mv & (r == 0)) & off_0)
    offx = torch.cat([off, off.new_zeros((1, R))])
    offx[pw, r] = new_off_r
    offx[pw, 0] = new_off_0
    offx[p2w, c.r2] = False

    # Float aggregates: util (4 planes), potential NW_OUT and leader NW_IN
    # ride one ordered segment sum — every source row first, then every
    # destination row, each in candidate order (zero deltas for candidates
    # that do not apply, like the reference's masked scatter-adds).
    dof = do[:, None]
    dpot = torch.where(mv, c.d_pot, 0.0)
    dlni = torch.where(do, c.d_lni, 0.0)
    src_planes = torch.cat([torch.where(dof, c.d_util_src, 0.0),
                            -dpot[:, None], -dlni[:, None]], dim=1)
    dst_planes = torch.cat([torch.where(dof, c.d_util_dst, 0.0),
                            dpot[:, None], dlni[:, None]], dim=1)
    base = torch.cat([state.util, state.potential_nw_out[:, None],
                      state.leader_nw_in[:, None]], dim=1)
    B1 = base.shape[0]
    agg = ordered_segment_sum(torch.cat([src_planes, dst_planes]),
                              torch.cat([c.src, c.dst]), B1, base=base)
    util = agg[:, :NUM_RESOURCES]
    potential = agg[:, NUM_RESOURCES]
    lni = agg[:, NUM_RESOURCES + 1]

    def int_delta(agg_int, d):
        return (agg_int.index_add(0, c.src, -d)
                .index_add(0, c.dst, d))

    counts = int_delta(state.replica_count,
                       torch.where(is_move, c.d_cnt, 0))
    leaders = int_delta(state.leader_count, torch.where(do, c.d_lead, 0))

    def topic_delta(agg_tb, moves):
        """Signed adds into a [T, B1] table through its flat index; rows of
        padding partitions (topic -1) go to a discard cell, sliced off."""
        T = agg_tb.shape[0]
        flat = torch.cat([agg_tb.reshape(-1), agg_tb.new_zeros(1)])
        for topic, broker, d in moves:
            ok = (topic >= 0) & (topic < T)
            flat = flat.index_add(0, torch.where(ok, topic * B1 + broker,
                                                 T * B1), d)
        return flat[:-1].reshape(agg_tb.shape)

    t1 = ctx.partition_topic[p].long()
    t2 = ctx.partition_topic[c.p2].long()
    topic_counts = state.topic_counts
    if topic_counts is not None:
        tc = torch.where(mv, 1, 0).to(torch.int32)
        tc2 = torch.where(is_swap, 1, 0).to(torch.int32)
        # the swap counterpart's topic travels the other way
        topic_counts = topic_delta(topic_counts, (
            (t1, c.src, -tc), (t1, c.dst, tc),
            (t2, c.dst, -tc2), (t2, c.src, tc2)))

    topic_leader_counts = state.topic_leader_counts
    if topic_leader_counts is not None:
        # Leadership of p lands on dst for transfers and leader-replica
        # (r == 0) moves/swaps; a swap counterpart with r2 == 0 hauls p2's
        # leadership to src.
        d1 = torch.where(is_lead | (mv & (r == 0)), 1, 0).to(torch.int32)
        d2 = torch.where(is_swap & (c.r2 == 0), 1, 0).to(torch.int32)
        topic_leader_counts = topic_delta(topic_leader_counts, (
            (t1, c.src, -d1), (t1, c.dst, d1),
            (t2, c.dst, -d2), (t2, c.src, d2)))

    return state.replace(rb=rbx[:P], pos=posx[:P], offline=offx[:P],
                         util=util, replica_count=counts,
                         leader_count=leaders,
                         potential_nw_out=potential, leader_nw_in=lni,
                         topic_counts=topic_counts,
                         topic_leader_counts=topic_leader_counts,
                         moves_applied=state.moves_applied + do.sum())


def to_model(state: SearchState, template: FlatClusterModel) -> FlatClusterModel:
    """Re-wrap the optimized assignment as a FlatClusterModel (``pos`` is
    the per-slot preferred-order position)."""
    return template.replace(
        replica_broker=state.rb.to(template.replica_broker.dtype),
        replica_offline=state.offline,
        replica_pref_pos=state.pos.to(template.replica_pref_pos.dtype))
