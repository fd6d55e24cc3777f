"""Device-side move scheduling: batched conflict-aware batching.

Port of ``cruise_control_tpu/executor/schedule.py``. The host greedy
planner (``planner.ExecutionTaskPlanner.inter_broker_batch``) walks the
strategy-ordered task list once per round, occupying per-broker
concurrency slots. Here the ENTIRE batch assignment is one launch of the
first-fit kernel (KE): move *i* lands in the lowest-indexed batch whose
touched brokers all have spare concurrency cap, the batch is under the
cluster movement cap, and (optionally) the per-destination bandwidth
budget holds.

First-fit over the strategy order is identical to running the host greedy
batcher to quiescence batch-by-batch: greedy round *k* takes, in order,
every remaining move whose brokers have spare cap in round *k* — exactly
the set first-fit assigns index *k*.

Intermediate-placement safety: every batch boundary's placement — the
initial model with the first *c* scheduled moves applied — is scored by
the what-if batch scorer (``make_scenario_scorer`` with no-op scenario
parameters, the same ``violated_matrix`` cutoff) against the registered
hard-goal audit set, all boundaries in one batch. A violating boundary
triggers bisection repair: the first offending batch splits in two, the
boundaries re-audit, bounded rounds.

Not ported: the reference's ``collector``/``tracer`` (the port has no
sensors yet; ROADMAP queue 1 item 11) and its program caches (eager
PyTorch compiles nothing).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import first_fit
from ..model.flat import FlatClusterModel
from ..model.proposals import ExecutionProposal
from ..parallel.batching import pow2_bucket
from ..utils.device import resolve_device
from .concurrency import ExecutionConcurrencyManager
from .planner import ExecutionTaskPlanner
from .strategy import StrategyContext
from .tasks import ExecutionTask, TaskType

logger = logging.getLogger(__name__)

#: Sentinel per-broker cap for the padding broker row — large enough to
#: never constrain, small enough to stay an exact int32.
_PAD_CAP = 1 << 30


@dataclass
class MoveSchedule:
    """A full batch assignment for one execution's inter-broker moves.

    ``batches`` holds tuples of indices into the ORIGINAL proposal list
    the scheduler was given. Batch order is execution order; the order
    within a batch is the strategy order, same as the host planner emits.
    """

    batches: list[tuple[int, ...]]
    #: per-batch estimated copy time (max over destination brokers of
    #: inbound MB / throttled rate), None when no throttle rate is known
    eta_ms: list[float | None]
    stats: dict = field(default_factory=dict)

    @property
    def num_moves(self) -> int:
        return sum(len(b) for b in self.batches)

    def to_json(self) -> dict:
        return {"numBatches": len(self.batches),
                "numMoves": self.num_moves,
                "batchSizes": [len(b) for b in self.batches],
                "etaMs": [None if e is None else round(e, 1)
                          for e in self.eta_ms],
                "stats": dict(self.stats)}


class DeviceMoveScheduler:
    """Batched move scheduling + intermediate-placement audit.
    ``device=None`` means the card and raises without one;
    ``device="cpu"`` runs the kernels' plain twins."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        #: host seconds of the last schedule's first-fit assignment and
        #: boundary audit (each ends in a device-to-host read, so each
        #: includes its device work)
        self.last_timings: dict[str, float] = {}

    # ------------------------------------------------------------ schedule
    def schedule(self, proposals: list[ExecutionProposal],
                 concurrency: ExecutionConcurrencyManager,
                 *,
                 model: FlatClusterModel | None = None,
                 metadata=None,
                 goals=(),
                 capacity_threshold=None,
                 strategy=None,
                 strategy_context: StrategyContext | None = None,
                 throttle_bytes: int | None = None,
                 bandwidth_mb_per_batch: float | None = None,
                 max_repair_rounds: int = 4,
                 strict: bool = False) -> MoveSchedule:
        """Compute the full batch assignment for ``proposals``'
        inter-broker moves.

        ``model``/``metadata``/``goals`` enable the intermediate-boundary
        hard-goal audit (skipped when absent); ``goals`` are BOUND goal
        kernels (the optimizer's registered hard-goal audit set).
        ``strict`` raises when repair cannot clear a boundary violation;
        otherwise the schedule ships with ``stats['unrepaired_violations']``
        set.
        """
        ctx = strategy_context or StrategyContext()
        order = self._strategy_order(proposals, strategy, ctx)
        if not order:
            return MoveSchedule(batches=[], eta_ms=[],
                                stats={"moves": 0, "batches": 0})
        t0 = time.monotonic()
        assign = self._assign(order, proposals, concurrency, metadata, ctx,
                              bandwidth_mb_per_batch)
        t1 = time.monotonic()
        self.last_timings = {"assign_s": t1 - t0, "audit_s": 0.0}
        batches = self._group(order, assign)
        stats = {"moves": len(order), "batches": len(batches),
                 "boundaries_audited": 0, "repair_rounds": 0,
                 "unrepaired_violations": 0, "spilled_moves":
                 int((assign >= _SPILL).sum()) if len(assign) else 0}
        if goals and model is not None and metadata is not None:
            if model.device != self.device:
                raise ValueError(f"model lies on {model.device}, the "
                                 f"scheduler runs on {self.device}")
            batches = self._audit_and_repair(
                batches, proposals, model, metadata, goals,
                capacity_threshold, stats,
                max_repair_rounds=max_repair_rounds, strict=strict)
            self.last_timings["audit_s"] = time.monotonic() - t1
        eta = [self._batch_eta_ms(b, proposals, ctx, throttle_bytes)
               for b in batches]
        stats["batches"] = len(batches)
        return MoveSchedule(batches=batches, eta_ms=eta, stats=stats)

    # ------------------------------------------------------ strategy order
    def _strategy_order(self, proposals, strategy, ctx):
        """Indices of the inter-broker proposals in strategy order —
        exactly the order the host planner's ``begin_phase`` sorts the
        corresponding tasks into."""
        planner = ExecutionTaskPlanner(strategy)
        shims = [ExecutionTask(i, p, TaskType.INTER_BROKER_REPLICA_ACTION)
                 for i, p in enumerate(proposals)
                 if p.has_replica_action]
        shims.sort(key=lambda t: planner.sort_key(t, ctx))
        return [t.execution_id for t in shims]

    # ------------------------------------------------------------- assign
    def _assign(self, order, proposals, concurrency, metadata, ctx,
                bandwidth_mb_per_batch):
        """Run the first-fit kernel; returns ``int32[len(order)]`` batch
        indices aligned with ``order``."""
        inputs = first_fit_inputs(order, proposals, concurrency, metadata,
                                  ctx, bandwidth_mb_per_batch)
        K = inputs["num_batches"]
        dev = self.device
        assign = first_fit(
            *(torch.from_numpy(inputs[k]).to(dev)
              for k in ("rows", "dest_rows", "size_mb", "valid", "caps")),
            inputs["cluster_cap"], inputs["budget"], K).cpu().numpy()
        # Spilled moves (finite-bandwidth corner): sentinel K → trailing
        # singleton batches, marked for stats via the _SPILL offset.
        if (assign >= K).any():
            nxt = int(assign[assign < K].max(initial=-1)) + 1
            for m in np.nonzero(assign >= K)[0]:
                assign[m] = _SPILL + nxt
                nxt += 1
        return assign

    @staticmethod
    def _group(order, assign) -> list[tuple[int, ...]]:
        """Batch index array -> ordered list of original-index tuples."""
        by_k: dict[int, list[int]] = {}
        for pos, k in enumerate(assign):
            by_k.setdefault(int(k) % _SPILL, []).append(order[pos])
        return [tuple(by_k[k]) for k in sorted(by_k)]

    # -------------------------------------------------------------- audit
    def _audit_and_repair(self, batches, proposals, model, metadata,
                          goals, capacity_threshold, stats, *,
                          max_repair_rounds, strict):
        """Score every batch boundary's placement against the hard-goal
        audit set; bisect-split offending batches, bounded rounds."""
        goals = tuple(goals)
        if capacity_threshold is None:
            capacity_threshold = np.ones(4, np.float32)
        for rnd in range(max_repair_rounds + 1):
            bad = self._violating_boundaries(
                batches, proposals, model, metadata, goals,
                capacity_threshold)
            stats["boundaries_audited"] += len(batches)
            if not bad:
                return batches
            if rnd == max_repair_rounds:
                break
            stats["repair_rounds"] += 1
            first = bad[0]
            batch = batches[first]
            if len(batch) <= 1:
                # A single move violating a hard goal mid-flight cannot
                # be split further — the plan itself walks through the
                # violation. Record and stop burning rounds.
                break
            mid = len(batch) // 2
            batches = (batches[:first]
                       + [tuple(batch[:mid]), tuple(batch[mid:])]
                       + batches[first + 1:])
            logger.info("executor.schedule: boundary %d violated hard "
                        "goals; split batch into %d+%d (round %d)",
                        first, mid, len(batch) - mid, rnd + 1)
        stats["unrepaired_violations"] = len(bad)
        msg = (f"move schedule leaves {len(bad)} batch boundaries in "
               f"hard-goal violation after {max_repair_rounds} repair "
               f"rounds")
        if strict:
            raise ScheduleAuditError(msg)
        logger.warning("executor.schedule: %s", msg)
        return batches

    def _violating_boundaries(self, batches, proposals, model, metadata,
                              goals, capacity_threshold):
        """Indices of batches whose post-batch placement violates any
        audit goal — every boundary scored in one batch."""
        from ..whatif.engine import make_scenario_scorer, violated_matrix
        P, R = model.replica_broker.shape
        B = model.num_brokers_padded
        dev = model.device
        # Apply-order: moves sorted by (batch, in-batch position) — the
        # boundary after batch k is then a PREFIX of this order.
        flat = [i for b in batches for i in b]
        M = len(flat)
        prop_rows = np.full((M,), P, np.int64)          # P: discard row
        new_rb = np.full((M, R), B, np.int32)
        for m, i in enumerate(flat):
            p = proposals[i]
            row = metadata.partition_index.get((p.topic, p.partition))
            if row is None:
                continue           # stale proposal; executor validates
            prop_rows[m] = row
            for j, b in enumerate(p.new_replicas[:R]):
                new_rb[m, j] = metadata.broker_index.get(b, B)
        counts = np.cumsum([len(b) for b in batches])
        Kb = len(counts)
        # Boundary k applies the moves m < counts[k]; moves are unique per
        # partition, so each boundary's placement is the template with
        # those partition rows overwritten. Rows of moves not yet applied
        # (and of stale proposals) write to the discard row P.
        applied = (torch.arange(M, device=dev)[None, :]
                   < torch.from_numpy(counts).to(dev)[:, None])   # [Kb, M]
        rows = torch.where(applied, torch.from_numpy(prop_rows).to(dev), P)
        kk = torch.arange(Kb, device=dev)[:, None].expand(Kb, M)

        def boundaries(template, values):
            out = torch.cat([template, template[:1]]).expand(
                (Kb, P + 1) + tuple(template.shape[1:])).clone()
            out[kk, rows] = values
            return out[:, :P]

        slots = torch.arange(R, dtype=torch.int32, device=dev)
        rb = boundaries(model.replica_broker,
                        torch.from_numpy(new_rb).to(dev)[None]
                        .expand(Kb, M, R))
        pref = boundaries(model.replica_pref_pos, slots.expand(Kb, M, R))
        off = boundaries(model.replica_offline,
                         torch.zeros((Kb, M, R), dtype=torch.bool,
                                     device=dev))
        score = make_scenario_scorer(goals, capacity_threshold,
                                     num_topics=metadata.num_topics)
        nb = model.num_brokers_padded
        viol, vscale, *_ = score(
            model.replace(replica_broker=rb, replica_pref_pos=pref,
                          replica_offline=off),
            torch.zeros((Kb, nb), dtype=torch.bool, device=dev),
            torch.zeros((Kb, nb), dtype=torch.bool, device=dev),
            torch.ones((Kb, nb, 4), dtype=torch.float32, device=dev),
            torch.ones((Kb, P), dtype=torch.float32, device=dev),
            model.partition_valid.expand(Kb, P))
        violated = violated_matrix(viol.cpu().numpy(), vscale.cpu().numpy())
        return [k for k in range(Kb) if violated[k].any()]

    # ---------------------------------------------------------------- eta
    @staticmethod
    def _batch_eta_ms(batch, proposals, ctx, throttle_bytes):
        """Estimated batch copy time: worst destination broker's inbound
        MB over the throttled replication rate."""
        if not throttle_bytes:
            return None
        rate_mb_s = float(throttle_bytes) / 1e6
        if rate_mb_s <= 0:
            return None
        inbound: dict[int, float] = {}
        for i in batch:
            p = proposals[i]
            mb = float(ctx.partition_size_mb.get(
                (p.topic, p.partition), 0.0))
            for b in p.replicas_to_add:
                inbound[b] = inbound.get(b, 0.0) + mb
        if not inbound:
            return 0.0
        return max(inbound.values()) / rate_mb_s * 1000.0


def first_fit_inputs(order, proposals, concurrency, metadata, ctx,
                     bandwidth_mb_per_batch) -> dict:
    """The first-fit kernel's inputs for the moves ``order`` (indices into
    ``proposals``, in strategy order): touched and destination broker rows
    ``[M, W]`` (padding: row B), sizes, the valid mask and per-row caps
    as numpy arrays, with the cluster cap, the bandwidth budget and the
    batch bound K. K is rounded up to a power of two, as the reference
    buckets it (K decides which moves spill); the moves are not padded, as
    that served only XLA's compile buckets."""
    M = len(order)
    # Broker-row universe: metadata rows when available (aligns with
    # the audit model), else a dense local index over the ids seen.
    if metadata is not None:
        bindex = metadata.broker_index
        row_ids = list(metadata.broker_ids)
        B = len(row_ids)
    else:
        row_ids = sorted({b for i in order
                          for b in (*proposals[i].replicas_to_add,
                                    *proposals[i].replicas_to_remove)})
        bindex = {b: r for r, b in enumerate(row_ids)}
        B = len(row_ids)
    touched = [tuple(proposals[i].replicas_to_add)
               + tuple(proposals[i].replicas_to_remove)
               for i in order]
    dests = [tuple(proposals[i].replicas_to_add) for i in order]
    W = max((len(t) for t in touched), default=1)
    rows = np.full((M, W), B, np.int32)
    dest_rows = np.full((M, W), B, np.int32)
    touch_count: dict[int, int] = {}
    for m, t in enumerate(touched):
        for j, b in enumerate(t):
            r = bindex[b]
            rows[m, j] = r
            touch_count[r] = touch_count.get(r, 0) + 1
        for j, b in enumerate(dests[m]):
            dest_rows[m, j] = bindex[b]
    sizes = np.array(
        [float(ctx.partition_size_mb.get(
            (proposals[i].topic, proposals[i].partition), 0.0))
         for i in order], np.float32)
    caps = np.full((B + 1,), _PAD_CAP, np.int32)
    for r in range(B):
        caps[r] = min(concurrency.inter_broker_cap(row_ids[r]), _PAD_CAP)
    ccap = max(int(concurrency.cluster_movement_cap), 1)

    # First-fit batch-index bound under caps alone: move i can be
    # rejected from batch k only by a full batch (at most
    # floor((M-1)/ccap) of those precede its slot) or by one of its
    # brokers at cap (broker b fills at most floor((touch_b-1)/cap_b)
    # batches with EARLIER moves). K = 1 + the worst move's bound.
    full_b = (M - 1) // ccap
    worst = 0
    for m in range(M):
        s = sum((touch_count[r] - 1) // max(int(caps[r]), 1)
                for r in set(int(x) for x in rows[m] if x < B))
        worst = max(worst, s)
    # A finite bandwidth budget can split batches the caps alone
    # admit; the first-move-per-destination rule bounds the extra
    # batches by the busiest destination's move count.
    bw_extra = 0
    if bandwidth_mb_per_batch:
        dest_count: dict[int, int] = {}
        for m in range(M):
            for b in set(int(x) for x in dest_rows[m] if x < B):
                dest_count[b] = dest_count.get(b, 0) + 1
        bw_extra = max(dest_count.values(), default=1) - 1
    K = min(M, 1 + full_b + worst + bw_extra)
    K = min(pow2_bucket(K), pow2_bucket(M))
    bw = (np.float32(bandwidth_mb_per_batch)
          if bandwidth_mb_per_batch else np.float32(np.inf))
    return dict(rows=rows, dest_rows=dest_rows, size_mb=sizes,
                valid=np.ones((M,), bool), caps=caps, cluster_cap=ccap,
                budget=float(bw), num_batches=K)


class ScheduleAuditError(RuntimeError):
    """Raised (strict mode) when bisection repair cannot produce a
    schedule whose every batch boundary passes the hard-goal audit."""


#: Spilled-move batch-index offset (see ``_assign``): indices >= _SPILL
#: encode trailing singleton batches for bandwidth-infeasible moves.
_SPILL = 1 << 20


def forecast_filter(proposals: list[ExecutionProposal], scenario, *,
                    shrink_below: float, hot_above: float):
    """Partition the proposal list by the forecast's projected per-topic
    load factors.

    ``scenario`` is a ``TrajectoryScale``. Topics projected to shrink below
    ``shrink_below`` get their heals DEFERRED (the imbalance they fix is
    predicted to dissolve — executing it now moves data twice); topics
    projected above ``hot_above`` are returned as the hot set the executor
    pre-positions leaders for first. Returns ``(kept, deferred,
    hot_topics)``; ``kept``/``deferred`` preserve input order.
    """
    factors = dict(getattr(scenario, "factors", ()) or ())
    shrink = {t for t, f in factors.items() if f < shrink_below}
    hot = {t for t, f in factors.items() if f >= hot_above}
    kept, deferred = [], []
    for p in proposals:
        (deferred if p.topic in shrink else kept).append(p)
    return kept, deferred, hot
