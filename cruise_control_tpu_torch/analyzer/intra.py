"""Intra-broker (disk) optimization: the JBOD dimension.

Port of ``cruise_control_tpu/analyzer/intra.py`` (ref ``model/Disk.java``,
``IntraBrokerDiskCapacityGoal.java``, ``IntraBrokerDiskUsageDistributionGoal
.java``). Logdir moves never leave their broker, so every broker's
rebalance is independent: per iteration, every broker moves its best
replica from its most- to its least-loaded disk. The whole walk is one
launch of KH (:func:`kernels.intra_broker_walk`). ``REMOVE_DISKS`` is the
same walk with the doomed disks' capacity zeroed, so everything on them
drains to the surviving disks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.resources import Resource
from ..executor.tasks import IntraBrokerReplicaMove
from ..kernels import intra_broker_walk, ordered_segment_sum
from ..utils.device import resolve_device
from ..utils.ordered import matrix_sum, tree_sum_last


@dataclass
class DiskState:
    """Disk-level tensors paired with a FlatClusterModel (same P/R/B
    padding; D = padded max logdirs per broker)."""

    replica_disk: torch.Tensor    # int32[P, R] — disk slot on its broker (-1 none)
    replica_size: torch.Tensor    # float32[P, R] — DISK load of the replica
    replica_broker: torch.Tensor  # int32[P, R]
    disk_capacity: torch.Tensor   # float32[B, D] (0 = absent or draining)
    disk_valid: torch.Tensor      # bool[B, D]

    @classmethod
    def from_numpy(cls, *, device=None, **arrays) -> "DiskState":
        """The state holding ``arrays`` (the reference ``DiskState``'s
        fields, e.g. ``{f: np.asarray(getattr(jax_state, f))}``)."""
        dev = resolve_device(device)
        dtypes = dict(replica_disk=torch.int32, replica_size=torch.float32,
                      replica_broker=torch.int32,
                      disk_capacity=torch.float32, disk_valid=torch.bool)
        return cls(**{name: torch.from_numpy(np.array(arrays[name])).to(
            device=dev, dtype=dt) for name, dt in dtypes.items()})

    def replace(self, **changes) -> "DiskState":
        return dataclasses.replace(self, **changes)

    @property
    def disk_util(self) -> torch.Tensor:
        """float32[B, D]: each disk's replica sizes added in flat replica
        order (the reference's scatter-add order) through KB."""
        B, D = self.disk_capacity.shape
        ok = self.replica_disk >= 0
        seg = torch.where(ok, self.replica_broker.long() * D
                          + self.replica_disk.long(), B * D)
        util = ordered_segment_sum(
            torch.where(ok, self.replica_size, 0.0).reshape(-1),
            seg.reshape(-1), B * D + 1)
        return util[:B * D].reshape(B, D)


@dataclass
class IntraBrokerResult:
    moves: list[IntraBrokerReplicaMove]
    capacity_violation_before: float
    capacity_violation_after: float
    balance_violation_before: float
    balance_violation_after: float
    iterations: int

    def goal_summary(self) -> list[dict]:
        """Per-goal entries in the inter-broker ``goalSummary`` shape,
        naming the two goal facets of the fused walk."""
        rows = [(IntraBrokerDiskCapacityGoal,
                 self.capacity_violation_before,
                 self.capacity_violation_after),
                (IntraBrokerDiskUsageDistributionGoal,
                 self.balance_violation_before,
                 self.balance_violation_after)]
        return [
            {"goal": goal.name, "hard": goal.hard,
             "violationBefore": before, "violationAfter": after,
             "status": "NO-ACTION" if before <= 1e-6
             else ("FIXED" if after <= 1e-6 else "VIOLATED")}
            for goal, before, after in rows]


def build_disk_state(model, metadata, admin, capacity_resolver
                     ) -> tuple[DiskState, list[list[str]]]:
    """Disk tensors from live logdir metadata and per-logdir capacity (ref
    LoadMonitor populating Disk objects from describeLogDirs and
    BrokerCapacityInfo.diskCapacityByLogDir), on the model's device."""
    logdirs_by_broker: list[list[str]] = []
    caps: list[dict[str, float]] = []
    placement = admin.describe_replica_log_dirs()   # one full-cluster scan
    dirs_by_broker: dict[int, set[str]] = {}
    for (t, p, b), d in placement.items():
        dirs_by_broker.setdefault(b, set()).add(d)
    # Configured-but-empty logdirs are valid drain destinations the
    # placement scan cannot reveal (ref AdminClient.describeLogDirs).
    conf_fn = getattr(admin, "describe_logdirs", None)
    if conf_fn is not None:
        for b, dirs in conf_fn().items():
            dirs_by_broker.setdefault(b, set()).update(dirs)
    for broker_id in metadata.broker_ids:
        info = capacity_resolver.capacity_for_broker("", "", broker_id)
        by_dir = info.disk_capacity_by_logdir
        if by_dir is None:
            # One logical disk unless the admin reports real logdirs.
            names = sorted(dirs_by_broker.get(broker_id, set())) or ["logdir0"]
            total = info.capacity[Resource.DISK]
            by_dir = {d: total / len(names) for d in names}
        logdirs_by_broker.append(sorted(by_dir))
        caps.append(by_dir)
    D = max((len(d) for d in logdirs_by_broker), default=1)
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape
    disk_capacity = np.zeros((B, D), np.float32)
    disk_valid = np.zeros((B, D), bool)
    dir_index: list[dict[str, int]] = []
    for i, dirs in enumerate(logdirs_by_broker):
        dir_index.append({d: j for j, d in enumerate(dirs)})
        for j, d in enumerate(dirs):
            disk_capacity[i, j] = caps[i][d]
            disk_valid[i, j] = True

    replica_disk = np.full((P, R), -1, np.int32)
    rb = model.replica_broker.cpu().numpy()
    for p, key in enumerate(metadata.partition_keys):
        for r in range(R):
            b = rb[p, r]
            if b >= len(metadata.broker_ids):
                continue
            broker_id = metadata.broker_ids[b]
            d = placement.get((key[0], key[1], broker_id))
            if d is not None and d in dir_index[b]:
                replica_disk[p, r] = dir_index[b][d]
            elif dir_index[b]:
                replica_disk[p, r] = 0
    from ..model.flat import replica_loads
    sizes = replica_loads(model)[..., Resource.DISK]
    state = DiskState.from_numpy(
        device=model.device, replica_disk=replica_disk,
        replica_size=sizes.cpu().numpy(), replica_broker=rb,
        disk_capacity=disk_capacity, disk_valid=disk_valid)
    return state, logdirs_by_broker


def _violations(state: DiskState, cap_threshold: float,
                balance_threshold: float):
    """(capacity_violation, balance_violation), both 0-dim float32. The
    reference computes these eagerly: every operation rounds on its own,
    the D-wide row sums follow :func:`utils.ordered.tree_sum_last` and the
    whole-matrix sums :func:`utils.ordered.matrix_sum` (probed at D =
    1-256 disks, and at 63 and 95 disks or brokers)."""
    util = state.disk_util
    cap = state.disk_capacity * cap_threshold
    # Draining disks (capacity 0) count everything on them as over capacity.
    over_cap = torch.where(state.disk_valid,
                           torch.clamp(util - cap, min=0.0), 0.0)
    # Balance: per broker, disks within the avg * threshold band (ref
    # IntraBrokerDiskUsageDistributionGoal's balance percentage).
    live = state.disk_valid & (state.disk_capacity > 0)
    n_live = torch.clamp(live.sum(dim=1), min=1).to(torch.float32)
    avg = tree_sum_last(torch.where(live, util, 0.0)) / n_live
    upper = avg[:, None] * balance_threshold
    lower = avg[:, None] * (2.0 - balance_threshold)
    bal = torch.where(live, torch.clamp(util - upper, min=0.0)
                      + torch.clamp(lower - util, min=0.0), 0.0)
    return matrix_sum(over_cap), matrix_sum(bal)


class IntraBrokerDiskCapacityGoal:
    """Named facet of the fused intra-broker walk (ref
    ``IntraBrokerDiskCapacityGoal.java``): no disk above ``capacity *
    cap_threshold``; draining disks (capacity 0) must empty completely.
    Hard goal."""

    name = "IntraBrokerDiskCapacityGoal"
    hard = True


class IntraBrokerDiskUsageDistributionGoal:
    """Named facet of the fused intra-broker walk (ref
    ``IntraBrokerDiskUsageDistributionGoal.java``): each broker's disks
    within ``avg * balance_threshold`` of the broker's mean disk
    utilization. Soft goal."""

    name = "IntraBrokerDiskUsageDistributionGoal"
    hard = False


def optimize_intra_broker(state: DiskState, *, cap_threshold: float = 0.8,
                          balance_threshold: float = 1.10,
                          max_iters: int = 512
                          ) -> tuple[DiskState, torch.Tensor]:
    """Every broker moves its heaviest movable replica from its most
    pressured disk to its best destination disk, iteration after
    iteration, until no broker can improve or ``max_iters`` iterations ran
    (one KH launch). Returns (final state, iterations). The thresholds are
    accepted for the reference's signature; its walk reads neither."""
    rd, iters = intra_broker_walk(state.replica_disk, state.replica_size,
                                  state.replica_broker, state.disk_capacity,
                                  state.disk_valid, max_iters)
    return state.replace(replica_disk=rd), iters


def diff_intra_moves(before: DiskState, after: DiskState, metadata,
                     logdirs_by_broker: list[list[str]]
                     ) -> list[IntraBrokerReplicaMove]:
    """Logdir moves from the disk-slot diff (the intra-broker
    ``AnalyzerUtils.getDiff``)."""
    b0 = before.replica_disk.cpu().numpy()
    b1 = after.replica_disk.cpu().numpy()
    rb = before.replica_broker.cpu().numpy()
    sizes = before.replica_size.cpu().numpy()
    moves: list[IntraBrokerReplicaMove] = []
    for p, r in zip(*np.nonzero(b0 != b1)):
        if p >= len(metadata.partition_keys) or rb[p, r] >= len(
                metadata.broker_ids):
            continue
        topic, partition = metadata.partition_keys[p]
        broker = int(rb[p, r])
        dirs = logdirs_by_broker[broker]
        moves.append(IntraBrokerReplicaMove(
            topic=topic, partition=partition,
            broker_id=metadata.broker_ids[broker],
            source_logdir=dirs[int(b0[p, r])],
            dest_logdir=dirs[int(b1[p, r])],
            size_mb=float(sizes[p, r])))
    return moves


def intra_broker_rebalance(model, metadata, admin, capacity_resolver, *,
                           cap_threshold: float = 0.8,
                           balance_threshold: float = 1.10,
                           drained_disks: dict[int, list[str]] | None = None
                           ) -> IntraBrokerResult:
    """Build the disk state, zero the capacity of disks being removed (if
    any), run the walk and emit logdir moves (the REMOVE_DISKS /
    intra-broker rebalance entry, ref RemoveDisksRunnable and the
    intra-broker goals). Runs on the model's device."""
    state, logdirs_by_broker = build_disk_state(model, metadata, admin,
                                                capacity_resolver)
    if drained_disks:
        cap = state.disk_capacity.cpu().numpy().copy()
        util = state.disk_util.cpu().numpy()
        bindex = {bid: i for i, bid in enumerate(metadata.broker_ids)}
        for broker_id, dirs in drained_disks.items():
            i = bindex.get(broker_id)
            if i is None:
                raise ValueError(f"unknown broker id {broker_id}")
            for d in dirs:
                if d not in logdirs_by_broker[i]:
                    # A typo'd logdir must fail the request, not leave the
                    # disk it named untouched while balance moves run.
                    raise ValueError(
                        f"broker {broker_id} has no logdir {d!r} "
                        f"(knows {sorted(logdirs_by_broker[i])})")
                cap[i, logdirs_by_broker[i].index(d)] = 0.0
            if not (cap[i] > 0).any():
                raise ValueError(
                    f"broker {broker_id}: cannot remove every logdir "
                    f"({sorted(dirs)}) — no surviving disk to drain to")
            # ref RemoveDisksRunnable.java:156-158: the broker's full disk
            # usage must fit under the surviving disks' capacity x
            # threshold, or the drain is refused up front.
            future_usage = float(util[i].sum())
            remaining = float(cap[i].sum())
            if future_usage > remaining * cap_threshold:
                raise ValueError(
                    f"Not enough remaining capacity to move replicas to "
                    f"for broker {broker_id}: {future_usage:.1f} MB used "
                    f"vs {remaining:.1f} MB x {cap_threshold} surviving")
        state = state.replace(disk_capacity=torch.from_numpy(cap).to(
            state.disk_capacity.device))
    cv0, bv0 = _violations(state, cap_threshold, balance_threshold)
    final, iters = optimize_intra_broker(
        state, cap_threshold=cap_threshold,
        balance_threshold=balance_threshold)
    cv1, bv1 = _violations(final, cap_threshold, balance_threshold)
    return IntraBrokerResult(
        moves=diff_intra_moves(state, final, metadata, logdirs_by_broker),
        capacity_violation_before=float(cv0),
        capacity_violation_after=float(cv1),
        balance_violation_before=float(bv0),
        balance_violation_after=float(bv1),
        iterations=int(iters))
