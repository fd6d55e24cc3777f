"""``FlatClusterModel`` — the cluster workload model as device tensors.

Port of ``cruise_control_tpu/model/flat.py``. The layout is the reference's
(P = padded partitions, R = padded max replication factor, B = padded
brokers, 4 resources CPU/NW_IN/NW_OUT/DISK; slot 0 of ``replica_broker`` is
the leader; empty slots and padding partitions hold the sentinel ``B``),
held as a plain dataclass of tensors. "Mutation" is the pure function
:func:`apply_moves`, which returns a new model.

Every float32 broker reduction adds its rows in ascending row order through
the ordered segment sum (KB), which is the order the reference's scatter-add
uses; integer counts are exact in any order. Out-of-range indices are
masked explicitly — never left to clamp or drop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.resources import NUM_RESOURCES, Resource
from ..kernels import ordered_segment_sum
from ..utils.device import resolve_device

# Move types (ref ActionType.java:23-28). MOVE_SWAP is
# INTER_BROKER_REPLICA_SWAP: two replicas of different partitions exchange
# brokers (count-neutral).
MOVE_INTER_BROKER = 0
MOVE_LEADERSHIP = 1
MOVE_SWAP = 2


@dataclass
class FlatClusterModel:
    # --- replica/partition axis ------------------------------------------
    replica_broker: torch.Tensor      # int32[P, R], sentinel B for empty slots
    leader_load: torch.Tensor         # float32[P, 4]
    follower_load: torch.Tensor       # float32[P, 4]
    partition_topic: torch.Tensor     # int32[P]
    partition_valid: torch.Tensor     # bool[P]
    replica_offline: torch.Tensor     # bool[P, R]
    #: position of each slot's broker in Kafka's *preferred* replica order
    replica_pref_pos: torch.Tensor    # int32[P, R]
    # --- broker axis ------------------------------------------------------
    broker_capacity: torch.Tensor     # float32[B, 4]
    broker_rack: torch.Tensor         # int32[B]
    broker_host: torch.Tensor         # int32[B]
    broker_set: torch.Tensor          # int32[B]
    broker_alive: torch.Tensor        # bool[B]
    broker_new: torch.Tensor          # bool[B]
    broker_demoted: torch.Tensor      # bool[B]
    broker_broken_disk: torch.Tensor  # bool[B]
    broker_valid: torch.Tensor        # bool[B]  (padding mask)

    @classmethod
    def from_numpy(cls, *, device=None, **arrays) -> "FlatClusterModel":
        """Build from host-side numpy arrays — exactly the field dict the
        reference model holds. ``device=None`` means the card (raises when
        CUDA is absent); only ``device="cpu"`` builds on the CPU. Every
        upload is metered on the process-default device-runtime collector,
        as the reference meters it."""
        from ..core.runtime_obs import default_collector
        dev = resolve_device(device)
        default_collector().record_h2d(
            sum(int(a.nbytes) for a in arrays.values()
                if isinstance(a, np.ndarray)))
        return cls(**{name: torch.from_numpy(np.array(a, order="C")).to(dev)
                      for name, a in arrays.items()})

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}

    def replace(self, **changes) -> "FlatClusterModel":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.replica_broker.device

    # Shapes read from the trailing axes, so a model whose fields carry a
    # leading scenario axis (the what-if engine's batch) answers alike.
    @property
    def num_partitions_padded(self) -> int:
        return self.replica_broker.shape[-2]

    @property
    def max_replication_factor(self) -> int:
        return self.replica_broker.shape[-1]

    @property
    def num_brokers_padded(self) -> int:
        return self.broker_capacity.shape[-2]

    @property
    def broker_sentinel(self) -> int:
        return self.num_brokers_padded

    @property
    def replica_valid(self) -> torch.Tensor:
        """bool[P, R] — true where a real replica occupies the slot."""
        return self.replica_broker < self.broker_sentinel

    @property
    def leader_broker(self) -> torch.Tensor:
        """int32[P] — broker of the leader replica (slot 0)."""
        return self.replica_broker[..., 0]


# ---------------------------------------------------------------------------
# Derived reductions
# ---------------------------------------------------------------------------

def replica_loads(model: FlatClusterModel) -> torch.Tensor:
    """float32[P, R, 4] — the load each replica slot contributes to its
    broker: slot 0 the leader load, the rest the follower load, empty slots
    zero. A leading scenario axis on every field carries through."""
    R = model.max_replication_factor
    is_leader_slot = (torch.arange(R, device=model.device) == 0)[:, None]
    loads = torch.where(is_leader_slot, model.leader_load[..., None, :],
                        model.follower_load[..., None, :])
    return torch.where(model.replica_valid[..., None], loads, 0.0)


def _broker_sum(values: torch.Tensor, brokers: torch.Tensor,
                B: int) -> torch.Tensor:
    """Ordered float sums into broker rows [0, B]; row B (the sentinel)
    collects empty slots and is sliced off."""
    return ordered_segment_sum(values, brokers.reshape(-1), B + 1)[:B]


def _broker_count(brokers: torch.Tensor, weights: torch.Tensor,
                  B: int) -> torch.Tensor:
    counts = torch.zeros(B + 1, dtype=torch.int32, device=brokers.device)
    return counts.index_add_(0, brokers.reshape(-1).long(),
                             weights.reshape(-1).to(torch.int32))[:B]


def broker_utilization(model: FlatClusterModel) -> torch.Tensor:
    """float32[B, 4] — per-broker resource utilization
    (``ClusterModel.utilizationMatrix()``)."""
    loads = replica_loads(model).reshape(-1, NUM_RESOURCES)
    return _broker_sum(loads, model.replica_broker,
                       model.num_brokers_padded)


def broker_replica_counts(model: FlatClusterModel) -> torch.Tensor:
    """int32[B] — replicas per broker."""
    rb = model.replica_broker
    return _broker_count(rb, torch.ones_like(rb), model.num_brokers_padded)


def broker_leader_counts(model: FlatClusterModel) -> torch.Tensor:
    """int32[B] — leader replicas per broker."""
    lb = model.leader_broker
    return _broker_count(lb, torch.ones_like(lb), model.num_brokers_padded)


def broker_potential_nw_out(model: FlatClusterModel) -> torch.Tensor:
    """float32[B] — NW_OUT each broker would serve if every replica it hosts
    led its partition (``ClusterModel.potentialLeadershipLoadFor``)."""
    potential = model.leader_load[:, Resource.NW_OUT][:, None]
    potential = torch.where(model.replica_valid, potential, 0.0)
    return _broker_sum(potential.reshape(-1), model.replica_broker,
                       model.num_brokers_padded)


def topic_broker_replica_counts(model: FlatClusterModel,
                                num_topics: int) -> torch.Tensor:
    """int32[T, B] — replicas of each topic on each broker. Padding
    partitions (topic -1) and empty slots are masked out explicitly."""
    B = model.num_brokers_padded
    topic = model.partition_topic[:, None].long()
    ok = (model.replica_valid & (topic >= 0) & (topic < num_topics))
    idx = torch.where(ok, topic * (B + 1) + model.replica_broker, 0)
    counts = torch.zeros(num_topics * (B + 1), dtype=torch.int32,
                         device=model.device)
    counts.index_add_(0, idx.reshape(-1), ok.reshape(-1).to(torch.int32))
    return counts.reshape(num_topics, B + 1)[:, :B]


def topic_broker_leader_counts(model: FlatClusterModel,
                               num_topics: int) -> torch.Tensor:
    """int32[T, B] — leaders of each topic on each broker."""
    B = model.num_brokers_padded
    topic = model.partition_topic.long()
    ok = model.partition_valid & (topic >= 0) & (topic < num_topics)
    idx = torch.where(ok, topic * (B + 1) + model.leader_broker, 0)
    counts = torch.zeros(num_topics * (B + 1), dtype=torch.int32,
                         device=model.device)
    counts.index_add_(0, idx, ok.to(torch.int32))
    return counts.reshape(num_topics, B + 1)[:, :B]


def leader_bytes_in(model: FlatClusterModel) -> torch.Tensor:
    """float32[B] — leader-only NW_IN per broker."""
    lbi = torch.where(model.partition_valid,
                      model.leader_load[:, Resource.NW_IN], 0.0)
    return _broker_sum(lbi, model.leader_broker, model.num_brokers_padded)


# ---------------------------------------------------------------------------
# Moves: the pure-functional mutation (ref relocateReplica/relocateLeadership)
# ---------------------------------------------------------------------------

@dataclass
class Moves:
    """A batch of balancing actions as a struct-of-arrays: (partition, slot,
    destination broker, kind); inactive entries use ``partition == -1``."""

    partition: torch.Tensor   # int[M]
    slot: torch.Tensor        # int[M]
    destination: torch.Tensor  # int[M] (ignored for leadership moves)
    kind: torch.Tensor        # int[M]: MOVE_INTER_BROKER | MOVE_LEADERSHIP

    @property
    def capacity(self) -> int:
        return self.partition.shape[0]

    @property
    def active(self) -> torch.Tensor:
        return self.partition >= 0

    @staticmethod
    def empty(capacity: int, device=None) -> "Moves":
        dev = resolve_device(device)
        z = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return Moves(partition=torch.full((capacity,), -1, dtype=torch.int32,
                                          device=dev),
                     slot=z, destination=z.clone(), kind=z.clone())


def apply_moves(model: FlatClusterModel, moves: Moves) -> FlatClusterModel:
    """Apply a batch of moves, returning a new model (pure). Moves apply in
    two phases like the reference — every replica relocation, then every
    leadership transfer (slot <-> 0 swap) against the relocated rows. One
    move per partition per batch, as the optimizer guarantees. Entries that
    are inactive, of the other kind, or outside [0, P) write to a discard
    row P that is sliced off."""
    rb = model.replica_broker
    off = model.replica_offline
    P, R = rb.shape
    part = moves.partition.long()
    slot = moves.slot.long()
    in_range = moves.active & (part < P)

    rbx = torch.cat([rb, rb.new_zeros((1, R))])
    offx = torch.cat([off, off.new_zeros((1, R))])
    is_move = in_range & (moves.kind == MOVE_INTER_BROKER)
    mpart = torch.where(is_move, part, P)
    rbx[mpart, slot] = moves.destination.to(rb.dtype)
    offx[mpart, slot] = False

    is_lead = in_range & (moves.kind == MOVE_LEADERSHIP)
    lpart = torch.where(is_lead, part, P)
    old_leader = rbx[lpart, 0]
    new_leader = rbx[lpart, slot]
    rbx[lpart, 0] = new_leader
    rbx[lpart, slot] = old_leader
    old_leader_off = offx[lpart, 0]
    slot_off = offx[lpart, slot]
    offx[lpart, 0] = slot_off
    offx[lpart, slot] = old_leader_off
    return model.replace(replica_broker=rbx[:P], replica_offline=offx[:P])


def validation_issue_counts(replica_broker: np.ndarray,
                            partition_valid: np.ndarray,
                            broker_valid: np.ndarray) -> dict[str, int]:
    """Vectorized structural checks over host-side arrays. All zeros means
    healthy."""
    rb = np.asarray(replica_broker)
    pvalid = np.asarray(partition_valid)
    bvalid = np.asarray(broker_valid)
    sentinel = bvalid.shape[0]
    valid = rb < sentinel
    issues: dict[str, int] = {}
    issues["partitions_without_leader"] = int((pvalid & ~valid[:, 0]).sum())
    srt = np.sort(np.where(valid, rb, sentinel), axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < sentinel)
    issues["duplicate_replica_brokers"] = int(dup[pvalid].sum())
    on_invalid = valid & ~np.pad(bvalid, (0, 1))[rb]
    issues["replicas_on_invalid_brokers"] = int(on_invalid.sum())
    issues["padding_with_replicas"] = int((~pvalid[:, None] & valid).sum())
    return issues


def sanity_check(model: FlatClusterModel) -> dict[str, Any]:
    """Host-side invariant checks (ref ClusterModel.sanityCheck :1147);
    all zeros means healthy."""
    return validation_issue_counts(model.replica_broker.cpu().numpy(),
                                   model.partition_valid.cpu().numpy(),
                                   model.broker_valid.cpu().numpy())
