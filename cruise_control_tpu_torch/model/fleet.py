"""``FleetModel`` — many clusters' flat models stacked on a leading
``[C, ...]`` cluster axis.

Port of ``cruise_control_tpu/model/fleet.py``. Every member's
``FlatClusterModel`` is padded to ONE shape bucket ``(B_f, P_f, R_f)`` with
:func:`..parallel.batching.pad_model_to` (new rows arrive invalid/empty, so
a padded member scores bit-identically to its original) and the members are
stacked into ``[C, ...]`` tensors. The fleet engine (``fleet/engine.py``)
runs the members one after another on the card and reads the stack for its
``[C, S]`` scenario sweeps. The reference also pads the cluster axis
(``cluster_pad_multiple``) so that clusters divide evenly over a device
mesh; one card has no mesh, so the port stacks exactly C slots and
``cluster_valid`` is all true.

The stacked model's shape properties read the trailing axes
(``FlatClusterModel.num_brokers_padded`` and friends), so they answer the
member shape on the stack too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.batching import pad_model_to, round_up
from ..utils.device import resolve_device
from .flat import FlatClusterModel


@dataclass
class FleetMember:
    """One cluster's slice of the fleet: its id, its model padded to the
    fleet bucket, and its own (un-padded, real-count) metadata."""

    cluster_id: str
    model: FlatClusterModel        # padded to the fleet bucket
    metadata: object               # ClusterMetadata (real counts)
    generation: int = 0
    stale: bool = False


@dataclass
class FleetModel:
    """Per-cluster members + the ``[C, ...]`` stacked model.

    ``stacked`` is a ``FlatClusterModel`` whose every field carries a
    leading cluster axis, one slot per member. ``cluster_valid`` (all
    true) and ``num_clusters_padded`` (= C) keep the reference's
    interface."""

    members: list[FleetMember]
    stacked: FlatClusterModel
    cluster_valid: np.ndarray       # bool[C]
    bucket: dict = field(default_factory=dict)

    @property
    def num_clusters(self) -> int:
        return len(self.members)

    @property
    def num_clusters_padded(self) -> int:
        return int(self.cluster_valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.stacked.device

    def member_index(self, cluster_id: str) -> int:
        for i, m in enumerate(self.members):
            if m.cluster_id == cluster_id:
                return i
        raise KeyError(cluster_id)

    @classmethod
    def stack(cls, members, *, broker_pad_multiple: int = 8,
              partition_pad_multiple: int = 128,
              device=None) -> "FleetModel":
        """Stack ``members`` — an iterable of ``(cluster_id, model,
        metadata)`` or ``(cluster_id, model, metadata, generation,
        stale)`` tuples — into one fleet bucket on ``device`` (``None``
        means the card and raises without one; only ``"cpu"`` stacks on
        the CPU). Every member model must already lie on that device.

        The bucket is the max padded shape over members, rounded up to
        the configured multiples."""
        dev = resolve_device(device)
        rows = [tuple(m) for m in members]
        if not rows:
            raise ValueError("FleetModel.stack requires at least one member")
        ids = [r[0] for r in rows]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate cluster ids in fleet: {ids}")
        models = [r[1] for r in rows]
        for cid, m in zip(ids, models):
            if m.device != dev:
                raise ValueError(f"member {cid!r} lies on {m.device}, the "
                                 f"fleet stacks on {dev}")
        B_f = round_up(max(m.num_brokers_padded for m in models),
                       broker_pad_multiple)
        P_f = round_up(max(m.num_partitions_padded for m in models),
                       partition_pad_multiple)
        R_f = max(m.max_replication_factor for m in models)
        padded = [pad_model_to(m, B_f, P_f, R_f) for m in models]
        C = len(padded)
        fleet_members = []
        for r, model in zip(rows, padded):
            generation = r[3] if len(r) > 3 else 0
            stale = bool(r[4]) if len(r) > 4 else False
            fleet_members.append(FleetMember(
                cluster_id=r[0], model=model, metadata=r[2],
                generation=generation, stale=stale))
        stacked = FlatClusterModel(**{
            f.name: torch.stack([getattr(m, f.name) for m in padded])
            for f in dataclasses.fields(FlatClusterModel)})
        return cls(members=fleet_members, stacked=stacked,
                   cluster_valid=np.ones(C, bool),
                   bucket={"clusters": C, "clustersPadded": C,
                           "brokersPadded": B_f, "partitionsPadded": P_f,
                           "replicaSlots": R_f})
