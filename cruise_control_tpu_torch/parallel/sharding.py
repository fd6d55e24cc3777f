"""The mesh-less sharding path (counterpart of
``cruise_control_tpu/parallel/sharding.py``).

The reference lays the flat model over a device mesh: partition-indexed
arrays shard over the mesh axis ``"p"``, broker-indexed arrays replicate,
and XLA inserts the collectives. The port runs on one GPU, so a mesh here is
one device and every sharding is the identity: ``make_mesh`` builds the
one-device mesh (more devices raise ``ValueError``: sharding the partition
axis over several cards is ROADMAP queue 2 K15, not ported), ``shard_model``
places the model on that device, and ``model_shardings`` returns ``None``
for every field (no placement beyond the device). ``TorchGoalOptimizer``
accepts a one-device mesh and runs its plain path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils.device import resolve_device

PARTITION_AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """A device mesh of one device over the partition axis."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (PARTITION_AXIS,)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The one-device mesh on ``device`` (``None`` means the card and
    raises without one). ``n_devices`` other than ``None`` or 1 raises: a
    multi-card mesh is not ported."""
    if n_devices is not None and n_devices != 1:
        raise ValueError(
            f"a mesh of {n_devices} devices is not ported: the port runs on "
            "one GPU (ROADMAP queue 2 K15); use make_mesh(1) or no mesh")
    return Mesh(devices=(resolve_device(device),))


def resolve_mesh_devices(n: int) -> int:
    """Resolve the ``search.mesh.devices`` config value to a concrete
    device count: ``-1`` means every visible card, positive values clamp
    to ``torch.cuda.device_count()``, ``0`` stays 0 (no mesh)."""
    if n == 0:
        return 0
    available = torch.cuda.device_count()
    return available if n < 0 else min(n, available)


def mesh_fingerprint(mesh: Mesh | None):
    """Hashable identity of a mesh for cache keys (None = no mesh)."""
    if mesh is None:
        return None
    return tuple(str(d) for d in mesh.devices)


def check_one_device(mesh) -> Mesh:
    """``mesh`` if it is a one-device :class:`Mesh`; raises
    ``NotImplementedError`` naming K15 for anything wider or foreign."""
    if not isinstance(mesh, Mesh) or mesh.size != 1:
        raise NotImplementedError(
            "only a one-device mesh (parallel.sharding.make_mesh) is ported: "
            "sharding the partition axis over several GPUs is ROADMAP "
            "queue 2 K15")
    return mesh


def model_shardings(model, mesh: Mesh) -> dict:
    """Per-field placements of a ``FlatClusterModel``: ``None`` (the
    identity) for every field on a one-device mesh."""
    check_one_device(mesh)
    return {f.name: None for f in dataclasses.fields(model)}


def shard_model(model, mesh: Mesh):
    """Place the model on the mesh's device (the model itself when it is
    already there)."""
    dev = check_one_device(mesh).device
    if model.device == dev:
        return model
    return type(model)(**{f.name: getattr(model, f.name).to(dev)
                          for f in dataclasses.fields(model)})
