"""Cluster-level statistics (port of ``cruise_control_tpu/model/stats.py``;
ref ``model/ClusterModelStats.java``).

Per-resource average / standard deviation / max / min of broker utilization
across alive brokers, plus replica- and leader-count statistics — the numbers
goal comparators compare and the payload of ``brokerStats`` responses, and
the ``summary`` of ``/load`` and ``loadAfterOptimization`` of a rebalance.

The broker aggregates come from the model's reductions (KB for the float
planes); one launch of KG (``kernels.cluster_stats``) reduces them all, in
the reference's float order, so every value equals the reference's bit for
bit, and counts the alive brokers, replicas and leaders into the same
buffer, which ``stats_summary`` reads from the card in one copy.
"""

from __future__ import annotations

import torch

from ..core.resources import NUM_RESOURCES, RESOURCE_NAMES
from ..kernels import cluster_stats as _cluster_stats_kernel
from ..kernels import split_cluster_stats
from ..utils.device import resolve_device
from .flat import (FlatClusterModel, broker_leader_counts, broker_replica_counts,
                   broker_utilization, broker_potential_nw_out)

_STATS = ("avg", "std", "max", "min")


def _stats_buffer(model: FlatClusterModel, util):
    """KG's buffer for ``model``: the [4 stats, 7 columns] table, then the
    alive broker, replica and leader counts."""
    alive = model.broker_alive & model.broker_valid
    return _cluster_stats_kernel(
        util, broker_replica_counts(model), broker_leader_counts(model),
        broker_potential_nw_out(model), alive, model.replica_valid,
        model.partition_valid)


def _groups(table) -> dict:
    def group(cols):
        return {k: table[i, cols] for i, k in enumerate(_STATS)}
    return {"resource": group(slice(0, NUM_RESOURCES)),    # each entry [4]
            "replica_count": group(4),
            "leader_count": group(5),
            "potential_nw_out": group(6)}


def cluster_stats(model: FlatClusterModel) -> dict:
    """Device-side stats dict, keyed as the reference's pytree. All entries
    are computed over alive brokers (dead/padding brokers excluded, matching
    ref ClusterModelStats which iterates aliveBrokers)."""
    util = broker_utilization(model)
    table, counts = split_cluster_stats(_stats_buffer(model, util))
    return {"num_alive_brokers": counts[0],
            "utilization": util,
            **_groups(table),
            "num_replicas": counts[1],
            "num_leaders": counts[2]}


def resource_cv(stats: dict) -> torch.Tensor:
    """Coefficient of variation per resource — the reference's balance metric
    (``ClusterModelStats.variance()`` normalized, cf. ClusterModel.java:1315)."""
    res = stats["resource"]
    return res["std"] / torch.clamp(res["avg"], min=1e-9)


def stats_summary(model: FlatClusterModel, device=None) -> dict:
    """Host-side JSON-friendly summary (for /state and /load responses).
    ``device`` follows the port's entry points (None = the card): the
    model must lie there."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model lies on {model.device}, not {dev}")
    table, counts = split_cluster_stats(
        _stats_buffer(model, broker_utilization(model)).cpu())  # one read
    groups = _groups(table.numpy())
    num_alive, num_replicas, num_leaders = counts.tolist()
    out = {"numAliveBrokers": num_alive, "numReplicas": num_replicas,
           "numLeaders": num_leaders, "resources": {}}
    for r in range(NUM_RESOURCES):
        out["resources"][RESOURCE_NAMES[r]] = {
            k: float(v[r]) for k, v in groups["resource"].items()}
    for key in ("replica_count", "leader_count", "potential_nw_out"):
        # the reference fetches these groups as pytrees: keys sorted
        out[key] = {k: float(v) for k, v in sorted(groups[key].items())}
    return out
