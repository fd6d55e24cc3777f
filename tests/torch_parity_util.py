"""Shared helpers for the port's parity tests: one cluster, built once in
each package from the same inputs.

The JAX package runs as tier-1 runs it (JAX on the CPU backend); the port
runs on ``device="cpu"``, where every kernel wrapper takes its plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu_torch.model.flat import FlatClusterModel as TorchModel

torch.set_num_threads(1)


def model_arrays(model) -> dict[str, np.ndarray]:
    """The JAX model's field dict as numpy arrays."""
    import dataclasses
    return {f.name: np.asarray(getattr(model, f.name))
            for f in dataclasses.fields(model)}


def torch_model(jax_model) -> TorchModel:
    """The port's model holding exactly the JAX model's arrays."""
    return TorchModel.from_numpy(device="cpu", **model_arrays(jax_model))


def _spec_inputs(num_brokers, partitions, rng, skew):
    brokers = [dict(broker_id=i, rack=f"r{i % 4}",
                    capacity=(100.0, 1e5, 1e5, 1e6))
               for i in range(num_brokers)]
    parts = []
    hot = max(num_brokers // 5, 2)
    for p in range(partitions):
        pool = hot if (skew and p % 2 == 0) else num_brokers
        reps = rng.choice(pool, size=2, replace=False).tolist()
        load = (float(0.02 + 0.02 * rng.random()), float(5 + 10 * rng.random()),
                float(8 + 15 * rng.random()), float(50 + 100 * rng.random()))
        parts.append(dict(topic=f"t{p % 8}", partition=p,
                          replicas=[int(b) for b in reps],
                          leader_load=load))
    return brokers, parts


def build_both(num_brokers: int = 8, partitions: int = 128, *,
               seed: int = 0, skew: bool = True, dead: tuple = ()):
    """((jax_model, jax_md), (torch_model, torch_md)) for one seeded
    skewed cluster, built through each package's own ``flatten_spec``.
    ``dead`` lists broker ids marked not alive."""
    rng = np.random.default_rng(seed)
    brokers, parts = _spec_inputs(num_brokers, partitions, rng, skew)
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        spec = mod.ClusterSpec(
            brokers=[mod.BrokerSpec(alive=b["broker_id"] not in dead, **b)
                     for b in brokers],
            partitions=[mod.PartitionSpec(**p) for p in parts])
        out.append(mod.flatten_spec(spec, **kw))
    return out[0], out[1]


def tiny_both():
    """``__graft_entry__._tiny_model`` (8 brokers x 128 partitions, every
    replica on brokers 0/1) in both packages."""
    rng = np.random.default_rng(0)
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        brokers = [mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}")
                   for i in range(8)]
        rng = np.random.default_rng(0)
        parts = []
        for p in range(128):
            lead = p % 2
            parts.append(mod.PartitionSpec(
                topic=f"t{p % 8}", partition=p, replicas=[lead, 1 - lead],
                leader_load=(1.0 + float(rng.random()), 20.0, 30.0, 200.0)))
        out.append(mod.flatten_spec(mod.ClusterSpec(brokers=brokers,
                                                    partitions=parts),
                                    pad_partitions_to=128, **kw))
    return out[0], out[1]


def spec_both(num_brokers=4, partitions=8, nw_out=3.0, nw_out_cap=1000.0,
              extra=()):
    """``tests/test_whatif.py``'s spec (4 brokers on their own racks, RF 2,
    two topics), flattened by each package:
    ((jax_model, jax_md), (torch_model, torch_md))."""
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        parts = [mod.PartitionSpec(
            f"t{p % 2}", p, [p % num_brokers, (p + 1) % num_brokers],
            leader_load=(1.0, 2.0, nw_out, 4.0)) for p in range(partitions)]
        parts += [mod.PartitionSpec(**e) for e in extra]
        spec = mod.ClusterSpec(
            brokers=[mod.BrokerSpec(b, rack=f"r{b}",
                                    capacity=(1000.0, 1000.0, nw_out_cap,
                                              100.0))
                     for b in range(num_brokers)],
            partitions=parts)
        out.append(mod.flatten_spec(spec, **kw))
    return out[0], out[1]


def assert_reports_equal(jrep, trep):
    """Two what-if reports agree on every outcome, floats bit for bit."""
    assert trep.goals == jrep.goals
    assert len(trep.outcomes) == len(jrep.outcomes)
    for j, t in zip(jrep.outcomes, trep.outcomes):
        assert t.scenario.to_json() == j.scenario.to_json()
        what = j.scenario.name
        assert t.violated_goals == j.violated_goals, what
        assert t.violated_hard_goals == j.violated_hard_goals, what
        assert t.unavailable_partitions == j.unavailable_partitions, what
        assert t.offline_replicas == j.offline_replicas, what
        assert t.worst_broker == j.worst_broker, what
        assert t.risk == j.risk, what
        assert t.capacity_pressure == j.capacity_pressure, what
        assert t.headroom == j.headroom, what
    assert trep.riskiest().scenario.name == jrep.riskiest().scenario.name


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, *, what: str = "") -> None:
    """Exact equality of two arrays/tensors (values, shape)."""
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64),
                              equal_nan=True), f"{what}: float values differ"
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
            f"{what}: values differ"


def assert_close(a, b, *, rtol: float = 1e-6, what: str = "") -> None:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, err_msg=what)
