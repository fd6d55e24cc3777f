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


# ---------------------------------------------------------------------------
# Monitor -> resident model: one simulated cluster, one sample feed, both
# packages' monitors
# ---------------------------------------------------------------------------

#: every FlatClusterModel field
MODEL_FIELDS = (
    "replica_broker", "leader_load", "follower_load", "partition_topic",
    "partition_valid", "replica_offline", "replica_pref_pos",
    "broker_capacity", "broker_rack", "broker_host", "broker_set",
    "broker_alive", "broker_new", "broker_demoted", "broker_broken_disk",
    "broker_valid")


def sim_both(num_brokers: int = 4, partitions: int = 24, *,
             num_topics: int = 3, size_mb=lambda p: 10.0 + p):
    """(jax_sim, torch_sim): the same ``SimulatedKafkaCluster`` built in
    each package — partition p of topic ``t{p % num_topics}`` on brokers
    ``[p % B, (p + 1) % B]``."""
    import cruise_control_tpu.executor as jex
    import cruise_control_tpu_torch.executor as tex
    out = []
    for mod in (jex, tex):
        sim = mod.SimulatedKafkaCluster()
        for b in range(num_brokers):
            sim.add_broker(b, rate_mb_s=10_000.0)
        for p in range(partitions):
            sim.add_partition(f"t{p % num_topics}", p,
                              [p % num_brokers, (p + 1) % num_brokers],
                              size_mb=size_mb(p))
        out.append(sim)
    return out[0], out[1]


def monitors_both(jsim, tsim, **cfg):
    """(jax_monitor, torch_monitor) over the two clusters, one
    ``MonitorConfig`` (four 1 s windows unless overridden); the port's on
    the CPU."""
    import cruise_control_tpu.monitor as jmon
    import cruise_control_tpu_torch.monitor as tmon
    conf = dict(num_windows=4, window_ms=1000, min_samples_per_window=1,
                num_broker_windows=4, broker_window_ms=1000)
    conf.update(cfg)
    return (jmon.LoadMonitor(jsim, jmon.MonitorConfig(**conf)),
            tmon.LoadMonitor(tsim, tmon.MonitorConfig(**conf), device="cpu"))


def base_values(num_partitions: int) -> np.ndarray:
    """float64[P, M] small-integer sample values (window means over equal
    values are exact, so only changed rows change a load row)."""
    from cruise_control_tpu_torch.core.metricdef import partition_metric_def
    M = partition_metric_def().size()
    return ((np.arange(num_partitions * M, dtype=np.float64)
             .reshape(num_partitions, M) % 8) + 1.0)


class SampleFeed:
    """A deterministic dense sample feed shared by several monitors (of
    either package). A metric-only cycle ingests the new value matrix into
    two windows so the changed window rolls out of the in-flight slot."""

    def __init__(self, sim, monitors, window_ms: int = 1000):
        self.monitors = monitors
        self.window_ms = window_ms
        self.keys = sorted(sim.describe_partitions())
        self.next_window = 0

    def refresh_keys(self, sim):
        self.keys = sorted(sim.describe_partitions())

    def ingest(self, vals, windows: int = 1, keep=None):
        """One window per call round; ``keep`` (bool[P]) samples only
        some partitions."""
        for _ in range(windows):
            keys, v = self.keys, vals
            if keep is not None:
                keys = [k for k, kp in zip(self.keys, keep) if kp]
                v = vals[keep]
            times = np.full(len(keys),
                            self.next_window * self.window_ms + 100, np.int64)
            for m in self.monitors:
                m.partition_aggregator.add_samples_dense(keys, times, v)
            self.next_window += 1

    @property
    def now_ms(self) -> int:
        return self.next_window * self.window_ms


def assert_models_equal(jmodel, tmodel, what: str = "") -> None:
    """Every ``FlatClusterModel`` field equal bit for bit (dtype too)."""
    for f in MODEL_FIELDS:
        a = np.asarray(getattr(jmodel, f))
        b = to_np(getattr(tmodel, f))
        assert a.dtype == b.dtype, f"{what}: {f} dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{what}: {f} shape {a.shape} != {b.shape}"
        assert np.array_equal(a, b), f"{what}: model.{f} differs"


def assert_results_equal(jres, tres, what: str = "") -> None:
    """Two ``ClusterModelResult``s agree: model, metadata, completeness,
    window times, generation and the stale flag."""
    assert_models_equal(jres.model, tres.model, what)
    jm, tm = jres.metadata, tres.metadata
    for f in ("broker_ids", "broker_index", "topics", "topic_index",
              "partition_keys", "partition_index", "racks", "hosts",
              "broker_sets"):
        assert getattr(tm, f) == getattr(jm, f), f"{what}: metadata.{f}"
    jc, tc = jres.completeness, tres.completeness
    for f in ("valid_windows", "valid_entity_ratio_by_window",
              "valid_entities", "num_total_entities", "generation"):
        assert getattr(tc, f) == getattr(jc, f), f"{what}: completeness.{f}"
    assert tres.window_times_ms == jres.window_times_ms, what
    assert tres.generation == jres.generation, what
    assert tres.stale == jres.stale, what
