"""Parity of the port's monitor (``cruise_control_tpu_torch.monitor``) with
the JAX package's: one simulated cluster and one sample feed go into
``cruise_control_tpu``'s ``LoadMonitor`` and the port's
``LoadMonitor(device="cpu")``; every ``FlatClusterModel`` field, the
metadata and the completeness must be equal bit for bit — on the dense and
the legacy pipeline, with bench's 1-in-7 sparsity, and through
``LoadMonitorTaskRunner`` + ``SyntheticWorkloadSampler``. Mirrors
``tests/test_monitor.py`` (the cases that need no metrics processor) and
runs ``tests/test_aggregator.py`` against the port's aggregator."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.monitor as jmon
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.monitor as tmon
from cruise_control_tpu.core.metricdef import KafkaMetric
from torch_parity_util import (SampleFeed, assert_models_equal,
                               assert_results_equal, base_values,
                               monitors_both, sim_both, to_np)

torch.set_num_threads(1)

WINDOW_MS = 1000
HERE = pathlib.Path(__file__).resolve().parent


def _fetch_windows(monitors, sims, n_windows, *, start=0):
    """``test_monitor.sample_windows`` for both packages: one
    ``SyntheticWorkloadSampler`` round per window."""
    for mon, sim, pkg in zip(monitors, sims, (jmon, tmon)):
        fetcher = pkg.MetricFetcherManager(pkg.SyntheticWorkloadSampler(sim))
        partitions = sorted(sim.describe_partitions())
        brokers = sorted(sim.describe_cluster())
        for w in range(n_windows):
            t = start + (w + 1) * WINDOW_MS - 1
            mon.add_samples(fetcher.fetch(partitions, brokers, t - 1, t))


def _pair(num_brokers=4, partitions=12, **cfg):
    jsim, tsim = sim_both(num_brokers, partitions)
    return (jsim, tsim), monitors_both(jsim, tsim, **cfg)


def _spec_rows(spec):
    return [(p.topic, p.partition, list(p.replicas), tuple(p.leader_load),
             p.follower_load and tuple(p.follower_load),
             list(p.offline_replicas), list(p.preferred_replicas))
            for p in spec.partitions]


def test_cluster_model_from_samples_and_completeness_gate():
    sims, (jm, tm) = _pair()
    _fetch_windows((jm, tm), sims, 1)
    req = (jmon.ModelCompletenessRequirements(1, 0.0),
           tmon.ModelCompletenessRequirements(1, 0.0))
    with pytest.raises(jmon.NotEnoughValidWindowsException):
        jm.cluster_model(WINDOW_MS + 1, req[0])
    with pytest.raises(tmon.NotEnoughValidWindowsException):
        tm.cluster_model(WINDOW_MS + 1, req[1])
    _fetch_windows((jm, tm), sims, 3, start=WINDOW_MS)
    jr = jm.cluster_model(4 * WINDOW_MS,
                          jmon.ModelCompletenessRequirements(2, 0.9))
    tr = tm.cluster_model(4 * WINDOW_MS,
                          tmon.ModelCompletenessRequirements(2, 0.9))
    assert_results_equal(jr, tr)
    assert tr.model.device.type == "cpu"
    assert _spec_rows(tr.spec) == _spec_rows(jr.spec)
    assert set(tr.partition_windows) == set(jr.partition_windows)
    for k, v in jr.partition_windows.items():
        assert np.array_equal(tr.partition_windows[k], v)
    p0 = {(p.topic, p.partition): p for p in tr.spec.partitions}[("t0", 0)]
    assert p0.leader_load[1] > 0 and p0.leader_load[3] == 10.0


def test_meets_completeness_requirements():
    sims, (jm, tm) = _pair()
    reqs = [pkg.ModelCompletenessRequirements(
        min_required_num_windows=2, min_monitored_partitions_percentage=0.5)
        for pkg in (jmon, tmon)]
    assert (tm.meets_completeness_requirements(reqs[1], WINDOW_MS)
            is jm.meets_completeness_requirements(reqs[0], WINDOW_MS)
            is False)
    _fetch_windows((jm, tm), sims, 4)
    assert (tm.meets_completeness_requirements(reqs[1], 4 * WINDOW_MS)
            is jm.meets_completeness_requirements(reqs[0], 4 * WINDOW_MS)
            is True)
    assert tm.state(4 * WINDOW_MS).to_json() == \
        jm.state(4 * WINDOW_MS).to_json()


def test_model_marks_dead_broker_replicas_offline():
    sims, (jm, tm) = _pair()
    _fetch_windows((jm, tm), sims, 4)
    for sim in sims:
        sim.kill_broker(2)
    jr, tr = jm.cluster_model(4 * WINDOW_MS), tm.cluster_model(4 * WINDOW_MS)
    assert_results_equal(jr, tr)
    assert _spec_rows(tr.spec) == _spec_rows(jr.spec)
    offline = [p for p in tr.spec.partitions if 2 in p.offline_replicas]
    assert offline and all(2 in p.replicas for p in offline)


def test_monitor_to_optimizer_end_to_end():
    sims, (jm, tm) = _pair(partitions=16)
    _fetch_windows((jm, tm), sims, 4)
    jr, tr = jm.cluster_model(4 * WINDOW_MS), tm.cluster_model(4 * WINDOW_MS)
    goals = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
    waive = dict(waived_hard_goals=frozenset({"RackAwareGoal"}))
    jres = ja.TpuGoalOptimizer(goals=ja.goals_by_name(goals)).optimize(
        jr.model, jr.metadata, ja.OptimizationOptions(**waive))
    tres = ta.TorchGoalOptimizer(goals=ta.goals_by_name(goals),
                                 device="cpu").optimize(
        tr.model, tr.metadata, ta.OptimizationOptions(**waive))
    assert tres.proposals == jres.proposals
    for g in tres.goal_results:
        assert g.violation_after <= g.violation_before + 1e-6


def test_sample_store_checkpoint_replay(tmp_path):
    """Both packages' runners sample into their own file stores; fresh
    monitors replay them and build identical models."""
    sims = sim_both(4, 12)
    stores = [str(tmp_path / sub) for sub in ("jax", "port")]

    def runners(monitors):
        return [pkg.LoadMonitorTaskRunner(
            mon, pkg.MetricFetcherManager(pkg.SyntheticWorkloadSampler(sim),
                                          store=pkg.FileSampleStore(store)),
            sampling_interval_ms=WINDOW_MS)
            for pkg, mon, sim, store in zip((jmon, tmon), monitors, sims,
                                            stores)]
    for pkg, runner in zip((jmon, tmon), runners(monitors_both(*sims))):
        runner.start(0)
        assert runner.state is pkg.RunnerState.RUNNING
        for w in range(4):
            assert runner.maybe_run_sampling((w + 1) * WINDOW_MS)
        assert not runner.maybe_run_sampling(4 * WINDOW_MS + 1)
    monitors = monitors_both(*sims)           # the restart
    replayed = [r.start(4 * WINDOW_MS) for r in runners(monitors)]
    assert replayed[1] == replayed[0] > 0
    assert_results_equal(
        *(mon.cluster_model(4 * WINDOW_MS,
                            pkg.ModelCompletenessRequirements(2, 0.9))
          for pkg, mon in zip((jmon, tmon), monitors)))


def test_pause_resume_and_bootstrap():
    sims, (jm, tm) = _pair()
    runners = [pkg.LoadMonitorTaskRunner(
        mon, pkg.MetricFetcherManager(pkg.SyntheticWorkloadSampler(sim)),
        sampling_interval_ms=WINDOW_MS)
        for pkg, mon, sim in zip((jmon, tmon), (jm, tm), sims)]
    for r in runners:
        r.start(4 * WINDOW_MS, skip_loading=True)
        r.pause("test")
        assert r.state.value == "PAUSED"
        assert not r.maybe_run_sampling(10 * WINDOW_MS)
        r.resume()
        assert r.bootstrap(0, 4 * WINDOW_MS) == 4
    assert runners[1].state_json() == runners[0].state_json()
    reqs = [pkg.ModelCompletenessRequirements(2, 0.9) for pkg in (jmon, tmon)]
    assert_results_equal(jm.cluster_model(4 * WINDOW_MS, reqs[0]),
                         tm.cluster_model(4 * WINDOW_MS, reqs[1]))
    for r in runners:
        with r.training():
            assert r.state.value == "TRAINING"
        assert r.state.value == "RUNNING"


def test_retain_current_topology_drops_stale_entities():
    from cruise_control_tpu_torch.core.aggregator import MetricSample
    sims, (_jm, tm) = _pair()
    _fetch_windows((_jm, tm), sims, 2)
    tm.partition_aggregator.add_sample(MetricSample(
        entity=("gone", 0), sample_time_ms=WINDOW_MS, values={0: 1.0}))
    assert ("gone", 0) in tm.partition_aggregator.all_entities()
    tm.retain_current_topology()
    assert ("gone", 0) not in tm.partition_aggregator.all_entities()


def test_disk_scores_latest_window_not_average():
    """DISK is the latest valid window, CPU the window average (ref
    KafkaMetricDef.java:44): the burst reaches the port's model and its
    DiskCapacityGoal, as the reference's."""
    from cruise_control_tpu.config.capacity import BrokerCapacityInfo as JCI
    from cruise_control_tpu.core.resources import Resource as JR
    from cruise_control_tpu_torch.config.capacity import \
        BrokerCapacityInfo as TCI
    from cruise_control_tpu_torch.core.resources import Resource as TR
    jsim, tsim = sim_both(2, 2, num_topics=1, size_mb=lambda p: 10.0)
    jm, tm = monitors_both(jsim, tsim)
    for mon, info, res in ((jm, JCI, JR), (tm, TCI, TR)):
        cap = info({res.CPU: 100.0, res.NW_IN: 1e6, res.NW_OUT: 1e6,
                    res.DISK: 100.0})
        mon.capacity_resolver = type(
            "TinyDisk", (), {"capacity_for_broker":
                             lambda self, *a, _c=cap: _c})()
    for w, disk in enumerate([10.0, 10.0, 10.0, 10.0, 95.0]):
        t = (w + 1) * WINDOW_MS - 1
        for mon, pkg in ((jm, jmon), (tm, tmon)):
            samples = []
            for part in (0, 1):
                s = pkg.PartitionMetricSample("t0", part, t)
                s.record(KafkaMetric.CPU_USAGE, 1.0 + w)
                s.record(KafkaMetric.LEADER_BYTES_IN, 4.0)
                s.record(KafkaMetric.LEADER_BYTES_OUT, 5.0)
                s.record(KafkaMetric.DISK_USAGE, disk if part == 0 else 1.0)
                samples.append(s)
            mon.add_samples(pkg.Samples(samples, []))
    for mon, pkg in ((jm, jmon), (tm, tmon)):
        roll = pkg.PartitionMetricSample("t0", 0, 5 * WINDOW_MS + 1)
        for m in range(4):
            roll.record(m, 0.0)
        mon.add_samples(pkg.Samples([roll], []))
    jr, tr = jm.cluster_model(5 * WINDOW_MS + 1), \
        tm.cluster_model(5 * WINDOW_MS + 1)
    assert_results_equal(jr, tr)
    idx = tr.metadata.partition_index[("t0", 0)]
    lead = to_np(tr.model.leader_load)
    assert lead[idx, 3] == np.float32(95.0)
    assert lead[idx, 0] == np.float32((2 + 3 + 4 + 5) / 4)
    tres = ta.TorchGoalOptimizer(goals=ta.goals_by_name(["DiskCapacityGoal"]),
                                 device="cpu").optimize(
        tr.model, tr.metadata, ta.OptimizationOptions(
            skip_hard_goal_check=True))
    jres = ja.TpuGoalOptimizer(goals=ja.goals_by_name(
        ["DiskCapacityGoal"])).optimize(jr.model, jr.metadata,
                                        ja.OptimizationOptions(
                                            skip_hard_goal_check=True))
    assert tres.goal_results[0].violation_before > 0.0
    assert (tres.goal_results[0].violation_before
            == jres.goal_results[0].violation_before)


def test_min_valid_partition_ratio_gates_default_model_builds():
    jsim, tsim = sim_both(2, 10, num_topics=1)
    jm, tm = monitors_both(jsim, tsim, num_windows=2,
                           min_valid_partition_ratio=0.95)
    for mon, pkg in ((jm, jmon), (tm, tmon)):
        batch = []
        for p, t in [(p, 500) for p in range(5)] + [(0, 1500)]:
            s = pkg.PartitionMetricSample("t0", p, t)
            for m in range(4):
                s.record(m, 10.0 if m == 3 else 1.0)
            batch.append(s)
        mon.add_samples(pkg.Samples(batch, []))
    with pytest.raises(jmon.NotEnoughValidWindowsException):
        jm.cluster_model(1800)
    with pytest.raises(tmon.NotEnoughValidWindowsException):
        tm.cluster_model(1800)
    assert_results_equal(
        jm.cluster_model(1800, jmon.ModelCompletenessRequirements(
            min_monitored_partitions_percentage=0.3)),
        tm.cluster_model(1800, tmon.ModelCompletenessRequirements(
            min_monitored_partitions_percentage=0.3)))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "legacy"])
def test_pipeline_matches_reference_after_failover(dense):
    """``test_monitor.py:625``: the dense and the legacy assemblers of the
    port build the reference's model (leader-first rotation after a
    failover, offline marks), windows and completeness."""
    jsim, tsim = sim_both(4, 16)
    jm, tm = monitors_both(jsim, tsim, dense_pipeline=dense)
    _fetch_windows((jm, tm), (jsim, tsim), 4)
    for sim in (jsim, tsim):
        sim.kill_broker(0)
    jr, tr = jm.cluster_model(4 * WINDOW_MS), tm.cluster_model(4 * WINDOW_MS)
    assert_results_equal(jr, tr)
    assert (to_np(tr.model.replica_pref_pos)[
        to_np(tr.model.partition_valid)] != 0).any()
    assert set(tr.partition_windows) == set(jr.partition_windows)
    for tp, v in jr.partition_windows.items():
        assert np.array_equal(tr.partition_windows[tp], v)
    assert (tm.resident is not None) == dense


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "legacy"])
def test_sparse_history_matches_reference(dense):
    """bench's model-build history (``bench.py:113-186``): every 7th
    partition sampled only every third window, so the extrapolation ladder
    is on the path; dense and legacy equal the reference and each other."""
    jsim, tsim = sim_both(8, 140, num_topics=2,
                          size_mb=lambda p: 50.0 + (p % 100))
    jm, tm = monitors_both(jsim, tsim, dense_pipeline=dense)
    other = monitors_both(jsim, tsim, dense_pipeline=not dense)[1]
    feed = SampleFeed(jsim, [jm, tm, other])
    rng = np.random.default_rng(11)
    P = len(feed.keys)
    for w in range(5):
        vals = np.abs(rng.normal(10.0, 3.0, size=(P, 9)))
        keep = np.ones(P, bool)
        keep[::7] = (w % 3 == 0)
        feed.ingest(vals, keep=keep)
    jr, tr = jm.cluster_model(feed.now_ms), tm.cluster_model(feed.now_ms)
    assert_results_equal(jr, tr)
    assert_models_equal(tr.model, other.cluster_model(feed.now_ms).model,
                        "dense vs legacy")


def test_dense_pipeline_lazy_spec_matches_reference():
    sims, (jm, tm) = _pair()
    _fetch_windows((jm, tm), sims, 4)
    jr, tr = jm.cluster_model(4 * WINDOW_MS), tm.cluster_model(4 * WINDOW_MS)
    assert tr._spec is None          # not built until asked
    assert _spec_rows(tr.spec) == _spec_rows(jr.spec)
    assert [b.broker_id for b in tr.spec.brokers] == \
        [b.broker_id for b in jr.spec.brokers]


def test_fetcher_retries_transient_sampler_failures():
    class Flaky:
        def __init__(self, fail_times):
            self.fail_times = fail_times
            self.calls = 0

        def get_samples(self, assignment):
            self.calls += 1
            if self.calls <= self.fail_times:
                raise RuntimeError("transient broker hiccup")
            return tmon.Samples([], [])

    f = tmon.MetricFetcherManager(Flaky(2), max_retries=2)
    assert f.fetch([("t", 0)], [0], 0, 1000).partition_samples == []
    assert f.registry.meter(
        "MetricFetcherManager.partition-samples-fetcher-failure-rate"
    ).count == 2
    with pytest.raises(RuntimeError, match="transient"):
        tmon.MetricFetcherManager(Flaky(3), max_retries=2).fetch(
            [("t", 0)], [0], 0, 1000)


def test_monitor_needs_the_card_and_refuses_a_mesh(monkeypatch):
    tsim = sim_both(2, 4)[1]
    with pytest.raises(NotImplementedError, match="K15"):
        tmon.LoadMonitor(tsim, device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmon.LoadMonitor(tsim)


def test_admin_reads_retry_on_the_ports_admin_errors():
    """``monitor.py:304``: a transient admin timeout is retried through the
    shared policy with the port's ``RETRYABLE_ADMIN_ERRORS``."""
    from cruise_control_tpu_torch.core.retry import RetryPolicy
    from cruise_control_tpu_torch.executor import AdminTimeoutError
    tsim = sim_both(4, 12)[1]
    calls = {"n": 0}
    real = tsim.describe_partitions

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise AdminTimeoutError("controller busy")
        return real()
    mon = tmon.LoadMonitor(tsim, tmon.MonitorConfig(
        num_windows=4, window_ms=WINDOW_MS, min_samples_per_window=1),
        device="cpu", admin_retry=RetryPolicy(max_attempts=3),
        sleep_ms=lambda ms: None)
    feed = SampleFeed(tsim, [mon])
    feed.ingest(base_values(12), windows=5)
    tsim.describe_partitions = flaky
    res = mon.cluster_model(feed.now_ms)
    assert calls["n"] >= 2 and len(res.metadata.partition_keys) == 12


# ---------------------------------------------------------------------------
# tests/test_aggregator.py against the port's aggregator
# ---------------------------------------------------------------------------

def _port_aggregator_tests():
    """``tests/test_aggregator.py`` with its imports pointed at the port."""
    src = (HERE / "test_aggregator.py").read_text()
    src = src.replace("cruise_control_tpu.", "cruise_control_tpu_torch.")
    spec = importlib.util.spec_from_loader("port_aggregator_tests",
                                           loader=None)
    module = importlib.util.module_from_spec(spec)
    exec(compile(src, str(HERE / "test_aggregator.py"), "exec"),
         module.__dict__)
    return module


_AGG = _port_aggregator_tests()


@pytest.mark.parametrize("name", sorted(n for n in vars(_AGG)
                                        if n.startswith("test_")))
def test_aggregator_case_on_port(name):
    assert getattr(_AGG, name).__globals__["MetricSampleAggregator"].\
        __module__ == "cruise_control_tpu_torch.core.aggregator"
    getattr(_AGG, name)()


def test_aggregator_matches_reference_bit_for_bit():
    """Random sparse histories into both packages' aggregators: the dense
    aggregates (values, extrapolations, completeness) are identical."""
    from cruise_control_tpu.core import aggregator as jagg
    from cruise_control_tpu.core.metricdef import partition_metric_def as jdef
    from cruise_control_tpu_torch.core import aggregator as tagg
    from cruise_control_tpu_torch.core.metricdef import \
        partition_metric_def as tdef
    rng = np.random.default_rng(5)
    aggs = [mod.MetricSampleAggregator(4, WINDOW_MS, 2, mdef(),
                                       entity_group_fn=lambda e: e[0])
            for mod, mdef in ((jagg, jdef), (tagg, tdef))]
    entities = [(f"t{i % 3}", i) for i in range(40)]
    for w in range(6):
        for _ in range(3):
            keep = rng.random(len(entities)) > 0.3
            ents = [e for e, k in zip(entities, keep) if k]
            vals = rng.normal(5.0, 2.0, size=(len(ents), 9))
            vals[rng.random(vals.shape) < 0.1] = np.nan
            times = w * WINDOW_MS + rng.integers(0, WINDOW_MS, len(ents))
            for agg in aggs:
                agg.add_samples_dense(ents, times.astype(np.int64), vals)
    out = []
    for mod, agg in zip((jagg, tagg), aggs):
        opts = mod.AggregationOptions(
            min_valid_entity_ratio=0.0, min_valid_windows=0,
            max_allowed_extrapolations_per_entity=2,
            granularity=mod.AggregationGranularity.ENTITY_GROUP,
            interested_entities=set(entities))
        out.append(agg.aggregate(0, 10**9, opts, use_dense=True))
    jd, td = out[0].dense, out[1].dense
    assert np.array_equal(td.values, jd.values, equal_nan=True)
    assert np.array_equal(td.extrapolations, jd.extrapolations)
    assert td.window_times_ms == jd.window_times_ms
    assert td.entities == jd.entities
    assert out[1].completeness.valid_entities == \
        out[0].completeness.valid_entities
