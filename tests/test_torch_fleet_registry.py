"""The port's fleet host side: ``tests/test_fleet_backends.py`` re-run
against the port's copies (breaker, backend, health machine, budget), the
registry tick / cache / zero-library-load / payload / guard cases of
``tests/test_fleet.py``, a tick held to the JAX registry's, and the
mesh-less ``parallel/sharding.py``. The port runs on ``device="cpu"``."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import cruise_control_tpu_torch.analyzer as ta
from cruise_control_tpu_torch.api.precompute import ProposalCache
from cruise_control_tpu_torch.core.runtime_obs import default_collector
from cruise_control_tpu_torch.fleet import FleetModel, FleetRegistry
from cruise_control_tpu_torch.parallel import sharding
from prom_lint import lint_prometheus_exposition

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
WINDOW_MS = 1000
#: tests/test_fleet.py's tick search
TICK_CFG = dict(num_replica_candidates=16, num_dest_candidates=4,
                num_swap_candidates=8, apply_per_iter=16, drain_batch=16,
                max_iters_per_goal=32)


# ---------------------------------------------------------------------------
# tests/test_fleet_backends.py against the port's copies
# ---------------------------------------------------------------------------

def _port_backend_tests():
    """``tests/test_fleet_backends.py`` with its imports pointed at the
    port."""
    src = (HERE / "test_fleet_backends.py").read_text()
    src = src.replace("cruise_control_tpu.", "cruise_control_tpu_torch.")
    spec = importlib.util.spec_from_loader("port_fleet_backend_tests",
                                           loader=None)
    module = importlib.util.module_from_spec(spec)
    exec(compile(src, str(HERE / "test_fleet_backends.py"), "exec"),
         module.__dict__)
    return module


_BACKENDS = _port_backend_tests()


@pytest.mark.parametrize("name", sorted(n for n in vars(_BACKENDS)
                                        if n.startswith("test_")))
def test_fleet_backend_case_on_port(name):
    assert getattr(_BACKENDS, name).__globals__["FleetRegistry"].\
        __module__ == "cruise_control_tpu_torch.fleet.registry"
    getattr(_BACKENDS, name)()


def _journal_walk(mod):
    """One member walked HEALTHY → DEGRADED → QUARANTINED, a failed probe,
    READMITTING, a failed fetch (requarantined), a good probe, HEALTHY;
    then a budget round journaled on the same ring. Returns the journal
    rows (host clock fields dropped), the notifier's alerts and the
    anomalies it was handed."""
    reg, journal, notifier = mod._registry(quarantine_after=2,
                                           breaker_failures=2,
                                           breaker_open_ms=1_000)
    seen = []
    on_anomaly = notifier.on_anomaly

    def record(anomaly, now):
        action = on_anomaly(anomaly, now)
        seen.append(dict(anomaly.to_json(), anomalyId=None,
                         action=action.result.name,
                         delayMs=action.delay_ms))
        return action
    notifier.on_anomaly = record
    h, mon = mod._member(reg)
    mon.fail = True
    mod._fail_fetch(reg, h, 1_000)
    mod._fail_fetch(reg, h, 2_000)
    probe_at = h.breaker.probe_at
    reg._collect_probes(reg._submit_probes([h], probe_at), probe_at)
    mon.fail = False
    probe_at = h.breaker.probe_at
    reg._collect_probes(reg._submit_probes([h], probe_at), probe_at)
    mon.fail = True
    mod._fail_fetch(reg, h, probe_at + 500)
    mon.fail = False
    now = probe_at + 2_000
    reg._collect_probes(reg._submit_probes([h], now), now)
    reg._on_fetch_ok(h, now + 1_000, mod._FakeResult())
    coord = mod.MoveBudgetCoordinator(budget_per_tick=9, journal=journal)
    coord.allocate([mod._req("m1", 8), mod._req("m2", 6, hard=1),
                    mod._req("m3", 4, tt=30_000)], now + 1_000)
    rows = [dict(e.to_json(), tsMs=None) for e in journal.query()]
    return rows, list(notifier.alerts), seen, str(h.health)


def test_journal_and_notifier_match_jax_registry():
    """The port's ``EventJournal`` and ``SelfHealingNotifier`` copies, fed
    by the port's registry and budget, record what the JAX package's
    record over the same health walk: every journal row (seq, action,
    severity, cause links, detail), every alert and every anomaly handed
    to the notifier."""
    import test_fleet_backends as ref
    assert ref.FleetRegistry.__module__ == "cruise_control_tpu.fleet.registry"
    want = _journal_walk(ref)
    got = _journal_walk(_BACKENDS)
    assert got == want
    rows, alerts, seen, health = got
    assert health == "HEALTHY"
    assert [r["action"] for r in rows] == [
        "member-degraded", "member-quarantined", "member-readmitting",
        "member-requarantined", "member-readmitting", "member-readmitted",
        "budget-allocated"]
    assert rows[1]["cause"] == rows[0]["seq"]
    assert len(seen) == 2 and {a["type"] for a in seen} == {
        "FLEET_MEMBER_QUARANTINED"}
    assert seen[0]["journalSeq"] == rows[1]["seq"]
    assert len(alerts) == 2


# ---------------------------------------------------------------------------
# Proposal cache scoping and namespaced sensors (tests/test_fleet.py)
# ---------------------------------------------------------------------------

class _StubMonitor:
    def __init__(self, generation=1):
        self.generation = generation


class _StubResult:
    stale_model = False


def test_proposal_cache_cluster_scoping():
    mon_a, mon_b = _StubMonitor(5), _StubMonitor(5)
    cache_a = ProposalCache(mon_a, optimizer=None, cache_id="a")
    cache_b = ProposalCache(mon_b, optimizer=None, cache_id="b")
    res = _StubResult()
    assert cache_a.store(res, generation=5, cache_id="a")
    assert cache_a.valid()
    with pytest.raises(ValueError, match="cross-serve"):
        cache_b.store(res, generation=5, cache_id="a")
    with pytest.raises(ValueError, match="cross-serve"):
        cache_b.store(res, generation=5)
    assert not cache_b.valid()
    assert not cache_a.store(res, generation=4, cache_id="a")
    cache_plain = ProposalCache(_StubMonitor(2), optimizer=None)
    assert cache_plain.store(res, generation=2)
    assert cache_a.registry.get(
        "ProposalCache.a.freshness-slo-breaches") is not None
    assert cache_a.freshness_json(0)["cacheId"] == "a"


def test_watch_only_refresh_never_computes():
    cache = ProposalCache(_StubMonitor(3), optimizer=None, cache_id="w")
    cache.freshness_target_ms = 1000
    assert cache.refresh_once(lambda: 5000, compute=False) is False
    assert cache.num_computations == 0
    assert cache.freshness_lag_ms(7000) == 2000


# ---------------------------------------------------------------------------
# The registry over simulated clusters
# ---------------------------------------------------------------------------

def _sim_cluster(pkg, num_brokers, partitions):
    sim = pkg.SimulatedKafkaCluster()
    for b in range(num_brokers):
        sim.add_broker(b, rate_mb_s=10_000.0)
    for p in range(partitions):
        sim.add_partition(f"t{p % 3}", p,
                          [p % num_brokers, (p + 1) % num_brokers],
                          size_mb=10.0 + p)
    return sim


class _Feed:
    """Deterministic dense sample feed (tests/test_fleet.py's)."""

    def __init__(self, sim, monitor):
        from cruise_control_tpu_torch.core.metricdef import \
            partition_metric_def
        self.monitor = monitor
        self.keys = sorted(sim.describe_partitions())
        self.M = partition_metric_def().size()
        self.next_window = 0

    def ingest(self, bump=0.0, windows=2):
        P = len(self.keys)
        vals = ((np.arange(P * self.M, dtype=np.float64)
                 .reshape(P, self.M) % 8) + 1.0 + bump)
        for _ in range(windows):
            times = np.full(P, self.next_window * WINDOW_MS + 100,
                            np.int64)
            self.monitor.partition_aggregator.add_samples_dense(
                self.keys, times, vals)
            self.next_window += 1

    @property
    def now_ms(self):
        return self.next_window * WINDOW_MS


def _torch_optimizer():
    return ta.TorchGoalOptimizer(goals=ta.goals_by_name(GOALS),
                                 config=ta.SearchConfig(**TICK_CFG),
                                 device="cpu")


def _registry(members, **kw):
    import cruise_control_tpu_torch.executor as tex
    from cruise_control_tpu_torch.monitor import LoadMonitor, MonitorConfig
    clock = {"now": 0}
    registry = FleetRegistry(_torch_optimizer(),
                             now_ms=lambda: clock["now"], **kw)
    feeds = []
    for cid, (b, p) in members:
        sim = _sim_cluster(tex, b, p)
        mon = LoadMonitor(sim, MonitorConfig(num_windows=4,
                                             window_ms=WINDOW_MS),
                          device="cpu")
        registry.register(cid, mon)
        feeds.append(_Feed(sim, mon))
    return registry, feeds, clock


def _advance(feeds, clock, bump):
    for f in feeds:
        f.ingest(bump=bump)
    clock["now"] = max(f.now_ms for f in feeds)


@pytest.fixture(scope="module")
def fleet_registry():
    return _registry((("east", (4, 24)), ("west", (6, 32))))


def test_tick_feeds_cluster_caches(fleet_registry):
    registry, feeds, clock = fleet_registry
    _advance(feeds, clock, bump=0.0)
    summary = registry.tick()
    assert summary == {"clusters": 2, "ready": 2, "proposed": 2,
                       "errors": 0, "skipped": 0, "quarantined": 0}
    for cid in ("east", "west"):
        h = registry.member(cid)
        assert h.cache.valid(), cid
        assert h.cache.cache_id == cid
        assert h.last_summary["balanceScore"] >= 0.0
        assert h.last_risk is not None and h.last_risk["scenarios"] > 0
    assert registry.tick()["skipped"] == 2


def test_cached_results_equal_fleet_propose(fleet_registry):
    """Each member's cache holds what ``FleetOptimizer.propose`` of the
    same served models computes."""
    registry, feeds, clock = fleet_registry
    _advance(feeds, clock, bump=0.5)
    registry.tick()
    served = [(cid, registry.member(cid).monitor.cluster_model(clock["now"]))
              for cid in ("east", "west")]
    fleet = FleetModel.stack(
        [(cid, r.model, r.metadata, r.generation, r.stale)
         for cid, r in served], device="cpu")
    want = registry.engine.propose(fleet, registry.options)
    for (cid, _r), w in zip(served, want):
        got = registry.member(cid).cache.fast_entry().result
        assert [p.to_json() for p in got.proposals] \
            == [p.to_json() for p in w.proposals], cid
        assert got.num_moves == w.num_moves
        assert [(g.name, g.violation_before, g.violation_after,
                 g.iterations) for g in got.goal_results] \
            == [(g.name, g.violation_before, g.violation_after,
                 g.iterations) for g in w.goal_results]


def test_warm_ticks_load_no_kernel_library(fleet_registry):
    """The zero-recompile gate of the reference becomes: warm ticks
    (fresh samples each — model rebuild, fleet propose, N-1 sweep) record
    no kernel-library build or load on the collector."""
    registry, feeds, clock = fleet_registry
    _advance(feeds, clock, bump=1.0)
    registry.tick()
    collector = default_collector()
    before = collector.snapshot()
    for i in range(3):
        _advance(feeds, clock, bump=2.0 + i)
        assert registry.tick()["proposed"] == 2
    after = collector.snapshot()
    for key in ("compileEvents", "aotCompileEvents", "recompileEvents"):
        assert after[key] == before[key], key


def test_partial_readiness_then_full():
    """A member still warming in is skipped (not ready, not a fault) and
    joins once it has samples; the layout is pinned to the member count."""
    registry, feeds, clock = _registry((("a", (4, 24)), ("b", (6, 32)),
                                        ("late", (4, 24))))
    _advance(feeds[:2], clock, bump=0.0)
    assert registry.tick() == {"clusters": 3, "ready": 2, "proposed": 2,
                               "errors": 0, "skipped": 0, "quarantined": 0}
    assert registry.engine.last_layout["clustersPadded"] == 3
    assert registry.member("late").last_error.startswith(
        "NotEnoughValidWindows")
    feeds[2].ingest(bump=0.0, windows=feeds[0].next_window)
    _advance(feeds, clock, bump=2.0)
    summary = registry.tick()
    assert summary["ready"] == 3 and summary["proposed"] == 3
    assert registry.member("late").cache.valid()


def test_summary_stats_and_merged_scrape(fleet_registry):
    registry, feeds, clock = fleet_registry
    if registry.member("west").last_risk is None:
        # the first test of the module on its xdist worker: tick once
        _advance(feeds, clock, bump=0.0)
        registry.tick()
    summary = registry.summary_json()
    assert summary["enabled"] and summary["numClusters"] == 2
    by_id = {c["clusterId"]: c for c in summary["clusters"]}
    assert by_id["east"]["freshness"]["cacheId"] == "east"
    assert by_id["west"]["risk"]["scenarios"] > 0
    assert summary["bucket"]["clusters"] == 2
    stats = registry.stats_json()
    assert stats["clusterCount"] == 2
    assert stats["bucket"]["brokersPadded"] >= 8
    assert stats["lastDispatchMs"] is not None and stats["ticks"] >= 1
    assert set(stats["members"]) == {"east", "west"}
    from cruise_control_tpu_torch.core.sensors import CompositeRegistry
    text = CompositeRegistry(registry.scrape_registries).expose_text()
    lint_prometheus_exposition(text, forbid_unlabeled_duplicates=True)
    assert "cc_east_LoadMonitor" in text and "cc_west_LoadMonitor" in text


def test_rebalance_forces_a_tick(fleet_registry):
    """The ``POST /fleet/rebalance`` payload: a forced tick recomputes
    every member even while its cache is valid."""
    registry, feeds, clock = fleet_registry
    _advance(feeds, clock, bump=9.0)
    registry.tick()
    payload = registry.rebalance()
    assert payload["tick"]["proposed"] == 2
    assert payload["tick"]["skipped"] == 0
    assert payload["numClusters"] == 2


def test_forecast_sweep_lands_on_members(fleet_registry):
    from cruise_control_tpu_torch.whatif import TrajectoryScale
    registry, _feeds, _clock = fleet_registry
    grid = [TrajectoryScale(horizon_ms=3_600_000, quantile=q,
                            factors=(("t0", f),))
            for q, f in ((0.5, 1.2), (0.9, 3.0))]
    out = registry.forecast_sweep(grid)
    assert [s["clusterId"] for s in out] == ["east", "west"]
    for s in out:
        assert len(s["scenarios"]) == 2
        assert registry.member(s["clusterId"]).last_forecast == s
    rows = {c["clusterId"]: c for c in registry.summary_json()["clusters"]}
    assert rows["east"]["forecast"]["riskiest"] == out[0]["riskiest"]


def test_registry_guards(fleet_registry):
    registry, _feeds, _clock = fleet_registry
    with pytest.raises(ValueError, match="already registered"):
        registry.register("east", registry.member("east").monitor)
    with pytest.raises(ValueError, match="does not match"):
        registry.register(
            "north", _StubMonitor(),
            proposal_cache=ProposalCache(_StubMonitor(), optimizer=None,
                                         cache_id="south"))
    small = FleetRegistry(registry.engine.optimizer, max_clusters=1)
    small.register("only", _StubMonitor())
    with pytest.raises(ValueError, match="fleet is full"):
        small.register("overflow", _StubMonitor())


def test_tick_matches_jax_registry():
    """One cold tick of each package's registry over the same simulated
    clusters and sample feeds: every member's cached proposals, moves and
    goal results, and its N-1 risk summary, are equal."""
    import cruise_control_tpu.analyzer as ja
    import cruise_control_tpu.executor as jex
    import cruise_control_tpu.fleet as jf
    import cruise_control_tpu.monitor as jmon
    import cruise_control_tpu_torch.executor as tex
    import cruise_control_tpu_torch.monitor as tmon
    jclock, tclock = {"now": 0}, {"now": 0}
    jreg = jf.FleetRegistry(
        ja.TpuGoalOptimizer(goals=ja.goals_by_name(GOALS),
                            config=ja.SearchConfig(**TICK_CFG)),
        now_ms=lambda: jclock["now"], max_devices=1)
    treg = FleetRegistry(_torch_optimizer(), now_ms=lambda: tclock["now"])
    feeds = []
    for cid, (b, p) in (("east", (4, 24)), ("west", (6, 32))):
        jmo = jmon.LoadMonitor(_sim_cluster(jex, b, p), jmon.MonitorConfig(
            num_windows=4, window_ms=WINDOW_MS))
        tsim = _sim_cluster(tex, b, p)
        tmo = tmon.LoadMonitor(tsim, tmon.MonitorConfig(
            num_windows=4, window_ms=WINDOW_MS), device="cpu")
        jreg.register(cid, jmo)
        treg.register(cid, tmo)
        feeds += [_Feed(tsim, jmo), _Feed(tsim, tmo)]
    _advance(feeds, jclock, bump=0.0)
    tclock["now"] = jclock["now"]
    assert treg.tick() == jreg.tick()
    for cid in ("east", "west"):
        jres = jreg.member(cid).cache.fast_entry().result
        tres = treg.member(cid).cache.fast_entry().result
        assert [p.to_json() for p in tres.proposals] \
            == [p.to_json() for p in jres.proposals], cid
        assert tres.num_moves == jres.num_moves
        assert [(g.name, g.violation_before, g.violation_after,
                 g.iterations, g.accepted) for g in tres.goal_results] \
            == [(g.name, g.violation_before, g.violation_after,
                 g.iterations, g.accepted) for g in jres.goal_results]
        assert treg.member(cid).last_risk == jreg.member(cid).last_risk
        assert treg.member(cid).last_summary \
            == jreg.member(cid).last_summary


# ---------------------------------------------------------------------------
# The mesh-less sharding path (K15)
# ---------------------------------------------------------------------------

def test_resolve_mesh_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert sharding.resolve_mesh_devices(0) == 0
    assert sharding.resolve_mesh_devices(-1) == 4
    assert sharding.resolve_mesh_devices(2) == 2
    assert sharding.resolve_mesh_devices(9) == 4


def test_one_device_mesh_and_fingerprint():
    mesh = sharding.make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.device == torch.device("cpu")
    assert sharding.make_mesh(1, device="cpu") == mesh
    assert sharding.mesh_fingerprint(None) is None
    assert sharding.mesh_fingerprint(mesh) == ("cpu",)
    with pytest.raises(ValueError, match="K15"):
        sharding.make_mesh(2, device="cpu")


def test_shard_model_is_the_identity_on_one_device():
    import cruise_control_tpu_torch.model.spec as tspec
    bs = [tspec.BrokerSpec(broker_id=i, rack="r0") for i in range(4)]
    ps = [tspec.PartitionSpec(topic="t", partition=p,
                              replicas=[p % 4, (p + 1) % 4])
          for p in range(16)]
    model, _md = tspec.flatten_spec(tspec.ClusterSpec(brokers=bs,
                                                      partitions=ps),
                                    device="cpu")
    mesh = sharding.make_mesh(device="cpu")
    assert sharding.shard_model(model, mesh) is model
    assert set(sharding.model_shardings(model, mesh).values()) == {None}
    wide = sharding.Mesh(devices=(torch.device("cpu"),) * 2)
    with pytest.raises(NotImplementedError, match="K15"):
        sharding.shard_model(model, wide)


def test_optimizer_runs_the_plain_path_on_a_one_device_mesh():
    import cruise_control_tpu_torch.model.spec as tspec
    bs = [tspec.BrokerSpec(broker_id=i, rack=f"r{i % 2}") for i in range(4)]
    ps = [tspec.PartitionSpec(topic="t", partition=p,
                              replicas=[p % 2, 1 - p % 2],
                              leader_load=(1.0, 20.0, 30.0, 200.0))
          for p in range(32)]
    model, md = tspec.flatten_spec(tspec.ClusterSpec(brokers=bs,
                                                     partitions=ps),
                                   device="cpu")
    kw = dict(goals=ta.goals_by_name(["ReplicaDistributionGoal"]),
              config=ta.SearchConfig(num_replica_candidates=16,
                                     apply_per_iter=16), device="cpu")
    opts = ta.OptimizationOptions(
        waived_hard_goals=frozenset({"RackAwareGoal"}))
    plain = ta.TorchGoalOptimizer(**kw).optimize(model, md, opts)
    meshed_opt = ta.TorchGoalOptimizer(
        mesh=sharding.make_mesh(device="cpu"), **kw)
    assert meshed_opt.mesh.size == 1
    meshed = meshed_opt.optimize(model, md, opts)
    assert [p.to_json() for p in meshed.proposals] \
        == [p.to_json() for p in plain.proposals]
    with pytest.raises(NotImplementedError, match="K15"):
        ta.TorchGoalOptimizer(
            mesh=sharding.Mesh(devices=(torch.device("cpu"),) * 2), **kw)
