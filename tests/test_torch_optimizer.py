"""Whole-slice parity: ``TorchGoalOptimizer`` (device="cpu", every kernel on
its plain twin) against ``TpuGoalOptimizer`` on the main path's chain with
the hard-goal audit — identical proposals, moves and per-goal iterations,
residuals bit for bit, the same audit verdicts — in the per-goal and
fused walks, with and without polish rounds, and with a dead broker. Also:
the port's entry points refuse a missing card, import and run with JAX
blocked (an optimize, a what-if N-1 sweep, a move schedule, a monitor
cycle, a ``stats_summary``, a population and a branched optimize and an
intra-broker rebalance), and import nothing of the JAX package."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu_torch.analyzer as ta
from torch_parity_util import build_both, tiny_both

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHAIN = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal"]
#: bench's main-path config (512/16/512/512), scaled down with the cluster
MAIN = dict(num_replica_candidates=128, num_dest_candidates=8,
            apply_per_iter=128, max_iters_per_goal=128)
WAIVE = dict(waived_hard_goals=frozenset({"RackAwareGoal"}))
MODELS = {"tiny": tiny_both,
          "20x1k": lambda: build_both(20, 1000, seed=9),
          "20x1k_dead": lambda: build_both(20, 1000, seed=10, dead=(4,)),
          "24x1k": lambda: build_both(24, 1000, seed=3)}
CASES = [("tiny", True, 128), ("tiny", False, 128),
         ("20x1k", True, 128), ("20x1k", False, 128),
         ("20x1k_dead", True, 128), ("24x1k", True, 128),
         # few iterations per pass, so residuals survive into the polish
         # rounds (fused and per-goal polish draw different key streams)
         ("20x1k", True, 2), ("20x1k", False, 2)]


def _run_both(model, fused, max_iters, seed=0, **opts):
    (jm, jmd), (tm, tmd) = MODELS[model]()
    cfg = dict(MAIN, max_iters_per_goal=max_iters, fused_chain=fused)
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN),
                               config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 config=ta.SearchConfig(**cfg), device="cpu")
    options = dict(WAIVE, seed=seed, **opts)
    jres = jopt.optimize(jm, jmd, ja.OptimizationOptions(**options))
    tres = topt.optimize(tm, tmd, ta.OptimizationOptions(**options))
    return jres, tres


def _goal_rows(results):
    return [(g.name, g.hard, g.iterations, g.accepted) for g in results]


@pytest.mark.parametrize("model,fused,max_iters", CASES)
def test_optimizer_parity(model, fused, max_iters):
    jres, tres = _run_both(model, fused, max_iters)
    assert tres.proposals == jres.proposals
    assert tres.num_moves == jres.num_moves > 0
    assert _goal_rows(tres.goal_results) == _goal_rows(jres.goal_results)
    for jg, tg in zip(jres.goal_results, tres.goal_results):
        for field in ("violation_before", "violation_after", "scale"):
            assert getattr(tg, field) == getattr(jg, field), \
                f"{jg.name} {field}"
        assert tg.satisfied == jg.satisfied
    assert [(g.name, g.satisfied) for g in tres.hard_goal_audit] == [
        (g.name, g.satisfied) for g in jres.hard_goal_audit]
    assert len(tres.hard_goal_audit) == 6
    for jg, tg in zip(jres.hard_goal_audit, tres.hard_goal_audit):
        assert ([tg.violation_before, tg.violation_after]
                == [jg.violation_before, jg.violation_after]), jg.name
    jt, tt = jres.telemetry, tres.telemetry
    assert tt["totalMoves"] == jt["totalMoves"]
    assert tt["violationTrajectory"] == jt["violationTrajectory"]
    assert (tres.provision_response.status.value
            == jres.provision_response.status.value)
    jjson, tjson = jres.to_json(), tres.to_json()
    assert tjson["summary"] == jjson["summary"]
    assert tjson["proposals"] == jjson["proposals"]
    assert tjson["violatedGoalsAfter"] == jjson["violatedGoalsAfter"]
    from cruise_control_tpu_torch.model.flat import sanity_check
    assert not any(sanity_check(tres.final_model).values())


def test_dead_broker_is_drained():
    _, tres = _run_both("20x1k_dead", True, 128, seed=3)
    (_, jmd), _ = MODELS["20x1k_dead"]()
    dead = jmd.broker_index[4]
    assert not (tres.final_model.replica_broker == dead).any()


def test_hard_goal_failure_matches_reference():
    tight = dict(capacity_threshold=(0.7, 0.8, 0.8, 0.001))
    (jm, jmd), (tm, tmd) = MODELS["tiny"]()
    cfg = dict(MAIN, fused_chain=True)
    jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(CHAIN),
                               constraint=ja.BalancingConstraint(**tight),
                               config=ja.SearchConfig(**cfg))
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 constraint=ta.BalancingConstraint(**tight),
                                 config=ta.SearchConfig(**cfg), device="cpu")
    with pytest.raises(ja.OptimizationFailureError) as jerr:
        jopt.optimize(jm, jmd, ja.OptimizationOptions(**WAIVE))
    with pytest.raises(ta.OptimizationFailureError) as terr:
        topt.optimize(tm, tmd, ta.OptimizationOptions(**WAIVE))
    assert str(terr.value) == str(jerr.value)
    assert terr.value.result.proposals == jerr.value.result.proposals
    skipped = topt.optimize(tm, tmd, ta.OptimizationOptions(
        skip_hard_goal_check=True))
    assert skipped.hard_goal_audit == []


def test_unwaived_rack_awareness_is_not_yet_ported():
    _, (tm, tmd) = MODELS["tiny"]()
    topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN),
                                 config=ta.SearchConfig(**MAIN), device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        topt.optimize(tm, tmd, ta.OptimizationOptions())


def test_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN))
    opt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN), device="cpu")
    assert opt.device.type == "cpu"


@pytest.mark.parametrize("kw,error,match", [
    (dict(population=2, branches=4), ValueError, "search.branches"),
    (dict(population=2, mesh=object()), ValueError, "search.mesh.devices"),
    (dict(population=ta.PopulationConfig(size=2, objective="bogus")),
     ValueError, "unknown population objective"),
    (dict(population=2, config=ta.SearchConfig(fused_chain=True)),
     ValueError, "search.fused.chain"),
    (dict(branches=4, mesh=object()), ValueError, "search.mesh.devices"),
    (dict(mesh=object()), NotImplementedError, "K15")])
def test_unported_search_modes_raise(kw, error, match):
    """The population and branched modes are ported and refuse the
    reference's exclusive combinations; a device mesh is not ported."""
    with pytest.raises(error, match=match):
        ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN), device="cpu",
                              **kw)


def test_model_on_another_device_is_refused():
    _, (tm, tmd) = MODELS["tiny"]()
    opt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(CHAIN), device="cpu")
    opt.device = torch.device("meta")
    with pytest.raises(ValueError, match="lies on"):
        opt.optimize(tm, tmd, ta.OptimizationOptions(**WAIVE))


_JAX_BLOCKED = r'''
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cruise_control_tpu"] = None
from cruise_control_tpu_torch.analyzer import (OptimizationOptions,
    SearchConfig, TorchGoalOptimizer, goals_by_name)
from cruise_control_tpu_torch.model.spec import (BrokerSpec, ClusterSpec,
    PartitionSpec, flatten_spec)
brokers = [BrokerSpec(broker_id=i, rack=f"r{i % 2}") for i in range(4)]
parts = [PartitionSpec(topic="t", partition=p, replicas=[p % 2, 1 - p % 2],
                       leader_load=(1.0, 20.0, 30.0, 200.0))
         for p in range(32)]
model, md = flatten_spec(ClusterSpec(brokers=brokers, partitions=parts),
                         device="cpu")
opt = TorchGoalOptimizer(goals=goals_by_name(["ReplicaDistributionGoal"]),
                         config=SearchConfig(num_replica_candidates=16,
                                             apply_per_iter=16),
                         device="cpu")
res = opt.optimize(model, md, OptimizationOptions(
    waived_hard_goals=frozenset({"RackAwareGoal"})))
assert res.num_moves > 0 and res.goal_results[0].satisfied
from cruise_control_tpu_torch.executor import (DeviceMoveScheduler,
    ExecutionConcurrencyManager)
from cruise_control_tpu_torch.whatif import WhatIfEngine, n1_sweep
report = WhatIfEngine(goals=goals_by_name(["ReplicaDistributionGoal"]),
                      device="cpu").sweep(model, md, n1_sweep(md.broker_ids))
assert report.num_scenarios == 4
sched = DeviceMoveScheduler(device="cpu").schedule(
    res.proposals, ExecutionConcurrencyManager(), model=model, metadata=md,
    goals=goals_by_name(["ReplicaCapacityGoal"]))
assert sched.num_moves == sum(p.has_replica_action for p in res.proposals)
assert sched.stats["unrepaired_violations"] == 0
import numpy as np
from cruise_control_tpu_torch.executor import SimulatedKafkaCluster
from cruise_control_tpu_torch.model.stats import stats_summary
from cruise_control_tpu_torch.monitor import LoadMonitor, MonitorConfig
sim = SimulatedKafkaCluster()
for b in range(4):
    sim.add_broker(b)
for p in range(32):
    sim.add_partition("t", p, [p % 4, (p + 1) % 4])
monitor = LoadMonitor(sim, MonitorConfig(num_windows=2, window_ms=1000),
                      device="cpu")
keys = sorted(sim.describe_partitions())
for w in range(3):
    monitor.partition_aggregator.add_samples_dense(
        keys, np.full(32, w * 1000 + 100, np.int64), np.ones((32, 9)))
served = monitor.cluster_model(3000)
assert monitor.resident.last_update == "full"
assert stats_summary(served.model, device="cpu")["numReplicas"] == 64
search = dict(goals=goals_by_name(["ReplicaDistributionGoal"]),
              config=SearchConfig(num_replica_candidates=16,
                                  apply_per_iter=16), device="cpu")
waive = OptimizationOptions(waived_hard_goals=frozenset({"RackAwareGoal"}))
pop = TorchGoalOptimizer(population=2, **search).optimize(model, md, waive)
assert pop.telemetry["population"]["size"] == 2
branched = TorchGoalOptimizer(branches=2, **search).optimize(model, md, waive)
assert branched.num_moves > 0
from cruise_control_tpu_torch.analyzer import intra_broker_rebalance
from cruise_control_tpu_torch.config import FixedCapacityResolver
jbod = SimulatedKafkaCluster()
for b in range(4):
    jbod.add_broker(b, logdirs=("d0", "d1"))
for p in range(32):
    jbod.add_partition("t", p, [p % 2, 1 - p % 2], size_mb=200.0,
                       logdir_by_broker={0: "d0", 1: "d0"})
disks = intra_broker_rebalance(model, md, jbod, FixedCapacityResolver())
assert disks.moves and disks.iterations > 0
assert not any(m == "jax" or m.startswith(("jax.", "flax"))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", res.num_moves, report.riskiest().scenario.name,
      len(sched.batches), pop.num_moves, branched.num_moves,
      len(disks.moves))
'''


def test_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("OK")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "cruise_control_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py", "profile_main_path.py"]))
def test_port_imports_nothing_of_jax(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "cruise_control_tpu",
                           "bench", "__graft_entry__"), (path, name)
