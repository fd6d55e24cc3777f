"""The population search of the port against the JAX package's
(``tests/test_population.py``): K = 1 against the port's sequential walk and
the reference's K = 1, K = 2 against the reference's optimizer telemetry,
the joint-scoring helpers and KI's twin against the reference's eager and
compiled forms (ties at the tolerance cutoff, NaN, hard and move weights,
every goal count up to 22, and at 23-32 goals the program's own
fusions and the refusal of a single plan or a move weight there; wider
rows: ``test_torch_weighted_row.py``), the layout and survivor arithmetic, plan
selection, the constructor's exclusivity, the tuner and the tuned-config
store, and the aliasing of adopted plans. The port runs on
``device="cpu"``, where KI takes its plain twin; equal means bit for bit.
(K = 4 against every output of the reference's program:
``test_torch_population_k4.py``.)"""

import json
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.analyzer.engine as jeng
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.analyzer.engine as teng
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.parallel import (n_survivors,
                                               population_layout,
                                               select_plan)

torch.set_num_threads(1)

#: ``tests/test_population.py``'s schedule
CFG = dict(num_replica_candidates=64, num_dest_candidates=8,
           num_swap_candidates=0, apply_per_iter=32, max_iters_per_goal=48,
           drain_rounds=0, polish_passes=1)
PARITY_GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"]
AB_GOALS = ["ReplicaDistributionGoal"]
OPTS = dict(seed=5, skip_hard_goal_check=True)


def _models(partitions=128, brokers=8, pad_to=None):
    """``tests/test_population.py``'s model in both packages."""
    out = []
    for mod, kw in ((jspec, {}), (tspec, {"device": "cpu"})):
        parts = [mod.PartitionSpec(topic=f"t{p % 8}", partition=p,
                                   replicas=[p % 2, 2 + p % 2],
                                   leader_load=(1.0, 10.0, 12.0,
                                                80.0 + p % 7))
                 for p in range(partitions)]
        out.append(mod.flatten_spec(mod.ClusterSpec(
            brokers=[mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}")
                     for i in range(brokers)], partitions=parts),
            pad_partitions_to=pad_to or partitions, **kw))
    return out[0], out[1]


@pytest.fixture(scope="module")
def models():
    return _models()


def _port(goals, **kw):
    return ta.TorchGoalOptimizer(goals=ta.goals_by_name(goals),
                                 config=ta.SearchConfig(**CFG), device="cpu",
                                 **kw)


def _ref(goals, **kw):
    return ja.TpuGoalOptimizer(goals=ja.goals_by_name(goals),
                               config=ja.SearchConfig(**CFG), **kw)


def _goal_rows(res):
    return [(g.name, g.violation_before, g.violation_after, g.iterations,
             g.accepted, g.scale) for g in res.goal_results]


def _population(res):
    """The population section without ``devices`` (the reference spreads
    members over its virtual devices, the port runs on one)."""
    section = dict(res.telemetry["population"])
    section.pop("devices")
    return section


def test_population_k1_equals_the_sequential_walk(models):
    (jm, jmd), (tm, tmd) = models
    seq = _port(PARITY_GOALS).optimize(tm, tmd, ta.OptimizationOptions(**OPTS))
    pop = _port(PARITY_GOALS, population=1).optimize(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    assert pop.proposals == seq.proposals
    assert pop.num_moves == seq.num_moves > 0
    assert _goal_rows(pop) == _goal_rows(seq)
    assert (pop.telemetry["violationTrajectory"]
            == seq.telemetry["violationTrajectory"])
    ps = pop.telemetry["population"]
    assert ps["size"] == 1 and ps["winner"] == 0 and ps["devices"] == 1
    assert ps["winnerIsAnchor"] and ps["paretoFrontSize"] == 1

    ref = _ref(PARITY_GOALS, population=1).optimize(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    assert pop.proposals == ref.proposals
    assert _goal_rows(pop) == _goal_rows(ref)
    assert (pop.telemetry["violationTrajectory"]
            == ref.telemetry["violationTrajectory"])
    assert _population(pop) == _population(ref)


@pytest.mark.parametrize("objective", ["weighted", "pareto"])
def test_population_k2_matches_reference_and_is_deterministic(models,
                                                              objective):
    (jm, jmd), (tm, tmd) = models
    ref = _ref(AB_GOALS, population=ja.PopulationConfig(
        size=2, objective=objective)).optimize(
        jm, jmd, ja.OptimizationOptions(**OPTS))
    opt = _port(AB_GOALS, population=ta.PopulationConfig(
        size=2, objective=objective))
    kernels.reset_launch_counts()
    pop = opt.optimize(tm, tmd, ta.OptimizationOptions(**OPTS))
    # on the CPU the wrapper takes its twin and counts nothing
    assert kernels.LAUNCHES["population_select"] == 0
    assert pop.proposals == ref.proposals
    assert _goal_rows(pop) == _goal_rows(ref)
    assert (pop.telemetry["violationTrajectory"]
            == ref.telemetry["violationTrajectory"])
    ps = pop.telemetry["population"]
    assert _population(pop) == _population(ref)
    assert ps["perGoalAcceptance"][ps["winner"]] == [
        g.accepted for g in pop.goal_results]
    assert sum(g.accepted for g in pop.goal_results) == pop.num_moves
    assert all(perm[0] == 0 for perm in ps["survivorPerms"])
    assert opt.last_population_stats == ps
    again = opt.optimize(tm, tmd, ta.OptimizationOptions(**OPTS))
    assert again.telemetry["population"] == ps
    assert again.proposals == pop.proposals
    assert ta.plan_quality(pop) == ja.plan_quality(ref)


# ------------------------------------------------------------ scoring units

def _stacks_at_the_cutoff(G, rng):
    """float32 stacks over G goals whose scales make the compiled (FMA) and
    the eager tolerance differ, with entries exactly at each tolerance,
    exact zeros, duplicate rows (ties) and one NaN row."""
    scales = np.empty(G, np.float32)
    for g in range(G):
        while True:
            s = np.float32(rng.random() * 10.0 ** rng.integers(0, 8))
            plain = np.float32(np.float32(1e-6) + np.float32(1e-6) * s)
            fused = np.float32(np.float64(np.float32(1e-6)) * np.float64(s)
                               + np.float64(np.float32(1e-6)))
            if plain != fused:
                scales[g] = s
                break
    plain = (np.float32(1e-6) + np.float32(1e-6) * scales).astype(np.float32)
    fused = (np.float64(np.float32(1e-6)) * scales.astype(np.float64)
             + np.float64(np.float32(1e-6))).astype(np.float32)
    stacks = (rng.random((12, G)) * 10.0 ** rng.integers(-6, 4, (12, G))
              ).astype(np.float32)
    stacks[0] = plain
    stacks[1] = fused
    stacks[2] = 0.0
    stacks[3] = stacks[4]
    stacks[5, rng.integers(G)] = np.nan
    return stacks, scales


@pytest.mark.parametrize("contract", [False, True])
def test_scoring_helpers_match_reference(contract):
    rng = np.random.default_rng(3)
    for G in (1, 2, 3, 4, 7, 16):
        stacks, scales = _stacks_at_the_cutoff(G, rng)
        hard = rng.random(G) < 0.5
        moves = rng.integers(0, 5000, stacks.shape[0]).astype(np.int32)
        for mw in (0.0, 0.37):
            def ref(b, s, m, _hard=hard, _mw=mw):
                return (jeng.normalized_stacks(b, s),
                        jeng.weighted_objective(b, s, _hard,
                                                hard_weight=1000.0,
                                                move_weight=_mw, moves=m),
                        jeng.pareto_ranks(b, s))
            want = (jax.jit(ref) if contract else ref)(stacks, scales, moves)
            got = (teng.normalized_stacks(stacks, scales, contract=contract),
                   teng.weighted_objective(stacks, scales, hard,
                                           hard_weight=1000.0,
                                           move_weight=mw,
                                           moves=torch.from_numpy(moves),
                                           contract=contract),
                   teng.pareto_ranks(stacks, scales, contract=contract))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _reference_select(boundary, moves, scales, hard, hard_weight,
                      move_weight, n_surv, pareto):
    """The reference program's ``_scores`` and ``_survivor_perm``
    (``parallel/population.py:255-275``), compiled as the program
    compiles them."""
    K = boundary.shape[0]

    @jax.jit
    def run(b, m, s):
        weighted = jeng.weighted_objective(
            b, s, hard, hard_weight=hard_weight, move_weight=move_weight,
            moves=m)
        ranks = jeng.pareto_ranks(b, s)
        primary = (ranks.astype(jnp.float32) if pareto
                   else jnp.zeros_like(weighted))
        order = jnp.lexsort((jnp.arange(K), weighted, primary))
        perm = order[:n_surv][jnp.arange(K) % n_surv]
        return ranks, weighted, perm.at[0].set(0)
    return [np.asarray(x) for x in run(boundary, moves, scales)]


@pytest.mark.parametrize("G,weights", [
    (g, w) for g in (1, 2, 4, 8, 16, 22) for w in ("soft", "hard", "mixed")])
def test_population_select_twin_matches_reference(G, weights):
    """Every chain of up to 22 goals (the catalog has 21, the default chain
    16) under any weights."""
    rng = np.random.default_rng(G * 7 + len(weights))
    K = 16
    scales = (rng.random(G) * 10.0 ** rng.integers(-2, 7, G)).astype(
        np.float32)
    boundary = (rng.random((K, G)) * 10.0 ** rng.integers(-7, 4, (K, G))
                ).astype(np.float32)
    boundary[3] = boundary[9]                     # a tie
    boundary[4, 0] = np.nan                       # sorts last
    boundary[6] = 0.0                             # dominates everything
    hard = {"soft": np.zeros(G, bool), "hard": np.ones(G, bool),
            "mixed": np.arange(G) % 3 == 0}[weights]
    if weights == "mixed" and G == 1:
        hard = np.ones(1, bool)
    moves = rng.integers(0, 100_000, K).astype(np.int32)
    for mw, pareto in ((0.0, False), (0.1, True)):
        n_surv = n_survivors(K, 0.5)
        want = _reference_select(boundary, moves, scales, hard, 1000.0, mw,
                                 n_surv, pareto)
        got = kernels.population_select(
            torch.from_numpy(boundary), torch.from_numpy(moves),
            torch.from_numpy(scales), torch.from_numpy(hard), 1000.0, mw,
            n_surv, pareto)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("G", [23, 24, 27, 32])
def test_population_select_refuses_wider_rows(G):
    """(Named for the refusal it replaced.) At 23-32 goals KI's twin
    scores a generation boundary and the final scores in the loops the
    reference's population program compiles: its weighted scores equal
    the program's own fusions compiled alone (``tests/weighted_row_fusions``,
    shapes set to G goals), with mixed weights, a tie and a converged goal,
    for 4 plans and for a single plan (whose fusion drops the plan axis),
    each without and with a move weight (added after the row)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import probe_row_fusion as prf
    rng = np.random.default_rng(G)
    hard = np.arange(G) % 3 == 0
    w = np.where(hard, np.float32(1000.0), np.float32(1.0))
    scales = (rng.random(G) * 10.0 ** rng.integers(-2, 4, G)).astype(
        np.float32)
    for K, site, final, form in ((4, "polish", False, ""),
                                 (4, "final", True, ""),
                                 (4, "polish", False, "_mw"),
                                 (4, "final", True, "_mw"),
                                 (1, "final", True, "_k1"),
                                 (1, "final", True, "_k1_mw")):
        mw = 0.1 if "mw" in form else 0.0
        boundary = ((1 + rng.random((K, G))) * np.maximum(scales, 1) * 4
                    ).astype(np.float32)
        boundary[:, 1] = 0.0
        boundary[-1] = boundary[0]
        walk = rng.integers(0, 20_000, (K, G)).astype(np.int32)
        norm = teng.normalized_stacks(boundary, scales, contract=True)
        text = (Path(__file__).parent / "weighted_row_fusions"
                / f"weighted_row_{site}_23{form}.hlo").read_text()
        module = prf.at_shape(text, 23, G, K, K)
        run, shapes = prf.compile_module(module)
        feed = dict(norm=norm.numpy(), stacks=boundary, w=w, scales=scales,
                    moves=walk)
        want = run(*[feed[r] if len(shape) == feed[r].ndim else feed[r][0]
                     for r, shape in zip(prf._roles(module), shapes)])
        _, weighted, perm = kernels.population_select(
            torch.from_numpy(boundary), torch.from_numpy(walk[:, -1]),
            torch.from_numpy(scales), torch.from_numpy(hard), 1000.0, mw, 1,
            False, final)
        np.testing.assert_array_equal(weighted.numpy().view(np.int32),
                                      want.reshape(-1).view(np.int32))
        assert perm[0] == 0


def test_pareto_ranks_and_weighted_objective_units():
    stacks = np.asarray([[0.0, 2.0], [1.0, 1.0], [1.0, 2.0], [2.0, 3.0]],
                        np.float32)
    scales = np.zeros(2, np.float32)
    assert teng.pareto_ranks(stacks, scales).tolist() == [0, 0, 2, 3]
    n = teng.normalized_stacks(np.asarray([[0.5, 2e6]], np.float32),
                               np.asarray([1e6, 1e6], np.float32))
    assert n[0, 0] == 0.0 and n[0, 1] == pytest.approx(2.0)
    hard = np.asarray([True, False])
    w = teng.weighted_objective(stacks, scales, hard, hard_weight=1000.0)
    assert w[0] < w[1]
    w_mv = teng.weighted_objective(np.zeros((2, 2), np.float32), scales, hard,
                                   hard_weight=1000.0, move_weight=0.1,
                                   moves=np.asarray([10, 2]))
    assert w_mv[1] < w_mv[0]


def test_population_layout_and_survivors():
    assert population_layout(1) == (1, 1, 1)
    assert population_layout(3) == (1, 4, 4)          # one GPU: D = 1
    assert population_layout(9) == (1, 16, 16)
    from cruise_control_tpu.parallel.population import \
        population_layout as ref_layout
    from cruise_control_tpu.parallel.population import \
        n_survivors as ref_survivors
    for size in (0, 1, 2, 3, 4, 5, 8, 9, 17):
        assert population_layout(size) == ref_layout(size, 1)
        for frac in (0.01, 0.5, 0.75, 1.0):
            assert n_survivors(size, frac) == ref_survivors(size, frac)
    assert n_survivors(4, 1.0) == 3 and n_survivors(2, 1.0) == 1


def test_select_plan_audit_dominates_and_rejects_nan():
    states = ["plan0", "plan1"]
    stacks = np.asarray([[0.0, 1.0], [0.0, 2.0]], np.float32)
    audit = {"plan0": ([5.0], [0.0]), "plan1": ([0.0], [0.0])}

    def audit_eval(state):
        av, sc = audit[state]
        return torch.tensor(av), torch.tensor(sc)

    pop = ta.PopulationConfig(size=2)
    args = (states, stacks, np.asarray([3, 3]), np.asarray([0, 1]),
            np.asarray([1.0, 2.0]))
    assert select_plan(*args, pop)[1] == 0
    picked, best, v = select_plan(*args, pop, audit_eval=audit_eval)
    assert (picked, best, tuple(v)) == ("plan1", 1, (0.0, 2.0))
    with pytest.raises(RuntimeError, match="NaN"):
        select_plan(["p"], np.asarray([[np.nan]]), np.asarray([0]),
                    np.asarray([0]), np.asarray([0.0]),
                    ta.PopulationConfig(size=1))


def _ctor_error(opt_cls, cfg_cls, pop_cls, goals, kw):
    with pytest.raises(ValueError) as err:
        opt_cls(goals=goals, **kw(cfg_cls, pop_cls))
    return str(err.value)


@pytest.mark.parametrize("kw", [
    lambda C, P: dict(population=2, branches=4),
    lambda C, P: dict(population=2, mesh=object()),
    lambda C, P: dict(population=P(size=2, objective="bogus")),
    lambda C, P: dict(population=2, config=C(fused_chain=True)),
    lambda C, P: dict(branches=4, mesh=object()),
])
def test_constructor_exclusivity_matches_reference(kw):
    want = _ctor_error(ja.TpuGoalOptimizer, ja.SearchConfig,
                       ja.PopulationConfig, ja.goals_by_name(AB_GOALS), kw)

    def port(**k):
        return ta.TorchGoalOptimizer(device="cpu", **k)
    assert _ctor_error(port, ta.SearchConfig, ta.PopulationConfig,
                       ta.goals_by_name(AB_GOALS), kw) == want
    # 0 = off: composes with branches
    ta.TorchGoalOptimizer(goals=ta.goals_by_name(AB_GOALS), population=0,
                          branches=4, device="cpu")


def test_adopted_plans_share_state_safely(models):
    """Adoption hands one plan to two slots without a copy. That is safe
    because every pass is functional: running a pass on a state leaves
    the state's tensors as they were, so the slots evolve apart."""
    _, (tm, tmd) = models
    opt = _port(PARITY_GOALS)
    cfg, goals, chain, ctx, state, _ = opt._prepare(
        tm, tmd, ta.OptimizationOptions(**OPTS))
    before = {k: v.clone() for k, v in vars(state).items()
              if isinstance(v, torch.Tensor)}
    key = _random.PRNGKey(5, device="cpu")
    out_a = chain.passes[0](state, ctx, _random.fold_in(key, 1))
    out_b = chain.passes[0](state, ctx, _random.fold_in(key, 2))
    for k, v in before.items():
        assert torch.equal(getattr(state, k), v), k
    assert out_a[3] > 0 and out_b[3] > 0
    assert not torch.equal(out_a[0].rb, state.rb)


# -------------------------------------------------------------- the tuner

def _stub_eval(wall_by_iters):
    def ev(fields, rung, repeats):
        f = dict(max_iters_per_goal=256, polish_passes=2)
        f.update(fields)
        return {"wall_s": wall_by_iters(f), "moves": 100,
                "quality": 5.0 if f["polish_passes"] == 0 else 1.0}
    return ev


def test_successive_halving_matches_reference():
    ev = _stub_eval(lambda f: abs(f["max_iters_per_goal"] - 128) / 100 + 1.0)
    best, history = ta.SuccessiveHalvingTuner(evaluate=ev, trials=12,
                                              rungs=3, seed=1).tune()
    ref_best, ref_history = ja.SuccessiveHalvingTuner(
        evaluate=ev, trials=12, rungs=3, seed=1).tune()
    assert (best, history) == (ref_best, ref_history)
    assert best and best.get("polish_passes") != 0
    assert sum(1 for h in history if h["incumbent"]) >= 1


def test_successive_halving_incumbent_survives_infeasible_pool():
    def ev(fields, rung, repeats):
        return {"wall_s": 0.1 if fields else 2.0,
                "quality": 9.0 if fields else 1.0, "moves": 100}
    best, history = ta.SuccessiveHalvingTuner(evaluate=ev, trials=6,
                                              rungs=2, seed=3).tune()
    assert best == {}
    assert any(not h["feasible"] for h in history)


def test_tuned_store_round_trip_and_versioning(tmp_path):
    from cruise_control_tpu_torch.analyzer.tuning import TUNED_CONFIG_VERSION
    path = tmp_path / "tuned.json"
    store = ta.TunedConfigStore(str(path))
    bucket = store.record(20_000, 100, {"num_swap_candidates": 512},
                          history=[{"rung": 0}])
    assert bucket == ta.shape_bucket(20_000, 100) == ja.shape_bucket(
        20_000, 100) == "b128p32768"
    assert ta.TunedConfigStore(str(path)).apply(
        ta.SearchConfig(), 19_000, 90).num_swap_candidates == 512
    assert store.apply(ta.SearchConfig(), 500, 10) == ta.SearchConfig()
    with pytest.raises(ValueError, match="not tunable"):
        store.record(100, 10, {"epsilon": 0.5})
    # the reference reads the port's file and the port the reference's
    assert ja.TunedConfigStore(str(path)).apply(
        ja.SearchConfig(), 19_000, 90).num_swap_candidates == 512
    data = json.loads(path.read_text())
    assert data["version"] == TUNED_CONFIG_VERSION
    data["version"] = TUNED_CONFIG_VERSION + 1
    path.write_text(json.dumps(data))
    stale = ta.TunedConfigStore(str(path))
    assert stale.apply(ta.SearchConfig(), 20_000, 100) == ta.SearchConfig()
    assert len(stale) == 0
    assert store.to_json()["buckets"][bucket]["history"] == [{"rung": 0}]
    data["version"] = TUNED_CONFIG_VERSION
    data["buckets"][bucket]["fields"] = {"num_swap_candidates": "512",
                                         "max_iters_per_goal": -3,
                                         "polish_passes": True,
                                         "drain_batch": 2048}
    path.write_text(json.dumps(data))
    applied = ta.TunedConfigStore(str(path)).apply(ta.SearchConfig(),
                                                   20_000, 100)
    assert applied.num_swap_candidates == ta.SearchConfig().num_swap_candidates
    assert applied.max_iters_per_goal == ta.SearchConfig().max_iters_per_goal
    assert applied.polish_passes == ta.SearchConfig().polish_passes
    assert applied.drain_batch == 2048
    regimed = ta.TunedConfigStore(str(tmp_path / "r.json"))
    regimed.record(20_000, 100, {"drain_batch": 1024}, regime="flash_crowd")
    assert regimed.apply(ta.SearchConfig(), 20_000, 100,
                         regime="flash_crowd").drain_batch == 1024


def test_default_store_lies_inside_the_checkout():
    import pathlib
    root = pathlib.Path(ta.tuning.__file__).resolve().parents[2]
    path = pathlib.Path(ta.TunedConfigStore.default_path())
    assert path.is_relative_to(root / "build")


def test_tuned_store_gives_one_chain_to_a_shape_bucket(tmp_path):
    """Two models of different raw sizes in one shape bucket (and one
    padded shape) run one tuned, scaled config: one chain key. The tuned
    schedule is the one the reference applies."""
    store = ta.TunedConfigStore(str(tmp_path / "tuned.json"))
    store.record(250, 8, {"max_iters_per_goal": 63, "polish_passes": 1,
                          "drain_batch": 128})
    opt = _port(AB_GOALS, tuned_store=store)
    _, (m1, md1) = _models(partitions=250, pad_to=256)
    _, (m2, md2) = _models(partitions=256)
    assert opt.optimize(m1, md1, ta.OptimizationOptions(**OPTS)).num_moves
    opt.optimize(m2, md2, ta.OptimizationOptions(**OPTS))
    assert len(opt._chains) == 1
    (cfg, _goals), = [(k[0], k[1]) for k in opt._chains]
    assert (cfg.max_iters_per_goal, cfg.polish_passes, cfg.drain_batch) == (
        63, 1, 128)
    jstore = ja.TunedConfigStore(str(tmp_path / "tuned.json"))
    want = jstore.apply(ja.SearchConfig(**CFG), 250, 8).scaled_for(250, 8)
    assert (want.max_iters_per_goal, want.polish_passes,
            want.drain_batch) == (63, 1, 128)


def test_autotune_records_a_bucket(tmp_path):
    _, (tm, tmd) = _models(partitions=64)
    store = ta.TunedConfigStore(str(tmp_path / "t.json"))
    fields, history, bucket = ta.autotune(
        tm, tmd, base=ta.SearchConfig(**CFG), store=store, trials=2,
        rungs=1, seed=0, goals=ta.goals_by_name(AB_GOALS))
    assert bucket == ta.shape_bucket(64, 8)
    assert len(history) == 2 and any(h["incumbent"] for h in history)
    assert store.lookup(64, 8) == fields
