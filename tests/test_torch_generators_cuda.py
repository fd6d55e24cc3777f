"""KR, KS and KT (``kernels.replica_priority``, ``dest_select``,
``assemble_candidates``) on the card, bit for bit against their twins.

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_generators_cuda.py -q

Each goal of a chain proposes on the card at its position (the context
its pass steers), its KR, KS and KT calls recorded
(``chip_smoke.generator_calls``); each call's twin then runs on the CPU on
the same inputs, and every output must be equal: the main path's cluster
(P 20,096 x R 2, B1 105) under the main, default, part-B and
kafka-assigner chains and the last position of a 60-goal chain, the scale
cell (B1 1,001) under the default chain with phase 13 (b)'s search, and
20,000 brokers (B1 20,001). Then the twins' own edges (K > P * R, D above
the alive brokers, brokers with no light slot, every priority -inf), the
launches of a propose and a default-chain optimize through the graphs
against the reference's constants.
"""

import pytest
import torch

from cruise_control_tpu_torch import _random, kernels


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return {"main": chip_smoke.build_flat_direct(100, 20_000, 2),
            "scale": chip_smoke.build_flat_direct(1000, 200_000, 2),
            "wide": chip_smoke.build_flat_direct(20_000, 100_000, 2),
            "tiny": chip_smoke.build_flat_direct(6, 8, 3)}


def _chain(name, state, ctx, md):
    """(state, ctx, goals) of a chain on a model's pass state."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import (default_goals,
                                                   goals_by_name)
    from cruise_control_tpu_torch.analyzer.goals import KAFKA_ASSIGNER_GOALS
    if name == "partb":
        return chip_smoke.partb_pass(state.rb.device)
    if name == "main":
        return state, ctx, goals_by_name(chip_smoke.GOALS)
    if name == "kafka_assigner":
        return state, ctx, [g.bind(md)
                            for g in goals_by_name(KAFKA_ASSIGNER_GOALS)]
    goals = [g.bind(md) for g in default_goals()]
    return state, ctx, (goals * 4)[:60] if name == "60 goals" else goals


@pytest.mark.cuda
@pytest.mark.parametrize("model,chain,search", [
    ("main", "main", "main"), ("main", "default", "main"),
    ("main", "partb", "main"), ("main", "kafka_assigner", "main"),
    ("main", "60 goals", "main"), ("scale", "default", "scale3"),
    ("wide", "main", "main"), ("wide", "default", "main")])
def test_generators_match_twins(models, model, chain, search):
    import chip_smoke
    m, md = models[model]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    state, ctx, goals = _chain(chain, state, ctx, md)
    search = (chip_smoke.MAIN_SEARCH if search == "main"
              else chip_smoke.SCALE3_SEARCH)
    forms = {form for *_, form, _a, _k, _o, _e in chip_smoke.check_generators(
        state, ctx, goals, search, f"{model} {chain}")}
    if chain == "default" and model != "wide":
        assert forms >= {"rack_aware", "shortlist", "interval_swap",
                         "interval_leadership", "topic", "topic_move_dest",
                         "topic_swap_dest", "no_leadership"}, forms
    if chain == "partb":
        assert forms >= {"broker_set", "topic_leaders", "topic_leaders_move",
                         "rack_spread", "preferred_leader"}, forms


@pytest.mark.cuda
@pytest.mark.parametrize("search", [
    dict(num_replica_candidates=4096, num_dest_candidates=64,
         num_swap_candidates=4096),          # K > P * R, D > alive brokers
    dict(num_replica_candidates=5, num_dest_candidates=1,
         num_swap_candidates=3)])
@pytest.mark.parametrize("dead", [(), (0, 1, 2, 3, 4)])
def test_generator_edges(models, search, dead):
    """A 6-broker, 8-partition RF-3 cluster (120 padding rows, one rack,
    brokers in two sets and two in none, its one topic interested): the
    twins' edges — more candidates than slots, more destinations than
    brokers (and brokers mostly dead: few alive, no light slot on most,
    offline replicas), every priority -inf where nothing is to move."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   default_goals,
                                                   goals_by_name)
    from cruise_control_tpu_torch.analyzer.goals import BrokerSetAwareGoal
    m, md = models["tiny"]
    m = m.replace(broker_set=torch.tensor([0, 0, 0, 1, 1, 1, -1, -1],
                                          dtype=torch.int32,
                                          device=m.device))
    state, ctx = chip_smoke.pass_state(m, md, dead=dead)
    cst = BalancingConstraint(topics_with_min_leaders_per_broker="t*",
                              min_topic_leaders_per_broker=1)
    goals = [g.bind(md) for g in default_goals() + goals_by_name(
        ["MinTopicLeadersPerBrokerGoal", "RackAwareDistributionGoal",
         "PreferredLeaderElectionGoal", "KafkaAssignerEvenRackAwareGoal"],
        cst)] + [BrokerSetAwareGoal(cst, topic_set=[1])]
    assert goals[16].eligibility_row()["kind"] == "topic_leaders"
    list(chip_smoke.check_generators(state, ctx, goals, search,
                                     f"tiny, dead {dead}"))


@pytest.mark.cuda
def test_a_propose_launches_only_the_generators(models):
    """Each default-chain goal's generators on the card (an interval
    goal's from its planes, which its bounds form ahead) launch KR, KS, KT
    and KO through their wrappers and nothing else a wrapper counts (no KA
    draw: the swap's shift is drawn inside KT)."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig
    from cruise_control_tpu_torch.analyzer.goals import IntervalGoal
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    _s, _c, goals = _chain("default", state, ctx, md)
    cfg = SearchConfig(**chip_smoke.MAIN_SEARCH)
    allowed = set(chip_smoke.GENERATOR_KERNELS) | {"flow_priority",
                                                   "flow_match"}
    for goal in goals:
        key = _random.PRNGKey(1, device=m.device)
        planes = (goal.propose_planes(state, ctx)
                  if isinstance(goal, IntervalGoal) else None)
        before = dict(kernels.LAUNCHES)
        if planes is None:
            goal.propose(state, ctx, key, cfg)
        else:
            goal.generate(state, ctx, key, cfg, *planes)
        torch.cuda.synchronize()
        made = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
        assert made and made <= allowed, (goal.name, made)
        assert kernels.LAUNCHES["assemble_candidates"] == (
            before["assemble_candidates"] + 1), goal.name


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(models):
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import SearchConfig, goals_by_name
    m, md = models["main"]
    state, ctx = chip_smoke.pass_state(m, md, dead=(3,))
    cfg = SearchConfig(**chip_smoke.MAIN_SEARCH)
    goal = goals_by_name(["RackAwareGoal"])[0]
    key = _random.PRNGKey(1, device=m.device)
    with pytest.raises(ValueError):
        kernels.replica_priority("no such kind", goal, state, ctx, (key,),
                                 cfg)
    with pytest.raises(ValueError):
        kernels.replica_priority("rack_aware", goal, state, ctx,
                                 (key, key), cfg)
    with pytest.raises(ValueError):
        kernels.dest_select("shortlist", goal, state, ctx, (key,), cfg,
                            n=0)
    with pytest.raises(ValueError):
        kernels.assemble_candidates(state, ctx, [])


@pytest.mark.cuda
def test_default_chain_outcome_through_the_graphs(models):
    """Phase 13 (a): the default chain's two seed-1 optimizes through the
    goal-loop graphs give the reference's outcome (moves, proposals,
    digest, every goal's iterations and violation, the audit), with no
    host read of a loop test."""
    import chip_smoke
    from cruise_control_tpu_torch.analyzer import engine
    from cruise_control_tpu_torch.model.spec import flatten_spec
    model, md = flatten_spec(chip_smoke.build_spec(), device="cuda")
    syncs = engine.HOST_SYNCS
    out = chip_smoke.default_chain_main(chip_smoke.port_default_package(),
                                        model, md)
    assert engine.HOST_SYNCS == syncs
    assert out["a"] == chip_smoke.REFERENCE_DEFAULT
