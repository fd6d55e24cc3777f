"""KO's weight range: the per-context table of ``_unit01``'s min and max
over the replica weights of every ``IntervalGoal._replica_weight`` form.

The port builds the table once a search context
(``state.py:build_context``, ``kernels.replica_weight_range``) and KO's
priorities read it instead of reducing the weights in every call. Here the
table's twin is held to the reference's ``_replica_weight`` and
``_norm01``'s min and max on a plain, a dead-broker and a stacked fleet
context and on a what-if scenario batch; the priorities are shown not to
depend on which zero is the minimum; and a context whose loads are
replaced rebuilds its table.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer import SearchConfig
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu_torch.model.fleet import FleetModel
from torch_parity_util import build_both

torch.set_num_threads(1)

#: a goal of each ``_replica_weight`` form, in the table's row order
#: (``kernels.WEIGHT_FORMS``)
FORM_GOALS = ["CpuUsageDistributionGoal",
              "NetworkInboundUsageDistributionGoal",
              "NetworkOutboundUsageDistributionGoal",
              "DiskUsageDistributionGoal", "PotentialNwOutGoal",
              "ReplicaDistributionGoal"]


def _reference_range(name, leader_load, follower_load, R):
    """(min, max) of the finite weights of the reference goal ``name``'s
    ``_replica_weight``, as its ``_norm01`` reduces them."""
    goal = jg.goals_by_name([name])[0]
    ctx = types.SimpleNamespace(leader_load=jnp.asarray(leader_load),
                                follower_load=jnp.asarray(follower_load))
    state = types.SimpleNamespace(
        rb=jnp.zeros((leader_load.shape[0], R), jnp.int32))
    w = goal._replica_weight(state, ctx)
    finite = jnp.isfinite(w)
    return (float(jnp.min(jnp.where(finite, w, jnp.inf))),
            float(jnp.max(jnp.where(finite, w, -jnp.inf))))


def _models(case):
    if case == "dead broker":
        return [build_both(20, 600, seed=4, dead=(2, 7))[1][0]]
    if case == "fleet":
        return [build_both(12, 300, seed=s)[1][0] for s in (5, 6, 7)]
    return [build_both(20, 600, seed=3)[1][0]]


@pytest.mark.parametrize("case", ["plain", "dead broker", "fleet"])
@pytest.mark.parametrize("form", range(len(FORM_GOALS)),
                         ids=lambda f: FORM_GOALS[f])
def test_weight_range_matches_the_reference(case, form):
    """Every form's (min, max) in the context's table equals the
    reference's ``_norm01`` min and max of ``_replica_weight``: a plain
    context, one with dead brokers and a fleet's stacked [C, ...] context
    (each member's row against its own model)."""
    models = _models(case)
    if case == "fleet":
        fleet = FleetModel.stack(
            [(f"c{i}", m, None) for i, m in enumerate(models)],
            device="cpu")
        table = ts.build_context(fleet.stacked).weight_range
        assert table.shape == (len(models), len(kernels.WEIGHT_FORMS), 2)
        members = [m.model for m in fleet.members]
    else:
        table = ts.build_context(models[0]).weight_range[None]
        members = models
    for c, model in enumerate(members):
        R = model.replica_broker.shape[-1]
        want = _reference_range(FORM_GOALS[form],
                                model.leader_load.numpy(),
                                model.follower_load.numpy(), R)
        got = tuple(float(x) for x in table[c, form])
        assert got == want, f"{case} member {c}: {got} != {want}"
        # the goal's own form row is the one its priorities read
        goal = tg.goals_by_name([FORM_GOALS[form]])[0]
        assert kernels._weight_form(goal) == form


def _priorities(goal, state, ctx, table):
    """KO's priorities (the twin) with ``table`` as the context's range."""
    planes = goal.propose_planes(state, ctx)
    return kernels.flow_priority_plain(
        goal, state, dataclasses.replace(ctx, weight_range=table),
        _random.PRNGKey(3), SearchConfig(), *planes)


def test_signed_zeros_give_the_same_priorities():
    """A weight plane whose minimum mixes -0.0 and +0.0: the table keeps
    +0.0, and the priorities are the same bits with either zero as the
    minimum (x - (-0.0) and x - (+0.0) differ only at x = -0.0, whose
    quotient adds to the tier as +0.0 either way)."""
    _, (tm, _) = build_both(16, 400, seed=9, dead=(3,))
    lead = tm.leader_load.clone()
    foll = tm.follower_load.clone()
    lead[::3, 3] = -0.0
    lead[1::3, 3] = 0.0
    foll[:, 3] = torch.where(torch.arange(foll.shape[0]) % 2 == 0, -0.0, 0.0)
    model = tm.replace(leader_load=lead, follower_load=foll)
    state = ts.init_state(model)
    ctx = ts.build_context(model)
    form = kernels._weight_form(tg.goals_by_name(["ReplicaDistributionGoal"]
                                                 )[0])
    zero = ctx.weight_range[form, 1]             # -disk: the max is a zero
    assert float(zero) == 0.0 and not bool(torch.signbit(zero))
    goal = tg.goals_by_name(["DiskUsageDistributionGoal"])[0]
    util_row = kernels._weight_form(goal)
    assert float(ctx.weight_range[util_row, 0]) == 0.0
    assert not bool(torch.signbit(ctx.weight_range[util_row, 0]))
    for name in ("DiskUsageDistributionGoal", "ReplicaDistributionGoal"):
        goal = tg.goals_by_name([name])[0]
        f = kernels._weight_form(goal)
        neg = ctx.weight_range.clone()
        pos = ctx.weight_range.clone()
        zero_col = 0 if name.startswith("Disk") else 1
        neg[f, zero_col] = -0.0
        pos[f, zero_col] = 0.0
        got = [_priorities(goal, state, ctx, t) for t in (neg, pos)]
        assert torch.equal(got[0].view(torch.int32),
                           got[1].view(torch.int32)), name
        assert bool(torch.isfinite(got[0]).any())


def test_replacing_loads_rebuilds_the_weight_range():
    """``SearchContext.replace`` rebuilds the table from new loads, keeps
    it for anything else (the steered ``dest_allowed``, the movable
    slots, which the weights do not read), and refuses a table handed in
    by the caller."""
    _, (tm, _) = build_both(12, 300, seed=11)
    ctx = ts.build_context(tm)
    scaled = ctx.replace(leader_load=ctx.leader_load * 3.0)
    fresh = ts.build_context(tm.replace(leader_load=tm.leader_load * 3.0))
    assert torch.equal(scaled.weight_range, fresh.weight_range)
    assert not torch.equal(scaled.weight_range, ctx.weight_range)
    foll = ctx.replace(follower_load=ctx.follower_load + 1.0)
    assert torch.equal(foll.weight_range, ts.build_context(
        tm.replace(follower_load=tm.follower_load + 1.0)).weight_range)
    steered = ctx.replace(dest_allowed=torch.zeros_like(ctx.dest_allowed))
    assert steered.weight_range is ctx.weight_range
    pinned = ctx.replace(movable=torch.zeros_like(ctx.movable))
    assert pinned.weight_range is ctx.weight_range
    with pytest.raises(ValueError):
        ctx.replace(weight_range=torch.zeros_like(ctx.weight_range))


@pytest.mark.parametrize("R", [1, 2, 3])
def test_weight_range_twin_by_slots(R):
    """The twin at one, two and three replica slots against the reference
    (one slot reads only the leader's loads), with non-finite loads left
    out."""
    rng = np.random.default_rng(R)
    lead = rng.random((50, 4), dtype=np.float32) * 100
    foll = rng.random((50, 4), dtype=np.float32) * 10
    lead[3, 3], foll[4, 0], lead[5, 2] = np.inf, np.nan, -np.inf
    table = kernels.replica_weight_range(torch.from_numpy(lead),
                                         torch.from_numpy(foll), R)
    for form, name in enumerate(FORM_GOALS):
        want = _reference_range(name, lead, foll, R)
        assert tuple(float(x) for x in table[form]) == want, name


def test_a_scenario_batch_has_a_range_per_scenario():
    """A what-if batch (``scenario_transform``: a leading ``[S]`` axis,
    each scenario's loads scaled by its own ``pscale``) builds one table
    row a scenario, each equal to the reference's range over that
    scenario's loads."""
    from cruise_control_tpu_torch.whatif.engine import scenario_transform
    _, (tm, _) = build_both(12, 300, seed=12)
    B = tm.num_brokers_padded
    P = tm.partition_valid.shape[0]
    S = 3
    pscale = torch.ones(S, P)
    pscale[1, ::2] = 2.5
    pscale[2] = 0.0
    batched, _ = scenario_transform(
        tm, torch.zeros(S, B, dtype=torch.bool),
        torch.zeros(S, B, dtype=torch.bool), torch.ones(S, B, 4), pscale,
        tm.partition_valid.expand(S, P))
    table = ts.build_context(batched).weight_range
    assert table.shape == (S, len(kernels.WEIGHT_FORMS), 2)
    R = tm.replica_broker.shape[-1]
    for s in range(S):
        for form, name in enumerate(FORM_GOALS):
            want = _reference_range(name, batched.leader_load[s].numpy(),
                                    batched.follower_load[s].numpy(), R)
            got = tuple(float(x) for x in table[s, form])
            assert got == want, f"scenario {s} {name}: {got} != {want}"


def test_a_scoring_context_has_no_weight_range():
    """``build_context(with_weight_range=False)`` (the what-if scorer's
    batched contexts) leaves the table out; replacing its loads keeps it
    out, and KO refuses such a context rather than reading a table it
    does not have."""
    _, (tm, _) = build_both(12, 300, seed=12)
    ctx = ts.build_context(tm, with_weight_range=False)
    assert ctx.weight_range is None
    assert ctx.replace(leader_load=ctx.leader_load * 2.0).weight_range is None
    goal = tg.goals_by_name(["DiskUsageDistributionGoal"])[0]
    state = ts.init_state(tm)
    with pytest.raises(ValueError, match="weight range"):
        kernels.flow_priority(goal, state, ctx, _random.PRNGKey(1),
                              SearchConfig(),
                              *goal.propose_planes(state, ctx))
