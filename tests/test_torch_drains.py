"""Parity of the bulk drains' twins with the JAX package on the CPU: KZ's
(``kernels.drain_order_plain``, with KP's) and KAA's
(``kernels.leadership_drain_plain``) through ``IntervalGoal.bulk_drain``,
against the reference's jitted ``bulk_drain`` on the same inputs, and the
twin's slot order against ``jnp.lexsort`` of the same keys.

On the CPU every wrapper takes its plain twin, the function the card's
kernels are held to bit for bit (``tests/test_torch_drains_cuda.py``).
Tolerance: exact equality of every candidate field, floats bit for bit
(the sign of a zero too)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.goals as jg
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer.goals as tg
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu.analyzer.constraint import (
    BalancingConstraint as JConstraint, SearchConfig as JConfig)
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer.constraint import (
    BalancingConstraint as TConstraint, SearchConfig as TConfig)
from torch_parity_util import build_both, model_arrays, torch_model

torch.set_num_threads(1)

GOALS = ("ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal")
#: B1 = padded brokers + 1: (brokers, pad multiple, partitions)
WIDTHS = {23: (22, 2, 200), 32: (31, 1, 200), 105: (100, 8, 1000)}
SEARCH = dict(num_replica_candidates=96, num_dest_candidates=8,
              num_swap_candidates=48, apply_per_iter=96, drain_batch=4096)
#: a batch smaller than what the drains take: the rank cuts it
TRUNCATED = dict(SEARCH, drain_batch=3)
CAND_FIELDS = ("p", "r", "p2", "r2", "src", "dst", "kind", "valid", "must",
               "d_util_src", "d_util_dst", "d_cnt", "d_lead", "d_pot",
               "d_lni")
DEAD = 2

_JITTED: dict = {}


def _bits(x) -> np.ndarray:
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def _models(width, case):
    """Both packages' models of one width: broker DEAD not alive, the
    partitions padded to a power of two (topic -1 past the real ones).
    ``case``: "zeros" gives the replicas on the dead broker loads of +0.0
    and -0.0, alternating, on every resource; "one" puts every slot on
    broker 1."""
    brokers, pad, parts = WIDTHS[width]
    (jm, jmd), _ = build_both(brokers, parts, seed=width, dead=(DEAD,),
                              broker_pad_multiple=pad)
    arrays = model_arrays(jm)
    rb = arrays["replica_broker"]
    valid = arrays["partition_valid"]
    if case == "zeros":
        on_dead = (rb == DEAD).any(axis=1) & valid
        sign = np.where(np.arange(rb.shape[0]) % 2 == 0, 0.0,
                        -0.0).astype(np.float32)[:, None]
        for name in ("leader_load", "follower_load"):
            arrays[name] = np.where(on_dead[:, None], sign,
                                    arrays[name]).astype(np.float32)
    elif case == "one":
        arrays["replica_broker"] = np.where(valid[:, None], 1,
                                            rb).astype(rb.dtype)
    jm = dataclasses.replace(jm, **{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    tm = torch_model(jm)
    topics = dict(with_topic_counts=jmd.num_topics,
                  with_topic_leader_counts=True)
    return ((js.init_state(jm, **topics), js.build_context(jm)),
            (ts.init_state(tm, **topics), ts.build_context(tm)))


def _jitted(name, search):
    """The reference's bulk drain of goal ``name``, jitted once a module."""
    key = (name, search["drain_batch"])
    if key not in _JITTED:
        goal = jg.goals_by_name([name], JConstraint())[0]
        cfg = JConfig(**search)
        _JITTED[key] = jax.jit(lambda s, c, k: goal.bulk_drain(s, c, k, cfg))
    return _JITTED[key]


@pytest.mark.parametrize("case", ["dead", "zeros", "one", "truncated"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("name", GOALS)
def test_bulk_drain_matches_reference(name, width, case):
    """A drain round's candidates, every field, against the reference's:
    the replica drains (KZ's and KP's twins) of a count and a util goal,
    the leadership drains (KAA's twin) of a two-sided and an upper-only
    goal, at B1 23, 32 and 105, with a dead broker and padding partitions,
    ±0.0 loads on the dead broker's replicas, every slot on one broker,
    and a batch the rank truncates."""
    (jst, jctx), (tst, tctx) = _models(width, case)
    search = TRUNCATED if case == "truncated" else SEARCH
    tgoal = tg.goals_by_name([name], TConstraint())[0]
    assert tgoal.supports_bulk_drain
    seed = width + len(case)
    jc = _jitted(name, search)(
        jst, jctx, jax.random.fold_in(jax.random.PRNGKey(seed), 70_000))
    tc = tgoal.bulk_drain(tst, tctx,
                          _random.fold(_random.PRNGKey(seed), 70_000),
                          TConfig(**search))
    for f in CAND_FIELDS:
        assert np.array_equal(_bits(getattr(jc, f)), _bits(getattr(tc, f))), \
            f"{name} B1 {width} {case}: {f}"
    if case == "truncated":
        assert int(tc.valid.sum()) == search["drain_batch"]


def _order_case(seed):
    """A util goal's state with forced ties (every DISK load 1.0), NaNs of
    either sign and ±0.0 among the loads, broker DEAD dead."""
    (jm, jmd), _ = build_both(22, 200, seed=seed, dead=(DEAD,),
                              broker_pad_multiple=2)
    arrays = model_arrays(jm)
    col = 3
    for name, nan in (("leader_load", np.nan), ("follower_load", -np.nan)):
        a = arrays[name].copy()
        a[:, col] = 1.0
        a[::7, col] = nan
        a[3::11, col] = -0.0
        a[5::13, col] = 0.0
        arrays[name] = a
    jm = dataclasses.replace(jm, **{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    tm = torch_model(jm)
    return ts.init_state(tm), ts.build_context(tm)


@pytest.mark.parametrize("seed", [0, 1])
def test_drain_order_twin_sorts_as_lexsort(seed):
    """``drain_order_plain``'s order against ``jnp.lexsort`` of the same
    keys (-sort_w, ~must, broker) and the same noise: ties keep index
    order, -0.0 sorts equal to +0.0 and a NaN of either sign last."""
    tst, tctx = _order_case(seed)
    goal = tg.goals_by_name(["DiskUsageDistributionGoal"], TConstraint())[0]
    key = _random.PRNGKey(seed)
    out = kernels.drain_order_plain(goal, tst, tctx, key)
    order, flat_b, flat_w, cand, must = (o.numpy() for o in out[4:])
    noise = _random.affine(key, (flat_w.shape[0],), 0.01, 1.0).numpy()
    sort_w = np.where(cand, flat_w * noise, np.float32(-1.0))
    assert (sort_w == 0).any() and np.isnan(sort_w).any()
    want = jnp.lexsort((jnp.asarray(-sort_w), jnp.asarray(~must),
                        jnp.asarray(flat_b)))
    assert np.isnan(flat_w).any() and (np.signbit(flat_w)
                                        & (flat_w == 0)).any()
    assert np.array_equal(order, np.asarray(want))
