"""KD (``kernels.scenario_failover``; its twin on the CPU) against the
reference's ``whatif/engine.py:scenario_transform`` at edge shapes: one to
four replica slots, a partition count that is not a multiple of four (the
card's vector path takes four partitions a thread), broker ids outside
[0, B) (-1, the sentinel B and past it), and the three input forms the
card's kernel is compiled for — the template's placement shared by every
scenario, one placement per scenario (the move scheduler's boundary
audit), and a pvalid expanded over the scenarios. Equal means bit for
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.whatif.engine import scenario_transform as j_transform
from cruise_control_tpu_torch import kernels
from torch_parity_util import assert_same, build_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def template():
    (jm, _), _ = build_both(8, 40, seed=7, dead=(2,))
    return jm


def _reference(jm, rb, off, pref, dead, add, pvalid, per_scenario):
    """The reference transform's placement fields, vmapped over the
    scenarios (over the placement too where it is per scenario)."""
    P = rb.shape[-2]

    def one(rb, off, pref, d, a, pv):
        m = jm.replace(replica_broker=rb, replica_offline=off,
                       replica_pref_pos=pref,
                       leader_load=jnp.zeros((P, 4), jnp.float32),
                       follower_load=jnp.zeros((P, 4), jnp.float32))
        B = m.broker_valid.shape[0]
        out, has_alive = j_transform(
            m, d, a, jnp.ones((B, 4), jnp.float32),
            jnp.ones((P,), jnp.float32), pv)
        return (out.replica_broker, out.replica_pref_pos,
                out.replica_offline, has_alive)
    axis = 0 if per_scenario else None
    return jax.jit(jax.vmap(one, in_axes=(axis, axis, axis, 0, 0, 0)))(
        rb, off, pref, dead, add, pvalid)


@pytest.mark.parametrize("form", ["shared", "per-scenario",
                                  "per-scenario, pvalid expanded"])
@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_scenario_failover_edges_match_reference_transform(template, R,
                                                           form):
    rng = np.random.default_rng(10 * R + len(form))
    B = template.broker_valid.shape[0]
    S, P = 5, 37
    lead = (S,) if form != "shared" else ()
    # ids in [-1, B + 5]: -1, the sentinel B and past it sit beside real
    # brokers; a partition may hold one broker twice
    rb = rng.integers(-1, B + 6, lead + (P, R)).astype(np.int32)
    rb[..., :3, 0] = [-1, B, B + 5]
    off = rng.random(lead + (P, R)) < 0.2
    pref = np.argsort(rng.random(lead + (P, R)), -1).astype(np.int32)
    dead = rng.random((S, B)) < 0.3
    add = rng.random((S, B)) < 0.15
    if form.endswith("expanded"):
        row = rng.random(P) < 0.9
        pvalid_np = np.broadcast_to(row, (S, P))
        pvalid_t = torch.from_numpy(row).expand(S, P)
    else:
        pvalid_np = rng.random((S, P)) < 0.9
        pvalid_t = torch.from_numpy(pvalid_np)
    want = _reference(template, rb, off, pref, dead, add,
                      np.ascontiguousarray(pvalid_np), form != "shared")
    got = kernels.scenario_failover(
        torch.from_numpy(rb), torch.from_numpy(off), torch.from_numpy(pref),
        torch.from_numpy(np.array(template.broker_valid)),
        torch.from_numpy(np.array(template.broker_alive)),
        torch.from_numpy(dead), torch.from_numpy(add), pvalid_t)
    for t, w, name in zip(got, want, ("replica_broker", "replica_pref_pos",
                                      "replica_offline", "has_alive")):
        assert_same(t, np.asarray(w), what=name)
    # the leadership swap and the stranded replicas both occur
    assert (got[0][..., 0] != torch.from_numpy(
        np.broadcast_to(rb, (S, P, R))[..., 0].copy())).any()
    assert got[2].any() and not got[3].all()
