"""Parity of the port's flat model (``model/flat.py``, ``spec.py``,
``proposals.py``), its fixed-order reductions (``utils/ordered.py``) and the
plain twins of KB/KC against the JAX package on the CPU.

Tolerances: integer and bool outputs exact; float32 aggregates exact where
the port reproduces the reference's summation order (scatter-add, tree sum,
blocked scan), rtol 1e-6 where it does not (KC's twin is a matmul)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.model.flat as jflat
import cruise_control_tpu.model.proposals as jprop
import cruise_control_tpu_torch.model.flat as tflat
import cruise_control_tpu_torch.model.proposals as tprop
from cruise_control_tpu.analyzer.goals import (_net_broker_flow,
                                               _net_src_hi)
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.utils import ordered
from torch_parity_util import (assert_close, assert_same, build_both,
                               tiny_both, torch_model)

torch.set_num_threads(1)

MODELS = {
    "tiny": tiny_both,
    "20x1k": lambda: build_both(20, 1000, seed=1),
    "20x1k_dead": lambda: build_both(20, 1000, seed=2, dead=(3,)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def both(request):
    return MODELS[request.param]()


def test_flatten_spec_same_arrays(both):
    (jm, jmd), (tm, tmd) = both
    for f in dataclasses.fields(jm):
        assert_same(getattr(jm, f.name), getattr(tm, f.name), what=f.name)
    assert dataclasses.asdict(jmd) == dataclasses.asdict(tmd)


def test_to_numpy_round_trip(both):
    (jm, _), (tm, _) = both
    again = tflat.FlatClusterModel.from_numpy(device="cpu", **tm.to_numpy())
    for name, arr in tm.to_numpy().items():
        assert_same(arr, getattr(again, name), what=name)


@pytest.mark.parametrize("fn", ["broker_utilization", "broker_potential_nw_out",
                                "leader_bytes_in", "replica_loads"])
def test_float_reductions_exact(both, fn):
    (jm, _), (tm, _) = both
    assert_same(getattr(jflat, fn)(jm), getattr(tflat, fn)(tm), what=fn)


@pytest.mark.parametrize("fn", ["broker_replica_counts",
                                "broker_leader_counts"])
def test_count_reductions(both, fn):
    (jm, _), (tm, _) = both
    assert_same(getattr(jflat, fn)(jm), getattr(tflat, fn)(tm), what=fn)


@pytest.mark.parametrize("fn", ["topic_broker_replica_counts",
                                "topic_broker_leader_counts"])
def test_topic_counts_mask_padding(both, fn):
    (jm, jmd), (tm, _) = both
    assert_same(getattr(jflat, fn)(jm, jmd.num_topics),
                getattr(tflat, fn)(tm, jmd.num_topics), what=fn)


def _random_moves(jm, seed, n=40):
    rng = np.random.default_rng(seed)
    P, R = jm.replica_broker.shape
    B = jm.num_brokers_padded
    part = rng.choice(P, size=n, replace=False).astype(np.int32)
    part[rng.random(n) < 0.2] = -1                      # inactive padding
    slot = rng.integers(0, R, n).astype(np.int32)
    dest = rng.integers(0, B, n).astype(np.int32)
    kind = rng.integers(0, 2, n).astype(np.int32)
    return part, slot, dest, kind


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_moves(both, seed):
    (jm, _), (tm, _) = both
    part, slot, dest, kind = _random_moves(jm, seed)
    jout = jflat.apply_moves(jm, jflat.Moves(jnp.asarray(part),
                                             jnp.asarray(slot),
                                             jnp.asarray(dest),
                                             jnp.asarray(kind)))
    tout = tflat.apply_moves(tm, tflat.Moves(*(torch.from_numpy(a) for a in
                                               (part, slot, dest, kind))))
    assert_same(jout.replica_broker, tout.replica_broker, what="rb")
    assert_same(jout.replica_offline, tout.replica_offline, what="offline")
    # the caller's model is untouched
    assert_same(jm.replica_broker, tm.replica_broker, what="input rb")


def test_empty_moves_are_a_no_op(both):
    _, (tm, _) = both
    out = tflat.apply_moves(tm, tflat.Moves.empty(16, device="cpu"))
    assert_same(out.replica_broker, tm.replica_broker)
    assert_same(out.replica_offline, tm.replica_offline)


def test_sanity_check_and_diff(both):
    (jm, jmd), (tm, tmd) = both
    assert jflat.sanity_check(jm) == tflat.sanity_check(tm)
    part, slot, dest, kind = _random_moves(jm, 5)
    kind[:] = jflat.MOVE_LEADERSHIP
    jmoved = jflat.apply_moves(jm, jflat.Moves(*(jnp.asarray(a) for a in
                                                 (part, slot, dest, kind))))
    tmoved = tflat.apply_moves(tm, tflat.Moves(*(torch.from_numpy(a) for a in
                                                 (part, slot, dest, kind))))
    jp = jprop.diff_proposals(jm, jmoved, jmd)
    tp = tprop.diff_proposals(tm, tmoved, tmd)
    assert jp == tp and len(tp) > 0
    assert jprop.proposal_summary(jp) == tprop.proposal_summary(tp)


def test_from_numpy_default_device_needs_cuda(both, monkeypatch):
    (jm, _), _ = both
    from torch_parity_util import model_arrays
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tflat.FlatClusterModel.from_numpy(**model_arrays(jm))
    assert torch_model(jm).device.type == "cpu"


# ---------------------------------------------------------------------------
# Fixed-order reductions against XLA's compiled ones
# ---------------------------------------------------------------------------

_SIZES = [1, 5, 31, 32, 33, 101, 1001, 2048, 5000, 40_192]


@pytest.mark.parametrize("n", _SIZES)
def test_tree_sum_matches_xla(n):
    x = (np.random.default_rng(n).random(n) * 1000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sum)(x))
    got = ordered.tree_sum(torch.from_numpy(x))
    assert got.item() == float(want)


@pytest.mark.parametrize("n", _SIZES)
def test_scan_sum_matches_xla(n):
    x = (np.random.default_rng(n).random(n) * 10).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    assert_same(want, ordered.scan_sum(torch.from_numpy(x)))


def test_fma_matches_xla_contraction():
    rng = np.random.default_rng(0)
    u = rng.random(4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda u: 1.0 + 0.01 * u)(u))
    assert_same(want, ordered.fma(0.01, torch.from_numpy(u), 1.0))


def test_stable_orders():
    x = torch.tensor([1.0, 3.0, 3.0, -np.inf, 3.0, 0.0])
    vals, idx = ordered.top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert_same(want_i, idx) and assert_same(want_v, vals)
    keys = (torch.tensor([3, 1, 2, 1, 3]), torch.tensor([True, False, True,
                                                         True, False]),
            torch.tensor([0, 0, 1, 1, 0]))
    want = jnp.lexsort(tuple(jnp.asarray(k.numpy()) for k in keys))
    assert_same(want, ordered.lexsort(keys))


# ---------------------------------------------------------------------------
# KB / KC twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_base", [False, True])
def test_ordered_segment_sum_twin_matches_xla_scatter(seed, with_base):
    rng = np.random.default_rng(seed)
    N, S, C = 3000, 25, 4
    vals = ((rng.random((N, C)) - 0.3) * 100).astype(np.float32)
    seg = rng.integers(-2, S + 2, N)                  # out of range: dropped
    base = (rng.random((S, C)) * 50).astype(np.float32)
    start = jnp.asarray(base) if with_base else jnp.zeros((S, C), jnp.float32)
    want = jax.jit(lambda b, s, v: b.at[s].add(v, mode="drop"))(
        start, np.where(seg < 0, S + 5, seg), vals)
    got = kernels.ordered_segment_sum(
        torch.from_numpy(vals), torch.from_numpy(seg), S,
        base=torch.from_numpy(base) if with_base else None)
    assert_same(want, got)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("ids", ["int32", "int64"])
def test_ordered_segment_sum_batch_axis_matches_vmapped_scatter(seed,
                                                                with_base,
                                                                ids):
    """The batch axis: each item's rows into its own S segments, as a
    vmapped scatter-add (the what-if scorer's init_state) adds them."""
    rng = np.random.default_rng(seed)
    L, N, S, C = 5, 700, 21, 4
    vals = ((rng.random((L, N, C)) - 0.3) * 100).astype(np.float32)
    seg = rng.integers(-2, S + 2, (L, N)).astype(ids)   # out of range: drop
    base = (rng.random((L, S, C)) * 50).astype(np.float32)
    start = jnp.asarray(base) if with_base else jnp.zeros((L, S, C),
                                                          jnp.float32)
    want = jax.jit(jax.vmap(lambda b, s, v: b.at[s].add(v, mode="drop")))(
        start, np.where(seg < 0, S + 5, seg), vals)
    got = kernels.ordered_segment_sum(
        torch.from_numpy(vals), torch.from_numpy(seg), S,
        base=torch.from_numpy(base) if with_base else None)
    assert_same(want, got)
    flat = kernels.ordered_segment_sum(torch.from_numpy(vals[..., 0]),
                                       torch.from_numpy(seg), S)
    assert_same(np.asarray(jax.jit(jax.vmap(
        lambda s, v: jnp.zeros(S, jnp.float32).at[s].add(v, mode="drop")))(
            np.where(seg < 0, S + 5, seg), vals[..., 0])), flat)


@pytest.mark.parametrize("seed", [0, 1])
def test_ordered_range_sum_twin_matches_xla_scatter(seed):
    """Contiguous runs (empty ones included) summed like a sorted scatter."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 60, 40)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    vals = ((rng.random((offsets[-1], 3)) - 0.3) * 100).astype(np.float32)
    seg = np.repeat(np.arange(lengths.size), lengths)
    want = jax.jit(lambda s, v: jnp.zeros((lengths.size, 3), jnp.float32)
                   .at[s].add(v))(seg, vals)
    got = kernels.ordered_range_sum(torch.from_numpy(vals),
                                    torch.from_numpy(offsets))
    assert_same(want, got)


@pytest.mark.parametrize("m", [16, 128])
def test_net_broker_flow_twin_matches_reference(m):
    rng = np.random.default_rng(m)
    src = rng.integers(0, 9, m)
    dst = rng.integers(0, 9, m)
    earlier = np.tril(rng.random((m, m)) < 0.5, k=-1)
    d_src = ((rng.random(m) - 0.5) * 60).astype(np.float32)
    d_dst = ((rng.random(m) - 0.5) * 60).astype(np.float32)

    class C:
        pass
    c = C()
    c.src, c.dst = jnp.asarray(src), jnp.asarray(dst)
    lo, hi = _net_broker_flow(c, jnp.asarray(earlier), jnp.asarray(d_src),
                              jnp.asarray(d_dst))
    src_hi = _net_src_hi(c, jnp.asarray(earlier), jnp.asarray(d_src),
                         jnp.asarray(d_dst))
    got = kernels.net_broker_flow(*(torch.from_numpy(a) for a in
                                    (src, dst, earlier, d_src, d_dst)))
    for want, g, name in zip((lo, hi, src_hi), got,
                             ("net_src_lo", "net_dst_hi", "net_src_hi")):
        assert_close(want, g, rtol=1e-6, what=name)


@pytest.mark.parametrize("call", [
    lambda: kernels.threefry2x32(torch.zeros(3, dtype=torch.long),
                                 torch.arange(4)),
    lambda: kernels.ordered_segment_sum(torch.zeros(4, 2),
                                        torch.zeros(3, dtype=torch.long), 2),
    lambda: kernels.net_broker_flow(
        torch.zeros(3, dtype=torch.long), torch.zeros(2, dtype=torch.long),
        torch.zeros(3, 3, dtype=torch.bool), torch.zeros(3), torch.zeros(3)),
], ids=["key_words", "rows_vs_segments", "candidate_lengths"])
def test_kernel_wrappers_refuse_mismatched_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_kernel_wrappers_refuse_mixed_devices():
    with pytest.raises(ValueError):
        kernels.ordered_segment_sum(torch.zeros(3, 1), torch.zeros(3),
                                    2, base=torch.zeros(2, 1, device="meta"))
