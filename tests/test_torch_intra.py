"""The intra-broker (JBOD) disk rebalance of the port against the JAX
package's (``tests/test_intra.py``'s analyzer cases): the disk state and
logdir lists built from one simulated cluster in each package, the walk's
final disk slots and iteration count on the 3-broker stack and on seeded
random JBOD layouts (equal sizes, zero-size replicas on a draining disk, a
capacity bound, an iteration cap that binds, padded brokers and
partitions), the eager violation sums, and ``intra_broker_rebalance``'s
moves, goal summary, violations and iterations for a rebalance and a drain
and its refusals. The port runs on ``device="cpu"``, where KH takes its
plain twin; every number must be equal bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.intra as ji
import cruise_control_tpu.config.capacity as jcap
import cruise_control_tpu.executor.simulated as jsim
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu_torch.analyzer.intra as ti
import cruise_control_tpu_torch.config.capacity as tcap
import cruise_control_tpu_torch.executor.simulated as tsim
import cruise_control_tpu_torch.model.spec as tspec
from cruise_control_tpu.core.resources import Resource as JResource
from cruise_control_tpu_torch.core.resources import Resource as TResource

torch.set_num_threads(1)

FIELDS = ("replica_disk", "replica_size", "replica_broker", "disk_capacity",
          "disk_valid")


class _JbodResolver:
    """Two 1000-MB logdirs per broker (``tests/test_intra.py``)."""

    def __init__(self, cap_mod, resource, by_dir=None, disk=2000.0):
        self.cap_mod, self.r = cap_mod, resource
        self.by_dir = ({"d0": 1000.0, "d1": 1000.0} if by_dir is None
                       else by_dir)
        self.disk = disk

    def capacity_for_broker(self, rack, host, broker_id):
        r = self.r
        return self.cap_mod.BrokerCapacityInfo(
            capacity={r.CPU: 100.0, r.NW_IN: 1e6, r.NW_OUT: 1e6,
                      r.DISK: self.disk},
            disk_capacity_by_logdir=self.by_dir)


def _stack_both(num_brokers=3, partitions=12, logdirs=("d0", "d1"),
                layout=None, sizes=None, by_dir=None, disk=2000.0):
    """(jax side, port side): each a (model, metadata, sim, resolver) of one
    JBOD cluster — by default ``tests/test_intra.py``'s stack: every
    replica crowds logdir d0, partition p sized 40 + p MB. ``layout(p, r)``
    names replica r's logdir; ``by_dir=False`` leaves the per-logdir
    capacity to the even split of the broker's DISK capacity."""
    out = []
    for spec_mod, sim_mod, cap_mod, res, kw in (
            (jspec, jsim, jcap, JResource, {}),
            (tspec, tsim, tcap, TResource, {"device": "cpu"})):
        sim = sim_mod.SimulatedKafkaCluster()
        for b in range(num_brokers):
            sim.add_broker(b, rate_mb_s=100_000.0, logdirs=tuple(logdirs))
        parts = []
        for p in range(partitions):
            reps = [p % num_brokers, (p + 1) % num_brokers]
            size = 40.0 + p if sizes is None else sizes(p)
            where = {b: (layout(p, r) if layout else "d0")
                     for r, b in enumerate(reps)}
            sim.add_partition("t", p, reps, size_mb=size,
                              logdir_by_broker=where)
            parts.append(spec_mod.PartitionSpec(
                topic="t", partition=p, replicas=reps,
                leader_load=(1.0, 10.0, 10.0, size)))
        model, md = spec_mod.flatten_spec(spec_mod.ClusterSpec(
            brokers=[spec_mod.BrokerSpec(broker_id=b, rack=f"r{b}")
                     for b in range(num_brokers)],
            partitions=parts), **kw)
        resolver = (cap_mod.FixedCapacityResolver(capacity={
            res.CPU: 100.0, res.NW_IN: 1e6, res.NW_OUT: 1e6,
            res.DISK: disk}) if by_dir is False
            else _JbodResolver(cap_mod, res, by_dir, disk))
        out.append((model, md, sim, resolver))
    return out[0], out[1]


def _assert_states_equal(jstate, tstate):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)


def _moves(result):
    return [tuple(dataclasses.astuple(m)) for m in result.moves]


def _assert_results_equal(jres, tres):
    assert _moves(tres) == _moves(jres)
    assert tres.goal_summary() == jres.goal_summary()
    for f in ("capacity_violation_before", "capacity_violation_after",
              "balance_violation_before", "balance_violation_after",
              "iterations"):
        assert getattr(tres, f) == getattr(jres, f), f


def test_disk_state_and_logdirs_from_one_cluster():
    (jm, jmd, jsim_, jres), (tm, tmd, tsim_, tres) = _stack_both()
    jstate, jdirs = ji.build_disk_state(jm, jmd, jsim_, jres)
    tstate, tdirs = ti.build_disk_state(tm, tmd, tsim_, tres)
    assert tdirs == jdirs == [["d0", "d1"]] * 3
    _assert_states_equal(jstate, tstate)
    np.testing.assert_array_equal(tstate.disk_util.numpy(),
                                  np.asarray(jstate.disk_util))
    # everything sits on d0
    assert tstate.disk_util[:3, 1].sum() == 0


def test_disk_state_from_numpy_carries_the_reference_arrays(monkeypatch):
    (jm, jmd, jsim_, jres), _ = _stack_both()
    jstate, _ = ji.build_disk_state(jm, jmd, jsim_, jres)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in FIELDS}
    tstate = ti.DiskState.from_numpy(device="cpu", **arrays)
    _assert_states_equal(jstate, tstate)
    assert tstate.replica_disk.dtype == torch.int32
    assert tstate.disk_valid.dtype == torch.bool
    # device=None means the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ti.DiskState.from_numpy(**arrays)


def test_balance_walk_on_the_three_broker_stack():
    (jm, jmd, jsim_, jres), (tm, tmd, tsim_, tres) = _stack_both()
    jstate, _ = ji.build_disk_state(jm, jmd, jsim_, jres)
    tstate, _ = ti.build_disk_state(tm, tmd, tsim_, tres)
    jfinal, jit = ji.optimize_intra_broker(jstate)
    tfinal, tit = ti.optimize_intra_broker(tstate)
    assert int(tit) == int(jit) > 0
    _assert_states_equal(jfinal, tfinal)
    util = tfinal.disk_util.numpy()
    for b in range(3):
        avg = util[b, :2].mean()
        assert abs(util[b, 0] - avg) <= 1.10 * avg


def _random_jbod(seed, D=None):
    """A seeded random JBOD layout: padded brokers and partitions, brokers
    with fewer disks than D (1-5 unless given; a given D keeps all or all
    but one, with sizes that round), draining disks, equal and zero sizes,
    tight capacities, and an iteration cap that sometimes binds."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 9))
    wide = D is not None
    D = D if wide else int(rng.integers(1, 6))
    P = int(rng.integers(1, 90)) if D < 6 else int(rng.integers(8, 40)) * D
    R = int(rng.integers(1, min(B, 3) + 1))
    Bp, Pp = B + int(rng.integers(0, 3)), P + int(rng.integers(0, 5))
    rb = np.full((Pp, R), Bp, np.int32)
    for p in range(P):
        rb[p] = rng.choice(B, R, replace=False)
    on = rb < Bp
    rd = np.where(on, rng.integers(0, D, (Pp, R)), -1).astype(np.int32)
    rd = np.where(on & (rng.random((Pp, R)) < 0.6), 0, rd).astype(np.int32)
    if seed % 2 and not wide:
        size = rng.choice([0.0, 10.0, 25.5, 40.0, 40.0, 77.25], (Pp, R))
    else:
        size = rng.random((Pp, R)) * 100
    size = np.where(on, size, 0.0).astype(np.float32)
    cap = np.zeros((Bp, D), np.float32)
    valid = np.zeros((Bp, D), bool)
    cap[:B] = rng.random((B, D)) * (400 if seed % 3 == 0 else 2000) + 100
    valid[:B] = True
    for b in range(B):
        # a wide broker keeps data on most disks: every window of the
        # D-axis sum holds live disks
        nd = int(rng.integers(D - 1 if wide else 1, D + 1))
        valid[b, nd:] = False
        cap[b, nd:] = 0.0
        if rng.random() < 0.3 and nd > 1:
            cap[b, 0] = 0.0                      # draining
    max_iters = int(rng.choice([0, 1, 3, 512]))
    return dict(replica_disk=rd, replica_size=size, replica_broker=rb,
                disk_capacity=cap, disk_valid=valid), max_iters


@pytest.mark.parametrize("seed,D", [pytest.param(s, None, id=str(s))
                                    for s in range(16)]
                         + [pytest.param(100 + D, D, id=f"D{D}")
                            for D in (6, 8, 12, 16, 24, 32, 33, 48, 64)])
def test_walk_on_random_jbod_layouts(seed, D):
    """Random layouts of 1-5 disks a broker, and of 6-64 (the walk's mean
    over the D axis and ``_violations``' sums change order at 9, 33 and 64
    disks)."""
    arrays, max_iters = _random_jbod(seed, D)
    jstate = ji.DiskState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = ti.DiskState.from_numpy(device="cpu", **arrays)
    np.testing.assert_array_equal(tstate.disk_util.numpy(),
                                  np.asarray(jstate.disk_util))
    jfinal, jit = ji.optimize_intra_broker(jstate, max_iters=max_iters)
    tfinal, tit = ti.optimize_intra_broker(tstate, max_iters=max_iters)
    assert int(tit) == int(jit)
    _assert_states_equal(jfinal, tfinal)
    for thresholds in ((0.8, 1.10), (0.5, 1.02)):
        for js, ts in ((jstate, tstate), (jfinal, tfinal)):
            assert [float(x) for x in ti._violations(ts, *thresholds)] == [
                float(x) for x in ji._violations(js, *thresholds)]


def test_zero_size_replicas_on_a_draining_disk():
    """The 5-MB replica leaves the draining disk 0; the zero-size replicas
    there stay, in both packages: once the disk holds 0 MB its pressure is
    -inf (a draining disk is pressured only while it holds data), so it is
    never the source again."""
    arrays = dict(
        replica_disk=np.array([[0], [0], [0], [1]], np.int32),
        replica_size=np.array([[0.0], [0.0], [5.0], [0.0]], np.float32),
        replica_broker=np.zeros((4, 1), np.int32),
        disk_capacity=np.array([[0.0, 100.0, 100.0]], np.float32),
        disk_valid=np.ones((1, 3), bool))
    jfinal, jit = ji.optimize_intra_broker(ji.DiskState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    tfinal, tit = ti.optimize_intra_broker(
        ti.DiskState.from_numpy(device="cpu", **arrays))
    _assert_states_equal(jfinal, tfinal)
    assert int(tit) == int(jit) == 2
    assert tfinal.replica_disk[:, 0].tolist() == [0, 0, 1, 1]


def test_capacity_goal_sheds_onto_siblings():
    """``tests/test_intra.py``'s three-disk broker: 900 MB on d0 of three
    1000-MB disks under a 0.8 threshold."""
    (jm, jmd, jsim_, _), (tm, tmd, tsim_, _) = _stack_both(
        num_brokers=2, partitions=9, logdirs=("d0", "d1", "d2"),
        sizes=lambda p: 100.0)
    by_dir = {"d0": 1000.0, "d1": 1000.0, "d2": 1000.0}
    jstate, _ = ji.build_disk_state(
        jm, jmd, jsim_, _JbodResolver(jcap, JResource, by_dir, 3000.0))
    tstate, _ = ti.build_disk_state(
        tm, tmd, tsim_, _JbodResolver(tcap, TResource, by_dir, 3000.0))
    jfinal, jit = ji.optimize_intra_broker(jstate, cap_threshold=0.8)
    tfinal, tit = ti.optimize_intra_broker(tstate, cap_threshold=0.8)
    _assert_states_equal(jfinal, tfinal)
    assert int(tit) == int(jit)
    util = tfinal.disk_util.numpy()[:2, :3]
    assert (util <= 1000.0 * 0.8 + 1e-3).all(), util


@pytest.mark.parametrize("drained", [None, {0: ["d0"]}, {0: ["d0"],
                                                         2: ["d1"]}])
def test_intra_broker_rebalance_matches_reference(drained):
    (jm, jmd, jsim_, jres), (tm, tmd, tsim_, tres) = _stack_both(
        partitions=24, logdirs=("d0", "d1", "d2"),
        layout=lambda p, r: f"d{(p + r) % 2}", by_dir=False, disk=6000.0)
    jr = ji.intra_broker_rebalance(jm, jmd, jsim_, jres,
                                   drained_disks=drained)
    tr = ti.intra_broker_rebalance(tm, tmd, tsim_, tres,
                                   drained_disks=drained)
    _assert_results_equal(jr, tr)
    assert tr.moves and tr.iterations > 0
    if drained:
        # a drained disk's capacity is 0, so whatever stays on it counts as
        # over capacity
        assert tr.capacity_violation_after == 0.0 < tr.capacity_violation_before


def test_rebalance_where_the_iteration_cap_binds():
    """Two brokers of 1,200 equal replicas each, all on d0 of two disks:
    each needs 600 moves, so the default cap of 512 iterations binds and
    the port must stop where the reference stops."""
    (jm, jmd, jsim_, jres), (tm, tmd, tsim_, tres) = _stack_both(
        num_brokers=2, partitions=1200, sizes=lambda p: 10.0, by_dir=False,
        disk=1e6)
    jr = ji.intra_broker_rebalance(jm, jmd, jsim_, jres)
    tr = ti.intra_broker_rebalance(tm, tmd, tsim_, tres)
    _assert_results_equal(jr, tr)
    assert tr.iterations == 512 and len(tr.moves) == 2 * 512


@pytest.mark.parametrize("drained,match", [
    ({7: ["d0"]}, "unknown broker id 7"),
    ({0: ["bogus"]}, "no logdir 'bogus'"),
    ({0: ["d0", "d1"]}, "cannot remove every logdir"),
    ({0: ["d0"]}, "Not enough remaining capacity"),
])
def test_rebalance_refusals_match_reference(drained, match):
    by_dir = ({"d0": 1000.0, "d1": 100.0} if "Not enough" in match
              else None)
    (jm, jmd, jsim_, jres), (tm, tmd, tsim_, tres) = _stack_both(
        partitions=24, by_dir=by_dir)
    with pytest.raises(ValueError, match=match) as jerr:
        ji.intra_broker_rebalance(jm, jmd, jsim_, jres,
                                  drained_disks=drained)
    with pytest.raises(ValueError) as terr:
        ti.intra_broker_rebalance(tm, tmd, tsim_, tres,
                                  drained_disks=drained)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape", [(1, 4), (3, 4), (4, 3), (8, 4), (12, 4),
                                   (16, 8), (24, 6), (32, 4), (40, 4),
                                   (64, 4), (104, 4), (104, 1), (1104, 4),
                                   (8, 12), (24, 16), (104, 24), (8, 33),
                                   (40, 48), (104, 64), (64, 64), (17, 5),
                                   (31, 3)])
def test_matrix_sum_follows_the_eager_reference_sum(shape):
    """``_violations``' whole-matrix sums: ``utils.ordered.matrix_sum``
    against an eager ``jnp.sum`` over both axes, across the lane, window
    and vector regimes."""
    from cruise_control_tpu_torch.utils.ordered import matrix_sum
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    for _ in range(4):
        x = (rng.random(shape) * 100 * (rng.random(shape) < 0.7)).astype(
            np.float32)
        assert float(matrix_sum(torch.from_numpy(x))) == float(
            jnp.asarray(x).sum())


@pytest.mark.parametrize("D", range(2, 13))
def test_matrix_sum_small_shapes(D):
    """Every matrix of 1-32 rows by ``D`` columns, with magnitudes spread
    over 30 binades so that any other order changes the bits."""
    from cruise_control_tpu_torch.utils.ordered import matrix_sum
    rng = np.random.default_rng(D)
    for B in range(1, 33):
        for _ in range(2):
            x = (rng.random((B, D)) * 2.0 ** rng.integers(-10, 20, (B, D))
                 ).astype(np.float32)
            assert float(matrix_sum(torch.from_numpy(x))) == float(
                jnp.asarray(x).sum()), (B, D)


@pytest.mark.parametrize("shape", [(8, 63), (63, 4)])
def test_matrix_sum_refuses_an_unreproduced_order(shape):
    """One element of padding on an axis over 32 (31 mod 32) takes a
    split loop; the order is now reproduced (once refused): the sum equals
    the eager reference sum."""
    from cruise_control_tpu_torch.utils.ordered import matrix_sum
    rng = np.random.default_rng(shape[0] + shape[1])
    for _ in range(4):
        x = (rng.random(shape) * 2.0 ** rng.integers(-10, 20, shape)
             ).astype(np.float32)
        assert float(matrix_sum(torch.from_numpy(x))) == float(
            jnp.asarray(x).sum())
