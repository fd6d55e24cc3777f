"""Parity of the port's device-resident model state
(``cruise_control_tpu_torch.model.resident``, kernel KF through its plain
twin on the CPU) with the JAX package's: the same simulated cluster and
sample feed drive both packages' monitors with the resident state on.
Mirrors ``tests/test_resident.py`` without the facade: delta cycles are
bit-identical to a from-scratch build and to the reference's resident
model, a no-op uploads nothing, placement-only builds bypass the state,
structural changes bump the epoch, the replication capture/apply chain
and snapshot export/restore round-trip, and nothing is built after
``warmup``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import resident as jres
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.core.runtime_obs import default_collector
from cruise_control_tpu_torch.model import resident as tres
from cruise_control_tpu_torch.model.flat import FlatClusterModel
from torch_parity_util import (SampleFeed, assert_models_equal, base_values,
                               monitors_both, sim_both, to_np)

torch.set_num_threads(1)


def _stack(partitions=24, num_brokers=4, **cfg):
    """Both packages' resident monitors plus the port's full-upload
    monitor, all fed the same samples (four windows)."""
    jsim, tsim = sim_both(num_brokers, partitions)
    jm, tm = monitors_both(jsim, tsim, **cfg)
    tfull = monitors_both(jsim, tsim, resident_state=False, **cfg)[1]
    feed = SampleFeed(jsim, [jm, tm, tfull])
    vals = base_values(len(feed.keys))
    feed.ingest(vals, windows=4)
    return (jsim, tsim), (jm, tm, tfull), feed, vals


def _build(monitors, feed, what):
    jm, tm, tfull = monitors
    jr, tr, fr = (m.cluster_model(feed.now_ms) for m in monitors)
    assert_models_equal(jr.model, tr.model, f"{what}: vs the reference")
    for f in dataclasses.fields(fr.model):
        assert torch.equal(getattr(tr.model, f.name),
                           getattr(fr.model, f.name)), \
            f"{what}: {f.name} vs a from-scratch upload"
    assert tr.metadata.partition_keys == jr.metadata.partition_keys
    return jr, tr


def _resident_json(res):
    out = res.to_json()
    out.pop("lastDeltaBytes")          # unpadded in the port, see below
    return out


def test_delta_cycles_match_full_rebuild_and_reference():
    """``test_resident.py:97``: random churn cycles, a broker death and
    restart, a partition add and a return to the delta path."""
    (jsim, tsim), monitors, feed, vals = _stack()
    jm, tm, _ = monitors
    _build(monitors, feed, "initial")
    assert tm.resident.epoch == 1 and tm.resident.last_update == "full"
    P = len(feed.keys)
    rng = np.random.default_rng(7)
    for cycle in range(4):
        rows = rng.choice(P, size=3, replace=False)
        vals = vals.copy()
        vals[rows] += 1.0 + cycle
        feed.ingest(vals, windows=2)
        _build(monitors, feed, f"delta cycle {cycle}")
        assert tm.resident.last_update == "delta" and tm.resident.epoch == 1
        assert (tm.resident.last_delta_rows
                == jm.resident.last_delta_rows >= len(rows))
        assert _resident_json(tm.resident) == _resident_json(jm.resident)
    for sim in (jsim, tsim):
        sim.kill_broker(1)
    _build(monitors, feed, "broker death")
    assert tm.resident.epoch == 2 and tm.resident.last_update == "full"
    for sim in (jsim, tsim):
        sim.restart_broker(1)
    _build(monitors, feed, "broker restart")
    assert tm.resident.epoch == 3
    for sim in (jsim, tsim):
        sim.add_partition("t0", P, [0, 2], size_mb=99.0)
    feed.refresh_keys(jsim)
    vals = np.vstack([vals, base_values(P + 1)[-1:]])
    feed.ingest(vals, windows=2)
    _build(monitors, feed, "partition add")
    assert tm.resident.epoch == 4 and tm.resident.last_update == "full"
    vals = vals.copy()
    vals[0] += 5.0
    feed.ingest(vals, windows=2)
    _build(monitors, feed, "delta after the bump")
    assert tm.resident.last_update == "delta" and tm.resident.epoch == 4
    assert _resident_json(tm.resident) == _resident_json(jm.resident)


def test_served_model_keeps_its_loads_after_later_cycles():
    """A model handed out by one cycle keeps that cycle's planes through
    the next delta cycles and a replica's ``apply_delta``, as the
    reference's copy-on-write scatter does."""
    _sims, monitors, feed, vals = _stack()
    jm, tm, _ = monitors
    _build(monitors, feed, "initial")
    tm.resident.enable_delta_capture()
    epoch, mirrors = tm.resident.export_state()
    replica = tres.ResidentClusterState(device="cpu")
    replica.restore(epoch, mirrors, ingest_seq=tm.resident.ingest_seq)
    kept, replica_models = [], [replica.model]
    for cycle in range(3):
        vals = vals.copy()
        vals[[1 + cycle, 11]] += 2.0 + cycle
        feed.ingest(vals, windows=2)
        kept.append(_build(monitors, feed, f"cycle {cycle}"))
        assert tm.resident.last_update == "delta"
    for entry in tm.resident.drain_deltas()[0]:
        assert replica.apply_delta(entry) is True
        replica_models.append(replica.model)
    for cycle, (jr, tr) in enumerate(kept):
        assert_models_equal(jr.model, tr.model, f"cycle {cycle}, kept")
        assert_models_equal(jr.model, replica_models[cycle + 1],
                            f"cycle {cycle}, replica")
    for f in ("leader_load", "follower_load"):
        assert torch.equal(getattr(replica_models[0], f),
                           torch.from_numpy(mirrors[f]))


def test_delta_payload_is_unpadded():
    """The port uploads exactly the changed rows: ``last_delta_bytes`` is
    K * (4 + 2 * 16) bytes, where the reference pads K to its 512-row
    bucket."""
    _sims, monitors, feed, vals = _stack(partitions=40)
    jm, tm, _ = monitors
    _build(monitors, feed, "initial")
    vals = vals.copy()
    vals[[3, 17, 29]] += 2.0
    feed.ingest(vals, windows=2)
    _build(monitors, feed, "delta")
    assert tm.resident.last_delta_rows == jm.resident.last_delta_rows == 3
    assert tm.resident.last_delta_bytes == 3 * (4 + 2 * 4 * 4)
    assert jm.resident.last_delta_bytes > tm.resident.last_delta_bytes


def test_noop_cycle_reuses_model_and_uploads_nothing():
    _sims, monitors, feed, _vals = _stack()
    tm = monitors[1]
    r1 = tm.cluster_model(feed.now_ms)
    snap = default_collector().snapshot()
    r2 = tm.cluster_model(feed.now_ms)
    res = tm.resident
    assert r2.model is r1.model
    assert res.last_update == "noop" and res.noop_cycles == 1
    assert res.last_delta_rows == 0 and res.last_delta_bytes == 0
    assert default_collector().snapshot()["h2dBytes"] == snap["h2dBytes"]


def test_placement_only_build_bypasses_resident_state():
    _sims, monitors, feed, vals = _stack()
    tm = monitors[1]
    r1 = tm.cluster_model(feed.now_ms)
    res = tm.resident
    snap = dict(res.to_json())
    placement = tm.cluster_model(feed.now_ms,
                                 populate_replica_placement_only=True)
    assert placement.model is not r1.model
    assert dict(res.to_json()) == snap
    vals = vals.copy()
    vals[7] += 2.0
    feed.ingest(vals, windows=2)
    tm.cluster_model(feed.now_ms)
    assert res.last_update == "delta" and res.last_delta_rows == 1


def test_warmup_then_metric_cycles_build_nothing():
    """``test_resident.py:178`` and the tier-1 gate at :373 without the
    facade: after ``warmup`` three metric-only cycles record no library
    build or load, and each cycle's host-to-device bytes are exactly its
    delta payload, a fraction of the full upload. (On the CPU KF's twin
    never loads the library; ``test_torch_kernels_cuda.py`` shows on the
    card that a delta cycle without ``warmup`` does.)"""
    _sims, monitors, feed, vals = _stack()
    tm = monitors[1]
    res = tm.resident
    assert res.warmup() is False          # nothing resident yet
    tm.cluster_model(feed.now_ms)
    full = res.last_full_bytes
    assert res.warmup() is True
    collector = default_collector()
    snap = collector.snapshot()
    for cycle in range(3):
        vals = vals.copy()
        vals[[2 + cycle, 9]] += 3.0
        feed.ingest(vals, windows=2)
        with collector.cycle("monitor"):
            tm.cluster_model(feed.now_ms)
        last = collector.last_cycle
        assert res.last_update == "delta" and res.epoch == 1
        assert last["compileEvents"] == 0
        assert last["h2dBytes"] == res.last_delta_bytes
        assert 0 < last["h2dBytes"] < full
    after = collector.snapshot()
    assert after["compileEvents"] == snap["compileEvents"]
    assert after["aotCompileEvents"] == snap["aotCompileEvents"]


def test_library_events_count_as_builds(monkeypatch, tmp_path):
    """``kernels.load_library`` reports each build or load of the kernel
    library to the default collector as a compile event (an ahead-of-time
    warmup inside ``warming``, a ``signature-change`` when it repeats);
    loading an already loaded library reports nothing. ``ctypes`` opens a
    stand-in here: the CPU has no library to load."""
    from cruise_control_tpu_torch.core import runtime_obs

    class FakeLibrary:
        def __getattr__(self, name):
            fn = type("Entry", (), {})()
            setattr(self, name, fn)
            return fn

    lib = tmp_path / "libcc_kernels.so"
    c = runtime_obs.DeviceStatsCollector()
    monkeypatch.setattr(runtime_obs, "_DEFAULT", c)
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "library_path", lambda: lib)
    monkeypatch.setattr(kernels, "build_library",
                        lambda: lib.touch() or lib)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: FakeLibrary())
    with c.warming():
        kernels.load_library()            # nvcc "ran": a build
    kernels.load_library()                # loaded already: nothing
    assert c.snapshot()["compileEvents"] == 0
    monkeypatch.setattr(kernels, "_LIB", None)
    kernels.load_library()                # cached: a load, after warmup
    snap = c.snapshot()
    assert (snap["compileEvents"], snap["aotCompileEvents"],
            snap["recompileEvents"]) == (1, 1, 1)
    events = c.to_json()["compile"]["recentEvents"]
    assert [(e["program"], e["cache"], e["trigger"]) for e in events] == [
        (runtime_obs.KERNEL_LIBRARY_PROGRAM, "build", "aot-warmup"),
        (runtime_obs.KERNEL_LIBRARY_PROGRAM, "load", "signature-change")]


def test_delta_capture_and_replica_apply():
    """``drain_deltas`` entries equal the reference's array for array;
    applying them on a replica restored from the leader's first export
    reproduces the leader's model; a gap is refused."""
    _sims, monitors, feed, vals = _stack()
    jm, tm, _ = monitors
    _build(monitors, feed, "initial")
    for m in (jm, tm):
        m.resident.enable_delta_capture()
    epoch, mirrors = tm.resident.export_state()
    replica = tres.ResidentClusterState(device="cpu")
    replica.restore(epoch, mirrors, ingest_seq=tm.resident.ingest_seq)
    rng = np.random.default_rng(3)
    for cycle in range(3):
        vals = vals.copy()
        vals[rng.choice(len(feed.keys), 4, replace=False)] += 1.0 + cycle
        feed.ingest(vals, windows=2)
        _build(monitors, feed, f"cycle {cycle}")
    jent, jover = jm.resident.drain_deltas()
    tent, tover = tm.resident.drain_deltas()
    assert tover == jover is False and len(tent) == len(jent) == 3
    for j, t in zip(jent, tent):
        assert set(t) == set(j)
        for k in j:
            if isinstance(j[k], np.ndarray):
                assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])
            else:
                assert t[k] == j[k], k
    assert replica.apply_delta(tent[1]) is False        # not contiguous
    for entry in tent:
        assert replica.apply_delta(entry) is True
    assert_models_equal(jm.resident.model, replica.model, "replica")
    assert replica.ingest_seq == tm.resident.ingest_seq
    assert replica.applied_deltas == 3


def test_export_restore_round_trip_and_reference_snapshot():
    """The port restores its own export and the reference's
    ``export_state`` mirrors as they are; the epoch resumes monotonic."""
    _sims, monitors, feed, _vals = _stack()
    jm, tm, _ = monitors
    _build(monitors, feed, "initial")
    for source in (tm.resident, jm.resident):
        epoch, mirrors = source.export_state()
        fresh = tres.ResidentClusterState(device="cpu")
        assert fresh.export_state() is None
        fresh.restore(epoch + 2, mirrors)
        assert fresh.epoch == epoch + 2 and fresh.restores == 1
        assert fresh.last_update == "restore"
        assert_models_equal(jm.resident.model, fresh.model, "restored")
        e2, m2 = fresh.export_state()
        assert e2 == epoch + 2 and all(m2[k] is mirrors[k] for k in mirrors)
    tm.resident.invalidate()
    assert tm.resident.model is None
    tm.cluster_model(feed.now_ms)
    assert tm.resident.last_update == "full" and tm.resident.epoch == 2


def _kf_both(lead, foll, idx, lead_rows, foll_rows):
    """(reference planes, port planes): the jitted ``_delta_scatter`` and
    KF's twin through the packed payload, the port's input planes checked
    untouched."""
    want = jax.jit(jres._delta_scatter)(lead, foll, idx, lead_rows,
                                        foll_rows)
    tl, tf = torch.from_numpy(lead.copy()), torch.from_numpy(foll.copy())
    got = kernels.delta_row_scatter(tl, tf, torch.from_numpy(
        kernels.pack_delta_rows(idx, lead_rows, foll_rows)))
    assert torch.equal(tl, torch.from_numpy(lead))
    assert torch.equal(tf, torch.from_numpy(foll))
    return [np.asarray(w) for w in want], [to_np(g) for g in got]


def test_kf_twin_matches_the_reference_scatter():
    """KF's twin equals the jitted ``_delta_scatter`` on a padded payload
    whose padding rows carry index P (dropped)."""
    rng = np.random.default_rng(0)
    P, K = 256, 16
    lead = rng.random((P, 4)).astype(np.float32)
    foll = rng.random((P, 4)).astype(np.float32)
    idx = np.full(K, P, np.int32)
    idx[:11] = rng.choice(P, 11, replace=False)
    lead_rows = rng.random((K, 4)).astype(np.float32)
    foll_rows = rng.random((K, 4)).astype(np.float32)
    want, got = _kf_both(lead, foll, idx, lead_rows, foll_rows)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.mark.parametrize("case", ["random_order", "padded_bucket",
                                  "one_dropped_row", "every_row",
                                  "three_columns"])
def test_kf_out_of_place_matches_the_reference(case):
    """KF's twin, through the packer, against the jitted ``_delta_scatter``:
    indices in random order (the packer sorts them), the reference's own
    padded payload (a 512-row bucket, padding at index P), one all-dropped
    row (``warmup``'s payload), every row, and a width other than 4; the
    input planes stay as they were."""
    rng = np.random.default_rng(len(case))
    P, C = 300, 3 if case == "three_columns" else 4
    lead = rng.random((P, C)).astype(np.float32)
    foll = rng.random((P, C)).astype(np.float32)
    if case == "padded_bucket":
        idx = np.full(512, P, np.int32)
        idx[:40] = np.sort(rng.choice(P, 40, replace=False))
    elif case == "one_dropped_row":
        idx = np.array([P], np.int32)
    elif case == "every_row":
        idx = rng.permutation(P).astype(np.int32)
    else:
        idx = rng.choice(P, 57, replace=False).astype(np.int32)
    lead_rows = rng.random((idx.size, C)).astype(np.float32)
    foll_rows = rng.random((idx.size, C)).astype(np.float32)
    if case == "padded_bucket":
        lead_rows[40:] = foll_rows[40:] = 0.0
    want, got = _kf_both(lead, foll, idx, lead_rows, foll_rows)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    if case == "one_dropped_row":
        assert np.array_equal(got[0], lead) and np.array_equal(got[1], foll)


@pytest.mark.parametrize("K,C", [(1, 4), (200, 4), (7, 3)])
def test_packed_payload_bytes(K, C):
    """The packed payload holds K * (4 + 2 * C * 4) bytes (rows, then
    indices; nothing padded), its rows in ascending index order."""
    rng = np.random.default_rng(K)
    idx = rng.choice(1000, K, replace=False).astype(np.int32)
    lead_rows = rng.random((K, C)).astype(np.float32)
    foll_rows = rng.random((K, C)).astype(np.float32)
    packed = kernels.pack_delta_rows(idx, lead_rows, foll_rows)
    assert packed.dtype == np.float32
    assert packed.nbytes == K * (4 + 2 * C * 4)
    order = np.argsort(idx)
    assert np.array_equal(packed[2 * K * C:].view(np.int32), idx[order])
    assert np.array_equal(packed[:K * C].reshape(K, C), lead_rows[order])
    assert np.array_equal(packed[K * C:2 * K * C].reshape(K, C),
                          foll_rows[order])


def test_resident_state_needs_the_card(monkeypatch):
    with pytest.raises(NotImplementedError, match="K15"):
        tres.ResidentClusterState(device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.ResidentClusterState()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlatClusterModel.from_numpy(leader_load=np.zeros((1, 4), np.float32))
