"""Parity of the port's cluster statistics (``model/stats.py``, kernel KG
through its plain twin on the CPU) with the JAX package's — every value
bit for bit, on the tiny model, on 20 brokers with a dead one and on 24
brokers (rows where XLA's fused goal sums use eight lanes; these eager
column sums keep the tree order) — and the whole slice on 20 x 1K: samples
-> monitor -> resident state -> ``stats_summary`` -> optimize -> a broker
death and its drain, equal to the JAX package run through the same
sequence (``chip_smoke.served_cycle``)."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import cruise_control_tpu.model.stats as jstats
import cruise_control_tpu_torch.model.stats as tstats
from cruise_control_tpu_torch import kernels
from torch_parity_util import build_both, tiny_both, to_np

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODELS = {"tiny": tiny_both,
          "20x1k_dead": lambda: build_both(20, 1000, seed=10, dead=(4,)),
          "24x1k": lambda: build_both(24, 1000, seed=3),
          "24x1k_dead": lambda: build_both(24, 1000, seed=4, dead=(0, 23))}


@pytest.fixture(scope="module", params=sorted(MODELS))
def both(request):
    return MODELS[request.param]()


def test_cluster_stats_match_reference(both):
    (jm, _), (tm, _) = both
    want = jstats.cluster_stats(jm)
    got = tstats.cluster_stats(tm)
    assert set(got) == set(want)
    for key in ("num_alive_brokers", "utilization", "num_replicas",
                "num_leaders"):
        assert np.array_equal(to_np(got[key]), np.asarray(want[key])), key
    for group in ("resource", "replica_count", "leader_count",
                  "potential_nw_out"):
        assert set(got[group]) == set(want[group])
        for k, v in want[group].items():
            g, w = to_np(got[group][k]), np.asarray(v)
            assert g.dtype == w.dtype and np.array_equal(g, w), (group, k)
    assert np.array_equal(to_np(tstats.resource_cv(got)),
                          np.asarray(jstats.resource_cv(want)))


def test_stats_summary_matches_reference(both):
    (jm, _), (tm, _) = both
    want = jstats.stats_summary(jm)
    got = tstats.stats_summary(tm, device="cpu")
    assert got == want
    assert json.dumps(got) == json.dumps(want)        # key order too


@pytest.mark.parametrize("B", [8, 16, 24, 32, 40, 104, 1008, 1100, 4100,
                               20_000])
def test_kg_twin_matches_column_stats_of_the_reference(B):
    """KG's twin against the reference's ``_stats`` arithmetic on random
    broker aggregates of padded widths from 8 to 20,000 brokers: one tree
    level (up to 1,024), two (1,100 and 4,100) and three levels of XLA's
    windowed sums (20,000, past what KG stages at once)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(B)
    util = (rng.random((B, 4)) * [100.0, 1e4, 1e4, 1e6]).astype(np.float32)
    counts = rng.integers(0, 500, (2, B)).astype(np.int32)
    pot = (rng.random(B) * 1e4).astype(np.float32)
    alive = rng.random(B) < 0.9
    rvalid = rng.random((37, 3)) < 0.7
    pvalid = rng.random(37) < 0.8
    out = kernels.cluster_stats(
        torch.from_numpy(util), torch.from_numpy(counts[0]),
        torch.from_numpy(counts[1]), torch.from_numpy(pot),
        torch.from_numpy(alive), torch.from_numpy(rvalid),
        torch.from_numpy(pvalid))
    table, n = kernels.split_cluster_stats(out)
    vals = np.column_stack([util, counts.T.astype(np.float32), pot])
    a = jnp.asarray(alive)[:, None]
    nj = jnp.maximum(jnp.asarray(alive).sum(), 1)
    v = jnp.asarray(vals)
    mean = jnp.where(a, v, 0.0).sum(axis=0) / nj
    var = jnp.where(a, (v - mean) ** 2, 0.0).sum(axis=0) / nj
    want = np.stack([np.asarray(mean), np.asarray(jnp.sqrt(var)),
                     np.asarray(jnp.where(a, v, -jnp.inf).max(axis=0)),
                     np.asarray(jnp.where(a, v, jnp.inf).min(axis=0))])
    assert np.array_equal(table.numpy(), want), B
    assert n.tolist() == [int(alive.sum()), int(rvalid.sum()),
                          int(pvalid.sum())]


def test_kg_counts_match_the_reference_on_a_padded_model():
    """KG's fused counts (its buffer's last three words) equal the
    reference's alive broker, ``num_replicas`` and ``num_leaders`` on a
    model padded on both axes, with a dead broker."""
    from cruise_control_tpu_torch.model.flat import broker_utilization
    (jm, _), (tm, _) = build_both(5, 45, seed=2, dead=(3,))
    assert not tm.partition_valid.all() and not tm.broker_valid.all()
    want = jstats.cluster_stats(jm)
    out = tstats._stats_buffer(tm, broker_utilization(tm))
    _table, counts = kernels.split_cluster_stats(out)
    assert counts.dtype == torch.int32
    assert counts.tolist() == [int(want[k]) for k in kernels.STATS_COUNTS]
    assert counts.tolist() == [4, 90, 45]


def test_stats_summary_needs_the_model_on_its_device(monkeypatch):
    _, (tm, _) = tiny_both()
    elsewhere = tm.replace(replica_broker=tm.replica_broker.to("meta"))
    with pytest.raises(ValueError, match="lies on"):
        tstats.stats_summary(elsewhere, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstats.stats_summary(tm)


# ---------------------------------------------------------------------------
# The whole slice, both packages through chip_smoke's phase-9 sequence
# ---------------------------------------------------------------------------

#: bench's main-path search (512/16/512/512), scaled down with the cluster
SEARCH = dict(num_replica_candidates=128, num_dest_candidates=8,
              apply_per_iter=128, max_iters_per_goal=128, fused_chain=True)


def _packages():
    """``chip_smoke`` and ``served_cycle``'s views of both packages (the
    port's on the CPU) with the scaled-down search."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import served_reference            # puts the repo root on sys.path
    import chip_smoke
    return chip_smoke, (served_reference.jax_package(SEARCH),
                        chip_smoke.port_package(SEARCH, device="cpu"))


def test_whole_slice_matches_reference():
    chip_smoke, (jpkg, tpkg) = _packages()
    spec = chip_smoke.build_spec(20, 1000)
    want = chip_smoke.served_cycle(jpkg, spec, dead_broker=19)
    got = chip_smoke.served_cycle(tpkg, spec, dead_broker=19)
    assert got["cold"]["update"] == "full" and got["cold"]["epoch"] == 1
    for c, w in zip(got["cycles"], want["cycles"]):
        assert (c["update"], c["epoch"], c["rows"]) == ("delta", 1, 10)
        assert c["planes"] == w["planes"]
    assert got["stats_before"] == want["stats_before"]
    assert got["optimize"] == want["optimize"]
    assert got["optimize"]["satisfied"] and got["optimize"]["audit_ok"]
    assert got["stats_after"] == want["stats_after"]
    assert got["structural"]["update"] == "full"
    assert got["structural"]["epoch"] == 2
    assert got["drain"] == want["drain"] and got["drain"]["left"] == 0
