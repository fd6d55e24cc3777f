"""The port's fleet sweeps against the JAX package's, on
``tests/test_fleet.py``'s three members built in both packages.

``sweep_n1`` and ``sweep_trajectories`` summaries must equal the JAX
fleet's exactly (also on the heterogeneous degrade path, and on a member
with a dead broker); the raw ``viol``/``vscale``/``pressure``/
``unavailable`` of the port's fleet scorer must equal the reference's
compiled fleet-sweep programs', bit for bit (no tolerance anywhere); and
KJ's twin over a ``[C, S]`` grid must equal C calls of KD's twin. The port
runs on ``device="cpu"``, where KJ takes its twin."""

import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.fleet as jf
import cruise_control_tpu.model.spec as jspec
import cruise_control_tpu.whatif as jw
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.fleet as tf
import cruise_control_tpu_torch.model.spec as tspec
import cruise_control_tpu_torch.whatif as tw
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.whatif.engine import make_fleet_scenario_scorer
from torch_parity_util import assert_same

torch.set_num_threads(1)

#: tests/test_fleet.py's chain, and the what-if tests' chain with a hard
#: capacity goal that N-1 losses violate
CHAINS = {"fleet2": ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"],
          "goals3": ["NetworkOutboundCapacityGoal", "ReplicaDistributionGoal",
                     "DiskUsageDistributionGoal"]}
PACKAGES = {"jax": (jspec, ja, jf, {}), "torch": (tspec, ta, tf,
                                                  {"device": "cpu"})}
#: bench's forecast grid shape: +1 h / +6 h / +24 h x p50 / p90
HORIZONS = (3_600_000, 21_600_000, 86_400_000)
QUANTILES = (0.5, 0.9)


def _cluster(mod, brokers, partitions, seed, topics=5, dead=(), **kw):
    bs = [mod.BrokerSpec(broker_id=i, rack=f"r{i % 4}",
                         capacity=(100.0, 1e4, 1500.0, 1e5),
                         alive=i not in dead)
          for i in range(brokers)]
    ps = [mod.PartitionSpec(topic=f"t{p % topics}", partition=p,
                            replicas=[p % 2, 2 + p % 3],
                            leader_load=(1.0, 10.0, 12.0 + (p % 7),
                                         60.0 + ((p * seed) % 13)))
          for p in range(partitions)]
    return mod.flatten_spec(mod.ClusterSpec(brokers=bs, partitions=ps), **kw)


FLEETS = {
    "fleet3": [("c0", 8, 96, 3, {}), ("c1", 10, 128, 4, {}),
               ("c2", 12, 160, 5, {})],
    "dead_broker": [("d0", 8, 96, 3, {"dead": (5,)}), ("d1", 10, 128, 4, {})],
    # topic counts differ: no shared scorer, per-member degrade path
    "heterogeneous": [("h0", 8, 96, 3, {"topics": 3}),
                      ("h1", 10, 128, 4, {})],
}


def fleet(pkg, case):
    spec, _an, fl, kw = PACKAGES[pkg]
    members = [(cid,) + _cluster(spec, b, p, seed, **extra, **kw)
               for cid, b, p, seed, extra in FLEETS[case]]
    return fl.FleetModel.stack(members, broker_pad_multiple=8,
                               partition_pad_multiple=64, **kw)


@pytest.fixture(scope="module")
def engines():
    out = {}
    for name, chain in CHAINS.items():
        jopt = ja.TpuGoalOptimizer(goals=ja.goals_by_name(chain))
        topt = ta.TorchGoalOptimizer(goals=ta.goals_by_name(chain),
                                     device="cpu")
        out[name] = (jf.FleetOptimizer(jopt), tf.FleetOptimizer(topt))
    return out


def grid(mod, topics):
    """Six trajectory scales, per-topic factors drawn from numpy seed 13
    in [0.9, 1.6] (the same draw in both packages)."""
    rng = np.random.default_rng(13)
    out = []
    for h in HORIZONS:
        for q in QUANTILES:
            f = rng.uniform(0.9, 1.6, size=len(topics))
            out.append(mod.TrajectoryScale(
                horizon_ms=h, quantile=q,
                factors=tuple(sorted(zip(topics, (float(x) for x in f)))),
                default_factor=1.05))
    return out


# ------------------------------------------------------------- summaries

@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("case", sorted(FLEETS))
def test_n1_summaries_match_reference(engines, case, chain):
    jfo, tfo = engines[chain]
    want = jfo.sweep_n1(fleet("jax", case))
    got = tfo.sweep_n1(fleet("torch", case))
    assert got == want
    assert all(s["scenarios"] > 0 for s in got)


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("case", ["fleet3", "heterogeneous"])
def test_trajectory_summaries_match_reference(engines, case, chain):
    jfo, tfo = engines[chain]
    topics = [f"t{i}" for i in range(5)]
    want = jfo.sweep_trajectories(fleet("jax", case), grid(jw, topics))
    got = tfo.sweep_trajectories(fleet("torch", case), grid(tw, topics))
    assert got == want
    assert [len(s["scenarios"]) for s in got] == [6] * len(got)


def test_trajectory_per_member_grids_match_reference(engines):
    """The ``{cluster_id: grid}`` form: each member its own factors."""
    jfo, tfo = engines["goals3"]
    ids = [m[0] for m in FLEETS["fleet3"]]
    topics = [f"t{i}" for i in range(5)]
    jg = {cid: grid(jw, topics)[k:] + grid(jw, topics)[:k]
          for k, cid in enumerate(ids)}
    tg = {cid: grid(tw, topics)[k:] + grid(tw, topics)[:k]
          for k, cid in enumerate(ids)}
    assert tfo.sweep_trajectories(fleet("torch", "fleet3"), tg) \
        == jfo.sweep_trajectories(fleet("jax", "fleet3"), jg)
    with pytest.raises(ValueError, match="must cover every member"):
        tfo.sweep_trajectories(fleet("torch", "fleet3"), {"c0": tg["c0"]})
    with pytest.raises(ValueError, match="at least one"):
        tfo.sweep_trajectories(fleet("torch", "fleet3"), [])


# ------------------------------------------------------------- raw outputs

def _reference_program(jfo, tag):
    """The one cached program of a fresh JAX fleet engine whose key
    starts with ``tag``."""
    (program,) = [v for k, v in jfo._programs._programs.items()
                  if k[0] == tag]
    return program


@pytest.mark.parametrize("max_devices", [1, None], ids=["D1", "DC"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("case", ["fleet3", "dead_broker"])
def test_n1_raw_outputs_match_reference_program(engines, case, chain,
                                                max_devices):
    """The reference's compiled fleet-sweep program and the port's fleet
    scorer on the same inputs: viol, vscale, pressure and unavailable bit
    for bit over every real (cluster, scenario) row — with every cluster
    on one device (the port's layout, D = 1) and one cluster a device."""
    import jax.numpy as jnp
    jfo, tfo = engines[chain]
    jfo = jf.FleetOptimizer(jfo.optimizer, max_devices=max_devices)
    jfl, tfl = fleet("jax", case), fleet("torch", case)
    jfo.sweep_n1(jfl)
    program = _reference_program(jfo, "fleet-sweep")
    C, B = jfl.num_clusters, jfl.bucket["brokersPadded"]
    P = jfl.bucket["partitionsPadded"]
    rows = [np.nonzero(np.asarray(m.model.broker_valid)
                       & np.asarray(m.model.broker_alive))[0]
            for m in jfl.members]
    S = max(len(r) for r in rows)
    S_pad = -(-S // jfo.scenario_pad_multiple) * jfo.scenario_pad_multiple
    C_pad = jfo._layout(C)[2]
    dead = np.zeros((C_pad, S_pad, B), bool)
    for c, r in enumerate(rows):
        dead[c, np.arange(len(r)), r] = True
    stacked = jfl.stacked
    jout = program(stacked, jnp.asarray(dead),
                   jnp.zeros((C_pad, B), bool),
                   jnp.ones((C_pad, B, 4), jnp.float32),
                   jnp.ones((C_pad, P), jnp.float32),
                   stacked.partition_valid)
    goals = [g.bind(tfl.members[0].metadata) for g in tfo.optimizer.goals]
    score = make_fleet_scenario_scorer(
        goals, tfo.optimizer.constraint.capacity_threshold,
        num_topics=tfl.members[0].metadata.num_topics)
    d = torch.from_numpy(dead[:C, :S])
    tout = score(tfl.stacked, d, torch.zeros_like(d),
                 torch.ones((C, S, B, 4)), torch.ones((C, S, P)),
                 tfl.stacked.partition_valid)
    viol, vscale, _hr, _hf, pressure, unavailable, _n = tout
    for name, t, j in (("viol", viol, jout[0]), ("vscale", vscale, jout[1]),
                       ("pressure", pressure, jout[2]),
                       ("unavailable", unavailable, jout[3])):
        assert_same(t, np.asarray(j)[:C, :S], what=f"{case}/{chain} {name}")


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_trajectory_raw_outputs_match_reference_program(engines, chain):
    """As above for the trajectory program, at the port's layout (every
    cluster on one device, ``lax.map`` over C). With one cluster a device
    XLA compiles this program without the FMA in the capacity penalty's
    ``util - capacity * threshold`` (one ulp apart; probed), so the port
    follows the one-device program, as it follows the what-if program."""
    import jax.numpy as jnp
    from cruise_control_tpu.whatif.engine import trajectory_pscale_row
    jfo, tfo = engines[chain]
    jfo = jf.FleetOptimizer(jfo.optimizer, max_devices=1)
    jfl, tfl = fleet("jax", "fleet3"), fleet("torch", "fleet3")
    topics = [f"t{i}" for i in range(5)]
    scenarios = grid(jw, topics)
    jfo.sweep_trajectories(jfl, scenarios)
    program = _reference_program(jfo, "fleet-forecast")
    C, S = jfl.num_clusters, len(scenarios)
    P = jfl.bucket["partitionsPadded"]
    B = jfl.bucket["brokersPadded"]
    S_pad = -(-S // jfo.scenario_pad_multiple) * jfo.scenario_pad_multiple
    C_pad = jfo._layout(C)[2]
    pscale = np.ones((C_pad, S_pad, P), np.float32)
    for c, m in enumerate(jfl.members):
        ptopic = np.asarray(m.model.partition_topic)
        for s, scn in enumerate(scenarios):
            pscale[c, s] = trajectory_pscale_row(scn, m.metadata.topic_index,
                                                 ptopic)
    jout = program(jfl.stacked, jnp.asarray(pscale),
                   jfl.stacked.partition_valid)
    goals = [g.bind(tfl.members[0].metadata) for g in tfo.optimizer.goals]
    score = make_fleet_scenario_scorer(
        goals, tfo.optimizer.constraint.capacity_threshold,
        num_topics=tfl.members[0].metadata.num_topics)
    no = torch.zeros((C, S, B), dtype=torch.bool)
    tout = score(tfl.stacked, no, no, torch.ones((C, S, B, 4)),
                 torch.from_numpy(pscale[:C, :S]),
                 tfl.stacked.partition_valid)
    for name, t, j in (("viol", tout[0], jout[0]),
                       ("vscale", tout[1], jout[1]),
                       ("pressure", tout[4], jout[2]),
                       ("unavailable", tout[5], jout[3])):
        assert_same(t, np.asarray(j)[:C, :S], what=f"{chain} {name}")


# ------------------------------------------------------------- KJ's twin

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_failover_twin_equals_per_cluster_kd_twins(seed):
    """KJ's twin over a [C, S] grid equals C calls of KD's twin, each on
    its own cluster's placement and broker masks (random placements with
    empty slots, offline replicas, invalid and dead brokers, adds and
    disabled partitions)."""
    rng = np.random.default_rng(seed)
    C, S, P, R, B = 3, 5, 40, 3, 9
    rb = rng.integers(0, B + 1, size=(C, P, R)).astype(np.int32)
    off = rng.random((C, P, R)) < 0.2
    pref = np.stack([np.stack([rng.permutation(R) for _ in range(P)])
                     for _ in range(C)]).astype(np.int32)
    valid = rng.random((C, B)) < 0.9
    alive = rng.random((C, B)) < 0.8
    dead = rng.random((C, S, B)) < 0.2
    add = rng.random((C, S, B)) < 0.1
    pvalid = rng.random((C, P)) < 0.9
    t = [torch.from_numpy(a) for a in (rb, off, pref, valid, alive, dead,
                                       add, pvalid)]
    got = kernels.fleet_scenario_failover(*t)
    assert [tuple(g.shape) for g in got] == [(C, S, P, R)] * 3 + [(C, S, P)]
    for c in range(C):
        want = kernels.scenario_failover_plain(
            t[0][c], t[1][c], t[2][c], t[3][c], t[4][c], t[5][c], t[6][c],
            t[7][c].expand(S, P))
        for name, g, w in zip(("rb", "pref", "off", "has_alive"), got, want):
            assert_same(g[c], w, what=f"cluster {c} {name}")


def test_fleet_failover_validates_shapes():
    C, S, P, R, B = 2, 3, 4, 2, 5
    rb = torch.zeros((C, P, R), dtype=torch.int32)
    off = torch.zeros((C, P, R), dtype=torch.bool)
    masks = torch.ones((C, B), dtype=torch.bool)
    dead = torch.zeros((C, S, B), dtype=torch.bool)
    pvalid = torch.ones((C, P), dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\[C, P, R\]"):
        kernels.fleet_scenario_failover(rb[0], off[0], rb[0], masks, masks,
                                        dead, dead, pvalid)
    with pytest.raises(ValueError, match=r"pvalid \[C, P\]"):
        kernels.fleet_scenario_failover(rb, off, rb, masks, masks, dead,
                                        dead, pvalid[:, :2])
