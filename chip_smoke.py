#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``cruise_control_tpu_torch``) on one
GPU: builds the hand-written kernels from ``cruise_control_tpu_torch/csrc``,
holds each against its plain PyTorch twin at the main path's shapes, drives
the dry-run rebalance proposal, the what-if sweep, the move schedule, the
monitor's device-resident model cycle, the population and branched search
modes, the intra-broker disk rebalance and the fleet control plane end to
end, and checks their results.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (every failure raises; nothing is caught):

1. environment — the card's name and power limit, torch and CUDA versions;
2. build — compile and load the kernel library;
3. kernels vs twins — KA (threefry draws: the main path's noise, every
   output form, a fold-in key), KB (ordered segment sum, also on
   the what-if sweep's batched layout), KC (net broker flow), KD
   (scenario failover, at the N-1 sweep's and the boundary audit's
   shapes), a launch's floor (an empty kernel), KF (delta row scatter,
   out of place), KG (cluster stats and counts, at the main path's
   brokers, the scale cell's and 20,000), KH
   (intra-broker walk, at phase 11's shape and a small one), KI
   (population selection, ``KI_SHAPES``) and KJ (fleet scenario failover,
   at phase 12's N-1 shape, every cluster with its own placement, masks
   and kills, and at edge shapes)
   against their plain versions, with times and bounds; KE
   (first fit) is held to its twin after phase 4, at the shape of the main
   path's own schedule; KK (the topic-cell guards' net flow, at M = 512
   and 1,024 with the topic and leader guards' queries, and edge shapes)
   bit for bit;
4. main path — 100 brokers x 20K partitions at RF 2, the 4-goal chain
   with the off-chain hard-goal audit, seeds 0, 1, 1 (proposals of the two
   seed-1 runs must be identical; KA, KB and KC must have launched; KA's
   launches of each optimize and the last one's device launches, counted
   under ``torch.profiler``, are printed);
5. self-healing drain — the same cluster with one dead broker;
6. scale — 1K brokers x 200K partitions at RF 2;
7. what-if — the N-1 sweep of the main-path cluster (cold, then three
   warm sweeps; KD and KB must have launched, as many times for one
   scenario as for all), then one batch of every scenario type, held to
   the reference's numbers;
8. schedule — the seed-1 proposals batched by the first-fit kernel with
   the hard-goal boundary audit, without and with a bandwidth budget,
   held to the host greedy planner and to the reference's statistics;
9. served cycle — the main-path cluster as a simulated Kafka cluster
   feeding ``LoadMonitor`` with dense samples: a cold full upload, three
   1%-churn metric-only cycles that must each be a KF delta of exactly 200
   rows at epoch 1 with nothing built after warmup (the device operations
   of the last one logged by ``torch.profiler``), ``stats_summary``
   (KG) before and after an optimize of the resident model, then a broker
   death that must rebuild at epoch 2 and drain; planes, summaries and
   proposals held to the reference's (``REFERENCE_SERVED_*``);
10. search modes — phase 4's cluster and chain with the per-goal walk:
    a population of 1 must equal the sequential walk; a population of 4
    (weighted, cold then warm) and 4 branches held to the reference's
    (``REFERENCE_SEARCH``); KI must have launched at every generation
    boundary;
11. intra-broker — phase 4's cluster with four logdirs a broker (two of
    them new and empty): a rebalance and a drain of d0 on ten brokers,
    held to the reference's (``REFERENCE_INTRA``); KH launched once per
    call;
12. fleet — bench scenario 6: 16 members, each phase 4's cluster with its
    loads scaled by 1 + 0.01 c, proposed by ``FleetOptimizer`` (cold, then
    warm: one group, every member equal to a sequential per-goal optimize
    of it, the warm propose loading no kernel library), their N-1 sweep
    and a trajectory sweep of four of them (one KJ launch a sweep), held
    to the reference's (``REFERENCE_FLEET``); then a ``FleetRegistry`` of
    two members on phase 9's simulated cluster: a cold tick and a warm
    tick after a 1%-churn ingest (each tick one KJ launch and no tick
    error, each member's cache and N-1 summary equal to a fleet propose
    and sweep of the same served models; the warm tick loading no kernel
    library);
13. default chain — the reference's own per-proposal contract
    (``goals=None``, nothing waived): (a) the main-path cluster, seeds 1
    and 1 (identical proposals, each run's outcome held to
    ``REFERENCE_DEFAULT``; KA, KB, KC and KK must have launched); (b) bench
    scale scenario 3 (1K x 200K, the reference bench's search; no hard
    goal left violated, no goal worse than it started); (c)
    ``WhatIfEngine()``'s N-1 sweep with the default goals (topic counts
    over the scenario batch; ``REFERENCE_DEFAULT_N1``); (d) the cluster in
    ten broker sets under the catalog's part-B chain and the
    kafka-assigner set (``REFERENCE_PARTB``, failures included).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

NUM_BROKERS = 100
NUM_PARTITIONS = 20_000
RF = 2
GOALS = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal"]
#: the quality the reference's CPU run reaches on the main path (bench row
#: rebalance_proposal_wall_clock_100x20k), printed beside the port's
REFERENCE_MOVES, REFERENCE_PROPOSALS = 19_167, 13_595
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 ops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: the main path's search (the reference bench's config for this row)
MAIN_SEARCH = dict(num_replica_candidates=512, num_dest_candidates=16,
                   apply_per_iter=512, max_iters_per_goal=512,
                   fused_chain=True)
#: the previous designs' times (KB sorting the ids, KC a thread a row, KE a
#: block testing every slot, KH rebuilding every disk sum each iteration,
#: KJ and KD a thread a row, KI a thread a plan, KF in place, KG a warp a
#: column reading global memory; same method, NVIDIA H100
#: 80GB HBM3 at 700 W; PERF.md), printed beside this run's: KB by rows, KC
#: by M, KI by (K, G), the others by shape
EARLIER_MS = {("KB", 40_192): 0.2029, ("KB", 400_128): 0.2322,
              ("KB", 4_019_200): 0.8807, ("KC", 512): 0.08195,
              ("KC", 1024): 0.16520, ("KE", "schedule"): 30.932,
              ("KH", "phase 11"): 8.433, ("KJ", "phase 12"): 0.5291,
              ("KD", "N-1"): 0.03526, ("KI", (4, 4)): 0.00439,
              ("KI", (16, 23)): 0.02128, ("KI", (16, 28)): 0.02223,
              ("KI", (16, 33)): 0.02669, ("KI", (16, 64)): 0.04678,
              ("KI", (1024, 64)): 7.42848, ("KF", "served"): 0.00128,
              ("KG", "main path"): 0.01372}
#: the 4-goal main path's audit waives RackAwareGoal, as the reference
#: bench keeps it for that row (the skewed build crowds racks); phase 13
#: runs the default chain with nothing waived
WAIVED = frozenset({"RackAwareGoal"})
#: phase 7's and phase 8's results as the reference computes them (the
#: JAX package on the CPU, from the same inputs; phase 8 schedules the
#: reference's own seed-1 proposals, which equal the port's): the N-1
#: sweep's and the mixed batch's riskiest scenario, max risk, count of
#: scenarios violating a goal, sum of 4-decimal risks and a digest of every
#: outcome (``_summary``); each schedule's
#: statistics, a digest of its batches and the sum of its batch ETAs
REFERENCE_N1 = dict(riskiest="loss:0", max_risk=0.30000000000000004,
                    violated=100, risk4_sum=30.0, digest="5b3c7b4ba73e74d7")
REFERENCE_MIXED = dict(riskiest="loss:3,17", max_risk=0.9301785, violated=9,
                       risk4_sum=3.3302, digest="746878a462cff777")
REFERENCE_MIXED_RISKS = [0.9302, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
_REFERENCE_STATS = dict(moves=13591, batches=174, boundaries_audited=174,
                        repair_rounds=0, unrepaired_violations=0,
                        spilled_moves=0)
REFERENCE_SCHEDULE = {
    "schedule": dict(stats=_REFERENCE_STATS, digest="1053b8d42516ce15",
                     eta_sum=None),
    "schedule_bw": dict(stats=_REFERENCE_STATS, digest="1e3df09d59f71c52",
                        eta_sum=505861.563),
}
#: phase 7's batch of every scenario type (``/simulate`` JSON); the two
#: broker adds need 7 new rows and the topic add 500 partition rows, more
#: than the model's padding holds, so the batch re-pads the model
MIXED_SCENARIOS = [
    {"type": "broker_loss", "brokers": [3, 17]},
    {"type": "broker_add", "count": 6},
    {"type": "broker_add", "count": 1, "capacity": [100.0, 1e6, 1e6, 1e8]},
    {"type": "capacity_resize", "factor": 0.5, "resource": "disk"},
    {"type": "capacity_resize", "factor": 0.8, "brokers": [0, 1, 2]},
    {"type": "load_scale", "factor": 1.5},
    {"type": "load_scale", "factor": 3.0, "topics": ["t0", "t1"]},
    {"type": "topic_add", "topic": "new", "partitions": 500, "rf": 2,
     "leaderLoad": [0.03, 10.0, 15.0, 100.0]},
    {"type": "trajectory_scale", "horizonMs": 3_600_000, "quantile": 0.9,
     "factors": {"t5": 2.0, "t7": 0.5}, "defaultFactor": 1.1},
]
#: phase 8's schedules: (tag, bandwidth MB per batch, throttle bytes/s) —
#: the facade's defaults, then a budget that splits batches and a
#: throttle that gives every batch an ETA
SCHEDULE_RUNS = (("schedule", None, None),
                 ("schedule_bw", 300.0, 100_000_000))
#: phase 9 (``bench.py:1228-1360``, run_resident_delta_bench, on phase 4's
#: cluster): windows, churn and the broker that dies
SERVED_WINDOWS = 4
SERVED_WINDOW_MS = 1000
SERVED_CHURN_ROWS = NUM_PARTITIONS // 100
SERVED_CYCLES = 3
SERVED_CAPACITY = (100.0, 1e6, 1e6, 1e8)
SERVED_DEAD_BROKER = 94
#: phase 9's results as the reference computes them (the JAX package on
#: the CPU from the same inputs: ``scripts/served_reference.py``): sha256
#: of the resident load planes after each delta cycle, of the
#: ``stats_summary`` JSON before and after the optimize, of the seed-1
#: proposals, and the counts
REFERENCE_SERVED_PLANES = ["ab31a1d5a344ef8b", "77f8de06059da63b",
                           "abd3ad1237880404"]
REFERENCE_SERVED_STATS = dict(before="4cbd0cac669aa172",
                              after="fb1abf3b8388f887")
REFERENCE_SERVED_OPTIMIZE = dict(moves=16088, proposals=11494,
                                 digest="9c3a9d40d9cccff0")
REFERENCE_SERVED_DRAIN = dict(moves=16267, proposals=11626, left=0,
                              audit_ok=True)
#: phase 10 (bench scenario 7's population size, ``bench.py:424``): phase
#: 4's chain and search with the per-goal walk (the population requires
#: it), seed 1; K = 1 and K = 4 populations, then N = 4 branches
SEARCH_MODES = dict(MAIN_SEARCH, fused_chain=False, polish_passes=2)
SEARCH_SEED = 1
SEARCH_POPULATION = dict(size=4, objective="weighted", hard_weight=1000.0)
SEARCH_BRANCHES = 4
#: phase 11: phase 4's cluster with four logdirs a broker, replica r of
#: partition p on d[(p + r) % 2] (two disks just added and empty), the
#: per-logdir capacity the even split of the DISK capacity; a rebalance,
#: then a drain of d0 on brokers 20-29
INTRA_LOGDIRS = ("d0", "d1", "d2", "d3")
INTRA_DRAINED = {b: ["d0"] for b in range(20, 30)}
#: phases 10 and 11 as the reference computes them (the JAX package on the
#: CPU from the same inputs: ``scripts/search_modes_reference.py``)
REFERENCE_SEARCH = dict(
    sequential=dict(moves=19167, proposals=13595, digest="b811bc8eb48d995f"),
    population=dict(
        size=4, requested=4, objective="weighted", winner=0,
        winnerIsAnchor=True, paretoFrontSize=4, paretoRanks=[0, 0, 0, 0],
        weightedScores=[0.0, 0.0, 0.0, 0.0],
        movesPerMember=[19167, 19200, 19167, 19200],
        perGoalAcceptance=[[19073, 42, 1, 51], [19094, 45, 0, 61],
                           [19073, 42, 1, 51], [19094, 45, 0, 61]],
        survivorPerms=[[0, 1, 0, 1], [0, 1, 0, 1], [0, 1, 0, 1]],
        moves=19167, proposals=13595, digest="b811bc8eb48d995f"),
    branches=dict(winner=0, stacks="f5a5fd42d16a2030", moves=19173,
                  proposals=13488, digest="dae2e5ca7d020381"))
#: phase 3's KD at the boundary audit's shape: one placement per batch
#: boundary (phase 8 audits 174)
KD_BOUNDARIES = 174
#: phase 12 (bench scenario 6, ``bench.py:287-410``; the forecast sweep
#: of ``bench.py:577-700``): FLEET_CLUSTERS members, member c phase 4's
#: cluster with its loads scaled by float32(1 + 0.01 c), the 4-goal chain
#: with the per-goal walk and bench's search, seed 3, the hard-goal check
#: skipped; the N-1 sweep of every member; the trajectory sweep of the
#: first FLEET_FORECAST_CLUSTERS over +1 h / +6 h / +24 h x p50 / p90, each
#: scale's per-topic factors drawn from numpy seed 13 in [0.9, 1.6] (the
#: forecast fit is not ported)
FLEET_CLUSTERS = 16
FLEET_SEARCH = dict(num_replica_candidates=512, num_dest_candidates=16,
                    apply_per_iter=512, max_iters_per_goal=512)
FLEET_SEED = 3
FLEET_FORECAST_CLUSTERS = 4
FLEET_HORIZONS = (3_600_000, 21_600_000, 86_400_000)
FLEET_QUANTILES = (0.5, 0.9)
FLEET_FACTOR_SEED = 13
#: phase 12 as the reference computes it (the JAX package on the CPU with
#: every cluster on one device, the port's layout:
#: ``scripts/fleet_reference.py``): per member (moves, proposals, digest);
#: for each sweep the digest of its summaries and each member's max risk
REFERENCE_FLEET = dict(
    members=[[19093, 13512, 'd9e5be4ae8010f3f']] * FLEET_CLUSTERS,
    n1=dict(digest='7917b3288273600d', max_risk=[0.3] * FLEET_CLUSTERS,
            riskiest=[0] * FLEET_CLUSTERS),
    trajectories=dict(digest='82154ca04aaaff9c',
                      max_risk=[0.3] * FLEET_FORECAST_CLUSTERS,
                      riskiest=['forecast:+1h:p50']
                      * FLEET_FORECAST_CLUSTERS))
REFERENCE_INTRA = dict(
    rebalance=dict(moves=15334, digest="8578c1cf5f136082", iterations=485,
                   violations=[0.0, 0.0, 3608307.0, 0.0]),
    drain=dict(moves=15786, digest="4100e37ee94369b6", iterations=485,
               violations=[97244.9765625, 0.0, 3551762.0, 0.0]))

KERNEL_INFO = {
    "threefry2x32": dict(
        source="cruise_control_tpu_torch/csrc/threefry.cu",
        replaces="cruise_control_tpu/analyzer/goals.py:52"),
    "ordered_segment_sum": dict(
        source="cruise_control_tpu_torch/csrc/segment_sum.cu",
        replaces="cruise_control_tpu/analyzer/state.py:119"),
    "net_broker_flow": dict(
        source="cruise_control_tpu_torch/csrc/net_flow.cu",
        replaces="cruise_control_tpu/analyzer/goals.py:254"),
    "cell_net_flow": dict(
        source="cruise_control_tpu_torch/csrc/cell_flow.cu",
        replaces="cruise_control_tpu/analyzer/goals.py:1390"),
    "scenario_failover": dict(
        source="cruise_control_tpu_torch/csrc/failover.cu",
        replaces="cruise_control_tpu/whatif/engine.py:599"),
    "first_fit": dict(
        source="cruise_control_tpu_torch/csrc/first_fit.cu",
        replaces="cruise_control_tpu/executor/schedule.py:88"),
    "delta_row_scatter": dict(
        source="cruise_control_tpu_torch/csrc/delta_scatter.cu",
        replaces="cruise_control_tpu/model/resident.py:75"),
    "cluster_stats": dict(
        source="cruise_control_tpu_torch/csrc/cluster_stats.cu",
        replaces="cruise_control_tpu/model/stats.py:20"),
    "intra_broker_walk": dict(
        source="cruise_control_tpu_torch/csrc/intra_walk.cu",
        replaces="cruise_control_tpu/analyzer/intra.py:182"),
    "population_select": dict(
        source="cruise_control_tpu_torch/csrc/population_select.cu",
        replaces="cruise_control_tpu/parallel/population.py:262"),
    "fleet_scenario_failover": dict(
        source="cruise_control_tpu_torch/csrc/failover.cu",
        replaces="cruise_control_tpu/fleet/engine.py:780"),
}


_T0 = time.monotonic()


def log(msg: str = "") -> None:
    if msg.startswith("== phase"):
        msg += f" [{time.monotonic() - _T0:.1f}s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# Inputs (numpy copies of the reference bench's builders)
# ---------------------------------------------------------------------------

def build_spec(num_brokers=NUM_BROKERS, num_partitions=NUM_PARTITIONS,
               broker_sets=0):
    """Skewed cluster: half the partitions crowd onto 20% of brokers
    (broker i in set ``s{i % broker_sets}`` when ``broker_sets``)."""
    from cruise_control_tpu_torch.model.spec import (BrokerSpec, ClusterSpec,
                                                     PartitionSpec)
    rng = np.random.default_rng(42)
    brokers = [BrokerSpec(broker_id=i, rack=f"r{i % 10}",
                          capacity=(100.0, 1e6, 1e6, 1e8),
                          broker_set=(f"s{i % broker_sets}" if broker_sets
                                      else None))
               for i in range(num_brokers)]
    hot = np.arange(num_brokers // 5)
    parts = []
    for p in range(num_partitions):
        pool = hot if p % 2 == 0 else np.arange(num_brokers)
        reps = rng.choice(pool, size=RF, replace=False).tolist()
        load = (0.02 + 0.02 * rng.random(), 5 + 10 * rng.random(),
                8 + 15 * rng.random(), 50 + 100 * rng.random())
        parts.append(PartitionSpec(topic=f"t{p % 200}", partition=p,
                                   replicas=[int(b) for b in reps],
                                   leader_load=load))
    return ClusterSpec(brokers=brokers, partitions=parts)


def build_flat_direct(num_brokers, num_partitions, rf, seed=42):
    """Array-native skewed model (no per-partition Python objects)."""
    from cruise_control_tpu_torch.model.flat import FlatClusterModel
    from cruise_control_tpu_torch.model.spec import ClusterMetadata, _round_up
    rng = np.random.default_rng(seed)
    P, B = num_partitions, num_brokers
    Ppad, Bpad = _round_up(P, 128), _round_up(B, 8)
    hot = B // 5
    base = rng.integers(0, hot, size=P)
    cold = rng.integers(0, B, size=P)
    first = np.where(np.arange(P) % 2 == 0, base, cold).astype(np.int64)
    step_cap = max((B - 1) // max(rf - 1, 1), 2)
    offsets = rng.integers(1, step_cap, size=(P, rf - 1)).cumsum(axis=1)
    rb = np.full((Ppad, rf), Bpad, np.int32)
    rb[:P, 0] = first
    rb[:P, 1:] = (first[:, None] + offsets) % B
    lead = np.zeros((Ppad, 4), np.float32)
    lead[:P] = np.column_stack([
        0.02 + 0.02 * rng.random(P), 5 + 10 * rng.random(P),
        8 + 15 * rng.random(P), 50 + 100 * rng.random(P)]).astype(np.float32)
    foll = lead.copy()
    foll[:, 0] *= 0.5
    foll[:, 2] = 0.0
    num_topics = max(P // 500, 1)
    ptopic = np.full(Ppad, -1, np.int32)
    ptopic[:P] = np.arange(P) % num_topics
    model = FlatClusterModel.from_numpy(
        device="cuda",
        replica_broker=rb, leader_load=lead, follower_load=foll,
        partition_topic=ptopic, partition_valid=np.arange(Ppad) < P,
        replica_offline=np.zeros((Ppad, rf), bool),
        replica_pref_pos=np.tile(np.arange(rf, dtype=np.int32), (Ppad, 1)),
        broker_capacity=np.tile(np.array([100.0, 1e6, 1e6, 1e8], np.float32),
                                (Bpad, 1)),
        broker_rack=(np.arange(Bpad) % max(B // 10, 1)).astype(np.int32),
        broker_host=np.arange(Bpad, dtype=np.int32),
        broker_set=np.full((Bpad,), -1, np.int32),
        broker_alive=np.arange(Bpad) < B,
        broker_new=np.zeros((Bpad,), bool),
        broker_demoted=np.zeros((Bpad,), bool),
        broker_broken_disk=np.zeros((Bpad,), bool),
        broker_valid=np.arange(Bpad) < B)
    topics = [f"t{i}" for i in range(num_topics)]
    keys = [(topics[i % num_topics], i) for i in range(P)]
    metadata = ClusterMetadata(
        broker_ids=list(range(B)), broker_index={i: i for i in range(B)},
        topics=topics, topic_index={t: i for i, t in enumerate(topics)},
        partition_keys=keys,
        partition_index={k: i for i, k in enumerate(keys)},
        racks=[f"r{i}" for i in range(max(B // 10, 1))],
        hosts=[f"h{i}" for i in range(B)], broker_sets=[])
    return model, metadata


def main_path_optimizer():
    """The optimizer of the main path (phases 4 and 5, and the profiler)."""
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    return TorchGoalOptimizer(goals=goals_by_name(GOALS),
                              config=SearchConfig(**MAIN_SEARCH),
                              device="cuda")


def main_path_options(seed):
    from cruise_control_tpu_torch.analyzer import OptimizationOptions
    return OptimizationOptions(seed=seed, waived_hard_goals=WAIVED)


def host_loads(arrays):
    """float64[P, R, 4] replica loads from host arrays."""
    rb = arrays["replica_broker"]
    B = arrays["broker_capacity"].shape[0]
    R = rb.shape[1]
    loads = np.where((np.arange(R) == 0)[None, :, None],
                     arrays["leader_load"][:, None, :],
                     arrays["follower_load"][:, None, :]).astype(np.float64)
    return np.where((rb < B)[:, :, None], loads, 0.0)


def greedy_baseline(arrays, nb, threshold=1.10, max_moves=60_000):
    """Sequential greedy on host arrays: one best move at a time, same
    bounds semantics as the goal kernels."""
    rb = arrays["replica_broker"].copy()
    loads = host_loads(arrays)
    B = arrays["broker_capacity"].shape[0]
    valid = rb < B
    util = np.zeros((B, 4))
    np.add.at(util, rb[valid], loads[valid])
    counts = np.bincount(rb[valid], minlength=B + 1)[:B].astype(float)
    moves = 0
    t0 = time.monotonic()
    for metric in ("count", 3, 1, 2):
        for _ in range(max_moves):
            vals = counts[:nb] if metric == "count" else util[:nb, metric]
            avg = vals.mean()
            upper = avg * threshold
            if metric == "count":
                upper = max(upper, np.ceil(avg))
            over = vals - upper
            src = int(np.argmax(over))
            if over[src] <= 0:
                break
            on_src = (rb == src) & valid
            w = (np.ones_like(loads[..., 0]) if metric == "count"
                 else loads[..., metric])
            w = np.where(on_src, w, -np.inf)
            flat = int(np.argmax(w))
            p, r = flat // rb.shape[1], flat % rb.shape[1]
            if not np.isfinite(w[p, r]):
                break
            hosting = np.zeros(nb, bool)
            hosting[rb[p][valid[p]]] = True
            dv = np.where(hosting[:nb], np.inf, vals)
            dst = int(np.argmin(dv))
            if not np.isfinite(dv[dst]):
                break
            delta = loads[p, r]
            util[src] -= delta
            util[dst] += delta
            counts[src] -= 1
            counts[dst] += 1
            rb[p, r] = dst
            moves += 1
    return time.monotonic() - t0, moves, util, counts


def residual(util, counts, nb, threshold=1.10):
    tot = 0.0
    for metric in ("count", 3, 1, 2):
        vals = counts[:nb] if metric == "count" else util[:nb, metric]
        avg = vals.mean()
        upper, lower = avg * threshold, avg * (2 - threshold)
        if metric == "count":
            upper = max(upper, np.ceil(avg))
            lower = min(lower, np.floor(avg))
        tot += (np.maximum(vals - upper, 0).sum()
                + np.maximum(lower - vals, 0).sum())
    return float(tot)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_ms(fn, groups=5, launches=200, group_ms=50.0, graph=False):
    """Median ms of one call: each of ``groups`` pairs of CUDA events
    brackets up to ``launches`` back-to-back calls (fewer for a slow call,
    about ``group_ms`` per group) and the pair's time is divided by the
    count. Eager calls are issued by the host one by one, so a call whose
    device work is shorter than its host dispatch reads the dispatch rate;
    with ``graph`` the calls are captured once in a CUDA graph and the
    graph is replayed between the events, which times the device work
    alone (for calls that never read the device from the host: the kernel
    wrappers and library calls, not the plain twins). Warm: the calls
    reuse their inputs, which may stay in L2."""
    import torch
    one_ms = 0.0
    for _ in range(3):                  # warm up; the last call calibrates
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        one_ms = (time.monotonic() - t0) * 1e3
        if one_ms > group_ms:           # a slow call needs no more warmup
            break
    n = int(max(1, min(launches, group_ms // max(one_ms, 1e-3))))
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(n):
                fn()
        run = captured.replay
        run()                           # the first replay uploads the graph
        torch.cuda.synchronize()
    else:
        def run():
            for _ in range(n):
                fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    log("== phase 1: environment")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from cruise_control_tpu_torch import kernels
    log("== phase 2: build")
    t0 = time.monotonic()
    kernels.load_library()
    log(f"built and loaded {kernels.build_library().name} in "
        f"{time.monotonic() - t0:.2f}s")
    for entry in kernels.BUILD_LOG:
        for line in entry.splitlines():
            if "Used" in line or "spill" in line or line.startswith("["):
                log("  " + line.strip())


def _keep_first_shape(rows, name, err, timing):
    """The kernel's row holds the timing of its first (main-path) shape and
    the largest error over every shape compared."""
    row = rows.setdefault(name, dict(timing, max_abs_err=0.0))
    row["max_abs_err"] = max(row["max_abs_err"], err)


def _check_summation_bound(got, want, src, dst, earlier, d_src, d_dst):
    """KC's outputs against a float64 sum of the same terms. A float32 sum
    of n terms in any order lies within gamma(n-1) * sum|term| of the exact
    sum (gamma(k) = k u / (1 - k u), u = 2^-24), so per row the kernel must
    lie within that of the exact sum, and within twice that of its twin."""
    e = earlier.cpu().numpy()
    s, d = src.cpu().numpy(), dst.cpu().numpy()
    a = d_src.cpu().numpy().astype(np.float64)
    b = d_dst.cpu().numpy().astype(np.float64)
    same_dd, same_ds = e & (d[:, None] == d), e & (d[:, None] == s)
    same_ss, same_sd = e & (s[:, None] == s), e & (s[:, None] == d)
    pos_a, pos_b = np.maximum(a, 0), np.maximum(b, 0)
    neg_a, neg_b = np.minimum(a, 0), np.minimum(b, 0)
    u = 2.0 ** -24
    for name, g, w, terms in (
            ("net_src_lo", got[0], want[0],
             ((same_ss, neg_a), (same_sd, neg_b))),
            ("net_dst_hi", got[1], want[1],
             ((same_dd, pos_b), (same_ds, pos_a))),
            ("net_src_hi", got[2], want[2],
             ((same_ss, pos_a), (same_sd, pos_b)))):
        exact = sum(mask @ x for mask, x in terms)
        magnitude = sum(mask @ np.abs(x) for mask, x in terms)
        k = np.maximum(sum((mask & (x != 0)).sum(1) for mask, x in terms) - 1,
                       0)
        tol = k * u / (1 - k * u) * magnitude
        g = g.cpu().numpy().astype(np.float64)
        w = w.cpu().numpy().astype(np.float64)
        if (np.abs(g - exact) > tol).any():
            fail(f"net_broker_flow {name} beyond the summation bound of "
                 f"its terms (M={len(s)})")
        if (np.abs(g - w) > 2 * tol).any():
            fail(f"net_broker_flow {name} differs from its twin by more than "
                 f"the two orders' summation bounds (M={len(s)})")


def phase_kernels(model, main_arrays: dict, scale_model, intra_state):
    """Each kernel against its twin at the main path's shapes."""
    import torch
    from cruise_control_tpu_torch import _random, kernels
    from cruise_control_tpu_torch.utils.device import set_precision_flags
    log("== phase 3: kernels vs twins")
    set_precision_flags()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = {}
    scale_arrays = scale_model.to_numpy()

    # --- KA: the fused draw — the main path's [P, R] candidate noise
    # (first: the kernels line's row), every other form at 40,192
    # counters, and a fold-in key (one counter through a two-word path).
    _kernel_threefry(rows, dev, *model.replica_broker.shape)

    # --- KB: replica loads into broker rows (the init_state reduction),
    # with int32 ids as init_state passes them.
    for arrays in (main_arrays, scale_arrays):
        rb = arrays["replica_broker"]
        S = arrays["broker_capacity"].shape[0] + 1
        seg = torch.from_numpy(rb.reshape(-1).astype(np.int32)).to(dev)
        vals = torch.from_numpy(
            host_loads(arrays).reshape(-1, 4).astype(np.float32)).to(dev)
        got = kernels.ordered_segment_sum(vals, seg, S)
        twin = kernels.ordered_segment_sum_plain(vals.cpu(), seg.cpu(), S)
        err_twin = float((got.cpu() - twin).abs().max())
        if not torch.equal(got.cpu(), twin):
            fail(f"ordered_segment_sum differs from its twin ({seg.numel()} "
                 f"rows -> {S})")
        seg64 = seg.long()
        lib = torch.zeros(S, 4, device=dev).index_add_(0, seg64, vals)
        exact = np.zeros((S, 4))
        np.add.at(exact, seg.cpu().numpy(),
                  vals.cpu().numpy().astype(np.float64))
        n_max = int(np.bincount(seg.cpu().numpy()).max())
        # recursive-summation bound: |sum_f32 - exact| <= (n-1) u sum|x|
        tol = (n_max - 1) * 2.0 ** -24 * np.abs(exact) + 1e-30
        err_kb = float(np.abs(got.cpu().numpy() - exact).max())
        if (np.abs(got.cpu().numpy() - exact) > tol).any():
            fail("ordered_segment_sum exceeds the float32 summation bound")
        rel_lib = float((np.abs(got.cpu().numpy() - lib.cpu().numpy())
                         / np.abs(lib.cpu().numpy()).clip(1e-30)).max())
        ms = time_ms(lambda: kernels.ordered_segment_sum(vals, seg, S),
                     graph=True)
        plain = time_ms(lambda: kernels.ordered_segment_sum_plain(
            vals, seg, S), groups=3)
        lib_ms = time_ms(lambda: torch.zeros(S, 4, device=dev).index_add_(
            0, seg64, vals), graph=True)
        b_ms, b_by = bound(vals.numel() * 4 + seg.numel() * 4 + S * 16,
                           vals.numel())
        log(f"KB ordered_segment_sum {seg.numel()}->{S} x4: bit-exact vs "
            f"twin; |err| vs float64 {err_kb:.3g} (within the summation "
            f"bound); max rel diff vs index_add_ {rel_lib:.3g}; {ms:.5f} ms "
            f"(earlier design: {EARLIER_MS[('KB', seg.numel())]} ms), twin "
            f"{plain:.3f} ms, "
            f"index_add_ {lib_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
        _keep_first_shape(rows, "ordered_segment_sum", err_twin, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))

    # --- KB at apply_group's shape: 1,024 candidate rows (sources, then
    # destinations) x 6 planes with a base, into the main path's B1.
    B1 = main_arrays["broker_capacity"].shape[0] + 1
    n_apply = 2 * MAIN_SEARCH["apply_per_iter"]
    seg = torch.from_numpy(rng.integers(0, B1, n_apply)).to(dev)
    vals = torch.from_numpy(
        (rng.random((n_apply, 6)) * 200 - 100).astype(np.float32)).to(dev)
    base = torch.from_numpy(
        (rng.random((B1, 6)) * 1e5).astype(np.float32)).to(dev)
    got = kernels.ordered_segment_sum(vals, seg, B1, base=base)
    twin = kernels.ordered_segment_sum_plain(vals.cpu(), seg.cpu(), B1,
                                             base.cpu())
    err = float((got.cpu() - twin).abs().max())
    if not torch.equal(got.cpu(), twin):
        fail("ordered_segment_sum differs from its twin at apply_group's "
             "shape")
    ms = time_ms(lambda: kernels.ordered_segment_sum(vals, seg, B1,
                                                     base=base), graph=True)
    lib_ms = time_ms(lambda: base.clone().index_add_(0, seg, vals),
                     graph=True)
    b_ms, b_by = bound(vals.numel() * 4 + seg.numel() * 8 + 2 * base.numel()
                       * 4, vals.numel())
    log(f"KB ordered_segment_sum apply_group {n_apply} rows x6 + base -> "
        f"{B1}: bit-exact vs twin; {ms:.5f} ms, clone + index_add_ "
        f"{lib_ms:.5f} ms, bound {b_ms:.7f} ms ({b_by})")
    _keep_first_shape(rows, "ordered_segment_sum", err, {})

    # --- KB without the grouping: tree_sum's 32-row windows over broker
    # rows, and runs of 1-32 rows.
    for arrays in (main_arrays, scale_arrays):
        n = -(-arrays["broker_capacity"].shape[0] // 32) * 32
        x = torch.from_numpy(rng.random(n).astype(np.float32) * 100).to(dev)
        offsets = torch.arange(0, n + 1, 32, device=dev)
        err = float((kernels.ordered_range_sum(x, offsets).cpu()
                     - kernels.ordered_range_sum(x.cpu(), offsets.cpu()))
                    .abs().max())
        if err != 0.0:
            fail(f"ordered_range_sum differs from its twin ({n} rows)")
        log(f"KB ordered_range_sum {n} rows in windows of 32: bit-exact vs "
            f"twin")
        _keep_first_shape(rows, "ordered_segment_sum", err, {})
    lengths = rng.integers(1, 33, 4096)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])).to(
        dev)
    x = torch.from_numpy((rng.random(int(lengths.sum())) * 1e4 - 3e3).astype(
        np.float32)).to(dev)
    got = kernels.ordered_range_sum(x, offsets)
    if not torch.equal(got.cpu(), kernels.ordered_range_sum(x.cpu(),
                                                           offsets.cpu())):
        fail("ordered_range_sum differs from its twin on runs of 1-32 rows")
    log(f"KB ordered_range_sum {len(lengths)} runs of 1-32 rows: bit-exact "
        f"vs twin")

    # --- KC: collective-guard flows at M = apply_per_iter.
    B1 = main_arrays["broker_capacity"].shape[0] + 1
    for m in (512, 1024):
        errs = []
        src = torch.from_numpy(rng.integers(0, B1, m)).to(dev)
        dst = torch.from_numpy(rng.integers(0, B1, m)).to(dev)
        earlier = torch.from_numpy(
            np.tril(rng.random((m, m)) < 0.6, k=-1)).to(dev)
        for label, d_src, d_dst in (
                ("integer deltas", rng.integers(-4, 5, m),
                 rng.integers(-4, 5, m)),
                ("float loads", (rng.random(m) - 0.5) * 300,
                 (rng.random(m) - 0.5) * 300)):
            ds = torch.from_numpy(d_src.astype(np.float32)).to(dev)
            dd = torch.from_numpy(d_dst.astype(np.float32)).to(dev)
            got = kernels.net_broker_flow(src, dst, earlier, ds, dd)
            want = kernels.net_broker_flow_plain(src, dst, earlier, ds, dd)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            # KC's own order, ascending j: bit for bit
            asc = kernels.net_broker_flow_ascending(src, dst, earlier, ds, dd)
            err_asc = max(float((g - w).abs().max()) for g, w in zip(got, asc))
            if not all(torch.equal(g, w) for g, w in zip(got, asc)):
                fail(f"net_broker_flow differs from the ascending-j form "
                     f"(M={m}, {label}): max |err| {err_asc}")
            errs.append(err_asc)
            if label == "integer deltas":
                # exact in either order: rtol 1e-6 / atol 1e-6
                for g, w in zip(got, want):
                    if not torch.allclose(g, w, rtol=1e-6, atol=1e-6):
                        fail(f"net_broker_flow differs from its twin (M={m})")
            else:
                # different summation orders: each row within the float32
                # summation bound of its own terms
                _check_summation_bound(got, want, src, dst, earlier, ds, dd)
            log(f"KC net_broker_flow M={m} ({label}): bit-exact vs the "
                f"ascending-j form; max |err| vs the matmul twin {err:.3g}")
        ds = torch.from_numpy(rng.integers(-4, 5, m).astype(np.float32)).to(dev)
        ms = time_ms(
            lambda: kernels.net_broker_flow(src, dst, earlier, ds, ds),
            graph=True)
        plain = time_ms(lambda: kernels.net_broker_flow_plain(
            src, dst, earlier, ds, ds))
        e = earlier.cpu().numpy()
        s, d = src.cpu().numpy(), dst.cpu().numpy()
        matches = (e * ((d[:, None] == d[None, :]).astype(int)
                        + (d[:, None] == s[None, :])
                        + 2 * (s[:, None] == s[None, :])
                        + 2 * (s[:, None] == d[None, :]))).sum()
        nnz = int(e.sum())
        b_ms, b_by = bound(m * m + 2 * m * 8 + 2 * m * 4 + 3 * m * 4,
                           4 * nnz + int(matches))
        # the library yardstick: the twin's masks and four float32 matrix
        # products (TF32 off), replayed as a CUDA graph
        lib_ms = time_ms(lambda: kernels.net_broker_flow_plain(
            src, dst, earlier, ds, ds), graph=True)
        log(f"KC net_broker_flow M={m}: {ms:.5f} ms (earlier design: "
            f"{EARLIER_MS[('KC', m)]} ms), twin {plain:.4f} ms, "
            f"torch.matmul form {lib_ms:.5f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
        _keep_first_shape(rows, "net_broker_flow", max(errs), dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))

    # --- KK: the topic-cell guards at M = apply_per_iter (512) and the
    # scale cell's 1,024: the topic guard's four queries over four cell
    # slots (first: the kernels line's row) and the leader minimum's two
    # over two, cell ids drawn from 48 values so that many collide; then
    # edge shapes (M = 1, an all-false prefix mask).
    _kernel_cell_flow(rows, rng, dev)

    # --- KD: the N-1 sweep's placement edit and failover.
    from cruise_control_tpu_torch.model.flat import replica_loads
    from cruise_control_tpu_torch.whatif.engine import scenario_transform
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape
    S = NUM_BROKERS
    dead = torch.zeros((S, B), dtype=torch.bool, device=dev)
    dead[torch.arange(NUM_BROKERS), torch.arange(NUM_BROKERS)] = True
    add = torch.zeros_like(dead)
    pvalid = model.partition_valid.expand(S, P).contiguous()
    args = (model.replica_broker, model.replica_offline,
            model.replica_pref_pos, model.broker_valid, model.broker_alive,
            dead, add, pvalid)
    for tag, kd_args in (("N-1", args),
                         ("boundary audit", kd_boundary_case(model, seed=8))):
        Sk = kd_args[5].shape[0]
        got = kernels.scenario_failover(*kd_args)
        want = kernels.scenario_failover_plain(*(t.cpu() for t in kd_args))
        err = max(float((g.cpu().long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        if err != 0:
            fail(f"scenario_failover differs from its twin at the {tag} "
                 f"shape")
        ms = time_ms(lambda: kernels.scenario_failover(*kd_args), graph=True)
        plain = time_ms(lambda: kernels.scenario_failover_plain(*kd_args),
                        groups=3)
        per_s = kd_args[0].dim() == 3
        pv_per_s = kd_args[7].stride(0) != 0
        nbytes = ((Sk if per_s else 1) * P * R * 9 + 2 * B + 2 * Sk * B
                  + (Sk if pv_per_s else 1) * P              # inputs
                  + Sk * P * R * 9 + Sk * P)                 # outputs
        b_ms, b_by = bound(nbytes, 8 * Sk * P * R)
        earlier = EARLIER_MS.get(("KD", tag))
        log(f"KD scenario_failover {tag} S={Sk} P={P} R={R} B={B} "
            f"(placement {'per scenario' if per_s else 'shared'}, pvalid "
            f"{'per scenario' if pv_per_s else 'shared'}; scenario chunk "
            f"{kernels.failover_chunk(1, Sk, P, R, B)}): bit-exact vs twin; "
            f"{ms:.5f} ms (earlier design: {earlier or 'not measured'} ms), "
            f"twin {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        _keep_first_shape(rows, "scenario_failover", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))

    # --- KB on the sweep's batched layout: one launch, a batch axis of S
    # scenarios, each scenario's int32 broker ids into its own B1 rows (as
    # init_state passes them); then the fleet N-1 sweep's batch, 16
    # clusters of those S scenarios (phase 12: 1,600 scenario rows).
    batched, _ = scenario_transform(
        model, dead, add, torch.ones((S, B, 4), device=dev),
        torch.ones((S, P), device=dev), pvalid)
    B1 = B + 1
    vals = replica_loads(batched).reshape(S, P * R, 4).contiguous()
    seg = batched.replica_broker.reshape(S, P * R).to(torch.int32)
    for label, items in (("what-if", 1), ("fleet", FLEET_CLUSTERS)):
        v = vals.repeat(items, 1, 1) if items > 1 else vals
        if items > 1:                   # member c's loads x (1 + 0.01 c)
            v = v * torch.repeat_interleave(
                1.0 + 0.01 * torch.arange(items, device=dev,
                                          dtype=torch.float32), S)[:, None,
                                                                   None]
        g = seg.repeat(items, 1) if items > 1 else seg
        got = kernels.ordered_segment_sum(v, g, B1)
        twin = kernels.ordered_segment_sum_plain(v, g, B1)  # on the card
        err = float((got - twin).abs().max())
        if not torch.equal(got, twin):
            fail(f"ordered_segment_sum differs from its twin on the {label} "
                 f"batch")
        del twin
        flat_ids = (g.long() + (torch.arange(g.shape[0], device=dev)
                                * B1)[:, None]).reshape(-1)
        flat_vals = v.reshape(-1, 4)
        ms = time_ms(lambda: kernels.ordered_segment_sum(v, g, B1),
                     graph=True, launches=50)
        lib_ms = time_ms(lambda: torch.zeros(g.shape[0] * B1, 4, device=dev)
                         .index_add_(0, flat_ids, flat_vals), graph=True,
                         launches=50)
        b_ms, b_by = bound(v.numel() * 4 + g.numel() * 4
                           + g.shape[0] * B1 * 16, v.numel())
        earlier = EARLIER_MS.get(("KB", g.numel()))
        earlier = "not measured" if earlier is None else f"{earlier} ms"
        log(f"KB ordered_segment_sum {label} batch {g.shape[0]} x "
            f"{g.shape[1]} rows -> {B1} segments x4 ({g.numel()} rows): "
            f"bit-exact vs twin; {ms:.4f} ms (earlier design: {earlier}), "
            f"index_add_ "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        _keep_first_shape(rows, "ordered_segment_sum", err, {})
        del v, g, flat_ids, flat_vals, got
        torch.cuda.empty_cache()

    # --- a launch's floor: an empty kernel in the same graph replay.
    floor_ms = time_ms(kernels.empty_launch, graph=True)
    log(f"launch floor: an empty kernel (one warp), graph replay: "
        f"{floor_ms:.5f} ms")
    _kernel_delta_scatter(rows, main_arrays, rng, floor_ms)
    _kernel_cluster_stats(rows, model, scale_model, rng, floor_ms)
    _kernel_intra_walk(rows, intra_state)
    _kernel_population_select(rows, rng)
    _kernel_fleet_failover(rows, model)
    return rows


#: KK's phase-3 shapes: (M, queries A, cell slots K) — the topic guard's
#: (A = K = 4) and the leader minimum's (A = K = 2) at apply_per_iter and
#: the scale cell's 1,024
KK_SHAPES = ((512, 4, 4), (512, 2, 2), (1024, 4, 4), (1024, 2, 2))


def kk_case(rng, m, a, k, dev, density=0.6, ids=48):
    """KK's inputs in the guards' form: colliding cell ids, integer terms
    (the topic guard's queries alternate inflow and outflow clipping; the
    leader minimum's are unclipped 0/1 outflows), a random prefix mask."""
    import torch
    key = rng.integers(-1, ids, (k, m))
    query = key[[1, 0, 3, 2][:a] if k == 4 else list(range(a))]
    query = np.where(rng.random((a, m)) < 0.2, rng.integers(-1, ids, (a, m)),
                     query)
    if a == 4:
        d = rng.integers(-4, 5, (k, m)).astype(np.float32)
        val = np.stack([np.maximum(d, 0), np.minimum(d, 0)] * 2)
    else:
        val = np.broadcast_to(rng.integers(0, 2, (k, m)).astype(np.float32),
                              (a, k, m))
    earlier = np.tril(rng.random((m, m)) < density, k=-1)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (query, key, val, earlier))


def _kernel_cell_flow(rows, rng, dev):
    """KK against its twin, bit for bit, at ``KK_SHAPES`` and edge shapes,
    with its time, bound and the library form's time (the twin's masked
    matmuls, TF32 off, replayed as a CUDA graph)."""
    import torch
    from cruise_control_tpu_torch import kernels
    for m, a, k in KK_SHAPES:
        args = kk_case(rng, m, a, k, dev)
        got = kernels.cell_net_flow(*args)
        want = kernels.cell_net_flow_plain(*(t.cpu() for t in args))
        err = float((got.cpu() - want).abs().max())
        if not torch.equal(got.cpu(), want):
            fail(f"cell_net_flow differs from its twin (M={m}, A={a}, K={k})"
                 f": max |err| {err}")
        ms = time_ms(lambda: kernels.cell_net_flow(*args), graph=True)
        plain = time_ms(lambda: kernels.cell_net_flow_plain(*args))
        lib_ms = time_ms(lambda: kernels.cell_net_flow_plain(*args),
                         graph=True)
        q, key, _val, e = (t.cpu().numpy() for t in args)
        nnz = int(e.sum())
        matches = int(sum((e * (q[i][:, None] == key[j][None, :])).sum()
                          for i in range(a) for j in range(k)))
        b_ms, b_by = bound(m * m + 8 * m * (a + k) + 4 * m * a * (k + 1),
                           nnz * a * k + matches)
        log(f"KK cell_net_flow M={m} A={a} K={k}: bit-exact vs twin "
            f"({matches} matching terms); {ms:.5f} ms, twin {plain:.4f} ms, "
            f"torch.matmul form {lib_ms:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
        _keep_first_shape(rows, "cell_net_flow", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    for tag, (m, a, k, density) in (("M = 1", (1, 4, 4, 0.6)),
                                    ("all-false mask", (512, 4, 4, 0.0)),
                                    ("M = 37, leaders", (37, 2, 2, 0.9))):
        args = kk_case(rng, m, a, k, dev, density=density)
        got = kernels.cell_net_flow(*args)
        want = kernels.cell_net_flow_plain(*(t.cpu() for t in args))
        if not torch.equal(got.cpu(), want):
            fail(f"cell_net_flow differs from its twin at the edge shape "
                 f"{tag}")
        if density == 0.0 and bool(got.any()):
            fail("cell_net_flow: an all-false mask gave non-zero flow")
        log(f"KK cell_net_flow {tag}: bit-exact vs twin")


def _kernel_delta_scatter(rows, main_arrays, rng, floor_ms):
    """KF at phase 9's shape: a 1%-churn payload in random order (one row
    dropped at index P), packed as the resident state packs it, into fresh
    copies of the main path's [P, 4] planes."""
    import torch
    from cruise_control_tpu_torch import kernels
    dev = torch.device("cuda")
    lead = torch.from_numpy(main_arrays["leader_load"]).to(dev)
    foll = torch.from_numpy(main_arrays["follower_load"]).to(dev)
    before = lead.clone(), foll.clone()
    P, C = lead.shape
    K = SERVED_CHURN_ROWS
    idx = np.concatenate([rng.choice(NUM_PARTITIONS, K - 1, replace=False),
                          [P]]).astype(np.int32)
    lead_rows = rng.random((K, C)).astype(np.float32)
    foll_rows = rng.random((K, C)).astype(np.float32)
    payload = torch.from_numpy(kernels.pack_delta_rows(
        idx, lead_rows, foll_rows)).to(dev)
    got = kernels.delta_row_scatter(lead, foll, payload)
    want = kernels.delta_row_scatter_plain(lead, foll, payload)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if err != 0.0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("delta_row_scatter differs from its twin")
    if not (torch.equal(lead, before[0]) and torch.equal(foll, before[1])):
        fail("delta_row_scatter wrote its input planes")
    ms = time_ms(lambda: kernels.delta_row_scatter(lead, foll, payload),
                 graph=True)
    plain = time_ms(lambda: kernels.delta_row_scatter_plain(
        lead, foll, payload), groups=3)
    order = np.argsort(idx)
    kept = order[idx[order] < P]
    rows_kept = torch.from_numpy(idx[kept].astype(np.int64)).to(dev)
    lead_kept = torch.from_numpy(lead_rows[kept]).to(dev)
    foll_kept = torch.from_numpy(foll_rows[kept]).to(dev)
    lib_ms = time_ms(lambda: (
        lead.clone().index_copy_(0, rows_kept, lead_kept),
        foll.clone().index_copy_(0, rows_kept, foll_kept)), graph=True)
    # both planes read once and written once, the payload read once
    b_ms, b_by = bound(4 * P * C * 4 + payload.numel() * 4, 0)
    log(f"KF delta_row_scatter K={K} (random order, one dropped) into fresh "
        f"[{P}, {C}] x2: bit-exact vs twin, inputs untouched; {ms:.5f} ms "
        f"({ms / floor_ms:.2f}x the launch floor; earlier design, in place "
        f"without the planes' copy: {EARLIER_MS[('KF', 'served')]} ms), "
        f"twin {plain:.4f} ms, clone + index_copy_ x2 {lib_ms:.5f} ms, "
        f"bound {b_ms:.7f} ms ({b_by})")
    _keep_first_shape(rows, "delta_row_scatter", err, dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))


def _kg_inputs(model):
    """KG's inputs for a model: the broker aggregates, the alive mask and
    the replica and partition masks."""
    from cruise_control_tpu_torch.model.flat import (broker_leader_counts,
                                                     broker_potential_nw_out,
                                                     broker_replica_counts,
                                                     broker_utilization)
    return (broker_utilization(model), broker_replica_counts(model),
            broker_leader_counts(model), broker_potential_nw_out(model),
            model.broker_alive & model.broker_valid, model.replica_valid,
            model.partition_valid)


def _kernel_cluster_stats(rows, model, scale_model, rng, floor_ms):
    """KG at the main path's shape (its row), the scale cell's and 20,000
    random brokers over the main path's masks."""
    import torch
    from cruise_control_tpu_torch import kernels
    dev = torch.device("cuda")
    B = 20_000
    wide = (torch.from_numpy((rng.random((B, 4)) * [100.0, 1e4, 1e4, 1e6])
                             .astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, 500, B).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, 250, B).astype(np.int32)).to(dev),
            torch.from_numpy((rng.random(B) * 1e4).astype(np.float32)).to(dev),
            torch.from_numpy(rng.random(B) < 0.9).to(dev),
            model.replica_valid, model.partition_valid)
    for tag, args in (("main path", _kg_inputs(model)),
                      ("scale cell", _kg_inputs(scale_model)),
                      ("20,000 random brokers", wide)):
        B = args[0].shape[0]
        got = kernels.cluster_stats(*args)
        want = kernels.cluster_stats_plain(*(t.cpu() for t in args))
        err = float((got.cpu() - want).abs().max())
        if not torch.equal(got.cpu(), want):
            fail(f"cluster_stats differs from its twin ({tag})")
        ms = time_ms(lambda: kernels.cluster_stats(*args), graph=True)
        plain = time_ms(lambda: kernels.cluster_stats_plain(*args), groups=3)
        util, replicas, leaders, potential, alive, rvalid, pvalid = args
        vals = torch.cat([util, replicas.float()[:, None],
                          leaders.float()[:, None], potential[:, None]],
                         dim=1)[alive].contiguous()

        def library():
            torch.std_mean(vals, dim=0, correction=0)
            vals.amax(dim=0)
            vals.amin(dim=0)
            rvalid.sum()
            pvalid.sum()
        lib_ms = time_ms(library, graph=True)
        n_alive = int(alive.sum())
        # inputs read once (util, two counts, potential, the three masks),
        # 31 words written; per column: a masked sum, a subtract, a square
        # and a sum over the alive brokers, a max and a min
        b_ms, b_by = bound(B * (16 + 4 + 4 + 4 + 1) + rvalid.numel()
                           + pvalid.numel() + 31 * 4, 7 * 6 * n_alive)
        earlier = EARLIER_MS.get(("KG", tag))
        earlier = ("not measured" if earlier is None
                   else f"{earlier} ms, without the counts")
        log(f"KG cluster_stats {tag}: B={B} ({n_alive} alive) x 7 columns, "
            f"counts over P x R {tuple(rvalid.shape)}: bit-exact vs twin; "
            f"{ms:.5f} ms ({ms / floor_ms:.2f}x the launch floor; earlier "
            f"design: {earlier}), twin {plain:.4f} ms, std_mean + amax + "
            f"amin + sum x2 {lib_ms:.5f} ms, bound {b_ms:.7f} ms ({b_by})")
        _keep_first_shape(rows, "cluster_stats", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))


def _once_ms(fn):
    """ms of one call between a pair of CUDA events (for a call too slow to
    repeat)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _wide_jbod(seed, B, D, P, hot=None):
    """A random JBOD layout of B brokers x D disks (rd, size, rb, capacity,
    valid as CPU tensors): half the replicas on disk 0, 5% of the disks
    invalid, one draining; ``hot`` puts the first copy of that many
    partitions on broker 0."""
    import torch
    gen = np.random.default_rng(seed)
    rb = gen.integers(0, B, (P, 2)).astype(np.int32)
    rb[:, 1] = (rb[:, 0] + 1 + gen.integers(0, B - 1, P)) % B
    if hot:
        rb[:hot, 0] = 0
        rb[:hot, 1] = 1 + gen.integers(0, B - 1, hot)
    rd = np.where(gen.random((P, 2)) < 0.5, 0,
                  gen.integers(0, D, (P, 2))).astype(np.int32)
    size = (gen.random((P, 2)) * 100).astype(np.float32)
    # the walk reads a capacity only as live (> 0) or draining (0)
    cap = (gen.random((B, D)) * 2000 + 100).astype(np.float32)
    cap[1, D - 1] = 0.0
    valid = gen.random((B, D)) < 0.95
    valid[:, 0] = True
    cap[~valid] = 0.0
    return tuple(torch.from_numpy(x) for x in (rd, size, rb, cap, valid))


def _kernel_intra_walk(rows, state):
    """KH against its twin at phase 11's shape (the rebalance's disk
    state), at a small shape with ties, zero sizes and a cap of 3, at 48
    and 96 disks a broker (the mean's sum over two and three windows of 32
    disks), and with one broker of 30,000 replicas whose lists exceed the
    launch's shared allotment (the global scratch)."""
    import torch
    from cruise_control_tpu_torch import kernels
    args = (state.replica_disk, state.replica_size, state.replica_broker,
            state.disk_capacity, state.disk_valid)
    small = (torch.tensor([[0, 0], [0, 1], [0, -1], [1, 0], [0, 0]],
                          dtype=torch.int32),
             torch.tensor([[40.0, 40.0], [0.0, 40.0], [25.0, 0.0],
                           [40.0, 0.0], [40.0, 10.0]]),
             torch.tensor([[0, 1], [0, 1], [1, 3], [0, 1], [1, 0]],
                          dtype=torch.int32),
             torch.tensor([[0.0, 100.0, 100.0], [100.0, 100.0, 0.0],
                           [100.0, 100.0, 100.0]]),
             torch.tensor([[True, True, True], [True, True, False],
                           [False, False, False]]))
    cases = (("phase 11", args, 512), ("small", small, 3),
             ("48 disks", _wide_jbod(48, 6, 48, 1000), 512),
             ("96 disks", _wide_jbod(96, 8, 96, 4000), 512),
             ("30,000 replicas on one broker", _wide_jbod(7, 4, 4, 31000,
                                                          hot=30000), 40))
    for tag, inputs, max_iters in cases:
        dev_in = [t.cuda() for t in inputs]
        got_rd, got_it = kernels.intra_broker_walk(*dev_in, max_iters)
        (want_rd, want_it), plain = _once_ms(
            lambda: kernels.intra_broker_walk_plain(
                *(t.cpu() for t in inputs), max_iters))
        err = float((got_rd.cpu() - want_rd).abs().max())
        if err != 0 or int(got_it) != int(want_it):
            fail(f"intra_broker_walk differs from its twin ({tag})")
        changed = int((got_rd.cpu() != inputs[0].cpu()).sum())
        if tag != "phase 11":
            ms = (time_ms(lambda: kernels.intra_broker_walk(*dev_in,
                                                            max_iters),
                          graph=True) if tag != "small" else 0.0)
            log(f"KH intra_broker_walk ({tag}, max_iters {max_iters}): "
                f"bit-exact vs twin, {int(got_it)} iterations, {changed} "
                f"replicas moved; {ms:.4f} ms")
            _keep_first_shape(rows, "intra_broker_walk", err, {})
            continue
        ms = time_ms(lambda: kernels.intra_broker_walk(*dev_in, max_iters),
                     graph=True)
        _, plain = _once_ms(lambda: kernels.intra_broker_walk_plain(
            *dev_in, max_iters))
        B, D = inputs[3].shape
        P, R = inputs[0].shape
        rb = inputs[2].cpu().numpy().reshape(-1)
        on = rb < B
        n_b = np.bincount(rb[on], minlength=B)
        moved = (got_rd.cpu() != inputs[0].cpu()).numpy().reshape(-1)
        m_b = np.bincount(rb[on & moved], minlength=B)
        its = int(got_it)
        # Work this run needs at least: each broker's iterations (its
        # changed replicas + 1, a lower bound on its moves + 1, capped)
        # times an in-order add and a test per replica.
        ops = int((np.minimum(m_b + 1, its) * 2 * n_b).sum())
        nbytes = P * R * (4 + 4 + 4) + B * D * (4 + 1) + P * R * 4 + 4
        b_ms, b_by = bound(nbytes, ops)
        hot = int(n_b.argmax())
        log(f"KH intra_broker_walk P={P} R={R} B={B} D={D} ({its} "
            f"iterations, hottest broker {hot}: {int(n_b[hot])} replicas, "
            f"{int(m_b[hot])} changed): bit-exact vs twin; {ms:.4f} ms "
            f"({ms * 1e3 / max(its, 1):.2f} us an iteration; PR 6: "
            f"{EARLIER_MS[('KH', tag)]} ms), twin {plain:.1f} ms (one "
            f"call), bound {b_ms:.6f} ms ({b_by}); a chain of {its} "
            f"iterations x 4 dependent steps")
        _keep_first_shape(rows, "intra_broker_walk", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))


#: KI's phase-3 shapes: (K plans, G goals, hard goals), phase 10's
#: population first
KI_SHAPES = ((4, 4, "mixed"), (4, 4, "hard"), (1, 4, "mixed"),
             (1, 23, "mixed"), (1, 28, "mixed"), (1, 32, "mixed"),
             (1, 28, "hard"), (64, 16, "mixed"), (16, 23, "mixed"),
             (16, 28, "mixed"), (16, 32, "mixed"), (16, 28, "hard"),
             (16, 32, "hard"), (16, 33, "mixed"), (16, 64, "mixed"),
             (1024, 64, "mixed"))


def _kernel_population_select(rows, rng):
    """KI against its twin at ``KI_SHAPES``: phase 10's population (K = 4,
    G = 4, mixed and all-hard weights), one plan, the population program's
    vector loops at 23, 28 and 32 goals (the boundary's and the final
    scores', of FMAs where the weights differ and of rounded products
    where they are all equal), its windowed tree at 33 and 64 goals, and
    K = 1,024 plans (past one block: a grid and a second launch), with
    ties, a NaN row, the weighted and the Pareto objective, and a move
    weight."""
    import torch
    from cruise_control_tpu_torch import kernels
    for K, G, kind in KI_SHAPES:
        boundary = (rng.random((K, G)) * 10.0 ** rng.integers(-7, 4, (K, G))
                    ).astype(np.float32)
        boundary[K // 2] = boundary[K // 4]          # a tie
        boundary[min(1, K - 1), 0] = np.nan          # sorts last
        scales = (rng.random(G) * 1e4).astype(np.float32)
        hard = np.arange(G) % 3 == 0 if kind == "mixed" else np.ones(G, bool)
        moves = rng.integers(0, 20_000, K)
        n_surv = max(1, min(K // 2, K - 1))
        inputs = [torch.from_numpy(a) for a in (boundary, moves, scales,
                                                hard)]
        dev_in = [t.cuda() for t in inputs]
        err = 0.0
        for mw, pareto, final in ((0.0, False, False), (0.01, True, False),
                                  (0.0, False, True), (0.01, False, True)):
            got = kernels.population_select(*dev_in, 1000.0, mw, n_surv,
                                            pareto, final)
            want = kernels.population_select_plain(*inputs, 1000.0, mw,
                                                   n_surv, pareto, final)
            for g, w in zip(got, want):
                g, w = g.cpu(), w.to(g.dtype)
                if g.shape != w.shape:
                    fail(f"population_select gives shape {tuple(g.shape)}, "
                         f"its twin {tuple(w.shape)} (K={K}, G={G})")
                # bit for bit, NaN (the NaN row's score) equal to NaN
                both_nan = torch.isnan(g) & torch.isnan(w)
                diff = torch.where(both_nan, 0.0, (g.double() - w.double()
                                                   ).abs())
                err = max(err, float(diff.max()) if diff.numel() else 0.0)
                if not bool(((g == w) | both_nan).all()):
                    fail(f"population_select differs from its twin (K={K}, "
                         f"G={G}, {kind}, move weight {mw}, final {final})")
        ms = time_ms(lambda: kernels.population_select(
            *dev_in, 1000.0, 0.0, n_surv, False), graph=True)
        plain = time_ms(lambda: kernels.population_select_plain(
            *dev_in, 1000.0, 0.0, n_surv, False), groups=3)
        # inputs read once, three [K] outputs written; normalize and weigh
        # K x G, K^2 G dominance tests, K^2 sort comparisons
        b_ms, b_by = bound(K * G * 4 + K * 8 + G * 5 + 3 * K * 4,
                           5 * K * G + 2 * K * K * G + 2 * K * K)
        earlier = EARLIER_MS.get(("KI", (K, G)) if kind == "mixed" else None)
        one = kernels.population_select_single(K, G)
        log(f"KI population_select K={K} G={G} {kind} "
            f"({'one block' if one else 'a grid and a second launch'}): "
            f"bit-exact vs twin (weighted and Pareto, with and without a "
            f"move weight, boundary and final scores); {ms:.5f} ms "
            f"(earlier design: {earlier or 'not measured'} ms), twin "
            f"{plain:.4f} ms, bound {b_ms:.3g} ms ({b_by})")
        _keep_first_shape(rows, "population_select", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))


def ka_draws(P, R):
    """KA's draws held to the twin in phase 3: (tag, words, shape, form,
    keyword arguments) at the model's padded [P, R]. The first is the main
    path's candidate noise, ``_noise(krep, ...)`` of a pass key fold_in(i)
    -> fold_in(it) -> split()[0]; the last a fold-in key (one element
    through one word), the shape of most of KA's launches' keys."""
    n = P * R
    return (
        ("noise [P, R]", (2, 17, 0), (P, R), "affine", dict(a=1e-3, b=0.0)),
        ("uniform", (2, 17, 0), (n,), "affine", {}),
        ("drain noise", (2, 70_001), (n,), "affine", dict(a=0.01, b=1.0)),
        ("bits", (2, 17, 1), (n,), "bits", {}),
        ("keys", (2,), (n,), "keys", {}),
        ("randint", (2, 17, 1, 2), (n,), "randint",
         dict(minval=0, maxval=128)),
        ("device word", ("dev", 17, 0), (n,), "affine",
         dict(a=1e-3, b=0.0)),
        ("fold-in key", (2,), (1,), "keys", dict(base=17)),
    )


def _kernel_threefry(rows, dev, P, R):
    """KA against its twin for every form, each timed by graph replay
    beside its bound: the bytes written (and the key read) over the card's
    rate, or the hashes (the path's once, then one an element; 130
    integer operations each) over its peak."""
    import torch
    from cruise_control_tpu_torch import _random, kernels
    key = _random.PRNGKey(0, device=dev)
    out_bytes = dict(affine=4, bits=4, keys=16, randint=8)
    for tag, words, shape, form, kw in ka_draws(P, R):
        words = tuple(torch.tensor(2, device=dev) if w == "dev" else w
                      for w in words)

        def draw(words=words, shape=shape, form=form, kw=kw):
            return kernels.threefry_draw(key, words, shape, form, **kw)
        got = draw()
        want = kernels.threefry_draw_plain(
            key.cpu(), tuple(w.cpu() if isinstance(w, torch.Tensor) else w
                             for w in words), shape, form, **kw)
        if got.shape != want.shape or not torch.equal(
                got.cpu().view(want.dtype), want):
            fail(f"threefry_draw ({tag}) differs from its twin")
        ms = time_ms(draw, graph=True)
        plain = time_ms(lambda: kernels.threefry_draw_plain(
            key, words, shape, form, **kw), groups=3)
        n = int(np.prod(shape))
        hashes = n * (3 if form == "randint" else 1) + len(words)
        b_ms, b_by = bound(16 + out_bytes[form] * n, 130 * hashes)
        log(f"KA threefry_draw {tag} n={n} path {len(words)} {form}: "
            f"bit-exact; {ms:.5f} ms, twin {plain:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        _keep_first_shape(rows, "threefry2x32", 0.0, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))


def kd_boundary_case(model, seed):
    """KD's inputs as the move scheduler's boundary audit passes them
    (``executor/schedule.py:_violating_boundaries``): KD_BOUNDARIES
    placements ``[S, P, R]``, boundary k the template with the first
    ``k * moves`` partitions of a seeded order moved to seeded brokers
    (their slots renumbered 0..R-1, online), the template's pvalid
    expanded over the boundaries, nothing killed or added."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    dev = model.replica_broker.device
    P, R = model.replica_broker.shape
    B = model.num_brokers_padded
    S = KD_BOUNDARIES
    order = torch.randperm(P, generator=gen)
    step = P // (2 * S)
    moved = torch.arange(P)[None] < (torch.arange(1, S + 1)[:, None] * step)
    rows = torch.zeros((S, P), dtype=torch.bool)
    rows[:, order] = moved
    rows = rows.to(dev)[..., None]
    new_rb = torch.randint(0, int(model.broker_valid.sum()), (P, R),
                           generator=gen, dtype=torch.int32).to(dev)
    slots = torch.arange(R, dtype=torch.int32, device=dev).expand(P, R)
    rb = torch.where(rows, new_rb, model.replica_broker)
    pref = torch.where(rows, slots, model.replica_pref_pos)
    off = rows.logical_not() & model.replica_offline
    none = torch.zeros((S, B), dtype=torch.bool, device=dev)
    return (rb, off, pref, model.broker_valid, model.broker_alive, none,
            none.clone(), model.partition_valid.expand(S, P))


def kj_case(C, S, P, R, B, seed, device):
    """KJ inputs with every edge the kernel must take: broker ids -1 and
    at or past B among the slots, partitions a cluster does not hold,
    offline replicas, brokers invalid or down per cluster, kills and adds
    per scenario, preferred positions shuffled."""
    import torch
    g = torch.Generator().manual_seed(seed)
    rb = torch.randint(-1, B + 2, (C, P, R), generator=g, dtype=torch.int32)
    off = torch.rand(C, P, R, generator=g) < 0.05
    pref = torch.argsort(torch.rand(C, P, R, generator=g), dim=-1).to(
        torch.int32)
    valid = torch.rand(C, B, generator=g) < 0.95
    alive = torch.rand(C, B, generator=g) < 0.9
    dead = torch.rand(C, S, B, generator=g) < 0.1
    add = torch.rand(C, S, B, generator=g) < 0.05
    pvalid = torch.rand(C, P, generator=g) < 0.9
    return tuple(t.to(device) for t in (rb, off, pref, valid, alive, dead,
                                        add, pvalid))


#: KJ's edge shapes (C, S, P, R, B), as ``tests/test_torch_kernels_cuda.py``
#: holds them: broker counts 33, 104 and 1,001, every compiled R and one
#: past them (the row kernel), P off the 1,024-partition tile and off a
#: multiple of 4 (element stores), one cluster, one scenario, and an S x B
#: whose masks fill several chunks
KJ_EDGES = ((3, 7, 1_000, 1, 33), (2, 5, 2_052, 2, 104),
            (2, 5, 2_050, 2, 104), (2, 9, 777, 3, 1_001),
            (3, 4, 1_029, 4, 104), (1, 1, 5, 2, 104), (4, 1, 4_096, 2, 104),
            (1, 3, 64, 1, 1_001), (1, 6, 4_096, 5, 33), (2, 3, 3, 2, 2),
            (1, 2_000, 64, 2, 60_000))


def _kernel_fleet_failover(rows, model):
    """KJ against its twin at phase 12's N-1 shape: FLEET_CLUSTERS
    clusters, each the main-path placement with its broker ids rolled by
    the cluster's index and two brokers of its own down, every broker
    killed in turn starting at a different one per cluster (S =
    NUM_BROKERS scenarios a cluster). Each cluster thus reads placements,
    masks and scenarios that no other cluster has, so a kernel that
    mixed up clusters would differ from the twin. The twin runs once, on
    the card. Then KJ's edge shapes (``KJ_EDGES``), twin on the CPU."""
    import torch
    from cruise_control_tpu_torch import kernels
    dev = model.device
    C, S = FLEET_CLUSTERS, NUM_BROKERS
    B = model.num_brokers_padded
    P, R = model.replica_broker.shape

    def per_cluster(t):
        return t.expand((C,) + tuple(t.shape)).contiguous()
    c_ix = torch.arange(C, device=dev)
    rb = per_cluster(model.replica_broker)
    real = rb < NUM_BROKERS
    rb = torch.where(real, (rb + c_ix.view(C, 1, 1)) % NUM_BROKERS, rb)
    alive = per_cluster(model.broker_alive)
    alive[c_ix, c_ix % NUM_BROKERS] = False
    alive[c_ix, (c_ix + 37) % NUM_BROKERS] = False
    s_ix = torch.arange(S, device=dev)
    dead = torch.zeros((C, S, B), dtype=torch.bool, device=dev)
    dead[c_ix.view(C, 1), s_ix.view(1, S),
         (s_ix.view(1, S) + c_ix.view(C, 1)) % S] = True
    args = (rb.contiguous(), per_cluster(model.replica_offline),
            per_cluster(model.replica_pref_pos),
            per_cluster(model.broker_valid), alive,
            dead, torch.zeros_like(dead), per_cluster(model.partition_valid))
    got = kernels.fleet_scenario_failover(*args)
    want, plain = _once_ms(
        lambda: kernels.fleet_scenario_failover_plain(*args))
    err = max(float((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail("fleet_scenario_failover differs from its twin at phase 12's "
             "N-1 shape")
    del got, want
    ms = time_ms(lambda: kernels.fleet_scenario_failover(*args), graph=True,
                 launches=20)
    nbytes = (C * P * R * 9 + 2 * C * B + 2 * C * S * B + C * P  # inputs
              + C * S * P * R * 9 + C * S * P)                 # outputs
    b_ms, b_by = bound(nbytes, 8 * C * S * P * R)
    log(f"KJ fleet_scenario_failover C={C} S={S} P={P} R={R} B={B} "
        f"(scenario chunk {kernels.failover_chunk(C, S, P, R, B)}): "
        f"bit-exact vs twin; {ms:.4f} ms (the row kernel: "
        f"{EARLIER_MS[('KJ', 'phase 12')]} ms), twin {plain:.3f} "
        f"ms (once), bound {b_ms:.5f} ms ({b_by}), "
        f"{100 * b_ms / ms:.1f}% of the bound")
    _keep_first_shape(rows, "fleet_scenario_failover", err, dict(
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None))
    for i, (C, S, P, R, B) in enumerate(KJ_EDGES):
        args = kj_case(C, S, P, R, B, seed=100 + i, device=dev)
        got = kernels.fleet_scenario_failover(*args)
        want = kernels.fleet_scenario_failover_plain(
            *(t.cpu() for t in args))
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"fleet_scenario_failover differs from its twin at "
                 f"C={C} S={S} P={P} R={R} B={B}")
        log(f"KJ edge C={C} S={S} P={P} R={R} B={B} (scenario chunk "
            f"{kernels.failover_chunk(C, S, P, R, B)}): bit-exact")


def schedule_context(model, md, proposals):
    """The facade's strategy context for a schedule: each moving
    partition's size is its disk load (``facade.py:_device_schedule``)."""
    from cruise_control_tpu_torch.executor import StrategyContext
    keys = {(p.topic, p.partition) for p in proposals}
    disk = model.leader_load[:, 3].cpu().numpy()
    return StrategyContext(partition_size_mb={
        k: float(disk[i]) for i, k in enumerate(md.partition_keys)
        if k in keys})


def phase_first_fit(model, md, proposals, rows):
    """KE against its twin at the shapes of phase 8's two schedules (the
    seed-1 proposals under the default concurrency caps, without and with
    the 300 MB budget), and at a frontier near K = 1,024 (every slot past
    the shared-memory ones in play). Each move depends on every earlier
    one: ``scripts/probe_walk_kernels.py`` prices that chain."""
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.executor import (
        ConcurrencyConfig, DeviceMoveScheduler, ExecutionConcurrencyManager)
    from cruise_control_tpu_torch.executor.schedule import first_fit_inputs
    log("== phase 3 (KE, at the shapes of phase 8's schedules)")
    ctx = schedule_context(model, md, proposals)
    order = DeviceMoveScheduler(device="cuda")._strategy_order(
        proposals, None, ctx)
    for tag, bandwidth, _throttle in SCHEDULE_RUNS:
        inp = first_fit_inputs(order, proposals, ExecutionConcurrencyManager(
            ConcurrencyConfig()), md, ctx, bandwidth)
        tensors = [torch.from_numpy(inp[k]).to(model.device)
                   for k in ("rows", "dest_rows", "size_mb", "valid",
                             "caps")]
        extra = (inp["cluster_cap"], inp["budget"], inp["num_batches"])
        got = kernels.first_fit(*tensors, *extra)
        # The twin walks the moves one by one from the host (~0.4 ms a
        # move), so it runs once, on the card, between a pair of events.
        want, plain = _once_ms(lambda: kernels.first_fit_plain(*tensors,
                                                                *extra))
        err = float((got - want).abs().max())
        if err != 0:
            fail(f"first_fit differs from its twin at phase 8's shape "
                 f"({tag})")
        ms = time_ms(lambda: kernels.first_fit(*tensors, *extra), graph=True)
        M, W = inp["rows"].shape
        K = inp["num_batches"]
        n = int(inp["valid"].sum())
        a = want.cpu().numpy()
        frontier = int(a[a < K].max(initial=-1)) + 1
        tested = int((a[inp["valid"]].astype(np.int64) + 1).sum())
        # each valid move's rows, destinations and size read once, the
        # valid mask and the caps read once, each valid move's batch
        # written once
        nbytes = n * W * 8 + n * 4 + M + inp["caps"].nbytes + n * 4
        b_ms, b_by = bound(nbytes, tested * (2 * W + 1))
        earlier = EARLIER_MS.get(("KE", tag))
        log(f"KE first_fit ({tag}) M={M} W={W} K={K} "
            f"B1={inp['caps'].shape[0]}: bit-exact vs twin; frontier "
            f"{frontier} batches ("
            f"{kernels.first_fit_shared_slots(W, K, inp['caps'].shape[0])} "
            f"slots in shared memory); {ms:.4f} ms ({ms * 1e3 / n:.3f} us a move"
            + (f"; PR 6: {earlier} ms" if earlier else "") + f"), twin "
            f"{plain:.1f} ms (one call), bound {b_ms:.6f} ms ({b_by}); a "
            f"chain of {n} dependent steps")
        _keep_first_shape(rows, "first_fit", err, dict(
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))

    # The largest-K form: every move touches row 0, whose cap is 1, so
    # move i opens batch i and the frontier climbs to K - 1 (slots past the
    # shared-memory ones live in the global arrays); the last moves spill.
    gen = np.random.default_rng(1024)
    Mk, K, B1, W = 1030, 1024, 101, 4
    rk = gen.integers(0, B1 - 1, (Mk, W)).astype(np.int32)
    rk[:, 0] = 0
    dk = np.where(gen.random((Mk, W)) < 0.5, rk, B1 - 1).astype(np.int32)
    caps = np.full(B1, 1 << 20, np.int32)
    caps[0] = 1
    caps[B1 - 1] = 1 << 30
    tensors = [torch.from_numpy(x).to(model.device) for x in (
        rk, dk, (gen.random(Mk) * 500).astype(np.float32),
        np.ones(Mk, bool), caps)]
    got = kernels.first_fit(*tensors, 1 << 20, 300.0, K)
    want, plain = _once_ms(lambda: kernels.first_fit_plain(
        *tensors, 1 << 20, 300.0, K))
    err = float((got - want).abs().max())
    a = want.cpu().numpy()
    if err != 0 or int(a[a < K].max()) != K - 1:
        fail("first_fit differs from its twin at the frontier near K")
    ms = time_ms(lambda: kernels.first_fit(*tensors, 1 << 20, 300.0, K),
                 graph=True)
    log(f"KE first_fit (frontier near K) M={Mk} W={W} K={K} B1={B1}: "
        f"bit-exact vs twin; frontier {K} batches "
        f"({kernels.first_fit_shared_slots(W, K, B1)} slots in shared "
        f"memory); "
        f"{ms:.4f} ms ({ms * 1e3 / Mk:.3f} us a move), twin {plain:.1f} ms")
    _keep_first_shape(rows, "first_fit", err, {})


def _peak_mib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**20


def _print_result(tag, res, wall, syncs):
    log(f"{tag}: wall {wall:.3f}s host_syncs {syncs} moves {res.num_moves} "
        f"(reference {REFERENCE_MOVES}) proposals {len(res.proposals)} "
        f"(reference {REFERENCE_PROPOSALS}) peak_mem {_peak_mib():.1f} MiB")
    for g in res.goal_results:
        log(f"  {g.name:42s} {g.violation_before:14.4f} -> "
            f"{g.violation_after:12.4f} iters={g.iterations} "
            f"({g.duration_s:.3f}s)")
    for g in res.hard_goal_audit:
        log(f"  [audit] {g.name:36s} {g.violation_before:14.4f} -> "
            f"{g.violation_after:12.4f} "
            f"{'ok' if g.satisfied else 'VIOLATED'}")


def _optimize(opt, model, md, seed):
    import torch
    from cruise_control_tpu_torch.analyzer import engine
    torch.cuda.synchronize()
    syncs0 = engine.HOST_SYNCS
    t0 = time.monotonic()
    res = opt.optimize(model, md, main_path_options(seed))
    torch.cuda.synchronize()
    return res, time.monotonic() - t0, engine.HOST_SYNCS - syncs0


def _device_ops(fn):
    """(fn's result, the names of the kernels and copies it ran on the
    card), read by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def _count_device_launches(fn):
    """(fn's result, the number of kernels and copies it ran on the
    card)."""
    out, ops = _device_ops(fn)
    return out, len(ops)


def _check_quality(res, tag):
    from cruise_control_tpu_torch.model.flat import sanity_check
    bad = [g.name for g in res.goal_results if not g.satisfied]
    if bad:
        fail(f"{tag}: chain goals left violated: {bad}")
    bad = [g.name for g in res.hard_goal_audit if not g.satisfied]
    if bad or len(res.hard_goal_audit) != 6:
        fail(f"{tag}: audit not ok ({len(res.hard_goal_audit)} goals, "
             f"violated {bad})")
    issues = sanity_check(res.final_model)
    if any(issues.values()):
        fail(f"{tag}: sanity_check {issues}")


def phase_main_path(model, md, arrays):
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.model.flat import (broker_replica_counts,
                                                     broker_utilization)
    log("== phase 4: main path 100x20K RF2")
    opt = main_path_optimizer()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results = []
    for tag, seed in (("cold seed 0", 0), ("warm seed 1", 1),
                      ("warm seed 1 again", 1)):
        ka0 = kernels.LAUNCHES["threefry2x32"]
        if tag == "warm seed 1 again":
            (res, wall, syncs), device_launches = _count_device_launches(
                lambda: _optimize(opt, model, md, seed))
            tag += " (under torch.profiler)"
        else:
            res, wall, syncs = _optimize(opt, model, md, seed)
        _print_result(tag, res, wall, syncs)
        _check_quality(res, tag)
        results.append(res)
        log(f"  KA launches in this optimize: "
            f"{kernels.LAUNCHES['threefry2x32'] - ka0}")
    log(f"warm optimize: {device_launches} device launches (kernels and "
        f"copies, torch.profiler)")
    launches = dict(kernels.LAUNCHES)
    log(f"main-path launches: {json.dumps(launches)}")
    missing = [k for k in ("threefry2x32", "ordered_segment_sum",
                           "net_broker_flow") if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if results[1].proposals != results[2].proposals:
        fail("the two seed-1 runs gave different proposals")
    log(f"seed-1 runs identical: {len(results[1].proposals)} proposals")

    g_dur, g_moves, g_util, g_counts = greedy_baseline(arrays, NUM_BROKERS)
    g_res = residual(g_util, g_counts, NUM_BROKERS)
    res = results[1]
    our_util = broker_utilization(res.final_model).cpu().numpy().astype(
        np.float64)
    our_counts = broker_replica_counts(res.final_model).cpu().numpy().astype(
        float)
    our_res = residual(our_util, our_counts, NUM_BROKERS)
    log(f"greedy baseline (host numpy): {g_dur:.2f}s moves={g_moves} "
        f"residual={g_res:.3f}; port residual {our_res:.3f}")
    if our_res > g_res * 1.05 + 10.0:
        fail(f"quality regression: residual {our_res:.1f} > greedy "
             f"{g_res:.1f} x1.05 + 10")
    return launches, res


def phase_drain(model, md):
    import torch
    log("== phase 5: self-healing drain 100x20K, one dead broker")
    dead = np.random.default_rng(7).choice(
        NUM_BROKERS, size=max(NUM_BROKERS // 100, 1), replace=False)
    alive = model.broker_alive.clone()
    alive[torch.from_numpy(dead).to(alive.device)] = False
    sick = model.replace(broker_alive=alive)
    res, wall, syncs = _optimize(main_path_optimizer(), sick, md, 0)
    _print_result(f"drain (dead broker {dead.tolist()})", res, wall, syncs)
    rb = res.final_model.replica_broker.cpu().numpy()
    left = int(np.isin(rb, dead).sum())
    log(f"replicas left on dead brokers: {left}")
    if left:
        fail(f"{left} replicas left on the dead broker")
    bad = [g.name for g in res.hard_goal_audit if not g.satisfied]
    if bad:
        fail(f"drain audit violated: {bad}")


def phase_scale(model, md):
    import torch
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    log("== phase 6: scale 1Kx200K RF2")
    opt = TorchGoalOptimizer(
        goals=goals_by_name(GOALS),
        config=SearchConfig(num_replica_candidates=1024,
                            num_dest_candidates=16, apply_per_iter=1024,
                            drain_batch=25_000, drain_rounds=8,
                            max_iters_per_goal=512),
        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res, wall, syncs = _optimize(opt, model, md, 0)
    _print_result("scale seed 0", res, wall, syncs)
    worse = [g.name for g in res.goal_results
             if g.violation_after > g.violation_before * (1 + 1e-6) + 1e-6]
    if worse:
        fail(f"scale: goals ended worse than they started: {worse}")
    bad = [g.name for g in res.hard_goal_audit if not g.satisfied]
    if bad:
        fail(f"scale audit violated: {bad}")


def _report_key(report):
    """A report's content without its wall time."""
    out = report.to_json()
    out.pop("durationMs")
    return out


def _summary(report):
    """The numbers held to the reference, with a digest of every outcome's
    risk and pressure (full float64 repr), headroom, violated goals, worst
    broker, offline replicas and unavailable partitions."""
    worst = report.riskiest()
    outcomes = [[o.scenario.name, o.risk, o.capacity_pressure, o.headroom,
                 o.violated_goals, o.worst_broker, o.offline_replicas,
                 o.unavailable_partitions] for o in report.outcomes]
    return dict(riskiest=worst.scenario.name, max_risk=worst.risk,
                violated=sum(bool(o.violated_goals) for o in report.outcomes),
                risk4_sum=round(sum(round(o.risk, 4)
                                    for o in report.outcomes), 4),
                digest=hashlib.sha256(json.dumps(outcomes).encode()
                                      ).hexdigest()[:16])


def _check_summary(tag, got, want):
    log(f"{tag}: riskiest {got['riskiest']} max risk {got['max_risk']!r} "
        f"scenarios violating a goal {got['violated']} sum of 4-decimal "
        f"risks {got['risk4_sum']} (reference {want})")
    if got != want:
        fail(f"{tag}: {got} differs from the reference's {want}")


def phase_whatif(model, md, arrays):
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import goals_by_name
    from cruise_control_tpu_torch.whatif import (WhatIfEngine,
                                                 alive_broker_ids, n1_sweep,
                                                 parse_scenarios)
    log("== phase 7: what-if 100x20K, N-1 sweep and every scenario type")
    engine = WhatIfEngine(goals=goals_by_name(GOALS), device="cuda")
    scenarios = n1_sweep(alive_broker_ids(model, md))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, reports = [], []
    for _ in range(4):                      # cold, then three warm sweeps
        t0 = time.monotonic()
        reports.append(engine.sweep(model, md, scenarios))
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    launches = dict(kernels.LAUNCHES)
    peak = _peak_mib()
    per_sweep = {k: v // 4 for k, v in launches.items()}
    log(f"N-1 S={len(scenarios)}: cold {walls[0]:.3f}s, warm "
        f"{', '.join(f'{w:.3f}s' for w in walls[1:])} "
        f"({len(scenarios) / min(walls[1:]):.0f} scenarios/s warm), peak "
        f"mem {peak:.1f} MiB; launches per sweep {json.dumps(per_sweep)}")
    if launches["scenario_failover"] != 4 or not launches[
            "ordered_segment_sum"]:
        fail(f"the sweep did not go through KD once and KB: {launches}")
    if any(_report_key(r) != _report_key(reports[0]) for r in reports[1:]):
        fail("N-1 sweeps of the same model gave different reports")
    kernels.reset_launch_counts()
    engine.sweep(model, md, scenarios[:1])
    one = dict(kernels.LAUNCHES)
    log(f"launches of a one-scenario sweep: {json.dumps(one)}")
    if one != per_sweep:
        fail("a sweep's launches depend on its scenario count")

    report = reports[-1]
    rb = arrays["replica_broker"]
    for o in report.outcomes:
        row = md.broker_index[o.scenario.brokers[0]]
        if o.offline_replicas != int((rb == row).sum()):
            fail(f"{o.scenario.name}: {o.offline_replicas} offline replicas, "
                 f"the broker hosts {int((rb == row).sum())}")
        if o.unavailable_partitions:
            fail(f"{o.scenario.name}: unavailable partitions at RF 2")
    for scn, got in zip(scenarios[:20], report.outcomes):
        single = engine.sweep(model, md, [scn]).outcomes[0]
        if single.to_json() != got.to_json() or single.risk != got.risk:
            fail(f"{scn.name}: the batched sweep differs from S = 1")
    log("offline replicas equal each broker's replica count, 0 unavailable; "
        "the first 20 scenarios alone equal the batch")
    _check_summary("N-1", _summary(report), REFERENCE_N1)

    mixed = parse_scenarios({"scenarios": MIXED_SCENARIOS}, md.broker_ids)
    t0 = time.monotonic()
    rep = engine.sweep(model, md, mixed)
    torch.cuda.synchronize()
    risks = [round(o.risk, 4) for o in rep.outcomes]
    if not all(np.isfinite([o.risk, o.capacity_pressure]).all()
               for o in rep.outcomes) or len(risks) != len(mixed):
        fail("mixed batch: non-finite or missing outcomes")
    log(f"mixed batch of {len(mixed)} scenario types (re-padded model): "
        f"{time.monotonic() - t0:.3f}s, risks {risks}")
    _check_summary("mixed", _summary(rep), REFERENCE_MIXED)
    if risks != REFERENCE_MIXED_RISKS:
        fail(f"mixed batch risks differ from the reference's "
             f"{REFERENCE_MIXED_RISKS}")
    return launches


def phase_schedule(model, md, proposals):
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.executor import (
        ConcurrencyConfig, DeviceMoveScheduler, ExecutionConcurrencyManager,
        ExecutionTaskPlanner, ExecutionTask, TaskType)
    log("== phase 8: schedule the seed-1 proposals with the boundary audit")
    opt = main_path_optimizer()
    goals = opt._audit_goals_for([], md, main_path_options(1))
    if len(goals) != 6:
        fail(f"audit set has {len(goals)} goals, want 6")
    ctx = schedule_context(model, md, proposals)
    scheduler = DeviceMoveScheduler(device="cuda")
    total = {k: 0 for k in kernels.LAUNCHES}
    schedules = {}
    for tag, bandwidth, throttle in SCHEDULE_RUNS:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        sched = scheduler.schedule(
            proposals, ExecutionConcurrencyManager(ConcurrencyConfig()),
            model=model, metadata=md, goals=goals,
            capacity_threshold=opt.constraint.capacity_threshold,
            strategy_context=ctx, throttle_bytes=throttle,
            bandwidth_mb_per_batch=bandwidth)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        digest = hashlib.sha256(json.dumps(sched.batches).encode()
                                ).hexdigest()[:16]
        eta = (None if sched.eta_ms[0] is None
               else round(sum(sched.eta_ms), 3))
        t = scheduler.last_timings
        log(f"{tag}: wall {wall:.3f}s (first fit {t['assign_s']:.3f}s, "
            f"audit {t['audit_s']:.3f}s) {sched.num_moves} moves in "
            f"{len(sched.batches)} batches, stats {sched.stats}, ETA sum "
            f"{eta} ms, digest {digest}; launches {json.dumps(launches)}")
        if not launches["first_fit"] or not launches["scenario_failover"]:
            fail(f"{tag}: the schedule did not launch KE and KD")
        want = REFERENCE_SCHEDULE[tag]
        if (sched.stats != want["stats"] or digest != want["digest"]
                or eta != want["eta_sum"]):
            fail(f"{tag}: schedule differs from the reference's {want}")
        schedules[tag] = sched

    planner = ExecutionTaskPlanner()
    tasks = [ExecutionTask(i, p, TaskType.INTER_BROKER_REPLICA_ACTION)
             for i, p in enumerate(proposals) if p.has_replica_action]
    planner.begin_phase(tasks, ctx)
    concurrency = ExecutionConcurrencyManager(ConcurrencyConfig())
    pending, greedy = list(tasks), []
    t0 = time.monotonic()
    while pending:
        batch = planner.inter_broker_batch(pending, [], concurrency, ctx)
        if not batch:
            break
        greedy.append(tuple(t.execution_id for t in batch))
        done = {id(t) for t in batch}
        pending = [t for t in pending if id(t) not in done]
    log(f"host greedy planner to quiescence: {len(greedy)} batches in "
        f"{time.monotonic() - t0:.2f}s")
    if greedy != schedules["schedule"].batches:
        fail("the first-fit schedule differs from the host greedy planner")
    return total


# ---------------------------------------------------------------------------
# Phase 9: the served monitor -> resident model cycle
# ---------------------------------------------------------------------------

def served_sample_values(spec, keys, num_metrics):
    """float64[P, M] dense sample values: each partition's spec leader load
    in the four resource columns (CPU, NW_IN, NW_OUT, DISK), zeros in the
    other metric columns."""
    loads = {(p.topic, p.partition): p.leader_load for p in spec.partitions}
    vals = np.zeros((len(keys), num_metrics))
    vals[:, :4] = np.array([loads[k] for k in keys], np.float64)
    return vals


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _json_sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


def served_setup(pkg, spec):
    """(sim, monitor, keys, vals, ingest, now_ms): phase 9's simulated
    cluster and resident monitor over one package's modules, with its
    sample values; ``ingest(v, windows)`` adds one dense sample round per
    window, ``now_ms()`` is the end of the last window ingested."""
    sim = pkg.SimulatedKafkaCluster.from_spec(spec)
    R = pkg.Resource
    resolver = pkg.FixedCapacityResolver(capacity=dict(zip(
        (R.CPU, R.NW_IN, R.NW_OUT, R.DISK), SERVED_CAPACITY)))
    monitor = pkg.make_monitor(
        sim, pkg.MonitorConfig(num_windows=SERVED_WINDOWS,
                               window_ms=SERVED_WINDOW_MS,
                               min_samples_per_window=1),
        capacity_resolver=resolver,
        rack_by_broker={b.broker_id: b.rack for b in spec.brokers})
    keys = sorted(sim.describe_partitions())
    vals = served_sample_values(spec, keys,
                                pkg.partition_metric_def().size())
    state = {"window": 0}

    def ingest(v, windows):
        for _ in range(windows):
            times = np.full(len(keys), state["window"] * SERVED_WINDOW_MS
                            + 100, np.int64)
            monitor.partition_aggregator.add_samples_dense(keys, times, v)
            state["window"] += 1

    return (sim, monitor, keys, vals, ingest,
            lambda: state["window"] * SERVED_WINDOW_MS)


def served_cycle(pkg, spec, check_planes=None,
                 dead_broker=SERVED_DEAD_BROKER, device_ops=None):
    """Phase 9's sequence over one package's modules (``pkg``, see
    ``port_package``; ``scripts/served_reference.py`` passes the JAX
    package's): cold cycle, warmup, metric-only cycles, stats, optimize,
    broker death, drain. Returns what it saw; the caller gates it.
    ``check_planes(resident)`` runs after each delta cycle;
    ``device_ops(fn)`` (``fn``'s result, the device operations it ran)
    wraps the last delta cycle's build."""
    sim, monitor, keys, vals, ingest, now_ms = served_setup(pkg, spec)
    resident = monitor.resident

    def build():
        pkg.sync()
        t0 = time.monotonic()
        res = monitor.cluster_model(now_ms())
        pkg.sync()
        return res, time.monotonic() - t0

    out = {}
    ingest(vals, SERVED_WINDOWS + 1)
    res, wall = build()
    out["cold"] = dict(wall=wall, update=resident.last_update,
                       epoch=resident.epoch,
                       bytes=resident.last_full_bytes)
    before = pkg.collector.snapshot()
    resident.warmup()
    snap = pkg.collector.snapshot()
    out["warmup_builds"] = (snap["aotCompileEvents"]
                            - before["aotCompileEvents"])
    out["cycles"] = []
    for c in range(SERVED_CYCLES):
        vals = vals.copy()
        vals[:len(keys) // 100] += 1.0 + c       # 1% of the partitions
        # two windows, so the changed window rolls out of the in-flight
        # slot (the aggregator never serves the current window)
        ingest(vals, 2)
        mark = max((sp.span_id for sp in pkg.tracer.spans()), default=0)
        ops = None
        if device_ops is not None and c == SERVED_CYCLES - 1:
            (res, wall), ops = device_ops(build)
        else:
            res, wall = build()
        spans = {}
        for sp in pkg.tracer.spans():
            if sp.span_id > mark:
                spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration_s
        lead, foll = pkg.planes(resident.model)
        out["cycles"].append(dict(
            wall=wall, update=resident.last_update, epoch=resident.epoch,
            rows=resident.last_delta_rows, bytes=resident.last_delta_bytes,
            planes=_sha(lead, foll), spans=spans, device_ops=ops,
            rebuild_equal=(None if check_planes is None
                           else check_planes(resident))))
    after = pkg.collector.snapshot()
    out["builds_after_warmup"] = (
        after["compileEvents"] + after["aotCompileEvents"]
        - snap["compileEvents"] - snap["aotCompileEvents"])
    out["stats_before"] = pkg.stats_summary(res.model)
    opt = pkg.optimize(res.model, res.metadata, 1)
    out["optimize"] = dict(
        moves=opt.num_moves, proposals=len(opt.proposals),
        digest=_json_sha([p.to_json() for p in opt.proposals]),
        satisfied=all(g.satisfied for g in opt.goal_results),
        audit_ok=all(g.satisfied for g in opt.hard_goal_audit))
    out["stats_after"] = pkg.stats_summary(opt.final_model)

    sim.kill_broker(dead_broker)
    res, wall = build()
    out["structural"] = dict(wall=wall, update=resident.last_update,
                             epoch=resident.epoch)
    drain = pkg.optimize(res.model, res.metadata, 0)
    row = res.metadata.broker_index[dead_broker]
    out["drain"] = dict(
        moves=drain.num_moves, proposals=len(drain.proposals),
        left=int((pkg.replica_broker(drain.final_model) == row).sum()),
        audit_ok=all(g.satisfied for g in drain.hard_goal_audit))
    return out


def port_package(search=MAIN_SEARCH, device="cuda"):
    """``served_cycle``'s view of the port on ``device``, optimizing with
    the search config ``search``."""
    import types

    import torch
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    from cruise_control_tpu_torch.config import FixedCapacityResolver
    from cruise_control_tpu_torch.core.metricdef import partition_metric_def
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.core.runtime_obs import default_collector
    from cruise_control_tpu_torch.core.tracing import default_tracer
    from cruise_control_tpu_torch.executor import SimulatedKafkaCluster
    from cruise_control_tpu_torch.model.stats import stats_summary
    from cruise_control_tpu_torch.monitor import LoadMonitor, MonitorConfig
    opt = TorchGoalOptimizer(goals=goals_by_name(GOALS),
                             config=SearchConfig(**search), device=device)
    return types.SimpleNamespace(
        SimulatedKafkaCluster=SimulatedKafkaCluster, Resource=Resource,
        FixedCapacityResolver=FixedCapacityResolver,
        MonitorConfig=MonitorConfig,
        partition_metric_def=partition_metric_def,
        make_monitor=lambda sim, cfg, **kw: LoadMonitor(sim, cfg,
                                                        device=device, **kw),
        collector=default_collector(), tracer=default_tracer(),
        sync=torch.cuda.synchronize if device == "cuda" else lambda: None,
        planes=lambda m: (m.leader_load.cpu().numpy(),
                          m.follower_load.cpu().numpy()),
        replica_broker=lambda m: m.replica_broker.cpu().numpy(),
        stats_summary=lambda m: stats_summary(m, device=device),
        optimize=lambda m, md, seed: opt.optimize(m, md,
                                                  main_path_options(seed)))


def _rebuild_equal(resident) -> bool:
    """The resident model equals a from-scratch upload of the monitor's
    arrays (the resident state's host mirrors), every field bit for
    bit."""
    import dataclasses

    import torch
    from cruise_control_tpu_torch.model.flat import FlatClusterModel
    _epoch, arrays = resident.export_state()
    fresh = FlatClusterModel.from_numpy(device="cuda", **arrays)
    return all(torch.equal(getattr(resident.model, f.name),
                           getattr(fresh, f.name))
               for f in dataclasses.fields(fresh))


def phase_served(spec):
    from cruise_control_tpu_torch import kernels
    log("== phase 9: served cycle 100x20K, monitor -> resident model")
    pkg = port_package()
    # Unload the kernel library, as in a fresh process: warmup() must load
    # it, and a delta cycle that has to load it fails the gate below.
    kernels._LIB = None
    kernels.reset_launch_counts()
    out = served_cycle(pkg, spec, check_planes=_rebuild_equal,
                       device_ops=_device_ops)
    launches = dict(kernels.LAUNCHES)
    cold = out["cold"]
    log(f"cold cycle: {cold['update']} at epoch {cold['epoch']}, wall "
        f"{cold['wall']:.3f}s, {cold['bytes']} bytes uploaded")
    if cold["update"] != "full" or cold["epoch"] != 1:
        fail(f"cold cycle was not a full rebuild at epoch 1: {cold}")
    for i, c in enumerate(out["cycles"]):
        sp = c["spans"]
        host = sp.get("monitor.aggregate", 0.0) + (
            sp.get("monitor.model-build", 0.0)
            - sp.get("resident.update", 0.0))
        log(f"delta cycle {i}: {c['update']} epoch {c['epoch']} rows "
            f"{c['rows']} bytes {c['bytes']} wall {c['wall']:.4f}s (host "
            f"aggregate {sp.get('monitor.aggregate', 0.0):.4f}s + assembly "
            f"{sp.get('monitor.model-build', 0.0) - sp.get('resident.update', 0.0):.4f}s"
            f" = {host:.4f}s; resident update with upload and KF "
            f"{sp.get('resident.update', 0.0):.4f}s); planes {c['planes']}; "
            f"equal to a fresh upload: {c['rebuild_equal']}")
        if (c["update"] != "delta" or c["epoch"] != 1
                or c["rows"] != SERVED_CHURN_ROWS or not c["rebuild_equal"]):
            fail(f"delta cycle {i} broke the resident contract: {c}")
    # logged, not gated: in a process that profiled before, torch.profiler
    # has been seen to drop a short window's events
    ops = out["cycles"][-1]["device_ops"]
    log(f"device operations of delta cycle {len(out['cycles']) - 1} "
        f"(torch.profiler): {len(ops)} {ops}")
    log(f"kernel-library loads: {out['warmup_builds']} in warmup, "
        f"{out['builds_after_warmup']} after it")
    if out["warmup_builds"] != 1:
        fail("warmup did not load the unloaded kernel library once")
    if out["builds_after_warmup"]:
        fail(f"{out['builds_after_warmup']} library builds or loads after "
             "warmup")
    ratio = cold["bytes"] / min(c["bytes"] for c in out["cycles"])
    log(f"full/delta upload bytes {ratio:.1f}x (gate >= 10)")
    if ratio < 10.0:
        fail(f"upload ratio {ratio:.1f} < 10")
    planes = [c["planes"] for c in out["cycles"]]
    if planes != REFERENCE_SERVED_PLANES:
        fail(f"resident planes {planes} differ from the reference's "
             f"{REFERENCE_SERVED_PLANES}")
    stats = dict(before=_json_sha(out["stats_before"]),
                 after=_json_sha(out["stats_after"]))
    disk = out["stats_before"]["resources"]["DISK"]
    log(f"stats_summary before {stats['before']} (DISK avg {disk['avg']!r} "
        f"std {disk['std']!r}), after {stats['after']}")
    if stats != REFERENCE_SERVED_STATS:
        fail(f"stats_summary digests {stats} differ from the reference's "
             f"{REFERENCE_SERVED_STATS}")
    o = out["optimize"]
    log(f"optimize of the resident model (seed 1): {o['moves']} moves, "
        f"{o['proposals']} proposals, digest {o['digest']}, chain "
        f"satisfied {o['satisfied']}, audit ok {o['audit_ok']}")
    got = {k: o[k] for k in REFERENCE_SERVED_OPTIMIZE}
    if got != REFERENCE_SERVED_OPTIMIZE or not (o["satisfied"]
                                                and o["audit_ok"]):
        fail(f"optimize {o} differs from the reference's "
             f"{REFERENCE_SERVED_OPTIMIZE}")
    st, d = out["structural"], out["drain"]
    log(f"broker {SERVED_DEAD_BROKER} dies: {st['update']} at epoch "
        f"{st['epoch']} ({st['wall']:.3f}s); drain {d['moves']} moves, "
        f"{d['proposals']} proposals, {d['left']} replicas left, audit ok "
        f"{d['audit_ok']}")
    if st["update"] != "full" or st["epoch"] != 2:
        fail(f"the broker death did not rebuild at epoch 2: {st}")
    if d != REFERENCE_SERVED_DRAIN:
        fail(f"drain {d} differs from the reference's "
             f"{REFERENCE_SERVED_DRAIN}")
    log(f"served-cycle launches: {json.dumps(launches)}")
    if not launches["delta_row_scatter"] or not launches["cluster_stats"]:
        fail("the served cycle did not launch KF and KG")
    return launches


# ---------------------------------------------------------------------------
# Phases 10 and 11: the search modes and the intra-broker rebalance
# ---------------------------------------------------------------------------

def _proposals_sha(result) -> str:
    return _json_sha([p.to_json() for p in result.proposals])


def search_modes(pkg, model, md):
    """Phase 10's sequence over one package's modules (``pkg``, see
    ``port_search_package``; ``scripts/search_modes_reference.py`` passes
    the JAX package's): the per-goal sequential walk, populations of 1 and
    K (the latter twice: cold, then warm) and N branches, all seed
    ``SEARCH_SEED``. Returns what it saw; the caller gates it."""
    out = {}
    seq = pkg.optimize(pkg.optimizer(), model, md)
    out["sequential"] = dict(moves=seq.num_moves,
                             proposals=len(seq.proposals),
                             digest=_proposals_sha(seq))
    k1 = pkg.optimize(pkg.optimizer(population=1), model, md)
    out["k1"] = dict(moves=k1.num_moves, proposals=len(k1.proposals),
                     digest=_proposals_sha(k1),
                     trajectory_equal=(k1.telemetry["violationTrajectory"]
                                       == seq.telemetry[
                                           "violationTrajectory"]))
    pop_opt = pkg.optimizer(population=pkg.PopulationConfig(
        **SEARCH_POPULATION))
    walls = []
    for _ in range(2):                      # cold, then warm
        pkg.sync()
        mark = pkg.host_syncs()
        t0 = time.monotonic()
        pop = pkg.optimize(pop_opt, model, md)
        pkg.sync()
        walls.append(time.monotonic() - t0)
        syncs = pkg.host_syncs() - mark
    section = dict(pop.telemetry["population"])
    section.pop("devices")
    out["population"] = dict(section, moves=pop.num_moves,
                             proposals=len(pop.proposals),
                             digest=_proposals_sha(pop))
    out["population_walls"] = walls
    out["population_host_syncs"] = syncs
    out["population_satisfied"] = all(g.satisfied for g in pop.goal_results)
    br_opt = pkg.optimizer(branches=SEARCH_BRANCHES)
    pkg.sync()
    t0 = time.monotonic()
    br = pkg.optimize(br_opt, model, md)
    pkg.sync()
    out["branches_wall"] = time.monotonic() - t0
    stacks, winner = pkg.branch_program(br_opt, model, md)
    out["branches"] = dict(winner=winner, stacks=_sha(stacks),
                           moves=br.num_moves, proposals=len(br.proposals),
                           digest=_proposals_sha(br))
    out["branch_stacks"] = stacks.tolist()
    return out


def intra_setup(pkg, spec):
    """(model, metadata, sim, resolver): phase 4's cluster as a simulated
    Kafka cluster with ``INTRA_LOGDIRS`` on every broker, replica r of
    partition p on ``d[(p + r) % 2]``, and a resolver without per-logdir
    capacities (so each broker's DISK capacity splits evenly)."""
    sim = pkg.SimulatedKafkaCluster()
    for b in spec.brokers:
        sim.add_broker(b.broker_id, logdirs=INTRA_LOGDIRS)
    for p in spec.partitions:
        sim.add_partition(p.topic, p.partition, list(p.replicas),
                          size_mb=float(p.leader_load[3]),
                          logdir_by_broker={
                              b: INTRA_LOGDIRS[(p.partition + r) % 2]
                              for r, b in enumerate(p.replicas)})
    model, md = pkg.flatten_spec(spec)
    R = pkg.Resource
    resolver = pkg.FixedCapacityResolver(capacity=dict(zip(
        (R.CPU, R.NW_IN, R.NW_OUT, R.DISK), SERVED_CAPACITY)))
    return model, md, sim, resolver


def intra_rebalances(pkg, setup):
    """Phase 11's two calls over one package's modules on ``setup``
    (``intra_setup``'s tuple): a rebalance, then the drain of
    ``INTRA_DRAINED``. Returns what each saw."""
    model, md, sim, resolver = setup
    out = {}
    for tag, drained in (("rebalance", None), ("drain", INTRA_DRAINED)):
        pkg.sync()
        t0 = time.monotonic()
        res = pkg.intra_broker_rebalance(model, md, sim, resolver,
                                         drained_disks=drained)
        pkg.sync()
        moves = [[m.topic, m.partition, m.broker_id, m.source_logdir,
                  m.dest_logdir, m.size_mb] for m in res.moves]
        out[tag] = dict(moves=len(moves), digest=_json_sha(moves),
                        iterations=res.iterations,
                        violations=[res.capacity_violation_before,
                                    res.capacity_violation_after,
                                    res.balance_violation_before,
                                    res.balance_violation_after])
        out[tag + "_wall"] = time.monotonic() - t0
        out[tag + "_summary"] = res.goal_summary()
    return out


def port_search_package(device="cuda"):
    """``search_modes``' and ``intra_rebalances``' view of the port on
    ``device``."""
    import types

    import torch
    from cruise_control_tpu_torch import _random
    from cruise_control_tpu_torch.analyzer import (
        OptimizationOptions, PopulationConfig, SearchConfig,
        TorchGoalOptimizer, engine, goals_by_name, intra_broker_rebalance)
    from cruise_control_tpu_torch.config import FixedCapacityResolver
    from cruise_control_tpu_torch.core.resources import Resource
    from cruise_control_tpu_torch.executor import SimulatedKafkaCluster
    from cruise_control_tpu_torch.model.spec import flatten_spec
    from cruise_control_tpu_torch.parallel import (make_branched_search,
                                                   select_best_audited)

    def options():
        return OptimizationOptions(seed=SEARCH_SEED, waived_hard_goals=WAIVED)

    def branch_program(opt, model, md):
        cfg, goals, _chain, ctx, state, audit = opt._prepare(model, md,
                                                             options())
        states, viols = make_branched_search(goals, cfg, opt.branches)(
            state, ctx, _random.PRNGKey(SEARCH_SEED, device=device))
        _, best, _ = select_best_audited(
            states, viols, lambda s: opt._audit(audit, s, ctx))
        return viols.cpu().numpy(), int(best)

    return types.SimpleNamespace(
        PopulationConfig=PopulationConfig,
        optimizer=lambda **kw: TorchGoalOptimizer(
            goals=goals_by_name(GOALS), config=SearchConfig(**SEARCH_MODES),
            device=device, **kw),
        optimize=lambda opt, model, md: opt.optimize(model, md, options()),
        branch_program=branch_program,
        sync=torch.cuda.synchronize if device == "cuda" else lambda: None,
        host_syncs=lambda: engine.HOST_SYNCS,
        SimulatedKafkaCluster=SimulatedKafkaCluster, Resource=Resource,
        FixedCapacityResolver=FixedCapacityResolver,
        flatten_spec=lambda spec: flatten_spec(spec, device=device),
        intra_broker_rebalance=intra_broker_rebalance)


def phase_search_modes(model, md):
    from cruise_control_tpu_torch import kernels
    log("== phase 10: search modes 100x20K (population K=1 and K=4, "
        "branches N=4)")
    kernels.reset_launch_counts()
    out = search_modes(port_search_package(), model, md)
    launches = dict(kernels.LAUNCHES)
    seq, k1 = out["sequential"], out["k1"]
    log(f"sequential per-goal walk: {seq['moves']} moves, "
        f"{seq['proposals']} proposals, digest {seq['digest']}")
    log(f"population K=1: {k1['moves']} moves, {k1['proposals']} proposals, "
        f"digest {k1['digest']}, trajectory equal {k1['trajectory_equal']}")
    if (k1["digest"], k1["moves"]) != (seq["digest"], seq["moves"]) or \
            not k1["trajectory_equal"]:
        fail("population K=1 differs from the sequential per-goal walk")
    pop = out["population"]
    log(f"population K=4 ({SEARCH_POPULATION['objective']}): cold "
        f"{out['population_walls'][0]:.3f}s, warm "
        f"{out['population_walls'][1]:.3f}s, host syncs "
        f"{out['population_host_syncs']}; winner {pop['winner']}, ranks "
        f"{pop['paretoRanks']}, weighted {pop['weightedScores']}, moves "
        f"{pop['movesPerMember']}, perms {pop['survivorPerms']}, "
        f"acceptance {pop['perGoalAcceptance']}; {pop['proposals']} "
        f"proposals, digest {pop['digest']}; chain satisfied "
        f"{out['population_satisfied']}")
    br = out["branches"]
    log(f"branches N={SEARCH_BRANCHES}: {out['branches_wall']:.3f}s, winner "
        f"{br['winner']}, stacks {out['branch_stacks']} ({br['stacks']}), "
        f"{br['moves']} moves, {br['proposals']} proposals, digest "
        f"{br['digest']}")
    got = dict(sequential=seq, population=pop, branches=br)
    if REFERENCE_SEARCH is None:
        fail(f"no reference constants for phase 10; the port gave {got}")
    if got != REFERENCE_SEARCH:
        fail(f"phase 10 differs from the reference's {REFERENCE_SEARCH}")
    log(f"search-mode launches: {json.dumps(launches)}")
    per_optimize = SEARCH_MODES["polish_passes"] + 2
    if launches["population_select"] != 3 * per_optimize:
        fail(f"KI launched {launches['population_select']} times, want "
             f"{3 * per_optimize} (polish passes + 2 per population "
             f"optimize)")
    return launches


def phase_intra(setup):
    from cruise_control_tpu_torch import kernels
    log("== phase 11: intra-broker disk rebalance 100x20K, four logdirs")
    kernels.reset_launch_counts()
    out = intra_rebalances(port_search_package(), setup)
    launches = dict(kernels.LAUNCHES)
    for tag in ("rebalance", "drain"):
        r = out[tag]
        log(f"{tag}: {out[tag + '_wall']:.3f}s, {r['moves']} moves "
            f"(digest {r['digest']}), {r['iterations']} iterations, "
            f"violations {r['violations']}; {out[tag + '_summary']}")
    got = dict(rebalance=out["rebalance"], drain=out["drain"])
    if REFERENCE_INTRA is None:
        fail(f"no reference constants for phase 11; the port gave {got}")
    if got != REFERENCE_INTRA:
        fail(f"phase 11 differs from the reference's {REFERENCE_INTRA}")
    log(f"intra-broker launches: {json.dumps(launches)}")
    if launches["intra_broker_walk"] != 2:
        fail("the two rebalances did not launch KH once each")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the fleet control plane
# ---------------------------------------------------------------------------

def fleet_grid(pkg, topics):
    """Phase 12's trajectory grid: one ``TrajectoryScale`` per (horizon,
    quantile), per-topic factors drawn from numpy seed FLEET_FACTOR_SEED in
    [0.9, 1.6] (the same draw for either package)."""
    rng = np.random.default_rng(FLEET_FACTOR_SEED)
    grid = []
    for h in FLEET_HORIZONS:
        for q in FLEET_QUANTILES:
            f = rng.uniform(0.9, 1.6, size=len(topics))
            grid.append(pkg.TrajectoryScale(
                horizon_ms=h, quantile=q,
                factors=tuple(zip(topics, (float(x) for x in f)))))
    return grid


def _sweep_digest(summaries, key):
    return dict(digest=_json_sha(summaries),
                max_risk=[s["maxRisk"] for s in summaries],
                riskiest=[s[key] for s in summaries])


def fleet_runs(pkg, model, md, *, warm=False):
    """Phase 12's fleet sequence over one package's modules (``pkg``, see
    ``port_fleet_package``; ``scripts/fleet_reference.py`` passes the JAX
    package's): the members, a cold fleet propose (and with ``warm`` a
    second one), the N-1 sweep of every member and the trajectory sweep of
    the first FLEET_FORECAST_CLUSTERS. Returns what it saw; the caller
    gates it."""
    members = [(f"cluster-{c:02d}",
                pkg.scale_loads(model, np.float32(1.0 + 0.01 * c)), md)
               for c in range(FLEET_CLUSTERS)]
    fleet = pkg.stack(members)
    fo = pkg.fleet_optimizer()
    out = {"fleet": fleet, "engine": fo}

    def timed(fn):
        pkg.sync()
        mark = pkg.host_syncs()
        t0 = time.monotonic()
        res = fn()
        pkg.sync()
        return res, time.monotonic() - t0, pkg.host_syncs() - mark

    results, out["cold_wall"], out["cold_syncs"] = timed(
        lambda: fo.propose(fleet, pkg.fleet_options()))
    out["groups"] = fo._groups_gauge_val
    if warm:
        before = pkg.collector.snapshot()
        results, out["warm_wall"], out["warm_syncs"] = timed(
            lambda: fo.propose(fleet, pkg.fleet_options()))
        after = pkg.collector.snapshot()
        out["warm_library_events"] = (
            after["compileEvents"] + after["aotCompileEvents"]
            - before["compileEvents"] - before["aotCompileEvents"])
    out["results"] = results
    out["members"] = [[r.num_moves, len(r.proposals), _proposals_sha(r)]
                      for r in results]
    mark = pkg.kj_launches()
    n1, out["n1_wall"], _ = timed(lambda: fo.sweep_n1(fleet))
    out["n1_kj"] = pkg.kj_launches() - mark
    out["n1"] = _sweep_digest(n1, "riskiestBroker")
    out["n1_summaries"] = n1
    fleet4 = pkg.stack(members[:FLEET_FORECAST_CLUSTERS])
    grid = fleet_grid(pkg, sorted(md.topic_index))
    mark = pkg.kj_launches()
    traj, out["traj_wall"], _ = timed(
        lambda: fo.sweep_trajectories(fleet4, grid))
    out["traj_kj"] = pkg.kj_launches() - mark
    out["trajectories"] = _sweep_digest(traj, "riskiest")
    return out


def port_fleet_package(device="cuda"):
    """``fleet_runs``' view of the port on ``device``."""
    import types

    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import (OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer,
                                                   engine, goals_by_name)
    from cruise_control_tpu_torch.core.runtime_obs import default_collector
    from cruise_control_tpu_torch.fleet import FleetModel, FleetOptimizer
    from cruise_control_tpu_torch.whatif import TrajectoryScale

    def scale_loads(model, f):
        f = torch.tensor(f, dtype=torch.float32, device=model.device)
        return model.replace(leader_load=model.leader_load * f,
                             follower_load=model.follower_load * f)

    return types.SimpleNamespace(
        scale_loads=scale_loads,
        stack=lambda members: FleetModel.stack(members, device=device),
        fleet_optimizer=lambda: FleetOptimizer(TorchGoalOptimizer(
            goals=goals_by_name(GOALS), config=SearchConfig(**FLEET_SEARCH),
            device=device)),
        fleet_options=lambda: OptimizationOptions(
            seed=FLEET_SEED, skip_hard_goal_check=True),
        TrajectoryScale=TrajectoryScale, collector=default_collector(),
        sync=torch.cuda.synchronize if device == "cuda" else lambda: None,
        host_syncs=lambda: engine.HOST_SYNCS,
        kj_launches=lambda: kernels.LAUNCHES["fleet_scenario_failover"])


def _library_events(collector, before):
    after = collector.snapshot()
    return (after["compileEvents"] + after["aotCompileEvents"]
            - before["compileEvents"] - before["aotCompileEvents"])


def phase_fleet(model, md, spec):
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import engine
    log(f"== phase 12: fleet of {FLEET_CLUSTERS} x 100x20K (bench scenario "
        f"6), N-1 and trajectory sweeps, registry ticks")
    pkg = port_fleet_package()
    # Unload the kernel library, as in a fresh process: the cold propose
    # must load it once and the warm one load nothing.
    kernels._LIB = None
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = pkg.collector.snapshot()
    out = fleet_runs(pkg, model, md, warm=True)
    fleet, fo = out["fleet"], out["engine"]
    cold_events = (_library_events(pkg.collector, before)
                   - out["warm_library_events"])
    log(f"fleet propose: cold {out['cold_wall']:.3f}s ({out['cold_syncs']} "
        f"host syncs), warm {out['warm_wall']:.3f}s ({out['warm_syncs']} "
        f"host syncs), {out['groups']} group(s); library events: "
        f"{cold_events} cold, {out['warm_library_events']} warm")
    if out["groups"] != 1:
        fail(f"the fleet split into {out['groups']} groups, want 1")
    if out["warm_library_events"]:
        fail(f"the warm fleet propose built or loaded the kernel library "
             f"{out['warm_library_events']} times")
    # The sequential loop over the same members, on the card.
    opt = fo.optimizer
    torch.cuda.synchronize()
    mark = engine.HOST_SYNCS
    t0 = time.monotonic()
    seq = [opt.optimize(m.model, m.metadata, pkg.fleet_options())
           for m in fleet.members]
    torch.cuda.synchronize()
    seq_wall = time.monotonic() - t0
    log(f"sequential loop of {FLEET_CLUSTERS} optimizes: {seq_wall:.3f}s "
        f"({engine.HOST_SYNCS - mark} host syncs); fleet warm / sequential "
        f"= {out['warm_wall'] / seq_wall:.3f}")
    for m, fr, sr in zip(fleet.members, out["results"], seq):
        if ([p.to_json() for p in fr.proposals]
                != [p.to_json() for p in sr.proposals]
                or fr.num_moves != sr.num_moves
                or [g.iterations for g in fr.goal_results]
                != [g.iterations for g in sr.goal_results]):
            fail(f"fleet member {m.cluster_id} differs from its sequential "
                 f"optimize")
    log("every member equals its sequential optimize (proposals, moves, "
        "per-goal iterations)")
    log(f"members (moves, proposals, digest): {out['members']}")
    log(f"N-1 sweep of {FLEET_CLUSTERS} x {NUM_BROKERS} scenarios: "
        f"{out['n1_wall']:.3f}s, {out['n1_kj']} KJ launch(es); "
        f"{out['n1']}")
    log(f"trajectory sweep of {FLEET_FORECAST_CLUSTERS} x "
        f"{len(FLEET_HORIZONS) * len(FLEET_QUANTILES)} scenarios: "
        f"{out['traj_wall']:.3f}s, {out['traj_kj']} KJ launch(es); "
        f"{out['trajectories']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"peak device memory over propose and sweeps: {peak:.0f} MiB")
    if out["n1_kj"] != 1 or out["traj_kj"] != 1:
        fail("each fleet sweep must launch KJ exactly once")
    got = dict(members=out["members"], n1=out["n1"],
               trajectories=out["trajectories"])
    if REFERENCE_FLEET is None:
        fail(f"no reference constants for phase 12; the port gave {got}")
    if got != REFERENCE_FLEET:
        fail(f"phase 12 differs from the reference's {REFERENCE_FLEET}")
    del out, fleet, seq
    _fleet_registry_ticks(spec)
    launches = dict(kernels.LAUNCHES)
    log(f"fleet launches: {json.dumps(launches)}")
    for name in ("threefry2x32", "ordered_segment_sum", "net_broker_flow",
                 "fleet_scenario_failover"):
        if not launches[name]:
            fail(f"the fleet path did not launch {name}")
    return launches


def _fleet_registry_ticks(spec):
    """Two members on phase 9's simulated cluster under one
    ``FleetRegistry``: a cold tick, then a warm tick after a 1%-churn
    ingest. Each tick's cached results must equal a fleet propose of the
    same served models; the warm tick must load no kernel library."""
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import (SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    from cruise_control_tpu_torch.fleet import FleetModel, FleetRegistry
    served = port_package()
    clock = {"now": 0}
    registry = FleetRegistry(
        TorchGoalOptimizer(goals=goals_by_name(GOALS),
                           config=SearchConfig(**FLEET_SEARCH),
                           device="cuda"),
        now_ms=lambda: clock["now"])
    setups = {}
    for cid in ("east", "west"):
        _sim, monitor, keys, vals, ingest, now_ms = served_setup(served,
                                                                 spec)
        registry.register(cid, monitor)
        setups[cid] = (monitor, keys, vals, ingest, now_ms)

    def tick(tag, churn):
        for _cid, (_m, keys, vals, ingest, now_ms) in setups.items():
            if churn:
                vals = vals.copy()
                vals[:len(keys) // 100] += 1.0
                ingest(vals, 2)
            else:
                ingest(vals, SERVED_WINDOWS + 1)
            clock["now"] = now_ms()
        # The registry logs a failed sweep or detector run and only marks
        # its tick-error meter; a stale ``last_risk`` must not pass either.
        for cid in setups:
            registry.member(cid).last_risk = None
        errors_before = registry._tick_errors.count
        kj_before = kernels.LAUNCHES["fleet_scenario_failover"]
        before = served.collector.snapshot()
        t0 = time.monotonic()
        summary = registry.tick()
        wall = time.monotonic() - t0
        events = _library_events(served.collector, before)
        kj = kernels.LAUNCHES["fleet_scenario_failover"] - kj_before
        tick_errors = registry._tick_errors.count - errors_before
        if summary["proposed"] != 2 or summary["errors"] or tick_errors:
            fail(f"registry {tag} tick did not propose and sweep both "
                 f"members: {summary}, {tick_errors} tick error(s)")
        if kj != 1:
            fail(f"registry {tag} tick launched KJ {kj} times, want 1")
        # The propose and sweep that check the tick are not the path's:
        # their launches are taken back out of the counts.
        counts = dict(kernels.LAUNCHES)
        models = [(cid, setups[cid][0].cluster_model(clock["now"]))
                  for cid in setups]
        fleet = FleetModel.stack(
            [(cid, r.model, r.metadata, r.generation, r.stale)
             for cid, r in models], device="cuda")
        want = registry.engine.propose(fleet, registry.options)
        for (cid, _r), w in zip(models, want):
            got = registry.member(cid).cache.fast_entry()
            if got is None or _proposals_sha(got.result) != \
                    _proposals_sha(w) or got.result.num_moves != w.num_moves:
                fail(f"registry {tag} tick: {cid}'s cache differs from a "
                     f"fleet propose of its served model")
        want_risk = {r["clusterId"]: r
                     for r in registry.engine.sweep_n1(fleet)}
        for cid in setups:
            if registry.member(cid).last_risk != want_risk.get(cid):
                fail(f"registry {tag} tick: {cid}'s N-1 summary "
                     f"{registry.member(cid).last_risk} differs from a "
                     f"fleet sweep of its served model {want_risk.get(cid)}")
        kernels.LAUNCHES.update(counts)
        risks = {cid: registry.member(cid).last_risk["maxRisk"]
                 for cid in setups}
        log(f"registry {tag} tick: {wall:.3f}s, {summary}, library events "
            f"{events}, one KJ launch, no tick errors, caches and N-1 "
            f"summaries equal to a fleet propose and sweep, N-1 max risk "
            f"{risks}")
        return events

    kernels._LIB = None          # a fresh process: the cold tick loads it
    if tick("cold", churn=False) != 1:
        fail("the cold registry tick did not load the kernel library once")
    if tick("warm", churn=True):
        fail("the warm registry tick built or loaded the kernel library")


# ---------------------------------------------------------------------------
# Phase 13: the reference's default chain
# ---------------------------------------------------------------------------

#: phase 13 (a): seeds of the two default-chain optimizes of the main-path
#: cluster (goals=None: ``config/cruisecontrol.properties:96``), with the
#: main path's search and nothing waived
DEFAULT_SEEDS = (1, 1)
#: phase 13 (b): bench scale scenario 3 as the reference runs it
#: (``bench.py:42-44``, :2755-2777): goals=None, k 1,024, 16 destinations,
#: 512 swaps, drain 25,000 x 8 rounds, 512 iterations a goal, seed 0
SCALE3_SEARCH = dict(num_replica_candidates=1024, num_dest_candidates=16,
                     num_swap_candidates=512, apply_per_iter=1024,
                     drain_batch=25_000, drain_rounds=8,
                     max_iters_per_goal=512)
#: phase 13 (d): the main-path cluster in 10 broker sets with at least one
#: leader of every t1* topic on every broker, under the catalog's part-B
#: chain and then the kafka-assigner set (main path's search, seed 1,
#: nothing waived)
PARTB_SETS = 10
PARTB_CONSTRAINT = dict(topics_with_min_leaders_per_broker="t1*",
                        min_topic_leaders_per_broker=1)
PARTB_CHAIN = ["BrokerSetAwareGoal", "MinTopicLeadersPerBrokerGoal",
               "RackAwareDistributionGoal", "PreferredLeaderElectionGoal"]
PARTB_SEED = 1
#: phase 13 as the reference computes it (the JAX package on the CPU from
#: the same inputs: ``scripts/default_chain_reference.py``): (a) each
#: optimize's moves, proposals, digest, per-goal (name, iterations,
#: violation after), audit verdicts and failure (None: no
#: OptimizationFailureError); (c) the default-goal N-1 sweep's summary;
#: (d) both chains' outcomes
_REFERENCE_DEFAULT_RUN = {'moves': 18989,
                          'proposals': 13483,
                          'digest': 'd07b06fafcc18e45',
                          'goals': [['RackAwareGoal', 45, 0.0],
                                    ['MinTopicLeadersPerBrokerGoal', 0, 0.0],
                                    ['ReplicaCapacityGoal', 0, 0.0],
                                    ['DiskCapacityGoal', 0, 0.0],
                                    ['NetworkInboundCapacityGoal', 0, 0.0],
                                    ['NetworkOutboundCapacityGoal', 0, 0.0],
                                    ['CpuCapacityGoal', 0, 0.0],
                                    ['ReplicaDistributionGoal', 6, 0.0],
                                    ['PotentialNwOutGoal', 0, 0.0],
                                    ['DiskUsageDistributionGoal', 6, 0.0],
                                    ['NetworkInboundUsageDistributionGoal', 0, 0.0],
                                    ['NetworkOutboundUsageDistributionGoal', 6, 0.0],
                                    ['CpuUsageDistributionGoal', 0, 0.0],
                                    ['TopicReplicaDistributionGoal', 10, 0.0],
                                    ['LeaderReplicaDistributionGoal', 6, 0.0],
                                    ['LeaderBytesInDistributionGoal', 5, 0.0]],
                          'audit': [],
                          'failure': None}
REFERENCE_DEFAULT = [_REFERENCE_DEFAULT_RUN] * len(DEFAULT_SEEDS)
REFERENCE_DEFAULT_N1 = {'riskiest': 'loss:0',
                        'max_risk': 0.3609523809523809,
                        'violated': 100,
                        'risk4_sum': 36.1,
                        'digest': '18981659e991ecdd'}
REFERENCE_PARTB = {'partb': {'moves': 29560,
                             'proposals': 18395,
                             'digest': '5abb7ea11c42b702',
                             'goals': [['BrokerSetAwareGoal', 205, 7507.0],
                                       ['MinTopicLeadersPerBrokerGoal', 22, 7783.0],
                                       ['RackAwareDistributionGoal', 20, 13342.0],
                                       ['PreferredLeaderElectionGoal', 25, 768.0]],
                             'audit': [['ReplicaCapacityGoal', True],
                                       ['DiskCapacityGoal', True],
                                       ['NetworkInboundCapacityGoal', True],
                                       ['NetworkOutboundCapacityGoal', True],
                                       ['CpuCapacityGoal', True]],
                             'failure': 'hard goals still violated after optimization: '
                                        "['BrokerSetAwareGoal', "
                                        "'MinTopicLeadersPerBrokerGoal', "
                                        "'RackAwareDistributionGoal']"},
                   'kafka_assigner': {'moves': 14815,
                                      'proposals': 8558,
                                      'digest': '18acede2ed190e1d',
                                      'goals': [['KafkaAssignerEvenRackAwareGoal',
                                                 47,
                                                 0.0],
                                                ['KafkaAssignerDiskUsageDistributionGoal',
                                                 6,
                                                 0.0]],
                                      'audit': [['MinTopicLeadersPerBrokerGoal', False],
                                                ['ReplicaCapacityGoal', True],
                                                ['DiskCapacityGoal', True],
                                                ['NetworkInboundCapacityGoal', True],
                                                ['NetworkOutboundCapacityGoal', True],
                                                ['CpuCapacityGoal', True]],
                                      'failure': 'hard goals still violated after '
                                                 'optimization: '
                                                 "['MinTopicLeadersPerBrokerGoal'] "
                                                 '(off-chain, caught by the '
                                                 'registered-hard-goal audit: '
                                                 "['MinTopicLeadersPerBrokerGoal'])"}}


def chain_outcome(pkg, opt, model, md, options):
    """(result, summary) of one optimize; an OptimizationFailureError is
    part of the outcome (its message and the result it carries)."""
    try:
        res, failure = opt.optimize(model, md, options), None
    except pkg.OptimizationFailureError as err:
        res, failure = err.result, str(err)
    return res, dict(
        moves=res.num_moves, proposals=len(res.proposals),
        digest=_proposals_sha(res),
        goals=[[g.name, g.iterations, g.violation_after]
               for g in res.goal_results],
        audit=[[g.name, g.satisfied] for g in res.hard_goal_audit],
        failure=failure)


def default_chain_main(pkg, model, md):
    """Phase 13 (a) over one package's modules (``pkg``, see
    ``port_default_package``; ``scripts/default_chain_reference.py``
    passes the JAX package's): each optimize's outcome, and the port's
    readings (walls, results)."""
    out = dict(a=[], walls=[], results=[])
    opt = pkg.optimizer(None, None, MAIN_SEARCH)
    for seed in DEFAULT_SEEDS:
        pkg.sync()
        t0 = time.monotonic()
        res, summary = pkg.measure(lambda: chain_outcome(
            pkg, opt, model, md, pkg.options(seed=seed)))
        pkg.sync()
        out["walls"].append(time.monotonic() - t0)
        out["results"].append(res)
        out["a"].append(summary)
    return out


def default_chain_rest(pkg, model, md):
    """Phase 13 (c) and (d) over one package's modules: the default-goal
    N-1 summary and both part-B chains' outcomes on the cluster in broker
    sets, with their walls."""
    out = dict(walls={})
    engine = pkg.whatif()
    scenarios = pkg.n1_sweep(pkg.alive_broker_ids(model, md))
    t0 = time.monotonic()
    out["c"] = _summary(engine.sweep(model, md, scenarios))
    pkg.sync()
    out["walls"]["n1"] = time.monotonic() - t0
    sets_model, sets_md = pkg.flatten_spec(build_spec(broker_sets=PARTB_SETS))
    cst = pkg.BalancingConstraint(**PARTB_CONSTRAINT)
    out["d"] = {}
    for tag, names in (("partb", PARTB_CHAIN),
                       ("kafka_assigner", pkg.KAFKA_ASSIGNER_GOALS)):
        opt = pkg.optimizer(pkg.goals_by_name(names, cst), cst, MAIN_SEARCH)
        t0 = time.monotonic()
        _res, out["d"][tag] = chain_outcome(pkg, opt, sets_model, sets_md,
                                            pkg.options(seed=PARTB_SEED))
        pkg.sync()
        out["walls"][tag] = time.monotonic() - t0
    return out


def port_default_package(device="cuda"):
    """Phase 13's view of the port on ``device``; ``measure`` runs the
    first optimize plainly and counts the device launches of the second
    under ``torch.profiler``."""
    import types

    import torch
    from cruise_control_tpu_torch.analyzer import (BalancingConstraint,
                                                   OptimizationFailureError,
                                                   OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer,
                                                   goals_by_name)
    from cruise_control_tpu_torch.analyzer.goals import KAFKA_ASSIGNER_GOALS
    from cruise_control_tpu_torch.model.spec import flatten_spec
    from cruise_control_tpu_torch.whatif import (WhatIfEngine,
                                                 alive_broker_ids, n1_sweep)
    launches = []

    def measure(fn):
        if not launches:                 # the first optimize: plain
            launches.append(None)
            return fn()
        out, n = _count_device_launches(fn)
        launches.append(n)
        return out

    return types.SimpleNamespace(
        flatten_spec=lambda spec: flatten_spec(spec, device=device),
        optimizer=lambda goals, cst, search: TorchGoalOptimizer(
            goals=goals, constraint=cst, config=SearchConfig(**search),
            device=device),
        options=lambda seed: OptimizationOptions(seed=seed),
        OptimizationFailureError=OptimizationFailureError,
        BalancingConstraint=BalancingConstraint, goals_by_name=goals_by_name,
        KAFKA_ASSIGNER_GOALS=KAFKA_ASSIGNER_GOALS,
        whatif=lambda: WhatIfEngine(device=device),
        n1_sweep=n1_sweep, alive_broker_ids=alive_broker_ids,
        sync=torch.cuda.synchronize if device == "cuda" else lambda: None,
        measure=measure, launches=launches)


def _check_outcome(tag, got, want):
    log(f"{tag}: {got['moves']} moves, {got['proposals']} proposals, digest "
        f"{got['digest']}, failure {got['failure']!r}")
    for name, iters, viol in got["goals"]:
        log(f"  {name:42s} iters={iters:4d} violation after {viol!r}")
    log(f"  audit {got['audit']}")
    if got != want:
        fail(f"{tag}: the outcome differs from the reference's {want}")


def phase_default_chain(model, md, scale_model, scale_md):
    """Phase 13: the reference's default chain on the card. Returns the
    kernel launches of (a), the main path of the default chain."""
    import torch
    from cruise_control_tpu_torch import kernels
    from cruise_control_tpu_torch.analyzer import (OptimizationFailureError,
                                                   OptimizationOptions,
                                                   SearchConfig,
                                                   TorchGoalOptimizer, engine)
    log("== phase 13: the reference's default chain (goals=None, nothing "
        "waived)")
    pkg = port_default_package()
    kernels.reset_launch_counts()
    syncs0 = engine.HOST_SYNCS
    main = default_chain_main(pkg, model, md)
    syncs = engine.HOST_SYNCS - syncs0
    launches = dict(kernels.LAUNCHES)
    log(f"(a) default chain 100x20K, seeds {DEFAULT_SEEDS}: walls "
        f"{main['walls'][0]:.3f}s (plain), {main['walls'][1]:.3f}s (under "
        f"torch.profiler: {pkg.launches[1]} device launches, kernels and "
        f"copies); host syncs of both {syncs}; kernel launches of both "
        f"{json.dumps(launches)}")
    first, second = main["results"]
    if first.proposals != second.proposals:
        fail("(a) the two seed-1 default-chain runs gave different proposals")
    for i, (got, want) in enumerate(zip(main["a"], REFERENCE_DEFAULT)):
        _check_outcome(f"(a) run {i + 1}", got, want)
    missing = [k for k in ("threefry2x32", "ordered_segment_sum",
                           "net_broker_flow", "cell_net_flow")
               if not launches[k]]
    if missing:
        fail(f"(a) kernels never launched by the default chain: {missing}")
    rest = default_chain_rest(pkg, model, md)
    log(f"(c) N-1 sweep with the default goals: {rest['walls']['n1']:.3f}s")
    _check_summary("(c) N-1, default goals", rest["c"], REFERENCE_DEFAULT_N1)
    for tag in ("partb", "kafka_assigner"):
        log(f"(d) {tag}: {rest['walls'][tag]:.3f}s")
        _check_outcome(f"(d) {tag}", rest["d"][tag], REFERENCE_PARTB[tag])

    opt = TorchGoalOptimizer(config=SearchConfig(**SCALE3_SEARCH),
                             device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs0 = engine.HOST_SYNCS
    t0 = time.monotonic()
    try:
        res = opt.optimize(scale_model, scale_md, OptimizationOptions(seed=0))
    except OptimizationFailureError as err:
        fail(f"(b) scale scenario 3: {err}")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    log(f"(b) scale scenario 3, 1Kx200K, default chain: wall {wall:.3f}s, "
        f"host syncs {engine.HOST_SYNCS - syncs0}, peak mem "
        f"{_peak_mib():.1f} MiB, {res.num_moves} moves, "
        f"{len(res.proposals)} proposals")
    for g in res.goal_results:
        log(f"  {g.name:42s} {g.violation_before!r} -> "
            f"{g.violation_after!r} iters={g.iterations}")
    bad = [g.name for g in res.goal_results + res.hard_goal_audit
           if g.hard and not g.satisfied]
    worse = [g.name for g in res.goal_results
             if g.violation_after > g.violation_before * (1 + 1e-6) + 1e-6]
    if bad or worse:
        fail(f"(b) hard goals left violated {bad}; goals ended worse than "
             f"they started {worse}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.model.spec import flatten_spec

    card = phase_environment()
    phase_build()
    t0 = time.monotonic()
    spec = build_spec()
    model, md = flatten_spec(spec, device="cuda")
    arrays = model.to_numpy()
    log(f"main-path model built in {time.monotonic() - t0:.1f}s")

    scale_model, scale_md = build_flat_direct(1000, 200_000, 2, seed=42)
    from cruise_control_tpu_torch.analyzer import build_disk_state
    intra = intra_setup(port_search_package(), spec)
    intra_state, _ = build_disk_state(*intra)
    rows = phase_kernels(model, arrays, scale_model, intra_state)
    launches, seed1 = phase_main_path(model, md, arrays)
    phase_first_fit(model, md, seed1.proposals, rows)
    phase_drain(model, md)
    phase_scale(scale_model, scale_md)
    whatif_launches = phase_whatif(model, md, arrays)
    schedule_launches = phase_schedule(model, md, seed1.proposals)
    served_launches = phase_served(spec)
    search_launches = phase_search_modes(model, md)
    intra_launches = phase_intra(intra)
    fleet_launches = phase_fleet(model, md, spec)
    default_launches = phase_default_chain(model, md, scale_model, scale_md)

    # Each kernel's launches come from the run of the path it serves.
    launches.update(scenario_failover=whatif_launches["scenario_failover"],
                    first_fit=schedule_launches["first_fit"],
                    delta_row_scatter=served_launches["delta_row_scatter"],
                    cluster_stats=served_launches["cluster_stats"],
                    population_select=search_launches["population_select"],
                    intra_broker_walk=intra_launches["intra_broker_walk"],
                    fleet_scenario_failover=fleet_launches[
                        "fleet_scenario_failover"],
                    cell_net_flow=default_launches["cell_net_flow"])
    kernels_line = [dict(name=name, route="cuda", source=info["source"],
                         replaces=info["replaces"], launches=launches[name],
                         **rows[name])
                    for name, info in KERNEL_INFO.items()]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
