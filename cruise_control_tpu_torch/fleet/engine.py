"""Fleet engine: optimize and risk-score a whole fleet of clusters on one
card.

Port of ``cruise_control_tpu/fleet/engine.py``. The reference shards the
cluster axis over a device mesh (``shard_map``) and runs the unmodified
single-cluster pass functions per cluster with ``lax.map``, one compiled
program per fleet bucket. One H100 has no mesh and eager PyTorch compiles
nothing, so the port runs the members one after another through the SAME
per-goal passes the sequential optimizer runs (the chain comes from
``TorchGoalOptimizer._chain_for``, so a fleet member and a sequential
optimize of it share one chain): a member's result equals a sequential
per-goal ``optimize`` of its (fleet-bucket-padded) model, bit for bit. The
host bookkeeping — per-cluster ``enabled`` masks, the self-check, polish
rounds, the off-chain hard-goal audit, proposal diffing — is the
reference's.

The N-1 and trajectory sweeps score a ``[C, S]`` grid in one batch: one KJ
launch (``kernels.fleet_scenario_failover``) places every scenario of every
cluster, and the C·S rows score through the what-if engine's scoring body
(``whatif/engine.py:make_fleet_scenario_scorer``). Unlike the reference,
neither the cluster axis nor the scenario axis is padded for the sweeps:
padding only served XLA's compile buckets, and no summary reads a padding
row.

Not ported: the ``ProgramCache`` and ``shard_map`` (nothing is compiled),
``max_devices`` (one card).
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace

import numpy as np
import torch

from .. import _random
from ..analyzer.optimizer import (GoalResult, OptimizationFailureError,
                                  OptimizerResult)
from ..analyzer.options import OptimizationOptions
from ..analyzer.state import build_context, init_state, to_model
from ..model.fleet import FleetModel
from ..model.flat import broker_utilization
from ..model.proposals import diff_replica_arrays
from ..whatif.engine import (make_fleet_scenario_scorer, risk_scores,
                             trajectory_pscale_row, violated_matrix)

LOG = logging.getLogger(__name__)

CLUSTER_AXIS = "cluster"


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class FleetOptimizer:
    """Fleet propose/score on top of a single-cluster
    ``TorchGoalOptimizer`` (whose goals, search config, constraint,
    options generator, registered hard goals and chain cache it shares).

    Members whose scaled search config or goal binding differ cannot share
    one chain; :meth:`propose` groups members by that identity (the
    reference's dispatch groups — the degrade path for heterogeneous
    fleets). A homogeneous fleet is always one group.
    """

    def __init__(self, optimizer, *, registry=None, tracer=None,
                 collector=None) -> None:
        from ..core.runtime_obs import default_collector
        from ..core.sensors import MetricRegistry
        from ..core.tracing import default_tracer
        if getattr(optimizer, "branches", 0) and optimizer.branches > 1:
            raise ValueError(
                "fleet batching and search.branches are mutually "
                "exclusive: both own the device axis")
        if getattr(optimizer, "mesh", None) is not None:
            raise ValueError(
                "fleet batching and search.mesh.devices are mutually "
                "exclusive: the fleet shards the cluster axis, the mesh "
                "the partition axis")
        population = getattr(optimizer, "population", None)
        if population is not None and population.enabled:
            raise ValueError(
                "fleet batching and search.population are mutually "
                "exclusive: the fleet shards the cluster axis over the "
                "local devices, the population replicates per member")
        self.optimizer = optimizer
        #: the optimizer's device (the card unless it was built for the CPU)
        self.device = getattr(optimizer, "device", None)
        self.registry = registry or MetricRegistry()
        self.tracer = tracer or default_tracer()
        self.collector = collector or default_collector()
        name = MetricRegistry.name
        self._propose_timer = self.registry.timer(
            name("FleetOptimizer", "propose-timer"))
        self._dispatch_timer = self.registry.timer(
            name("FleetOptimizer", "dispatch-timer"))
        self._clusters_meter = self.registry.meter(
            name("FleetOptimizer", "clusters-proposed"))
        self._groups_gauge_val = 0
        self.registry.gauge(name("FleetOptimizer", "last-propose-groups"),
                            lambda: self._groups_gauge_val)
        #: wall clock of the most recent fleet walk or sweep
        self.last_dispatch_s: float | None = None
        #: the most recent group's (devices, clusters per device, padded
        #: clusters) layout
        self.last_layout: dict | None = None
        #: cluster-axis shape floor: lay out every batch as if it held at
        #: least this many clusters. The registry pins it to its member
        #: count. On one card it only sets the reported layout: padding
        #: slots never run a pass.
        self.cluster_bucket_floor: int = 0

    # ---------------------------------------------------------- layout
    def _layout(self, C: int) -> tuple[int, int, int]:
        """(devices D, clusters per device k, padded cluster count) for a
        C-cluster group on one card: D = 1, k = the padded count, with the
        cluster bucket floor applied first."""
        C = max(C, self.cluster_bucket_floor or 0, 1)
        self.last_layout = {"devices": 1, "clustersPerDevice": C,
                            "clustersPadded": C}
        return 1, C, C

    def _check_device(self, fleet: FleetModel) -> None:
        if fleet.device != self.device:
            raise ValueError(f"fleet lies on {fleet.device}, the optimizer "
                             f"runs on {self.device}")

    # --------------------------------------------------------- propose
    def propose(self, fleet: FleetModel,
                options: OptimizationOptions | None = None) -> list:
        """Optimize every fleet member; returns a list aligned with
        ``fleet.members`` whose entries are ``OptimizerResult``s — or
        ``OptimizationFailureError``s for members whose hard goals stay
        violated under strict options (the sequential path raises; a
        fleet propose must not let one member's failure destroy the
        others' results)."""
        self._check_device(fleet)
        options = options or OptimizationOptions()
        t0 = time.monotonic()
        C = fleet.num_clusters
        with self.collector.cycle("fleet-propose"), \
                self.tracer.span("fleet.propose", clusters=C) as sp:
            prepared = [self._prepare_member(m, options)
                        for m in fleet.members]
            groups: dict[tuple, list[int]] = {}
            for i, prep in enumerate(prepared):
                groups.setdefault(prep["group_key"], []).append(i)
            self._groups_gauge_val = len(groups)
            if len(groups) > 1:
                LOG.info(
                    "fleet propose split into %d groups (heterogeneous "
                    "search configs or goal bindings)", len(groups))
            results: list = [None] * C
            dispatch_s = 0.0
            for idxs in groups.values():
                dispatch_s += self._propose_group(prepared, idxs, results)
            self.last_dispatch_s = dispatch_s
            self._dispatch_timer.update(dispatch_s)
            sp.set(groups=len(groups),
                   dispatchMs=round(dispatch_s * 1e3, 3))
        self._propose_timer.update(time.monotonic() - t0)
        self._clusters_meter.mark(C)
        return results

    def _prepare_member(self, member, options: OptimizationOptions) -> dict:
        """Mirror of ``TorchGoalOptimizer._prepare`` for one member:
        generated options, scaled config, bound goals, audit set and
        exclusion masks — plus the group key (chain identity, masks, topic
        widths and the seed)."""
        opt = self.optimizer
        md = member.metadata
        model = member.model
        opts = options
        if opt.options_generator is not None:
            opts = opt.options_generator.generate(opts, md)
        # Tuned schedules first, then the tiny-model clamp (the sequential
        # _prepare's rule). The cfg is part of group_key, so members in
        # differently-tuned buckets split into separate groups.
        base_cfg = opt.config
        if opt.tuned_store is not None:
            base_cfg = opt.tuned_store.apply(
                base_cfg, md.num_partitions, md.num_brokers,
                regime=opt.active_regime)
        cfg = base_cfg.scaled_for(md.num_partitions, md.num_brokers)
        if opts.fast_mode:
            cfg = replace(
                cfg,
                max_iters_per_goal=max(cfg.max_iters_per_goal // 4, 16)
            ).scaled_for(max(md.num_partitions // 4, 8), md.num_brokers)
        goals = [g.bind(md) for g in opt.goals]
        audit = opt._audit_goals_for(goals, md, opts)
        Pn = model.num_partitions_padded
        B = model.num_brokers_padded
        masks = (opts.excluded_partition_mask(md, Pn),
                 opts.replica_move_exclusion_mask(md, B),
                 opts.broker_mask(md, B,
                                  opts.excluded_brokers_for_leadership))
        needs_tlc = any(g.uses_topic_leader_counts for g in goals + audit)
        needs_topics = needs_tlc or any(g.uses_topic_counts
                                        for g in goals + audit)
        num_topics = md.num_topics if needs_topics else None
        group_key = (
            cfg,
            tuple((type(g), g.name, g.hard,
                   getattr(g, "constraint", None), g.bind_signature())
                  for g in goals),
            tuple((g.name, g.bind_signature()) for g in audit),
            num_topics, needs_tlc,
            tuple(m is None for m in masks),
            # One key stream per group: an options generator varying the
            # seed per cluster must split groups.
            opts.seed)
        return {"member": member, "opts": opts, "cfg": cfg,
                "goals": goals, "audit": audit, "masks": masks,
                "num_topics": num_topics, "needs_tlc": needs_tlc,
                "group_key": group_key}

    def _member_state_ctx(self, prep):
        """Per-member search state and context — exactly the sequential
        ``_prepare``'s construction (exclusion masks included)."""
        model = prep["member"].model

        def mask(m):
            return (None if m is None
                    else torch.from_numpy(np.asarray(m)).to(self.device))
        excluded_parts, repl_mask, lead_mask = prep["masks"]
        ctx = build_context(
            model, excluded_partitions=mask(excluded_parts),
            excluded_brokers_for_replica_move=mask(repl_mask),
            excluded_brokers_for_leadership=mask(lead_mask))
        state = init_state(
            model, with_topic_counts=prep["num_topics"],
            with_topic_leader_counts=prep["needs_tlc"])
        return state, ctx

    def _propose_group(self, prepared, idxs, results) -> float:
        preps = [prepared[i] for i in idxs]
        cfg = preps[0]["cfg"]
        goals = preps[0]["goals"]
        audit = preps[0]["audit"]
        G = len(goals)
        Cg = len(idxs)
        self._layout(Cg)
        # The optimizer's chain cache is the one source of pass identity:
        # the fleet walk runs exactly the passes a sequential optimize of
        # the same member runs.
        chain = self.optimizer._chain_for(cfg, goals)
        pairs = [self._member_state_ctx(p) for p in preps]
        states = [s for s, _ in pairs]
        ctxs = [c for _, c in pairs]
        seed_key = _random.PRNGKey(preps[0]["opts"].seed, device=self.device)
        keys_main = [_random.fold_in(seed_key, i) for i in range(G)]

        t_disp = time.monotonic()
        audit_before = ([self.optimizer._audit(audit, s, c)
                         for s, c in zip(states, ctxs)] if audit else None)
        aux = [tuple(_host(a) for a in chain.aux(s, c))
               for s, c in zip(states, ctxs)]
        has_broken = np.array([bool(a[0]) for a in aux])
        scales = np.stack([a[1] for a in aux])
        v0 = np.stack([a[2] for a in aux])
        with self.tracer.span("fleet.walk", clusters=Cg, devices=1,
                              goals=G):
            iters_np, bounds_np, moves_np = self._walk(
                chain.passes, states, ctxs, np.ones((Cg, G), bool),
                keys_main, v0, np.zeros(Cg, np.int64))

        # Per-cluster trajectories/accounting, exactly the sequential
        # walk's host bookkeeping (self-check included).
        traj = [[[float(x) for x in v0[c]]] for c in range(Cg)]
        accepted = np.zeros((Cg, G), np.int64)
        #: each goal's pre-pass reading: the stack after goal i-1 (row 0
        #: the initial stack), the sequential loop's violation_before
        before = np.zeros((Cg, G))
        iters_total = iters_np.copy()
        prev_moves = np.zeros(Cg, np.int64)
        for c in range(Cg):
            cid = preps[c]["member"].cluster_id
            boundary = v0[c]
            for i, g in enumerate(goals):
                before_i = float(boundary[i])
                before[c, i] = before_i
                boundary = bounds_np[c, i]
                traj[c].append([float(x) for x in boundary])
                accepted[c, i] = moves_np[c, i] - prev_moves[c]
                prev_moves[c] = moves_np[c, i]
                after_i = float(boundary[i])
                if after_i > before_i * (1 + 1e-6) + 1e-6:
                    if has_broken[c]:
                        LOG.warning(
                            "fleet[%s]: goal %s worsened its own "
                            "violation %.6g -> %.6g while draining broken"
                            " brokers (self-check exempt)", cid, g.name,
                            before_i, after_i)
                    else:
                        raise RuntimeError(
                            f"fleet optimization self-check failed for "
                            f"cluster {cid}: goal {g.name} worsened its "
                            f"own violation {before_i:.6g} -> "
                            f"{after_i:.6g}")

        # Polish rounds — the per-goal path's semantics with per-cluster
        # enabled masks: todo is each cluster's residual goals at round
        # start, keys fold_in(key, 1000*(rnd+1)+i), and a fully-converged
        # cluster runs nothing further. `~(x <= eps)` keeps NaN residuals
        # in the todo set, like the sequential path.
        polish_eps = min(cfg.epsilon, 1e-6)
        boundary_np = bounds_np[:, -1, :].copy()        # [Cg, G]
        rounds = cfg.polish_passes + 1 if cfg.polish_passes else 0
        for rnd in range(rounds):
            enab = ~(boundary_np <= polish_eps)
            if not enab.any():
                break
            keys_rnd = [_random.fold_in(seed_key, 1000 * (rnd + 1) + i)
                        for i in range(G)]
            with self.tracer.span("fleet.polish", round=rnd,
                                  clusters=int(enab.any(axis=1).sum())):
                it2, b2, m2 = self._walk(chain.passes, states, ctxs, enab,
                                         keys_rnd, boundary_np, prev_moves)
            for c in range(Cg):
                if not enab[c].any():
                    continue       # cluster converged: no further rounds
                for i in range(G):
                    if not enab[c, i]:
                        continue
                    accepted[c, i] += m2[c, i] - prev_moves[c]
                    prev_moves[c] = m2[c, i]
                    iters_total[c, i] += it2[c, i]
                # One trajectory row per polish ROUND, the sequential
                # convention (the round-end boundary stack).
                traj[c].append([float(x) for x in b2[c, -1]])
                boundary_np[c] = b2[c, -1]
        dispatch_s = time.monotonic() - t_disp

        audit_after = None
        if audit:
            audit_before = [tuple(_host(a) for a in ab)
                            for ab in audit_before]
            audit_after = [tuple(_host(a) for a in
                                 self.optimizer._audit(audit, s, c))
                           for s, c in zip(states, ctxs)]

        walk_share = dispatch_s / max(Cg, 1)
        for c, idx in enumerate(idxs):
            results[idx] = self._finish_member(
                preps[c], states[c], goals, audit,
                None if audit_before is None else audit_before[c],
                None if audit_after is None else audit_after[c],
                before=before[c], scales=scales[c],
                boundary=boundary_np[c], iters=iters_total[c],
                accepted=accepted[c], trajectory=traj[c],
                walk_share=walk_share)
        return dispatch_s

    @staticmethod
    def _walk(passes, states, ctxs, enabled, keys, start_rows, start_moves):
        """Run the enabled goal passes of every cluster with an enabled
        goal, in goal order, cluster after cluster; ``states`` is updated
        in place. Returns host ``(iters [C, G], bounds [C, G, G], moves
        [C, G])``: a disabled goal reports 0 iterations, the previous
        stack (``start_rows[c]`` before any pass ran) and the previous
        cumulative move count — the reference's ``_skip`` branch."""
        C, G = enabled.shape
        iters = np.zeros((C, G), np.int64)
        bounds = np.repeat(np.asarray(start_rows)[:, None, :], G, axis=1)
        moves = np.repeat(np.asarray(start_moves, np.int64)[:, None], G,
                          axis=1)
        for c in np.nonzero(enabled.any(axis=1))[0]:
            state, ctx = states[c], ctxs[c]
            prev, m = bounds[c, 0].copy(), int(start_moves[c])
            for i, run in enumerate(passes):
                if enabled[c, i]:
                    state, it, stack, mv = run(state, ctx, keys[i])
                    prev, m = _host(stack), int(mv)
                    iters[c, i] = it
                bounds[c, i] = prev
                moves[c, i] = m
            states[c] = state
        return iters, bounds, moves

    def _finish_member(self, prep, state, goals, audit, audit_before,
                       audit_after, *, before, scales, boundary, iters,
                       accepted, trajectory, walk_share):
        """Per-member ``_finish``: proposal diff, audit verdicts, provision
        verdict (from a from-scratch utilization of the final model, not
        the incrementally kept ``state.util``), telemetry — and the
        hard-goal gate, returned as an ``OptimizationFailureError``
        instead of raised."""
        member = prep["member"]
        opts = prep["opts"]
        total_iters = max(int(iters.sum()), 1)
        goal_results = [GoalResult(
            name=g.name, hard=g.hard,
            violation_before=float(before[i]),
            violation_after=float(boundary[i]),
            duration_s=walk_share * int(iters[i]) / total_iters,
            iterations=int(iters[i]),
            scale=float(scales[i]),
            accepted=int(accepted[i])) for i, g in enumerate(goals)]
        audit_results = []
        if audit:
            (va, sa), (vb, _sb) = audit_after, audit_before
            audit_results = [
                GoalResult(name=g.name, hard=True,
                           violation_before=float(vb[i]),
                           violation_after=float(va[i]),
                           duration_s=0.0, iterations=0,
                           scale=float(sa[i]))
                for i, g in enumerate(audit)]
        model = member.model
        final = to_model(state, model)
        util = _host(broker_utilization(final))
        rb0, rb1 = _host(model.replica_broker), _host(final.replica_broker)
        alive = _host(final.broker_alive & final.broker_valid)
        caps = _host(final.broker_capacity)
        racks = _host(final.broker_rack)
        proposals = diff_replica_arrays(rb0, rb1, member.metadata,
                                        model.broker_sentinel)
        num_moves = int(state.moves_applied.item())
        result = OptimizerResult(
            proposals=proposals, goal_results=goal_results,
            num_moves=num_moves, duration_s=walk_share, final_model=final,
            provision_response=self.optimizer._provision_verdict_from_host(
                util, alive, caps, model.num_brokers_padded, goal_results,
                placement=lambda: (rb1, racks)),
            hard_goal_audit=audit_results,
            telemetry=self.optimizer._goal_telemetry(
                goal_results, trajectory, num_moves),
            stale_model=member.stale)
        if result.violated_hard_goals and not opts.skip_hard_goal_check:
            return OptimizationFailureError(
                f"fleet[{member.cluster_id}]: hard goals still violated "
                f"after optimization: {result.violated_hard_goals}",
                result)
        return result

    # ------------------------------------------------------- sweeps
    def _homogeneous(self, members) -> bool:
        """Whether every member binds the chain alike and has the same
        topic count (one scorer for the whole grid)."""
        binds = [tuple((g.name, g.bind_signature())
                       for g in (gg.bind(m.metadata)
                                 for gg in self.optimizer.goals))
                 for m in members]
        topics = [m.metadata.num_topics for m in members]
        return (all(b == binds[0] for b in binds)
                and all(t == topics[0] for t in topics))

    def _per_member(self, members, sweep) -> list[dict]:
        """Degrade path: heterogeneous goal bindings or topic widths
        cannot share one scorer, so each member sweeps alone
        (``sweep(one-member fleet, member index)``)."""
        out: list[dict] = []
        for i, m in enumerate(members):
            sub = FleetModel.stack([(m.cluster_id, m.model, m.metadata)],
                                   device=self.device)
            out.extend(sweep(sub, i))
        return out

    def _score_grid(self, fleet, members, dead, pscale=None):
        """Score the ``[C, S]`` grid (``dead`` bool[C, S, B], ``pscale``
        f32[C, S, P] or None for unit loads; no adds, unit capacity scale)
        with the fleet scorer. Returns host ``(goals, violated[C, S, G],
        risk[C, S], pressure[C, S])``."""
        C = len(members)
        goals = [g.bind(members[0].metadata) for g in self.optimizer.goals]
        self._layout(C)
        dev = self.device
        stacked = fleet.stacked
        # Only the varying planes travel: unit scales are broadcast views
        # made on the device (x * 1.0 is x, so they change no value).
        one = torch.ones((), device=dev)
        dead_t = torch.from_numpy(dead).to(dev)
        P = stacked.num_partitions_padded
        pscale_t = (one.expand(dead.shape[:2] + (P,)) if pscale is None
                    else torch.from_numpy(pscale).to(dev))
        self.collector.record_h2d(
            dead.nbytes + (0 if pscale is None else pscale.nbytes))
        score = make_fleet_scenario_scorer(
            goals, self.optimizer.constraint.capacity_threshold,
            num_topics=members[0].metadata.num_topics)
        pvalid = stacked.partition_valid
        out = score(stacked, dead_t, torch.zeros_like(dead_t),
                    one.expand(dead.shape + (4,)), pscale_t, pvalid)
        viol, vscale, _hr, _hf, pressure, unavailable, _n_off = (
            _host(t) for t in out)
        self.collector.record_d2h(viol.nbytes + vscale.nbytes
                                  + pressure.nbytes + unavailable.nbytes)
        hard = np.array([g.hard for g in goals], bool)
        violated = violated_matrix(viol, vscale)           # [C, S, G]
        n_hard = max(int(hard.sum()), 1)
        n_soft = max(int((~hard).sum()), 1)
        hard_frac = violated[..., hard].sum(axis=-1) / n_hard
        soft_frac = violated[..., ~hard].sum(axis=-1) / n_soft
        valid_parts = np.maximum(_host(pvalid).sum(axis=1), 1)[:, None]
        risk = risk_scores(hard_frac, soft_frac, pressure,
                           unavailable.astype(int), valid_parts)
        return goals, violated, risk, pressure

    # ------------------------------------------------------- N-1 sweep
    def sweep_n1(self, fleet: FleetModel) -> list[dict]:
        """Per-cluster N-1 resilience risk for the whole fleet in one
        batch: every alive broker of every member killed in turn, scored
        over a ``[C, S]`` grid. Returns one summary dict per member
        (maxRisk / riskiestBroker / violatedHardGoals of the riskiest
        loss, scenario count)."""
        self._check_device(fleet)
        t0 = time.monotonic()
        with self.collector.cycle("fleet-sweep"), \
                self.tracer.span("fleet.sweep-n1",
                                 clusters=fleet.num_clusters):
            out = self._sweep_n1_impl(fleet)
        self.last_dispatch_s = time.monotonic() - t0
        return out

    def _sweep_n1_impl(self, fleet: FleetModel) -> list[dict]:
        members = fleet.members
        if not self._homogeneous(members):
            return self._per_member(
                members, lambda sub, _i: self._sweep_n1_impl(sub))
        B_f = fleet.stacked.num_brokers_padded
        alive_rows = []
        for m in members:
            up = _host(m.model.broker_valid & m.model.broker_alive)
            alive_rows.append(np.nonzero(up)[0])
        C = len(members)
        S = max((len(r) for r in alive_rows), default=1) or 1
        dead = np.zeros((C, S, B_f), bool)
        for c, rows in enumerate(alive_rows):
            dead[c, np.arange(len(rows)), rows] = True
        goals, violated, risk, _pressure = self._score_grid(fleet, members,
                                                            dead)

        summaries = []
        for c, m in enumerate(members):
            rows = alive_rows[c]
            n = len(rows)
            if n == 0:
                summaries.append({"clusterId": m.cluster_id, "maxRisk": 0.0,
                                  "riskiestBroker": None, "scenarios": 0})
                continue
            r = risk[c, :n]
            worst = int(np.argmax(r))
            broker_ids = m.metadata.broker_ids
            worst_row = int(rows[worst])
            summaries.append({
                "clusterId": m.cluster_id,
                "maxRisk": round(float(r[worst]), 4),
                "riskiestBroker": (broker_ids[worst_row]
                                   if worst_row < len(broker_ids)
                                   else worst_row),
                "violatedHardGoals": [
                    g.name for g, v in zip(goals, violated[c, worst])
                    if v and g.hard],
                "scenarios": n})
        return summaries

    # ------------------------------------------------- trajectory sweep
    def sweep_trajectories(self, fleet: FleetModel, trajectories
                           ) -> list[dict]:
        """Forecast trajectory sweep across the whole fleet in one batch:
        the ``[S]`` projected-load scenario axis composed with the ``[C]``
        cluster axis, scored by the same scorer as the N-1 sweep.

        ``trajectories`` is either one scenario list (every member scores
        the same horizon/quantile grid, factors resolved against each
        member's own topics) or ``{cluster_id: [scenarios]}`` with equal
        lengths. Returns one summary per member with per-scenario
        risk/pressure rows."""
        self._check_device(fleet)
        t0 = time.monotonic()
        with self.collector.cycle("fleet-forecast"), \
                self.tracer.span("fleet.sweep-trajectories",
                                 clusters=fleet.num_clusters):
            out = self._sweep_trajectories_impl(fleet, trajectories)
        self.last_dispatch_s = time.monotonic() - t0
        return out

    def _sweep_trajectories_impl(self, fleet: FleetModel, trajectories
                                 ) -> list[dict]:
        members = fleet.members
        C = len(members)
        if isinstance(trajectories, dict):
            missing = [m.cluster_id for m in members
                       if m.cluster_id not in trajectories]
            if missing:
                raise ValueError(
                    f"sweep_trajectories: no trajectory grid for fleet "
                    f"member(s) {missing}; the per-cluster dict form "
                    f"must cover every member")
            per_member = [trajectories[m.cluster_id] for m in members]
        else:
            per_member = [list(trajectories)] * C
        if not per_member or not per_member[0]:
            raise ValueError("sweep_trajectories requires at least one "
                             "scenario")
        S = len(per_member[0])
        if any(len(t) != S for t in per_member):
            raise ValueError(
                "every member must score the same scenario count (one "
                "[C, S] grid); pad shorter trajectories with no-op "
                "scenarios")
        if not self._homogeneous(members):
            return self._per_member(
                members, lambda sub, i: self._sweep_trajectories_impl(
                    sub, per_member[i]))
        B_f = fleet.stacked.num_brokers_padded
        P_f = fleet.stacked.num_partitions_padded
        # Per-(cluster, scenario) load-scale planes: each member's factors
        # resolve against its OWN topic ids.
        pscale = np.ones((C, S, P_f), np.float32)
        for c, (m, traj) in enumerate(zip(members, per_member)):
            ptopic = _host(m.model.partition_topic)
            for s, scn in enumerate(traj):
                pscale[c, s] = trajectory_pscale_row(
                    scn, m.metadata.topic_index, ptopic)
        dead = np.zeros((C, S, B_f), bool)
        goals, violated, risk, pressure = self._score_grid(
            fleet, members, dead, pscale)

        summaries = []
        for c, (m, traj) in enumerate(zip(members, per_member)):
            rows = [{"scenario": scn.name,
                     "horizonMs": scn.horizon_ms,
                     "quantile": scn.quantile,
                     "risk": round(float(risk[c, s]), 4),
                     "capacityPressure": round(float(pressure[c, s]), 4),
                     "violatedHardGoals": [
                         g.name for g, v in zip(goals, violated[c, s])
                         if v and g.hard]}
                    for s, scn in enumerate(traj)]
            worst = max(range(S), key=lambda s: risk[c, s])
            summaries.append({"clusterId": m.cluster_id,
                              "maxRisk": round(float(risk[c, worst]), 4),
                              "riskiest": traj[worst].name,
                              "scenarios": rows})
        return summaries
