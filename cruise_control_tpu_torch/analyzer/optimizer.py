"""Host-side optimizer orchestration (ref ``analyzer/GoalOptimizer.java``).

Port of ``cruise_control_tpu/analyzer/optimizer.py``.
``TorchGoalOptimizer.optimize`` runs the goal chain in priority order (the
per-goal walk or the ``fused_chain`` walk — identical moves, different
polish key streams, as in the reference), polishes goals that later passes
drifted, audits the registered hard goals that are not in the chain, and
diffs initial vs final placement into execution proposals. Two search
modes replace the single walk: a population of K candidate plans scored
jointly (``population=``, :mod:`..parallel.population`) and best-of-N
independent branches (``branches=``, :mod:`..parallel.branches`); a
``tuned_store`` supplies per-shape-bucket schedules (:mod:`.tuning`).

A device mesh is one device (``parallel.sharding``, the mesh-less path): a
one-device mesh runs the plain path and a wider one raises
``NotImplementedError`` naming ROADMAP queue 2 K15. Left out: the tracer,
device collector and sensor hooks;
``duration_s`` fields come from ``time.monotonic()``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import _random
from ..kernels import ViolationTable, violation_rows
from ..model.flat import FlatClusterModel, broker_utilization
from ..model.proposals import ExecutionProposal, diff_proposals, proposal_summary
from ..model.spec import ClusterMetadata
from ..utils.device import resolve_device
from .constraint import BalancingConstraint, PopulationConfig, SearchConfig
from .engine import CompiledGoalChain, read_host
from .goals import (DEFAULT_GOALS, HARD_GOAL_ALTERNATIVES, GoalKernel,
                    default_goals, goals_by_name)
from .options import OptimizationOptions
from .state import build_context, init_state, to_model


@dataclass
class GoalResult:
    name: str
    hard: bool
    violation_before: float
    violation_after: float
    duration_s: float
    iterations: int
    #: magnitude the goal's float32 penalty sums reduce over (0 for
    #: integer-count goals)
    scale: float = 0.0
    #: candidate actions this goal's pass applied
    accepted: int = 0

    @property
    def satisfied(self) -> bool:
        # Ulp-aware cutoff (see the reference's GoalResult.satisfied).
        return self.violation_after <= 1e-6 + 1e-6 * self.scale

    def to_json(self) -> dict:
        return {"goal": self.name, "hard": self.hard,
                "violationBefore": self.violation_before,
                "violationAfter": self.violation_after,
                "optimizationDurationMs": round(self.duration_s * 1e3, 3),
                "iterations": self.iterations,
                "acceptedMoves": self.accepted,
                "status": "NO-ACTION" if self.violation_before <= 1e-6
                else ("FIXED" if self.satisfied else "VIOLATED")}


@dataclass
class OptimizerResult:
    """Proposals + per-goal stats + the off-chain hard-goal audit +
    provision verdict (ref ``analyzer/OptimizerResult.java``)."""

    proposals: list[ExecutionProposal]
    goal_results: list[GoalResult]
    num_moves: int
    duration_s: float
    final_model: FlatClusterModel
    provision_response: object | None = None   # detector.ProvisionResponse
    #: post-optimization audit of registered hard goals NOT in the chain
    hard_goal_audit: list[GoalResult] = field(default_factory=list)
    #: per-goal iteration/acceptance counts and the violation trajectory
    telemetry: dict | None = None
    stale_model: bool = False

    @property
    def violated_goals_before(self) -> list[str]:
        return [g.name for g in self.goal_results if g.violation_before > 1e-6]

    @property
    def violated_goals_after(self) -> list[str]:
        return [g.name for g in self.goal_results if not g.satisfied]

    @property
    def violated_hard_goals(self) -> list[str]:
        return ([g.name for g in self.goal_results
                 if g.hard and not g.satisfied]
                + [g.name for g in self.hard_goal_audit
                   if not g.satisfied])

    def to_json(self) -> dict:
        summary = proposal_summary(self.proposals)
        summary["numActions"] = self.num_moves
        return {"summary": summary,
                "goalSummary": [g.to_json() for g in self.goal_results],
                "hardGoalAudit": [g.to_json()
                                  for g in self.hard_goal_audit],
                "violatedGoalsBefore": self.violated_goals_before,
                "violatedGoalsAfter": self.violated_goals_after,
                "proposals": [p.to_json() for p in self.proposals],
                "optimizationDurationMs": round(self.duration_s * 1e3, 3),
                "searchTelemetry": self.telemetry,
                "provisionResponse": (None if self.provision_response is None
                                      else self.provision_response.to_json())}


class OptimizationFailureError(RuntimeError):
    """A hard goal remains violated (ref OptimizationFailureException)."""

    def __init__(self, message: str, result: OptimizerResult):
        super().__init__(message)
        self.result = result


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class TorchGoalOptimizer:
    """Runs goal chains on one device. ``device=None`` means the card and
    raises when CUDA is absent; ``device="cpu"`` runs the plain twins."""

    def __init__(self, goals: list[GoalKernel] | None = None,
                 constraint: BalancingConstraint | None = None,
                 config: SearchConfig | None = None,
                 options_generator=None,
                 hard_goal_names: list[str] | None = None,
                 population: "PopulationConfig | int | None" = None,
                 branches: int = 0,
                 mesh=None,
                 tuned_store=None,
                 device=None,
                 goal_loop: str = "auto"):
        self.device = resolve_device(device)
        #: "auto": the goal passes run as CUDA graphs on the card
        #: (``analyzer/graph_loop.py``) and as host loops on the CPU;
        #: "host": host loops on the card too — the graphs' plain twin, for
        #: comparison only
        self.goal_loop = goal_loop
        self.constraint = constraint or BalancingConstraint()
        self.goals = goals if goals is not None else default_goals(self.constraint)
        self.config = config or SearchConfig()
        #: per-shape-bucket tuned SearchConfig overrides (``tuning.
        #: TunedConfigStore``), applied in ``_prepare`` before ``scaled_for``
        self.tuned_store = tuned_store
        #: the active traffic regime qualifying the tuned-store lookup (None
        #: until the workload plane is ported)
        self.active_regime: str | None = None
        #: population search over K candidate plans (0 = off); member 0
        #: anchors the sequential schedule. Exclusive with branches and a
        #: mesh (all three own the device axis) and with the fused chain
        #: (its polish rounds take the per-goal key schedule).
        if population is None:
            population = PopulationConfig()
        elif isinstance(population, int):
            population = PopulationConfig(size=population)
        self.population = population
        if self.population.enabled:
            if self.population.objective not in ("weighted", "pareto"):
                raise ValueError(
                    f"unknown population objective "
                    f"{self.population.objective!r}: expected 'weighted' "
                    "or 'pareto'")
            if branches and int(branches) > 1:
                raise ValueError(
                    "search.population and search.branches are mutually "
                    "exclusive: both replicate the model per device "
                    "(the population IS the generalized branch pool)")
            if mesh is not None:
                raise ValueError(
                    "search.population and search.mesh.devices are "
                    "mutually exclusive: the population replicates the "
                    "model per member, the mesh shards it")
            if self.config.fused_chain:
                raise ValueError(
                    "search.population and search.fused.chain are "
                    "mutually exclusive: the population program IS one "
                    "fused dispatch already, and its polish rounds use "
                    "the per-goal key schedule — running it against the "
                    "fused sequential path would break the K=1 "
                    "bit-parity anchor guarantee (docs/search.md)")
        #: the last population optimize's joint-scoring snapshot
        self.last_population_stats: dict | None = None
        #: best-of-N independent branches (0/1 = one walk)
        self.branches = int(branches or 0)
        if self.branches > 1 and mesh is not None:
            raise ValueError("search.branches and search.mesh.devices are "
                             "mutually exclusive: branches replicate the "
                             "model per device, the mesh shards it")
        if mesh is not None:
            # The mesh-less sharding path: a one-device mesh runs the plain
            # path; anything wider raises naming K15.
            from ..parallel.sharding import check_one_device
            if check_one_device(mesh).device != self.device:
                raise ValueError(f"the mesh lies on {mesh.device}, the "
                                 f"optimizer runs on {self.device}")
        #: the one-device mesh (``parallel.sharding.make_mesh``) or None
        self.mesh = mesh
        self.options_generator = options_generator
        #: the registered hard-goal set for the post-optimization audit
        #: (None = the default catalog's hard members)
        self.hard_goal_names = hard_goal_names
        self._chains: dict = {}

    def _chain_for(self, cfg: SearchConfig, goals: list[GoalKernel]
                   ) -> CompiledGoalChain:
        key = (cfg, tuple((type(g), g.name, g.hard,
                           getattr(g, "constraint", None),
                           g.bind_signature()) for g in goals))
        chain = self._chains.get(key)
        if chain is None:
            chain = self._chains[key] = CompiledGoalChain(
                goals, cfg, loop=self.goal_loop)
            while len(self._chains) > 16:
                self._chains.pop(next(iter(self._chains)))
        return chain

    def _prepare(self, model: FlatClusterModel, metadata: ClusterMetadata,
                 options: OptimizationOptions):
        """Scaled config, bound goals, chain, audit set, search context
        (with the request's exclusion masks) and initial state."""
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, the optimizer "
                             f"runs on {self.device}")
        if self.options_generator is not None:
            options = self.options_generator.generate(options, metadata)
        P = model.num_partitions_padded
        B = model.num_brokers_padded
        # The tuned schedule first, then the tiny-model clamp: one tuned
        # config per shape bucket means one scaled config for the bucket.
        base_cfg = self.config
        if self.tuned_store is not None:
            base_cfg = self.tuned_store.apply(
                base_cfg, metadata.num_partitions, metadata.num_brokers,
                regime=self.active_regime)
        cfg = base_cfg.scaled_for(metadata.num_partitions,
                                  metadata.num_brokers)
        if options.fast_mode:
            cfg = replace(
                cfg,
                max_iters_per_goal=max(cfg.max_iters_per_goal // 4, 16)
            ).scaled_for(max(metadata.num_partitions // 4, 8),
                         metadata.num_brokers)
        goals = [g.bind(metadata) for g in self.goals]
        chain = self._chain_for(cfg, goals)
        audit = self._audit_goals_for(goals, metadata, options)

        def mask(m):
            return (None if m is None
                    else torch.from_numpy(np.asarray(m)).to(self.device))
        ctx = build_context(
            model,
            excluded_partitions=mask(options.excluded_partition_mask(
                metadata, P)),
            excluded_brokers_for_replica_move=mask(
                options.replica_move_exclusion_mask(metadata, B)),
            excluded_brokers_for_leadership=mask(options.broker_mask(
                metadata, B, options.excluded_brokers_for_leadership)))

        needs_tlc = any(g.uses_topic_leader_counts for g in goals + audit)
        needs_topics = needs_tlc or any(g.uses_topic_counts
                                        for g in goals + audit)
        state = init_state(
            model,
            with_topic_counts=metadata.num_topics if needs_topics else None,
            with_topic_leader_counts=needs_tlc)
        return (cfg, goals, chain, ctx, state,
                ViolationTable(audit) if audit else None)

    def _audit_goals_for(self, chain_goals, metadata,
                         options: OptimizationOptions):
        """Registered hard goals NOT in the chain, bound to this model — the
        post-optimization audit set. Goals are filtered by name (waivers,
        the chain and its documented alternatives) before any is built."""
        if options.skip_hard_goal_check:
            return []
        in_chain = {g.name for g in chain_goals}
        names = (self.hard_goal_names if self.hard_goal_names is not None
                 else [n for n, hard in DEFAULT_GOALS if hard])
        keep = [n for n in names
                if n not in in_chain
                and n not in options.waived_hard_goals
                and not any(a in in_chain
                            for a in HARD_GOAL_ALTERNATIVES.get(n, ()))]
        return [g.bind(metadata) for g in goals_by_name(keep, self.constraint)]

    @staticmethod
    def _audit(audit: ViolationTable, state, ctx):
        """(f32[A] violations, f32[A] scales) over the audit goals: one KX
        launch over their table (built once an optimize)."""
        return violation_rows(audit, state, ctx, True)

    def warmup(self, model: FlatClusterModel, metadata: ClusterMetadata,
               options: OptimizationOptions | None = None) -> None:
        """Nothing is compiled ahead of time; kept for API parity."""
        return None

    def optimize(self, model: FlatClusterModel, metadata: ClusterMetadata,
                 options: OptimizationOptions | None = None,
                 on_goal_start=None) -> OptimizerResult:
        """``on_goal_start(goal_name)``: optional progress hook invoked as
        each goal pass begins."""
        options = options or OptimizationOptions()
        t0 = time.monotonic()
        cfg, goals, chain, ctx, state, audit = self._prepare(
            model, metadata, options)
        key = _random.PRNGKey(options.seed, device=self.device)
        audit_before = self._audit(audit, state, ctx) if audit else None
        if self.population.enabled:
            return self._optimize_population(
                model, metadata, options, cfg, goals, chain, ctx, state, key,
                t0, on_goal_start, audit, audit_before)
        if self.branches > 1:
            return self._optimize_branched(
                model, metadata, options, cfg, goals, chain, ctx, state, key,
                t0, on_goal_start, audit, audit_before)

        if cfg.fused_chain:
            # One walk over the whole chain; per-goal wall-clock is
            # attributed proportionally to iteration counts.
            if on_goal_start is not None:
                on_goal_start(f"FusedChain[{len(goals)}]")
            t_walk = time.monotonic()
            state, (has_broken_raw, scales_arr, v0), iters_np, bounds_np, \
                moves_np = chain.fused(state, ctx, key)
            iters_l = [int(x) for x in iters_np]
            walk_s = time.monotonic() - t_walk
            total_iters = max(sum(iters_l), 1)
            durations = [walk_s * it / total_iters for it in iters_l]
            fetched = list(zip(iters_l, bounds_np, moves_np))
        else:
            has_broken_raw, scales_arr, v0 = (
                _host(a) for a in chain.aux(state, ctx))
            fetched, durations = [], []
            for i, goal in enumerate(goals):
                if on_goal_start is not None:
                    on_goal_start(goal.name)
                tp = time.monotonic()
                state, iters, stack, moves = chain.passes[i](
                    state, ctx, _random.fold(key, i))
                fetched.append(tuple(read_host(iters, stack, moves)))
                durations.append(time.monotonic() - tp)

        # ref AbstractGoal.java:110-119: the "never worsen" assertion only
        # runs when no broker is broken (a dead-broker drain's must-moves may
        # legitimately worsen a goal's own residual).
        has_broken = bool(has_broken_raw)
        scales = [float(s) for s in scales_arr]
        goal_results: list[GoalResult] = []
        boundary = np.asarray(v0)
        trajectory: list[list[float]] = [[float(x) for x in boundary]]
        prev_moves = 0
        for i, (goal, (iters, stack, moves)) in enumerate(zip(goals,
                                                              fetched)):
            before_i = float(boundary[i])
            boundary = np.asarray(stack)
            trajectory.append([float(x) for x in boundary])
            accepted_i = int(moves) - prev_moves
            prev_moves = int(moves)
            after_i = float(boundary[i])
            if after_i > before_i * (1 + 1e-6) + 1e-6:
                if has_broken:
                    logging.getLogger(__name__).warning(
                        "goal %s worsened its own violation %.6g -> %.6g "
                        "while draining broken brokers (self-check exempt, "
                        "ref AbstractGoal brokenBrokers guard)",
                        goal.name, before_i, after_i)
                else:
                    raise RuntimeError(
                        f"optimization self-check failed: goal {goal.name} "
                        f"worsened its own violation {before_i:.6g} -> "
                        f"{after_i:.6g}")
            goal_results.append(GoalResult(
                name=goal.name, hard=goal.hard,
                violation_before=before_i,
                violation_after=after_i,
                duration_s=durations[i],
                iterations=int(iters),
                scale=scales[i],
                accepted=accepted_i))

        # Polish passes re-run goals that later passes drifted (fused: the
        # whole chain under fold_in(key, 50_000 + rnd); per-goal: only the
        # unconverged goals under fold_in(key, 1000 * (rnd + 1) + i)). The
        # +1 round is the catch-up sweep for drift created in the last
        # budgeted round.
        polish_eps = min(cfg.epsilon, 1e-6)
        moves_total = prev_moves
        for rnd in range(cfg.polish_passes + 1 if cfg.polish_passes else 0):
            if (boundary <= polish_eps).all():
                break
            if cfg.fused_chain:
                tp0 = time.monotonic()
                state, _aux2, it2, b2, m2 = chain.fused(
                    state, ctx, _random.fold(key, 50_000 + rnd))
                it2 = [int(x) for x in it2]
                w = time.monotonic() - tp0
                tot = max(sum(it2), 1)
                boundary = np.asarray(b2[-1])
                trajectory.append([float(x) for x in boundary])
                prev = moves_total
                for i, gr in enumerate(goal_results):
                    acc = int(m2[i]) - prev
                    prev = int(m2[i])
                    goal_results[i] = replace(
                        gr,
                        duration_s=gr.duration_s + w * it2[i] / tot,
                        iterations=gr.iterations + it2[i],
                        accepted=gr.accepted + acc)
                moves_total = prev
                continue
            todo = [i for i in range(len(goals))
                    if not (boundary[i] <= polish_eps)]
            for i in todo:
                tp = time.monotonic()
                state, iters, stack, moves = chain.passes[i](
                    state, ctx, _random.fold(key, 1000 * (rnd + 1) + i))
                iters, boundary, moves = read_host(iters, stack, moves)
                gr = goal_results[i]
                acc = int(moves) - moves_total
                moves_total = int(moves)
                goal_results[i] = replace(
                    gr, violation_after=float(boundary[i]),
                    duration_s=gr.duration_s + time.monotonic() - tp,
                    iterations=gr.iterations + int(iters),
                    accepted=gr.accepted + acc)
            trajectory.append([float(x) for x in boundary])

        goal_results = [replace(gr, violation_after=float(boundary[i]))
                        for i, gr in enumerate(goal_results)]
        return self._finish(model, metadata, options, state, goal_results,
                            t0, ctx, audit, audit_before,
                            trajectory=trajectory)

    def _optimize_population(self, model, metadata, options, cfg, goals,
                             chain, ctx, state, key, t0, on_goal_start,
                             audit=None, audit_before=None):
        """Population search (:mod:`..parallel.population`): K plans walk
        the chain under their own streams, each polish generation starts
        with joint scoring and truncation selection (KI), and the served
        plan is the multi-objective winner, hard-goal audit verdicts
        dominating. Member 0 anchors the sequential schedule."""
        from ..parallel.population import (make_population_search,
                                           population_layout, select_plan)
        D, _k, K = population_layout(self.population.size)
        if on_goal_start is not None:
            on_goal_start(f"PopulationSearch[{len(goals)}x{K}]")
        t_walk = time.monotonic()
        run = make_population_search(chain.passes, goals, cfg,
                                     self.population)
        (states, aux, iters_np, wb_np, pr_np, mv_np, acc_np, perm_np,
         ranks, weighted) = run(state, ctx, key)
        has_broken_raw, scales_arr, v0 = (_host(a) for a in aux)
        rank_np, w_np = _host(ranks), _host(weighted)
        boundary_np = pr_np[-1] if len(pr_np) else wb_np[:, -1, :]
        state, best, _vbest = select_plan(
            states, boundary_np, mv_np, rank_np, w_np, self.population,
            audit_eval=(None if not audit
                        else lambda s: self._audit(audit, s, ctx)))
        walk_s = time.monotonic() - t_walk

        has_broken = bool(has_broken_raw)
        logger = logging.getLogger(__name__)
        # Per-lineage self-check over the walk boundaries (ref
        # AbstractGoal.java:110-119), with the broken-broker exemption.
        for m in range(K):
            boundary = v0
            for i, g in enumerate(goals):
                before_i = float(boundary[i])
                boundary = wb_np[m, i]
                after_i = float(boundary[i])
                if after_i > before_i * (1 + 1e-6) + 1e-6:
                    if has_broken:
                        logger.warning(
                            "population[%d]: goal %s worsened its own "
                            "violation %.6g -> %.6g while draining broken "
                            "brokers (self-check exempt)", m, g.name,
                            before_i, after_i)
                    else:
                        raise RuntimeError(
                            f"optimization self-check failed: population "
                            f"member {m}, goal {g.name} worsened its own "
                            f"violation {before_i:.6g} -> {after_i:.6g}")

        # The winner's lineage, in the sequential bookkeeping.
        scales = [float(s) for s in scales_arr]
        total_iters = max(int(iters_np[best].sum()), 1)
        goal_results: list[GoalResult] = []
        for i, goal in enumerate(goals):
            before_i = float((v0 if i == 0 else wb_np[best, i - 1])[i])
            goal_results.append(GoalResult(
                name=goal.name, hard=goal.hard,
                violation_before=before_i,
                violation_after=float(boundary_np[best][i]),
                duration_s=walk_s * int(iters_np[best, i]) / total_iters,
                iterations=int(iters_np[best, i]),
                scale=scales[i],
                accepted=int(acc_np[best, i])))

        # Trajectory, sequential convention: the initial stack, the G walk
        # boundaries, then one row per polish round that ran (a round that
        # starts converged is the host loop's ``break``).
        polish_eps = min(cfg.epsilon, 1e-6)
        trajectory = [[float(x) for x in v0]]
        trajectory += [[float(x) for x in wb_np[best, i]]
                       for i in range(len(goals))]
        prev_row = wb_np[best, -1]
        for r in range(len(pr_np)):
            if (prev_row <= polish_eps).all():
                break
            prev_row = pr_np[r, best]
            trajectory.append([float(x) for x in prev_row])

        pop_stats = {
            "size": K,
            "requested": self.population.size,
            "devices": D,
            "objective": self.population.objective,
            "winner": int(best),
            "winnerIsAnchor": bool(best == 0),
            "paretoFrontSize": int((rank_np == 0).sum()),
            "paretoRanks": [int(x) for x in rank_np],
            "weightedScores": [round(float(x), 6) for x in w_np],
            "movesPerMember": [int(x) for x in mv_np],
            "perGoalAcceptance": acc_np.tolist(),
            "survivorPerms": perm_np.tolist(),
        }
        self.last_population_stats = pop_stats
        return self._finish(model, metadata, options, state, goal_results,
                            t0, ctx, audit, audit_before,
                            trajectory=trajectory,
                            extra_telemetry={"population": pop_stats})

    def _optimize_branched(self, model, metadata, options, cfg, goals, chain,
                           ctx, state, key, t0, on_goal_start, audit=None,
                           audit_before=None):
        """Best-of-N independent branches (:mod:`..parallel.branches`):
        each runs the full chain under its own stream and the
        lexicographically best final state is served (the audit dominating
        when there is one). Per-goal iterations are not reported (0) and
        there is no polish, as in the reference's one-program walk."""
        from ..parallel.branches import (make_branched_search, select_best,
                                         select_best_audited)
        if on_goal_start is not None:
            on_goal_start(f"BranchedChain[{len(goals)}x{self.branches}]")
        aux = chain.aux(state, ctx)
        t_walk = time.monotonic()
        run = make_branched_search(goals, cfg, self.branches, chain=chain)
        states, viols = run(state, ctx, key)
        if audit:
            state, best_idx, vbest = select_best_audited(
                states, viols, lambda s: self._audit(audit, s, ctx))
        else:
            state, best_idx, vbest = select_best(states, viols)
        walk_s = time.monotonic() - t_walk
        _has_broken, scales_arr, v0 = (_host(a) for a in aux)
        logging.getLogger(__name__).info(
            "branched search: %d branches, winner %d, %.2fs", self.branches,
            best_idx, walk_s)
        per = walk_s / max(len(goals), 1)
        # No per-goal self-check: one walk per branch exposes no per-goal
        # boundaries, and the initial-vs-final comparison would flag legal
        # later-goal drift.
        goal_results = [GoalResult(
            name=goal.name, hard=goal.hard,
            violation_before=float(v0[i]),
            violation_after=float(vbest[i]), duration_s=per,
            iterations=0, scale=float(scales_arr[i]))
            for i, goal in enumerate(goals)]
        return self._finish(model, metadata, options, state, goal_results,
                            t0, ctx, audit, audit_before)

    def _finish(self, model, metadata, options, state, goal_results, t0,
                ctx=None, audit=None, audit_before=None, trajectory=None,
                extra_telemetry=None):
        audit_results: list[GoalResult] = []
        if audit:
            t_a = time.monotonic()
            v_after, scales = (_host(a) for a in self._audit(audit, state,
                                                             ctx))
            v_before = _host(audit_before[0])
            audit_s = (time.monotonic() - t_a) / max(audit.n, 1)
            audit_results = [
                GoalResult(name=g.name, hard=True,
                           violation_before=float(v_before[i]),
                           violation_after=float(v_after[i]),
                           duration_s=audit_s, iterations=0,
                           scale=float(scales[i]))
                for i, g in enumerate(audit.goals)]
        final = to_model(state, model)
        proposals = diff_proposals(model, final, metadata)
        num_moves = int(state.moves_applied.item())
        duration_s = time.monotonic() - t0
        result = OptimizerResult(
            proposals=proposals, goal_results=goal_results,
            num_moves=num_moves,
            duration_s=duration_s, final_model=final,
            provision_response=self._provision_verdict(final, goal_results),
            hard_goal_audit=audit_results,
            telemetry=self._goal_telemetry(goal_results, trajectory,
                                           num_moves, extra_telemetry))
        if result.violated_hard_goals and not options.skip_hard_goal_check:
            in_chain = {g.name for g in goal_results
                        if g.hard and not g.satisfied}
            audited = [n for n in result.violated_hard_goals
                       if n not in in_chain]
            detail = (f" (off-chain, caught by the registered-hard-goal "
                      f"audit: {audited})" if audited else "")
            raise OptimizationFailureError(
                f"hard goals still violated after optimization: "
                f"{result.violated_hard_goals}{detail}", result)
        return result

    @staticmethod
    def _goal_telemetry(goal_results, trajectory, num_moves,
                        extra=None) -> dict | None:
        """Per-goal counts and the violation trajectory; None for a path
        whose goal boundaries are unobservable (the branched walk).
        ``extra`` merges path-specific sections (the population's)."""
        if trajectory is None:
            return None
        telemetry = {
            "perGoal": [{"goal": g.name,
                         "iterations": g.iterations,
                         "accepted": g.accepted,
                         "violationBefore": g.violation_before,
                         "violationAfter": g.violation_after,
                         "durationMs": round(g.duration_s * 1e3, 3)}
                        for g in goal_results],
            "violationTrajectory": [[round(x, 6) for x in row]
                                    for row in trajectory],
            "totalMoves": num_moves,
        }
        telemetry.update(extra or {})
        return telemetry

    def _provision_verdict(self, final: FlatClusterModel,
                           goal_results: list[GoalResult]):
        """Under/over-provisioning verdict (ref CapacityGoal /
        ResourceDistributionGoal attaching ProvisionRecommendation)."""
        util = _host(broker_utilization(final))
        alive = _host(final.broker_alive & final.broker_valid)
        caps = _host(final.broker_capacity)

        def placement():
            return _host(final.replica_broker), _host(final.broker_rack)
        return self._provision_verdict_from_host(
            util, alive, caps, final.num_brokers_padded, goal_results,
            placement=placement)

    def _provision_verdict_from_host(self, util, alive, caps, B,
                                     goal_results, *, placement):
        """Host half of :meth:`_provision_verdict` on fetched arrays;
        ``placement`` is a lazy ``() -> (replica_broker, broker_rack)``."""
        from ..core.resources import RESOURCE_NAMES, Resource
        from ..detector.provisioner import (ProvisionRecommendation,
                                            ProvisionResponse,
                                            ProvisionStatus)
        cst = self.constraint
        response = ProvisionResponse()

        def _headroom(total: float, usable_total: float) -> dict:
            return {"demand": round(total, 3),
                    "usableCapacity": round(usable_total, 3),
                    "headroomPct": round(
                        100.0 * (1.0 - total / max(usable_total, 1e-9)),
                        2)}
        n_alive = max(int(alive.sum()), 1)
        violated_capacity = {g.name for g in goal_results
                             if g.hard and not g.satisfied
                             and "CapacityGoal" in g.name}
        needed_by_resource: dict[Resource, int] = {}
        for r in Resource:
            name = RESOURCE_NAMES[int(r)]
            total = float(util[:, int(r)].sum())
            usable_per_broker = float(
                np.where(alive, caps[:, int(r)], 0.0).sum()
            ) / n_alive * cst.cap_threshold(r)
            if usable_per_broker <= 0:
                continue
            needed_by_resource[r] = int(np.ceil(total / usable_per_broker))
            goal_name = {Resource.CPU: "CpuCapacityGoal",
                         Resource.NW_IN: "NetworkInboundCapacityGoal",
                         Resource.NW_OUT: "NetworkOutboundCapacityGoal",
                         Resource.DISK: "DiskCapacityGoal"}[r]
            if goal_name in violated_capacity:
                response.aggregate(ProvisionRecommendation(
                    ProvisionStatus.UNDER_PROVISIONED,
                    num_brokers=max(needed_by_resource[r] - n_alive, 1),
                    resource=name,
                    reason=f"{name} demand {total:.0f} exceeds usable "
                           f"capacity of {n_alive} brokers",
                    headroom=_headroom(total, usable_per_broker * n_alive)))
        if response.status is not ProvisionStatus.UNDER_PROVISIONED:
            rb, racks = placement()
            valid_rb = rb < B
            total_replicas = int(valid_rb.sum())
            max_rf = int(valid_rb.sum(axis=1).max()) if rb.size else 0
            num_alive_racks = len(set(racks[alive].tolist()))
            if num_alive_racks < max_rf + cst.overprovisioned_min_extra_racks:
                if not response.recommendations:
                    response.status = ProvisionStatus.RIGHT_SIZED
                return response
            min_needed = max(
                *needed_by_resource.values(),
                cst.overprovisioned_min_brokers,
                int(np.ceil(total_replicas
                            / cst.overprovisioned_max_replicas_per_broker)))
            for r, low in zip(Resource, cst.low_utilization_threshold):
                if low <= 0 or r not in needed_by_resource:
                    continue
                total = float(util[:, int(r)].sum())
                usable_per_broker = float(
                    np.where(alive, caps[:, int(r)], 0.0).sum()
                ) / n_alive * cst.cap_threshold(r)
                if (total < low * usable_per_broker * n_alive
                        and min_needed < n_alive):
                    response.aggregate(ProvisionRecommendation(
                        ProvisionStatus.OVER_PROVISIONED,
                        num_brokers=n_alive - min_needed,
                        resource=RESOURCE_NAMES[int(r)],
                        reason=f"{RESOURCE_NAMES[int(r)]} utilization below "
                               f"{low:.0%} of usable capacity (cluster still "
                               f"needs {min_needed} brokers for its most "
                               "demanding resource)",
                        headroom=_headroom(total,
                                           usable_per_broker * n_alive)))
        if not response.recommendations:
            response.status = ProvisionStatus.RIGHT_SIZED
        return response
