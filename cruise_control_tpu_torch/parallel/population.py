"""Multi-objective population search: K candidate plans, scored jointly
over every goal.

Port of ``cruise_control_tpu/parallel/population.py``. Every member walks
the goal chain with the chain's own per-goal passes under its own PRNG
stream; before each polish round the whole population is scored jointly
(scale-normalized violation stacks, reduced to a weighted sum or a
dominance-count Pareto rank) and truncation selection reseeds the losers
from the survivors — one launch of KI (:func:`kernels.population_select`)
per generation boundary, and one more for the final scores. The served
plan is the multi-objective winner (:func:`select_plan`, hard-goal audit
verdicts dominating).

**Anchor guarantee**: member 0 runs the exact sequential schedule (its
stream is the request key itself, it never adopts another member's state,
its polish skip decisions are the host loop's), so ``K=1`` is the
sequential per-goal walk bit for bit.

The reference packs members over a device mesh (``shard_map``) and an
inner ``lax.map``; on one GPU the K members (K rounded up to a power of
two) run one after another, D = 1 device and k = K members on it. States
are never copied: the passes are functional (every apply builds new
tensors), so a plan adopted by two slots is shared by both and each slot's
next pass builds its own successor.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .. import _random
from ..analyzer import engine
from ..analyzer.constraint import PopulationConfig, SearchConfig
from ..analyzer.goals import GoalKernel
from ..kernels import ViolationTable, population_select, violation_rows
from .batching import pow2_bucket
from .branches import audit_violation_count, checked_violations

#: PRNG stream salt for members > 0 (member 0 uses the request key itself;
#: distinct from the engine's salts: 70_000 drain, 50_000 fused polish,
#: the 1000-series polish rounds)
_MEMBER_KEY_SALT = 90_000


def population_layout(size: int) -> tuple[int, int, int]:
    """(devices D, members per device k, K bucket) for a ``size``-member
    population on the port's one GPU: K rounds up to the next power of
    two and every member packs on the one device (D = 1, k = K)."""
    K = pow2_bucket(max(int(size), 1))
    return 1, K, K


def n_survivors(size: int, fraction: float) -> int:
    """Survivors of a K-member generation: ``ceil(K * fraction)`` clamped to
    ``[1, K-1]`` for K > 1 (slot 0 is re-anchored after the survivor
    round-robin, so only K-1 slots are free; with K survivors the rank
    winner could hold only slot 0 and be evicted)."""
    if size <= 1:
        return 1
    return max(1, min(math.ceil(size * fraction), size - 1))


def _member_key(key, m: int) -> _random.KeyPath:
    # Member 0 is the anchor: its stream is the request key itself.
    return (_random.path(key) if m == 0
            else _random.fold(key, _MEMBER_KEY_SALT + m))


def _read_host(*tensors):
    """One device -> host fetch of a generation boundary's readings,
    counted in ``engine.HOST_SYNCS``."""
    engine.HOST_SYNCS += 1
    return engine.read_host(*tensors)


def _iters(iters: list):
    """A pass's iteration counts as one int64 tensor where any is a device
    scalar (a CUDA-graph pass), else as they are (Python ints)."""
    like = next((x for x in iters if isinstance(x, torch.Tensor)), None)
    if like is None:
        return np.asarray(iters, np.int64)
    return torch.stack([x if isinstance(x, torch.Tensor)
                        else torch.full_like(like, x) for x in iters])


def make_population_search(passes: Sequence, goals: Sequence[GoalKernel],
                           cfg: SearchConfig, pop_cfg: PopulationConfig):
    """Build ``run(state, ctx, key)`` — the population search for K members,
    ``pop_cfg.size`` rounded up to a power of two. ``passes`` are the
    chain's per-goal passes (``CompiledGoalChain.passes``). ``run``
    returns:

    - ``states``: the K final search states (a list);
    - ``aux``: ``(offline.any(), f32[G] scales, f32[G] initial stack)``;
    - ``iters``: i64[K, G] per-member per-goal iteration totals;
    - ``walk_bounds``: f32[K, G, G] — row i is slot m's plan's stack after
      walk pass i (histories follow adoptions: a slot always carries its
      current plan's lineage);
    - ``polish_rows``: f32[R, K, G] round-end stacks (R polish rounds);
    - ``moves``: i64[K] cumulative moves per member;
    - ``accepted``: i64[K, G] per-member per-goal accepted moves;
    - ``perms``: i32[R, K] the survivor permutation applied before each
      polish round (slot i's plan came from slot ``perms[r, i]``);
    - ``ranks``: i32[K] final dominance-count Pareto ranks;
    - ``weighted``: f32[K] final weighted-objective scores.

    ``iters``, ``walk_bounds``, ``polish_rows``, ``moves``, ``accepted``
    and ``perms`` are numpy arrays already on the host (the generation
    boundaries read them); ``ranks`` and ``weighted`` stay on the device.
    """
    goals = list(goals)
    passes = list(passes)
    G = len(goals)
    #: the chain's violation rows (KX's table)
    viol_rows = ViolationTable(goals)
    K = pow2_bucket(max(int(pop_cfg.size), 1))
    R = cfg.polish_passes + 1 if cfg.polish_passes else 0
    polish_eps = min(cfg.epsilon, 1e-6)
    hard = [g.hard for g in goals]
    n_surv = n_survivors(K, pop_cfg.survivor_fraction)
    pareto = pop_cfg.objective == "pareto"

    def member_walk(state, ctx, mkey):
        """The sequential walk, one member: every pass in chain order with
        key fold_in(mkey, i)."""
        iters, bounds, moves = [], [], []
        for i, run_pass in enumerate(passes):
            state, it, stack, mv = run_pass(state, ctx,
                                            _random.fold(mkey, i))
            iters.append(it)
            bounds.append(stack)
            moves.append(mv)
        return state, iters, torch.stack(bounds), torch.stack(moves)

    def member_polish(state, ctx, mkey, boundary: np.ndarray,
                      prev: torch.Tensor, rnd: int):
        """One polish round, one member, with the sequential loop's
        semantics: skip decisions read the round-start boundary, keys are
        fold_in(mkey, 1000*(rnd+1)+i), ``~(x <= eps)`` keeps NaN residuals
        to do, and a round that starts converged runs nothing (zero
        iterations, the previous stack carried through)."""
        round_do = bool(np.any(~(boundary <= polish_eps)))
        iters, moves = [], []
        for i, run_pass in enumerate(passes):
            if round_do and not (boundary[i] <= polish_eps):
                state, it, prev, mv = run_pass(
                    state, ctx, _random.fold(mkey, 1000 * (rnd + 1) + i))
            else:
                it, mv = 0, state.moves_applied
            iters.append(it)
            moves.append(mv)
        return state, iters, prev, torch.stack(moves)

    def select(boundary, moves, scales, hard_mask, final=False):
        return population_select(boundary, moves, scales, hard_mask,
                                 pop_cfg.hard_weight, pop_cfg.move_weight,
                                 n_surv, pareto, final)

    def run(state, ctx, key):
        dev = state.rb.device
        viol, scales = violation_rows(viol_rows, state, ctx, True)
        aux = (state.offline.any(), scales, viol)
        hard_mask = torch.tensor(hard, dtype=torch.bool, device=dev)
        states, iters, wb, mv_walk = [], [], [], []
        for m in range(K):
            st, it, bounds, mv = member_walk(state, ctx, _member_key(key, m))
            states.append(st)
            iters.append(it)
            wb.append(bounds)
            mv_walk.append(mv)
        boundary_d = torch.stack([b[-1] for b in wb])            # [K, G]
        wb_np, mv_np, iters = _read_host(torch.stack(wb),
                                         torch.stack(mv_walk),
                                         _iters(sum(iters, [])))
        iters = iters.astype(np.int64).reshape(K, G)
        accepted = mv_np - np.concatenate(
            [np.zeros((K, 1), mv_np.dtype), mv_np[:, :-1]], axis=1)
        moves = mv_np[:, -1]
        boundary = wb_np[:, -1, :]
        moves_d = torch.from_numpy(moves).to(dev)
        perms, rows = [], []
        for rnd in range(R):
            # Generation boundary: joint scoring, truncation selection,
            # survivor adoption; every per-slot history follows its plan.
            _, _, perm_d = select(boundary_d, moves_d, scales, hard_mask)
            (perm,) = _read_host(perm_d)
            perm = perm.astype(np.int64)
            states = [states[j] for j in perm]
            boundary_d = boundary_d[perm_d.long()]
            boundary, iters = boundary[perm], iters[perm]
            accepted, moves = accepted[perm], moves[perm]
            wb_np = wb_np[perm]
            rows = [r[perm] for r in rows]
            out_states, it_r, b_r, mv_r = [], [], [], []
            for m in range(K):
                st, it, stack, mv = member_polish(
                    states[m], ctx, _member_key(key, m), boundary[m],
                    boundary_d[m], rnd)
                out_states.append(st)
                it_r.append(it)
                b_r.append(stack)
                mv_r.append(mv)
            states = out_states
            boundary_d = torch.stack(b_r)
            boundary, mv_r, it_r = _read_host(boundary_d, torch.stack(mv_r),
                                              _iters(sum(it_r, [])))
            accepted = accepted + mv_r - np.concatenate(
                [moves[:, None], mv_r[:, :-1]], axis=1)
            moves = mv_r[:, -1]
            moves_d = torch.from_numpy(moves).to(dev)
            iters = iters + it_r.astype(np.int64).reshape(K, G)
            perms.append(perm.astype(np.int32))
            rows.append(boundary)
        ranks, weighted, _ = select(boundary_d, moves_d, scales, hard_mask,
                                    final=True)
        polish_rows = (np.stack(rows) if rows
                       else np.zeros((0, K, G), np.float32))
        perm_arr = (np.stack(perms) if perms
                    else np.zeros((0, K), np.int32))
        return (states, aux, iters, wb_np, polish_rows, moves, accepted,
                perm_arr, ranks, weighted)

    return run


def select_plan(states, stacks, moves, ranks, weighted,
                pop_cfg: PopulationConfig, audit_eval=None):
    """The served plan: hard-goal audit verdicts dominate (a gate-passing
    plan beats any gate-failing one), then the configured joint objective
    (the Pareto rank when ``objective="pareto"``), then the weighted score,
    the lexicographic stack, the move count, and the lower slot (slot 0 is
    the sequential anchor). Returns ``(state, winner_index, winner_stack)``.
    """
    v = checked_violations(stacks, "population search")
    ranks, weighted, moves = (
        (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t))
        for t in (ranks, weighted, moves))
    keys = []
    for m in range(v.shape[0]):
        num_bad = (0 if audit_eval is None
                   else audit_violation_count(audit_eval, states[m]))
        primary = int(ranks[m]) if pop_cfg.objective == "pareto" else 0
        keys.append((num_bad, primary, float(weighted[m]), tuple(v[m]),
                     int(moves[m]), m))
    best = min(keys)[-1]
    return states[best], best, v[best]
