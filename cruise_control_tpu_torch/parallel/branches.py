"""Best-of-N independent search branches on one device.

Port of ``cruise_control_tpu/parallel/branches.py``. Every branch runs the
full goal chain on the request's model under its own PRNG stream, and the
best final state by lexicographic violation wins — the replacement for the
reference's proposal-precompute thread pool
(``num.proposal.precompute.threads``, ``GoalOptimizer.java:112-119``: N
goal-chain runs on cloned models, the best result cached).

The JAX package fans the branches over an N-device ``shard_map`` mesh and
derives branch i's key from ``axis_index``; one GPU runs the N branches one
after another with the same key ``fold_in(key, i)``, so branch i equals
branch i of the reference's mesh. There is no mesh object. The passes are
functional (every apply builds new tensors), so all branches start from one
shared initial state without copying it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _random
from ..analyzer.constraint import SearchConfig
from ..analyzer.engine import make_chain_step
from ..analyzer.goals import GoalKernel


def make_branched_search(goals: Sequence[GoalKernel], cfg: SearchConfig,
                         n_branches: int, chain=None):
    """Build ``run(state, ctx, key) -> (states, violations)``: ``states[i]``
    is branch i's final state and ``violations[i, g]`` its final residual of
    goal g (float32[N, G]). Use :func:`select_best` to pick the winner.
    ``chain``: the goals' ``CompiledGoalChain`` to run the passes of (its
    CUDA graphs are captured once; by default a chain of its own)."""
    chain = (make_chain_step(goals, cfg) if chain is None
             else chain.step)
    n = int(n_branches)

    def run(state, ctx, key):
        states, stacks = [], []
        for i in range(n):
            st, stack = chain(state, ctx, _random.fold(key, i))
            states.append(st)
            stacks.append(stack)
        return states, torch.stack(stacks)

    return run


def checked_violations(violations, what: str = "branched search"
                       ) -> np.ndarray:
    """Fetch a [N, G] violation matrix, failing loudly on NaN residuals (a
    broken goal kernel: NaN compares False both ways, so a sort below could
    silently serve the broken plan) — the shared guard of every best-of-N
    selection (branches and the population search)."""
    v = (violations.cpu().numpy() if isinstance(violations, torch.Tensor)
         else np.asarray(violations))
    if np.isnan(v).any():
        bad = sorted(set(np.nonzero(np.isnan(v))[0].tolist()))
        raise RuntimeError(
            f"{what} produced NaN violations on members {bad}")
    return v


def audit_violation_count(audit_eval, member_state) -> int:
    """Number of audited hard goals a plan leaves violated — the one
    definition of the audit verdict used for best-of-N selection (the
    ulp-aware cutoff is ``GoalResult.satisfied``'s, 1e-6 + 1e-6 * scale).
    ``audit_eval(state) -> (f32[A] violations, f32[A] scales)``."""
    av, scales = audit_eval(member_state)
    av = (av.cpu().numpy() if isinstance(av, torch.Tensor)
          else np.asarray(av)).astype(np.float64)
    scales = (scales.cpu().numpy() if isinstance(scales, torch.Tensor)
              else np.asarray(scales)).astype(np.float64)
    return int((av > 1e-6 + 1e-6 * scales).sum())


def select_best(states, violations):
    """The branch whose violation stack wins lexicographically (earlier
    goals dominate, as in the sequential chain); ties go to the lower
    branch index. Returns ``(state, index, stack)``."""
    v = checked_violations(violations)
    best = min(range(v.shape[0]), key=lambda i: (tuple(v[i]), i))
    return states[best], best, v[best]


def select_best_audited(states, violations, audit_eval):
    """Like :func:`select_best`, but the off-chain hard-goal audit
    dominates: a branch with fewer audit-violated hard goals wins even when
    another edges it on chain residuals, so the winner can pass the
    hard-goal gate whenever some branch does."""
    v = checked_violations(violations)
    keys = [(audit_violation_count(audit_eval, states[i]), tuple(v[i]), i)
            for i in range(v.shape[0])]
    best = min(keys)[-1]
    return states[best], best, v[best]
