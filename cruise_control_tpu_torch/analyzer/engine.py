"""The batched greedy search engine.

Port of ``cruise_control_tpu/analyzer/engine.py``. Per goal, a pass
repeatedly:

1. asks the goal for a batch of candidate actions;
2. scores every candidate at once (base legality, acceptance by every
   previously-optimized goal, the goal's own residual delta);
3. takes the best M, and applies them in partition-disjoint rounds, each
   round re-validated against the updated state and guarded by every chain
   goal's collective (prefix-sum) bound check.

The pass ends when ``stall_patience`` iterations in a row apply nothing.
Mandatory moves (offline replicas) apply even when they do not improve the
goal, as long as they are legal and accepted by earlier goals.

The reference runs these loops on the device (``lax.cond`` and
``lax.while_loop``). The port cuts a pass into segments
(:class:`PassSegments`) that two loops run: on the card
:class:`~.graph_loop.GraphLoop` captures them into CUDA graphs whose loops
are conditional nodes (no host read per iteration); on the CPU
:class:`HostLoop` runs them as host loops whose every test reads ONE packed
scalar from the device. :data:`HOST_SYNCS` counts those reads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _random
from ..kernels import (GoalChecks, GuardTable, SteerTable, ViolationTable,
                       apply_group, candidate_eligibility, proposal_select,
                       round_guards, steer_dest, violation_rows)
from ..utils.ordered import (fma, fma_loop_sum, tree_sum_last,
                             vector_loop_sum)
from .constraint import SearchConfig
from .goals import GoalKernel
from .state import Candidates, SearchContext, SearchState

#: device -> host scalar reads made by the engine's loop tests
HOST_SYNCS = 0
#: apply rounds run: calls of :meth:`PassSegments.round`, and the rounds a
#: goal pass's CUDA graph replayed once their counters are read (credited
#: with the kernels' launches, ``graph_loop``)
APPLY_ROUNDS = 0


def _read(flag: torch.Tensor):
    """The one host read of a loop test."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return flag.item()


# ---------------------------------------------------------------------------
# Joint multi-objective scoring over violation stacks (the population
# search's selection math). ``contract=False`` rounds every operation on its
# own, as the reference's eager calls do (``tuning.plan_quality``);
# ``contract=True`` follows the reference's compiled population program,
# where XLA's CPU backend contracts ``1e-6 + 1e-6 * scale`` and
# ``obj + move_weight * moves`` into FMAs and fuses the weighted row sum
# (:func:`_fused_weighted_sum`). KI (``kernels.population_select``) computes
# the contracted form on the card; its twin calls these.
# ---------------------------------------------------------------------------

def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normalized_stacks(stacks, scales, *, contract: bool = False
                      ) -> torch.Tensor:
    """``stacks[..., g] / max(scale_g, 1)``, with residuals at or below the
    ulp-aware ``GoalResult.satisfied`` cutoff ``1e-6 + 1e-6 * scale``
    clamped to exactly 0 (converged goals tie bit for bit)."""
    stacks = _as_f32(stacks)
    scales = _as_f32(scales, stacks.device)
    tol = fma(1e-6, scales, 1e-6) if contract else 1e-6 + 1e-6 * scales
    norm = stacks / torch.clamp(scales, min=1.0)
    return torch.where(stacks <= tol, 0.0, norm)


#: LLVM's loop for the weighted row at 23-32 goals, as the reference's
#: population program compiles it: read from the program's own fusions,
#: each compiled alone (``scripts/probe_row_fusion.py``). Per weight form
#: and site, (first goal count, last, (vf, ic, epi)); vf = 1 is goal order.
#: The forms: weights that differ reach the fusion as a buffer, and every
#: product is contracted into its add (:func:`~..utils.ordered.
#: fma_loop_sum`); equal weights are a splat constant of the program, and
#: every product is rounded on its own before the adds of
#: :func:`~..utils.ordered.vector_loop_sum` — a weight of 1 leaves no
#: product at all, and the row is a plain sum in loops of its own. The
#: sites: the scores of each generation boundary (the walk's end and every
#: polish round) and the final scores the program returns, at two or more
#: plans; and the final scores of a single plan, whose fusion drops the
#: plan axis (its boundary scores are dead code there: one plan's
#: permutation is fixed). A move term is added after the row, contracted.
WEIGHTED_ROW_LOOPS = {
    "mixed": {
        "boundary": ((23, 23, (4, 4, 2)), (24, 27, (8, 1, 0)),
                     (28, 31, (4, 2, 0)), (32, 32, (8, 1, 0))),
        "final": ((23, 24, (1, 1, 0)), (25, 27, (8, 1, 0)),
                  (28, 31, (4, 2, 0)), (32, 32, (8, 2, 0))),
        "single": ((23, 27, (1, 1, 0)), (28, 31, (4, 2, 0)),
                   (32, 32, (8, 1, 0)))},
    "equal": {
        "boundary": ((23, 24, (1, 1, 0)), (25, 32, (8, 1, 0))),
        "final": ((23, 27, (1, 1, 0)), (28, 31, (8, 1, 0)),
                  (32, 32, (8, 2, 0))),
        "single": ((23, 29, (1, 1, 0)), (30, 32, (8, 1, 0)))},
    "unit": {
        "boundary": ((23, 27, (1, 1, 0)), (28, 32, (8, 1, 0))),
        "final": ((23, 29, (1, 1, 0)), (30, 31, (8, 1, 0)),
                  (32, 32, (8, 2, 0))),
        "single": ((23, 32, (1, 1, 0)),)},
}
#: the forms in KI's order (``csrc/population_select.cu:RowForm``)
WEIGHT_FORMS = ("mixed", "equal", "unit")


def weight_form(w: torch.Tensor) -> str:
    """The form of a weight vector in the compiled program: 'mixed' where
    the weights differ, else 'unit' for weights of 1 and 'equal'."""
    if w.numel() and bool((w != w[0]).any()):
        return "mixed"
    return "unit" if not w.numel() or float(w[0]) == 1.0 else "equal"


def weighted_row_loop(G: int, final: bool = False, plans: int = 2,
                      weights: str = "mixed"):
    """(vf, ic, epi) of the weighted row's loop at G goals (23-32) of
    ``plans`` plans, at the final scores or a generation boundary, for a
    weight form of :data:`WEIGHT_FORMS`; None outside 23-32."""
    site = "single" if plans < 2 else "final" if final else "boundary"
    for lo, hi, loop in WEIGHTED_ROW_LOOPS[weights][site]:
        if lo <= G <= hi:
            return loop
    return None


def _fused_weighted_sum(norm: torch.Tensor, w: torch.Tensor,
                        final: bool = False) -> torch.Tensor:
    """float32 ``(norm * w).sum(-1)`` as XLA's CPU backend computes it inside
    the compiled population program: where the weights differ, each product
    contracted into the running sum (an FMA), from zero in goal order up to
    22 goals and in LLVM's vectorized loop at 23-32; where they are all
    equal, each product rounded on its own (a weight of 1 leaves it
    exact), in goal order or LLVM's loop of adds. The loops differ between
    the generation boundaries and the ``final`` scores, for a single plan
    and by weight form (:data:`WEIGHTED_ROW_LOOPS`). Past 32 goals the
    rounded products in XLA's windowed tree. A goal may repeat."""
    G = norm.shape[-1]
    if G > 32:
        return tree_sum_last(norm * w)
    plans = norm.shape[0] if norm.dim() == 2 else 1
    form = weight_form(w)
    loop = weighted_row_loop(G, final, plans, form) or (1, 1, 0)
    if form == "mixed":
        return fma_loop_sum(norm, w, *loop)
    return vector_loop_sum(norm * w, *loop)


def weighted_objective(stacks, scales, hard_mask, *, hard_weight: float,
                       move_weight: float = 0.0, moves=None,
                       contract: bool = False,
                       final: bool = False) -> torch.Tensor:
    """float32[K] scalarized joint objective per plan (lower is better):
    normalized violations with hard goals weighted by ``hard_weight``,
    summed over the goals, plus ``move_weight`` per applied move
    (``final``: the compiled program's final scores, see
    :func:`_fused_weighted_sum`)."""
    norm = normalized_stacks(stacks, scales, contract=contract)
    hard = torch.as_tensor(hard_mask, dtype=torch.bool, device=norm.device)
    w = torch.where(hard, _as_f32(hard_weight), _as_f32(1.0)).to(norm.device)
    if contract:
        obj = _fused_weighted_sum(norm, w, final)
    else:
        obj = tree_sum_last(norm * w)
    if move_weight and moves is not None:
        mv = _as_f32(torch.as_tensor(moves).to(norm.device))
        obj = (fma(move_weight, mv, obj) if contract
               else obj + move_weight * mv)
    return obj


def pareto_ranks(stacks, scales, *, contract: bool = False) -> torch.Tensor:
    """int32[K] dominance-count Pareto rank per plan over the normalized
    stacks: ``rank[j]`` = how many plans dominate plan j (every goal <=,
    at least one <). Rank 0 is the Pareto front."""
    n = normalized_stacks(stacks, scales, contract=contract)
    le = (n[:, None, :] <= n[None, :, :]).all(dim=-1)
    lt = (n[:, None, :] < n[None, :, :]).any(dim=-1)
    return (le & lt).sum(dim=0, dtype=torch.int32)


class PassSegments:
    """One goal pass cut into the segments its loops run, each a function
    of the state, the context and its loop's carry that reads nothing back
    to the host (the body of the reference's ``make_goal_pass``):

    - :meth:`active`: the converged test (the pass runs where it is true);
    - :meth:`drain`: one bulk-drain round (its test: the applied count);
    - :meth:`propose`: the fine loop's body up to the apply rounds — the
      goal's candidates, scored, the best ``apply_per_iter`` taken, their
      conflicts;
    - :meth:`round`: one apply round (its test: candidates still pending
      and some applied);
    - :meth:`stack`: the boundary stack over ``all_goals``.

    :class:`HostLoop` drives them with a host read per loop test; on the
    card :class:`~.graph_loop.GraphLoop` captures each once and runs the
    loops as CUDA graph conditional nodes."""

    def __init__(self, goal: GoalKernel, prev_goals: Sequence[GoalKernel],
                 cfg: SearchConfig,
                 all_goals: Sequence[GoalKernel] | None = None):
        self.goal = goal
        self.prev_goals = list(prev_goals)
        self.cfg = cfg
        self.all_goals = list(all_goals or [goal])
        #: whether the pass opens with the bulk-drain rounds
        self.drains = goal.supports_bulk_drain and cfg.drain_rounds > 0
        #: a drain round applying fewer moves ends the drain
        self.min_applied = max(cfg.drain_batch // 64, 8)
        #: the goals a candidate is checked against (KN's goal table)
        self.checks = GoalChecks(goal, self.prev_goals, cfg.epsilon)
        #: the goals whose collective bounds an apply round keeps (KQ's
        #: guard table)
        self.guards = GuardTable(self.checks)
        #: the earlier goals' receptive tests (KV's table)
        self.steer = SteerTable(self.prev_goals)
        #: the pass goal's and the boundary stack's violation rows (KX's
        #: tables)
        self.active_rows = ViolationTable([goal])
        self.stack_rows = ViolationTable(self.all_goals)
        #: KV's output a (device, B1): a fixed address for the graphs
        self._steered: dict = {}

    def eligibility(self, state, ctx, cands, bounds=None):
        """(bool[N] eligible, f32[N] the goal's delta): base legality, every
        earlier goal's acceptance, and an improving delta or a mandatory
        move (KN, ``kernels.candidate_eligibility``; ``bounds`` as
        there)."""
        return candidate_eligibility(state, ctx, cands, self.checks, bounds)

    def steer_ctx(self, state: SearchState, ctx: SearchContext
                  ) -> SearchContext:
        """Steer candidate generation toward destinations every earlier goal
        can accept; keep the original set if the intersection is empty
        (KV, ``kernels.steer_dest``, into a buffer this pass keeps)."""
        if not self.prev_goals:
            return ctx
        out = None
        if state.rb.device.type == "cuda":
            if not self.steer.n and not self.steer.outside:
                # every earlier goal receives everywhere: the mask is
                # dest_allowed itself
                return ctx
            where = (state.rb.device, ctx.dest_allowed.shape[0])
            out = self._steered.get(where)
            if out is None:
                out = self._steered[where] = torch.empty(
                    where[1], dtype=torch.bool, device=where[0])
        return ctx.replace(dest_allowed=steer_dest(state, ctx, self.steer,
                                                   out=out))

    def active(self, state: SearchState, ctx: SearchContext,
               flag: torch.Tensor | None = None) -> torch.Tensor:
        """int64 scalar, 1 where the goal is violated or a replica is
        offline (a converged pass skips its loops: one violation read
        instead of stall_patience zero-apply iterations), written by KX's
        one-row launch into ``flag`` (the loop's counter word) or a new
        scalar."""
        if flag is None:
            flag = torch.empty((), dtype=torch.int64, device=state.rb.device)
        violation_rows(self.active_rows, state, ctx, flag=flag,
                       eps=self.cfg.epsilon)
        return flag

    def drain(self, state: SearchState, ctx: SearchContext, key, r,
              out: SearchState | None = None):
        """Bulk-drain round ``r`` (an int or an int64 scalar tensor): up to
        drain_batch conflict-free moves. Returns (state, int64 scalar
        applied count); with ``out`` (buffers the caller owns, possibly
        ``state``'s own) the new state is written into them (KM's in-place
        form) and ``out`` is returned."""
        c = self.goal.bulk_drain(state, self.steer_ctx(state, ctx),
                                 _random.fold(key, 70_000 + r), self.cfg)
        elig, _ = self.eligibility(state, ctx, c)
        return apply_group(state, ctx, c, elig, out=out)

    def propose(self, state: SearchState, ctx: SearchContext, key, it,
                out=None, flag=None):
        """The fine loop's iteration ``it`` (an int or an int64 scalar
        tensor) up to the apply rounds: the goal's candidates, KN's verdict
        and KW's selection (``kernels.proposal_select``: mandatory moves
        first, then the most negative deltas). Returns (the best M
        candidates in score order, bool[M, M] conflicts with earlier ones,
        bool[M] pending); with ``out`` (buffers the caller owns: the
        rounds' carry) they are written there, and ``flag`` (an int64
        scalar) is set to whether any is pending."""
        cands = self.goal.propose(state, self.steer_ctx(state, ctx),
                                  _random.fold(key, it), self.cfg)
        elig, delta = self.eligibility(state, ctx, cands)
        M = min(self.cfg.apply_per_iter, cands.p.shape[0])
        return proposal_select(cands, elig, delta, M, out=out, flag=flag)

    def round(self, state: SearchState, ctx: SearchContext, c: Candidates,
              conflict_earlier: torch.Tensor, pending: torch.Tensor,
              out: SearchState | None = None):
        """One apply round over the pending candidates, re-validated against
        the state (KN) and guarded by every chain goal's collective bound
        (KQ, ``kernels.round_guards``, which reads the bounds KN leaves in
        ``bounds``), then applied (KM). Returns (state, pending, int64
        scalar applied, bool scalar: still pending and some applied);
        ``out`` as for :meth:`drain`."""
        global APPLY_ROUNDS
        APPLY_ROUNDS += 1
        bounds = self.checks.round_bounds(state)
        elig = self.eligibility(state, ctx, c, bounds)[0]
        do, pending, more = round_guards(state, ctx, c, conflict_earlier,
                                         pending, elig, self.guards, bounds)
        state, applied = apply_group(state, ctx, c, do, out=out)
        return state, pending, applied, more

    def stack(self, state: SearchState, ctx: SearchContext,
              out: torch.Tensor | None = None) -> torch.Tensor:
        """f32[len(all_goals)] the boundary stack (KX), into ``out``."""
        return violation_rows(self.stack_rows, state, ctx, out=out)


class HostLoop:
    """A goal pass whose loop tests the host reads, one packed scalar each
    (:data:`HOST_SYNCS`): the CPU's loop over :class:`PassSegments`, and
    the plain twin of the card's :class:`~.graph_loop.GraphLoop`.

    ``run(state, ctx, key) -> (state, iters, violations, moves)``:
    ``iters`` a Python int, ``violations`` the post-pass residual stack over
    ``all_goals`` and ``moves`` the cumulative ``state.moves_applied``."""

    def __init__(self, seg: PassSegments):
        self.seg = seg

    def __call__(self, state: SearchState, ctx: SearchContext, key):
        seg = self.seg
        iters = 0
        if _read(seg.active(state, ctx)):
            state, iters = self._run_active(state, ctx, key)
        return state, iters, seg.stack(state, ctx), state.moves_applied

    def _run_active(self, state, ctx, key):
        seg, cfg = self.seg, self.seg.cfg
        if seg.drains:
            # Vectorized shedding prologue; the fine loop finishes the tail.
            r = 0
            while r < cfg.drain_rounds:
                state, applied = seg.drain(state, ctx, key, r)
                r += 1
                if r < cfg.drain_rounds and _read(applied) < seg.min_applied:
                    break
        it = 0
        stalls = 0
        while stalls < cfg.stall_patience and it < cfg.max_iters_per_goal:
            c, conflict_earlier, pending = seg.propose(state, ctx, key, it)
            n = torch.zeros((), dtype=torch.int64, device=pending.device)
            rounds = 0
            go = _read(pending.any())
            while go and rounds < cfg.apply_groups:
                state, pending, applied, more = seg.round(
                    state, ctx, c, conflict_earlier, pending)
                n = n + applied
                rounds += 1
                if rounds < cfg.apply_groups:
                    go = _read(more)
            stalls = stalls + 1 if _read(n == 0) else 0
            it += 1
        return state, it


def make_goal_pass(goal: GoalKernel, prev_goals: Sequence[GoalKernel],
                   cfg: SearchConfig,
                   all_goals: Sequence[GoalKernel] | None = None):
    """Build the single-goal optimization pass.

    Returns ``run(state, ctx, key) -> (state, iters, violations, moves)``:
    ``violations`` the post-pass residual stack over ``all_goals`` and
    ``moves`` the cumulative ``state.moves_applied``; ``iters`` a Python int
    on the CPU and an int64 scalar on the card, where the pass runs as a
    CUDA graph (:mod:`.graph_loop`)."""
    return _PassRunner([PassSegments(goal, prev_goals, cfg,
                                     all_goals)]).passes[0]


def make_chain_step(goals: Sequence[GoalKernel], cfg: SearchConfig):
    """Compose the per-goal passes into ``step(state, ctx, key) ->
    (state, violations)``; each pass folds its goal index into the key."""
    return CompiledGoalChain(goals, cfg).step


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, flat and back to back (one device->host read)."""
    return torch.cat([t.reshape(-1).contiguous().view(torch.uint8)
                      for t in tensors])


def _unpack(buf: np.ndarray, like: Sequence[torch.Tensor]) -> list:
    """Numpy arrays of ``like``'s dtypes and shapes from :func:`_pack`'s
    bytes read to the host."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(buf[off:off + n].copy().view(dt).reshape(tuple(t.shape)))
        off += n
    return out


def read_host(*xs) -> list:
    """Numpy arrays of ``xs`` in one device->host read: the tensors among
    them are packed into one buffer (all on one device); Python numbers
    pass through."""
    dev = [x for x in xs if isinstance(x, torch.Tensor)]
    host = iter(_unpack(_pack(dev).cpu().numpy(), dev) if dev else ())
    return [next(host) if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


class _PassRunner:
    """The passes of a list of :class:`PassSegments`: on the CPU (or with
    ``loop="host"``) each is a :class:`HostLoop`; on the card every pass
    runs through the CUDA graphs of :class:`~.graph_loop.GraphLoop`, one
    set a state and context signature, captured at first use. A capture
    or launch that fails raises; there is no fallback to the host loop."""

    def __init__(self, segments: Sequence[PassSegments], loop: str = "auto",
                 aux=None):
        if loop not in ("auto", "host"):
            raise ValueError(f"unknown goal-loop mode {loop!r}")
        self.segments = list(segments)
        self.loop = loop
        self._aux = aux
        self.host_passes = [HostLoop(s) for s in self.segments]
        self.passes = [self._pass(i) for i in range(len(self.segments))]
        self._graphs: dict = {}

    def _pass(self, i: int):
        def run(state, ctx, key):
            if self._on_host(state):
                return self.host_passes[i](state, ctx, key)
            return self.graph_loop(state, ctx).run_pass(i, state, ctx, key)
        return run

    def _on_host(self, state) -> bool:
        return self.loop == "host" or state.rb.device.type != "cuda"

    def graph_loop(self, state, ctx):
        """The :class:`~.graph_loop.GraphLoop` of this state and context
        signature (captured on first use)."""
        from .graph_loop import GraphLoop, signature
        key = signature(state, ctx)
        gl = self._graphs.get(key)
        if gl is None:
            gl = self._graphs[key] = GraphLoop(self.segments, state, ctx,
                                               aux=self._aux)
            while len(self._graphs) > 4:
                self._graphs.pop(next(iter(self._graphs))).settle()
        return gl

    def step(self, state, ctx, key):
        """Every pass back to back with fold_in(key, i); returns (state,
        the last pass's violations)."""
        stack = None
        for i, p in enumerate(self.passes):
            state, _, stack, _ = p(state, ctx, _random.fold(key, i))
        return state, stack


class CompiledGoalChain(_PassRunner):
    """Per-goal passes for one (goal chain, config) pair, plus the aux
    readings and the one-walk ``fused`` form. On the card the first call at
    a new model shape captures the chain's segments (a compile event of
    ``core.runtime_obs``); ``warmup`` is a no-op kept for API parity with
    the reference."""

    def __init__(self, goals: Sequence[GoalKernel], cfg: SearchConfig,
                 loop: str = "auto"):
        self.goals = list(goals)
        self.cfg = cfg
        #: the chain's violation rows (KX's table)
        self.rows = ViolationTable(self.goals)
        super().__init__([PassSegments(g, self.goals[:i], cfg,
                                       all_goals=self.goals)
                          for i, g in enumerate(self.goals)], loop,
                         aux=self.aux)

    def warmup(self, state, ctx, key) -> None:
        return None

    def aux(self, state, ctx, out=None):
        """(offline.any(), f32[G] violation scales, f32[G] violations), the
        last two from one KX launch; ``out``: the three buffers to write
        (the fused graph's)."""
        off = state.offline.any()
        if out is None:
            viol, scales = violation_rows(self.rows, state, ctx, True)
            return off, scales, viol
        out[0].copy_(off)
        violation_rows(self.rows, state, ctx, True, out=out[2],
                       scale_out=out[1])
        return out

    def violations(self, state, ctx) -> torch.Tensor:
        return violation_rows(self.rows, state, ctx)

    def fused(self, state, ctx, key):
        """The whole chain back to back with fold_in(key, i) per goal, like
        the per-goal walk, ending in one packed device->host read. Returns
        (state, aux, [G] iters, f32[G, G] boundary stacks, [G] cumulative
        moves), all but the state numpy arrays on the host (aux as in
        :meth:`aux`)."""
        if not self._on_host(state):
            return self.graph_loop(state, ctx).run_fused(state, ctx, key)
        aux = self.aux(state, ctx)
        iters, bounds, moves = [], [], []
        for i, run in enumerate(self.passes):
            state, it, stack, m = run(state, ctx, _random.fold(key, i))
            iters.append(it)
            bounds.append(stack)
            moves.append(m)
        bounds, moves = torch.stack(bounds), torch.stack(moves)
        readings = [aux[0], aux[1], aux[2], bounds, moves]
        host = _unpack(_pack(readings).cpu().numpy(), readings)
        return (state, (host[0], host[1], host[2]),
                np.asarray(iters, np.int64), host[3], host[4])
