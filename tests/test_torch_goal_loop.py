"""The goal loops (``analyzer/engine.py``: :class:`PassSegments` driven by
:class:`HostLoop`) against the JAX package's ``make_goal_pass`` and fused
walk, at every way a pass ends: the converged skip, the bulk drain stopping
under its applied minimum, ``stall_patience``, ``max_iters_per_goal``,
``apply_groups`` at 1 and 2, and mandatory moves off a dead broker; and one
fused optimize of the default chain.

Each pass also runs through KL's plain twin (``kernels.goal_loop_step_
plain``) in the very shape of the card's CUDA graph (``analyzer/graph_loop.
py:GraphLoop._build_pass``: a segment, then the KL step that writes the
loop test), with its fold words as int64 scalar tensors the way the graph
reads them; its counters say which exit the pass took.

Tolerances: none — placements, iterations, moves and violation stacks
exactly equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer as ja
import cruise_control_tpu.analyzer.engine as je
import cruise_control_tpu.analyzer.state as js
import cruise_control_tpu_torch.analyzer as ta
import cruise_control_tpu_torch.analyzer.engine as te
import cruise_control_tpu_torch.analyzer.state as ts
from cruise_control_tpu.analyzer import SearchConfig as JConfig
from cruise_control_tpu.analyzer import goals_by_name as jgoals
from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer import SearchConfig as TConfig
from cruise_control_tpu_torch.analyzer import goals_by_name as tgoals
from torch_parity_util import assert_same, build_both, tiny_both

torch.set_num_threads(1)

SLOT = {name: i for i, name in enumerate(kernels.GOAL_LOOP_SLOTS)}
CHAIN = ["ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal"]
BASE = dict(num_replica_candidates=64, num_dest_candidates=8,
            apply_per_iter=64, max_iters_per_goal=32, drain_batch=128)


def kl_twin_pass(seg: te.PassSegments, state, ctx, key):
    """One pass with its loops driven as the card's graph drives them: each
    loop test written by a KL step over the int64 counters (the twin), the
    fold words read from the counters. Returns (state, iters, stack, moves,
    counters)."""
    cfg = seg.cfg
    ctr = torch.zeros(len(SLOT), dtype=torch.int64)

    def step(op, a=0, b=0):
        return bool(kernels.goal_loop_step_plain(ctr, op, a, b))

    ctr[SLOT["flag"]] = seg.active(state, ctx)
    if step("active"):
        if seg.drains:
            go = step("drain_enter", cfg.drain_rounds)
            while go:
                state, n = seg.drain(state, ctx, key, ctr[SLOT["round"]])
                ctr[SLOT["flag"]] = n
                go = step("drain_step", cfg.drain_rounds, seg.min_applied)
        limits = (cfg.stall_patience, cfg.max_iters_per_goal)
        go = step("fine_enter", *limits)
        while go:
            c, ce, pending = seg.propose(state, ctx, key, ctr[SLOT["it"]])
            ctr[SLOT["flag"]] = pending.any()
            more = step("rounds_enter", cfg.apply_groups)
            while more:
                state, pending, n, again = seg.round(state, ctx, c, ce,
                                                     pending)
                ctr[SLOT["applied"]] += n
                ctr[SLOT["flag"]] = again
                more = step("rounds_step", cfg.apply_groups)
            go = step("fine_step", *limits)
    return (state, int(ctr[SLOT["it"]]), seg.stack(state, ctx),
            state.moves_applied, ctr)


def _same_state(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None:
            assert y is None, f"{what}.{f.name}"
        else:
            assert_same(x, y, what=f"{what}.{f.name}")


def _run_pass(both, i, cfg, seed=7, before=0):
    """Pass i of CHAIN in both packages (after ``before`` earlier runs of
    the same pass, to reach its converged state), held equal; returns the
    twin's counters, the port's config, segments and final state."""
    (jm, jmd), (tm, tmd) = both
    jg, tg = jgoals(CHAIN), tgoals(CHAIN)
    jcfg = JConfig(**cfg).scaled_for(jmd.num_partitions, jmd.num_brokers)
    tcfg = TConfig(**cfg).scaled_for(tmd.num_partitions, tmd.num_brokers)
    jst, jctx = js.init_state(jm), js.build_context(jm)
    tst, tctx = ts.init_state(tm), ts.build_context(tm)
    jrun = jax.jit(je.make_goal_pass(jg[i], jg[:i], jcfg, all_goals=jg))
    seg = te.PassSegments(tg[i], tg[:i], tcfg, all_goals=tg)
    host = te.HostLoop(seg)
    for r in range(before + 1):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), r)
        tkey = _random.fold(_random.PRNGKey(seed), r)
        jst, jit_, jstack, jmoves = jrun(jst, jctx, jkey)
        twin = kl_twin_pass(seg, tst, tctx, tkey)
        tst, tit, tstack, tmoves = host(tst, tctx, tkey)
        assert int(jit_) == tit == twin[1], f"iterations, run {r}"
        assert int(jmoves) == int(tmoves) == int(twin[3]), f"moves, run {r}"
        assert_same(jstack, tstack, what=f"stack, run {r}")
        assert_same(tstack, twin[2], what=f"twin stack, run {r}")
        _same_state(jst, tst, f"state, run {r}")
        _same_state(tst, twin[0], f"twin state, run {r}")
    return twin[4], tcfg, seg, tst


def test_converged_goal_skips_its_loops():
    ctr, _, _, _ = _run_pass(tiny_both(), 0, BASE, before=1)
    assert ctr[SLOT["exec_active"]] == 0 and ctr[SLOT["it"]] == 0


def test_drain_stops_under_its_applied_minimum():
    ctr, cfg, seg, _ = _run_pass(tiny_both(), 0, BASE)
    assert seg.drains
    assert 0 < ctr[SLOT["exec_drain"]] < cfg.drain_rounds
    assert ctr[SLOT["flag"]] < seg.min_applied


def test_stall_patience_ends_the_fine_loop():
    cfg = dict(BASE, stall_patience=2, max_iters_per_goal=200)
    ctr, cfg, _, _ = _run_pass(build_both(8, 128, seed=3), 1, cfg)
    assert ctr[SLOT["stalls"]] == cfg.stall_patience
    assert 0 < ctr[SLOT["it"]] < cfg.max_iters_per_goal


def test_max_iters_ends_the_fine_loop():
    cfg = dict(BASE, max_iters_per_goal=3, drain_rounds=0)
    ctr, cfg, seg, _ = _run_pass(build_both(8, 128, seed=3), 0, cfg)
    assert not seg.drains
    assert ctr[SLOT["it"]] == 3 and ctr[SLOT["stalls"]] < cfg.stall_patience


@pytest.mark.parametrize("groups", [1, 2])
def test_apply_groups_bound_the_rounds(groups):
    cfg = dict(BASE, apply_groups=groups, drain_rounds=0)
    ctr, cfg, _, _ = _run_pass(build_both(8, 128, seed=5), 2, cfg)
    fine, rounds = ctr[SLOT["exec_fine"]], ctr[SLOT["exec_round"]]
    assert 0 < rounds <= groups * fine


def test_mandatory_moves_leave_a_dead_broker():
    both = build_both(8, 128, seed=4, dead=(2,))
    ctr, _, _, tst = _run_pass(both, 0, dict(BASE, drain_rounds=0))
    dead = both[1][1].broker_index[2]
    assert ctr[SLOT["exec_active"]] == 1
    assert bool(ts.init_state(both[1][0]).offline.any())
    assert not bool((tst.rb == dead).any()) and not bool(tst.offline.any())


def test_default_chain_fused_optimize():
    """``TorchGoalOptimizer`` (the default chain, ``fused_chain=True``) on the
    CPU — every pass a HostLoop, the walk ending in one packed read —
    against the reference's fused program."""
    (jm, jmd), (tm, tmd) = tiny_both()
    search = dict(num_replica_candidates=96, num_dest_candidates=8,
                  num_swap_candidates=48, apply_per_iter=96,
                  max_iters_per_goal=24, drain_batch=256, fused_chain=True)
    jres = ja.TpuGoalOptimizer(config=JConfig(**search)).optimize(
        jm, jmd, ja.OptimizationOptions(seed=0))
    tres = ta.TorchGoalOptimizer(config=TConfig(**search),
                                 device="cpu").optimize(
        tm, tmd, ta.OptimizationOptions(seed=0))
    assert [p.to_json() for p in jres.proposals] == [
        p.to_json() for p in tres.proposals]
    assert jres.num_moves == tres.num_moves
    for jg, tg in zip(jres.goal_results, tres.goal_results):
        assert (jg.name, jg.iterations, jg.accepted) == (
            tg.name, tg.iterations, tg.accepted)
        assert jg.violation_after == tg.violation_after, jg.name
    assert_same(jres.final_model.replica_broker,
                tres.final_model.replica_broker, what="placement")


def test_packed_read_round_trips_every_dtype():
    xs = [torch.tensor(True), torch.tensor([1.5, -0.0], dtype=torch.float32),
          torch.arange(6, dtype=torch.int64).reshape(2, 3),
          torch.tensor([[3, 4]], dtype=torch.int32)]
    out = te.read_host(*xs, 7)
    for x, y in zip(xs, out):
        assert y.dtype == x.numpy().dtype and y.shape == tuple(x.shape)
        assert x.numpy().tobytes() == y.tobytes()
    assert int(out[-1]) == 7


@pytest.mark.parametrize("words", ["it", "drain"])
def test_tensor_fold_words_equal_int_words(words):
    """A fold word held as an int64 scalar tensor (the graph's counters)
    draws the bits of the same word as a Python int, and of JAX."""
    values = (range(301) if words == "it"
              else [70_000 + r for r in range(16)])
    root = _random.PRNGKey(42)
    jroot = jax.random.PRNGKey(42)
    jkeys = np.asarray(jax.vmap(lambda w: jax.random.fold_in(jroot, w))(
        np.asarray(list(values), np.uint32)))
    ctr = torch.zeros(len(SLOT), dtype=torch.int64)
    word = ctr[SLOT["it"]]
    for j, v in enumerate(values):
        word.fill_(v)
        by_tensor = _random.fold(root, word)
        by_int = _random.fold(root, v)
        assert torch.equal(by_tensor.key(), by_int.key())
        assert np.array_equal(by_tensor.key().numpy(),
                              jkeys[j].astype(np.int64))
        if j % 25 == 0:
            assert torch.equal(_random.uniform(by_tensor, (6,)),
                               _random.uniform(by_int, (6,)))
            assert torch.equal(_random.uniform(_random.fold(by_tensor, 3),
                                               (4,)),
                               _random.uniform(_random.fold(by_int, 3), (4,)))


def test_kl_twin_steps():
    """KL's twin on hand-set counters: each step's test and counters."""
    ctr = torch.zeros(len(SLOT), dtype=torch.int64)
    step = kernels.goal_loop_step_plain
    ctr[SLOT["flag"]] = 1
    ctr[SLOT["it"]] = 9
    assert bool(step(ctr, "active")) and ctr[SLOT["it"]] == 0
    assert bool(step(ctr, "drain_enter", 2))
    ctr[SLOT["flag"]] = 8
    assert bool(step(ctr, "drain_step", 2, 8))
    ctr[SLOT["flag"]] = 7
    assert not bool(step(ctr, "drain_step", 12, 8))
    assert ctr[SLOT["round"]] == 2 and ctr[SLOT["exec_drain"]] == 2
    assert not bool(step(ctr, "fine_enter", 0, 5))
    assert bool(step(ctr, "fine_enter", 2, 5))
    ctr[SLOT["flag"]] = 0
    assert not bool(step(ctr, "rounds_enter", 4))
    assert bool(step(ctr, "fine_step", 2, 5))       # applied 0: one stall
    assert ctr[SLOT["stalls"]] == 1 and ctr[SLOT["it"]] == 1
    ctr[SLOT["flag"]] = 1
    assert bool(step(ctr, "rounds_enter", 1))
    ctr[SLOT["applied"]] = 3
    assert not bool(step(ctr, "rounds_step", 1))    # the group cap
    assert bool(step(ctr, "fine_step", 2, 5))
    assert ctr[SLOT["stalls"]] == 0 and ctr[SLOT["it"]] == 2
    assert ctr[SLOT["exec_loop"]] == 11 and ctr[SLOT["cond"]] == 1
    with pytest.raises(ValueError):
        kernels.goal_loop_step(ctr, "nope")
    assert not bool(kernels.goal_loop_step(ctr, "fine_step", 2, 3))


def test_apply_group_with_nothing_to_do_is_an_identity():
    (_, _), (tm, tmd) = build_both(8, 128, seed=2)
    tst, tctx = ts.init_state(tm), ts.build_context(tm)
    seg = te.PassSegments(tgoals(CHAIN)[0], [], TConfig(**BASE).scaled_for(
        tmd.num_partitions, tmd.num_brokers))
    c, _, _ = seg.propose(tst, tctx, _random.PRNGKey(0), 0)
    out = ts.apply_group(tst, tctx, c, torch.zeros_like(c.valid))
    for f in dataclasses.fields(tst):
        x, y = getattr(tst, f.name), getattr(out, f.name)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.numpy().tobytes() == y.numpy().tobytes(), f.name


# ---------------------------------------------------------------------------
# GraphLoop's graphs, interpreted on the host: the same carry, captures and
# conditional structure as on the card, each "replay" running the segment's
# Python again and each KL node its twin.
# ---------------------------------------------------------------------------

class _Body:
    def __init__(self):
        self.ops = []


class _Graph:
    def __init__(self):
        self.root = _Body()
        self.flags = {}
        self.kl_steps = 0

    def child(self, body, seg):
        body.ops.append(("seg", seg))

    def loop(self, body, ctr, op, a=0, b=0, handle=None):
        body.ops.append(("kl", ctr, op, a, b, handle))

    def handle(self, body):
        return len(self.flags)

    def cond(self, body, handle, loop):
        inner = _Body()
        self.flags[handle] = False
        body.ops.append(("cond", handle, loop, inner))
        return inner

    def instantiate(self):
        pass

    def launch(self):
        self._run(self.root)

    def _run(self, body):
        for op in body.ops:
            if op[0] == "seg":
                op[1].fn()
            elif op[0] == "kl":
                _, ctr, name, a, b, h = op
                cond = bool(kernels.goal_loop_step_plain(ctr, name, a, b))
                self.kl_steps += 1
                if h is not None:
                    self.flags[h] = cond
            elif op[2]:
                while self.flags[op[1]]:
                    self._run(op[3])
            elif self.flags[op[1]]:
                self._run(op[3])


class _Segment:
    def __init__(self, name, fn):
        self.name, self.fn, self.launches, self.rounds = name, fn, {}, 0


class HostInterpreter:
    """A GraphLoop backend that interprets the graphs on the host."""

    def __init__(self):
        self.graphs = []

    def check(self):
        pass

    def segment(self, name, fn):
        return _Segment(name, fn)

    def graph(self):
        self.graphs.append(_Graph())
        return self.graphs[-1]

    def pool_bytes(self):
        return 0

    def synchronize(self):
        pass


@pytest.mark.parametrize("seed", [3, 4])
def test_graph_loop_structure_equals_host_loop(seed):
    """GraphLoop's per-pass and fused graphs, interpreted on the host, give
    HostLoop's states, iterations, stacks and moves, twice in a row (the
    second call reuses every capture); the credited KL launches equal the
    KL steps the graphs ran."""
    from cruise_control_tpu_torch.analyzer.graph_loop import GraphLoop
    (_, _), (tm, tmd) = build_both(8, 128, seed=seed,
                                   dead=(2,) if seed == 4 else ())
    cfg = TConfig(**dict(BASE, apply_groups=3)).scaled_for(
        tmd.num_partitions, tmd.num_brokers)
    chain = te.CompiledGoalChain(tgoals(CHAIN), cfg)
    st, ctx = ts.init_state(tm), ts.build_context(tm)
    backend = HostInterpreter()
    gl = GraphLoop(chain.segments, st, ctx, aux=chain.aux, backend=backend)
    key = _random.PRNGKey(seed)
    kernels.reset_launch_counts()
    for _ in range(2):
        want = chain.fused(st, ctx, key)
        got = gl.run_fused(st, ctx, key)
        _same_state(want[0], got[0], "fused state")
        for a, b in zip(want[1], got[1]):
            assert_same(a, b, what="aux")
        for a, b, what in zip(want[2:], got[2:],
                              ("iters", "bounds", "moves")):
            assert_same(a, b, what=what)
    s_host = s_graph = st
    for i, run in enumerate(chain.passes):
        k = _random.fold(key, 100 + i)
        s_host, it, stack, mv = run(s_host, ctx, k)
        s_graph, git, gstack, gmv = gl.run_pass(i, s_graph, ctx, k)
        assert it == int(git) and int(mv) == int(gmv), CHAIN[i]
        assert_same(stack, gstack, what=f"pass {i} stack")
        _same_state(s_host, s_graph, f"pass {i}")
    gl.settle()
    assert kernels.LAUNCHES["goal_loop"] == sum(g.kl_steps
                                                for g in backend.graphs)
    assert want[2].sum() > 0


def test_graph_loop_under_the_population_walk():
    """The population search over GraphLoop's per-pass graphs (run by the
    host interpreter) gives the host loop's plans, and the KL launches it
    credits equal the KL steps its graphs ran."""
    from cruise_control_tpu_torch.analyzer.constraint import PopulationConfig
    from cruise_control_tpu_torch.analyzer.graph_loop import GraphLoop
    from cruise_control_tpu_torch.parallel.population import \
        make_population_search
    (_, _), (tm, tmd) = build_both(8, 128, seed=3)
    cfg = TConfig(**BASE).scaled_for(tmd.num_partitions, tmd.num_brokers)
    goals = tgoals(CHAIN)
    chain = te.CompiledGoalChain(goals, cfg)
    st, ctx = ts.init_state(tm), ts.build_context(tm)
    backend = HostInterpreter()
    gl = GraphLoop(chain.segments, st, ctx, aux=chain.aux, backend=backend)
    graph_passes = [lambda s, c, k, i=i: gl.run_pass(i, s, c, k)
                    for i in range(len(goals))]
    kernels.reset_launch_counts()
    pop = PopulationConfig(size=4)
    key = _random.PRNGKey(1)
    got = make_population_search(graph_passes, goals, cfg, pop)(st, ctx, key)
    want = make_population_search(chain.passes, goals, cfg, pop)(st, ctx,
                                                                  key)
    for a, b in zip(got[0], want[0]):
        _same_state(a, b, "member")
    for a, b, what in zip(got[2:8], want[2:8],
                          ("iters", "walk bounds", "polish rows", "moves",
                           "accepted", "perms")):
        assert_same(a, b, what=what)
    gl.settle()
    assert kernels.LAUNCHES["goal_loop"] == sum(g.kl_steps
                                                for g in backend.graphs)
