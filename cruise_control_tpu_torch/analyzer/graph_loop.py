"""Goal passes as CUDA graphs whose loops run on the device.

The reference runs each goal pass as one device program: a ``lax.cond``
on the converged test, the bulk drain's ``while_loop``, and the fine
``while_loop`` with the apply rounds' ``while_loop`` inside it
(``cruise_control_tpu/analyzer/engine.py:make_goal_pass``). The port's
pass is split into segments over a carry (:class:`~.engine.PassSegments`);
on the CPU :class:`~.engine.HostLoop` drives them with a host read per loop
test. On the card this module captures every segment once with
``torch.cuda.CUDAGraph(keep_graph=True)`` (one memory pool for a chain)
and builds, with KL's graph functions (``csrc/goal_loop.cu``), one graph per pass
(and one for the whole chain) in which:

- each segment is a child-graph node, a clone of its capture;
- each loop is a CUDA graph conditional node (IF for the converged test,
  WHILE for the drain, the fine loop and the apply rounds), its test
  written by a KL node from the pass's int64 counters after the segment
  that reads it.

A launch copies the caller's state, context and key into the carry, runs
the graph on the current stream and copies the state out; nothing is read
back per iteration. A capture or a launch that fails raises: there is no
fallback to the host loop. The kernels replayed inside the bodies are
credited to ``kernels.LAUNCHES`` from the counters' body-execution counts
(:meth:`GraphLoop.settle`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import time
import weakref
import zlib

import torch

from .. import _random, kernels
from ..kernels import GOAL_LOOP_SLOTS
from . import engine
from .engine import _pack, _unpack

SLOT = {name: i for i, name in enumerate(GOAL_LOOP_SLOTS)}
#: the CUDA version (runtime and installed) nested conditional nodes need
MIN_CUDA = 12040

_P = ctypes.c_void_p


def _lib():
    return kernels.load_library()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"goal-loop graph: {what} failed (cudaError {rc})")


def cuda_versions() -> tuple[int, int]:
    """(installed, runtime) CUDA versions of the kernel library, e.g.
    12040 (``cudaDriverGetVersion``, ``cudaRuntimeGetVersion``)."""
    drv, rt = ctypes.c_int(), ctypes.c_int()
    _check(_lib().cc_cuda_versions(ctypes.byref(drv), ctypes.byref(rt)),
           "cudaDriverGetVersion")
    return drv.value, rt.value


def check_cuda_versions() -> None:
    drv, rt = cuda_versions()
    if min(drv, rt) < MIN_CUDA:
        raise RuntimeError(
            f"goal passes as CUDA graphs need nested conditional nodes "
            f"(CUDA 12.4); the card supports {drv} and the runtime is {rt}")


class _Body:
    """A linear chain of nodes in one graph (the root or a conditional
    body): each node added depends on the one before."""

    __slots__ = ("graph", "last")

    def __init__(self, graph):
        self.graph = graph
        self.last = None


class ParentGraph:
    """A graph built from captured segments, KL nodes and conditional
    nodes; instantiated once and launched on the current stream."""

    def __init__(self):
        lib = _lib()
        g = _P()
        _check(lib.cc_graph_create(ctypes.byref(g)), "cudaGraphCreate")
        self._graph = g
        self._exec = None
        self.root = _Body(g)
        self.segments = []          # the captures, kept alive with the graph

    def child(self, body: _Body, seg) -> None:
        """Append a clone of segment ``seg``'s captured graph."""
        node = _P()
        _check(_lib().cc_graph_add_child(body.graph, body.last,
                                         _P(seg.raw_graph), ctypes.byref(node)),
               f"adding segment {seg.name}")
        body.last = node
        self.segments.append(seg)

    def loop(self, body: _Body, ctr: torch.Tensor, op: str, a: int = 0,
             b: int = 0, handle=None) -> None:
        """Append a KL node: step ``op`` over ``ctr``, writing the test into
        ``handle`` (None: the counters only)."""
        node = _P()
        _check(_lib().cc_graph_add_loop(
            body.graph, body.last, _P(ctr.data_ptr()),
            kernels.GOAL_LOOP_OPS[op], int(a), int(b),
            0 if handle is None else handle, int(handle is not None),
            ctypes.byref(node)), f"adding KL {op}")
        body.last = node

    def handle(self, body: _Body) -> int:
        """A new conditional handle of ``body``'s graph."""
        h = ctypes.c_uint64()
        _check(_lib().cc_graph_handle(body.graph, ctypes.byref(h)),
               "cudaGraphConditionalHandleCreate")
        return h.value

    def cond(self, body: _Body, handle: int, loop: bool) -> _Body:
        """Append a conditional node on ``handle`` (WHILE where ``loop``,
        else IF); returns its body."""
        node, inner = _P(), _P()
        _check(_lib().cc_graph_add_cond(body.graph, body.last, int(loop),
                                        handle, ctypes.byref(node),
                                        ctypes.byref(inner)),
               "adding a conditional node")
        body.last = node
        return _Body(inner)

    def instantiate(self) -> None:
        ex = _P()
        _check(_lib().cc_graph_instantiate(self._graph, ctypes.byref(ex)),
               "cudaGraphInstantiate")
        self._exec = ex
        _check(_lib().cc_graph_upload(ex, _P(kernels._stream())),
               "cudaGraphUpload")

    def launch(self) -> None:
        if self._exec is None:
            self.instantiate()
        _check(_lib().cc_graph_launch(self._exec, _P(kernels._stream())),
               "cudaGraphLaunch")

    def __del__(self):
        try:
            lib = kernels._LIB
            if lib is None:
                return
            if self._exec is not None:
                lib.cc_graph_exec_destroy(self._exec)
            lib.cc_graph_destroy(self._graph)
        except Exception:
            pass


class Segment:
    """One captured segment: ``fn()`` recorded into a CUDA graph on a side
    stream, in the chain's memory pool. The launches its kernel wrappers
    counted while it was captured are kept in ``launches``, and the apply
    rounds it ran in ``rounds`` (both credited per replay, and taken back
    out of ``kernels.LAUNCHES`` and ``engine.APPLY_ROUNDS``). A refused
    capture raises and leaves the device's default CUDA generator as it
    found it."""

    def __init__(self, name: str, fn, pool, stream):
        self.name = name
        before = dict(kernels.LAUNCHES)
        rounds = engine.APPLY_ROUNDS
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # The capture puts the device's default generator into capture; a
        # capture that is refused never takes it out (its end raises before
        # the generator's epilogue), and the next draw outside a capture
        # would raise. Its state as it was goes back in on a refusal.
        generator = torch.cuda.default_generators[
            torch.cuda.current_device()]
        saved = generator.clone_state()
        # A cyclic collection inside the capture could free an earlier
        # chain's graphs, whose destruction the capture does not allow.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                fn()
        except BaseException:
            generator.graphsafe_set_state(saved)
            raise
        finally:
            if collecting:
                gc.enable()
            self.launches = {k: v - before[k]
                             for k, v in kernels.LAUNCHES.items()
                             if v != before[k]}
            kernels.LAUNCHES.update(before)
            self.rounds = engine.APPLY_ROUNDS - rounds
            engine.APPLY_ROUNDS = rounds
        self.graph = graph
        self.raw_graph = graph.raw_cuda_graph()
        msg = ctypes.create_string_buffer(256)
        if _lib().cc_graph_check_body(_P(self.raw_graph), msg, 256) != 0:
            raise RuntimeError(
                f"goal-loop segment {name} captured {msg.value.decode()}, "
                f"which a conditional body may not hold")


class CudaBackend:
    """The card's side of a :class:`GraphLoop`: captures on a side stream
    into one memory pool, graphs built with KL's graph functions."""

    def __init__(self):
        self.pool = None
        self.stream = None

    def check(self) -> None:
        check_cuda_versions()
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream()

    def segment(self, name: str, fn) -> Segment:
        return Segment(name, fn, self.pool, self.stream)

    def graph(self) -> ParentGraph:
        return ParentGraph()

    def pool_bytes(self) -> int:
        """Device memory the chain's capture pool holds."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def synchronize(self) -> None:
        torch.cuda.synchronize()


def signature(state, ctx) -> tuple:
    """What a chain's graphs are captured for: every field's shape and
    dtype (None for an absent one) and the device."""
    def sig(obj):
        return tuple((f.name, None if (t := getattr(obj, f.name)) is None
                      else (tuple(t.shape), t.dtype))
                     for f in dataclasses.fields(obj))
    return sig(state), sig(ctx), state.rb.device


def _buffers_like(obj):
    """A dataclass of fresh tensors shaped like ``obj``'s (None kept)."""
    return dataclasses.replace(obj, **{
        f.name: None if (t := getattr(obj, f.name)) is None
        else torch.empty_like(t, memory_format=torch.contiguous_format)
        for f in dataclasses.fields(obj)})


def _store(dst, src) -> None:
    """Copy the dataclass ``src``'s tensors into ``dst``'s buffers (a
    tensor that is already its buffer is left alone)."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if d is None:
            if s is not None:
                raise RuntimeError(f"goal-loop carry has no {f.name}")
            continue
        if s is not d:
            d.copy_(s)


def _clone(obj):
    return dataclasses.replace(obj, **{
        f.name: None if (t := getattr(obj, f.name)) is None else t.clone()
        for f in dataclasses.fields(obj)})


#: the counters a pass's bodies count their executions in, and the
#: segment each counts (None: the KL nodes themselves)
_EXEC = (("exec_drain", "drain"), ("exec_fine", "propose"),
         ("exec_round", "round"), ("exec_loop", None))
#: the slice of the counters holding them (contiguous, in _EXEC's order)
_EXEC_SLOTS = slice(SLOT["exec_drain"], SLOT["exec_loop"] + 1)

#: every live GraphLoop, for :func:`settle`
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class GraphLoop:
    """The CUDA graphs of a chain of goal passes (:class:`~.engine.
    PassSegments`) at one state and context signature.

    The carry — the state, the context, each pass's key, counters and
    candidates, the outputs — is a set of fixed buffers that the graphs
    read and write. Every segment is captured once (a CUDA graph in the
    chain's memory pool), after one eager run on the caller's own inputs
    that makes every lazy upload and library load happen before capture.
    Graphs: one a pass (``run_pass``, built at its first use) and one for
    the whole chain (``run_fused``: the initial readings, every pass with
    its key folded from the chain's, and one packed buffer of the
    readings)."""

    def __init__(self, segments, state, ctx, aux=None, backend=None):
        #: captures segments and makes graphs (the card's; a test may hand
        #: in a host interpreter of the same structure)
        self.backend = backend or CudaBackend()
        self.backend.check()
        t0 = time.perf_counter()
        self.segments = list(segments)
        self.aux_fn = aux
        G = len(self.segments)
        dev = state.rb.device
        n_all = len(self.segments[0].all_goals)
        self.state = _buffers_like(state)
        self.ctx = _buffers_like(ctx)
        self._ctx_src = None
        self.root = torch.zeros(2, dtype=torch.int64, device=dev)
        self.keys = torch.zeros((G, 2), dtype=torch.int64, device=dev)
        self.ctr = torch.zeros((G, len(SLOT)), dtype=torch.int64, device=dev)
        self.iters = torch.zeros(G, dtype=torch.int64, device=dev)
        self.bounds = torch.zeros((G, n_all), dtype=torch.float32,
                                  device=dev)
        self.moves = torch.zeros(G, dtype=torch.int64, device=dev)
        self.load(state, ctx)
        #: host-side launch counts not yet credited to kernels.LAUNCHES
        self._pending_pass = [0] * G
        self._pending_fused = 0
        self.segs: list[dict] = [self._capture_pass(i) for i in range(G)]
        self._fused_segs = None
        self._pass_graphs: list[ParentGraph | None] = [None] * G
        self._fused_graph = None
        #: time (s) spent building the pass and fused graphs at first use
        self.graphs_s = 0.0
        self.backend.synchronize()
        #: cold capture time (s); device memory (bytes) of the carry and
        #: of the captures' pool
        self.capture_s = time.perf_counter() - t0
        self.carry_bytes = sum(
            t.numel() * t.element_size()
            for obj in (self.state, self.ctx,
                        *(s["cand"][0] for s in self.segs))
            for f in dataclasses.fields(obj)
            if (t := getattr(obj, f.name)) is not None) + sum(
            t.numel() * t.element_size()
            for t in (self.root, self.keys, self.ctr, self.iters,
                      self.bounds, self.moves,
                      *(x for s in self.segs for x in s["cand"][1:])))
        self.pool_bytes = self.backend.pool_bytes()
        _record_capture(self, self.capture_s)
        _LIVE.add(self)

    # ------------------------------------------------------------ carry
    def load(self, state, ctx) -> None:
        _store(self.state, state)
        if ctx is not self._ctx_src:
            _store(self.ctx, ctx)
            self._ctx_src = ctx

    def _word(self, i: int, name: str) -> torch.Tensor:
        return self.ctr[i, SLOT[name]]

    # ---------------------------------------------------------- capture
    def _capture_pass(self, i: int) -> dict:
        seg = self.segments[i]
        S, C, ctr = self.state, self.ctx, self.ctr[i]
        key = _random.KeyPath(self.keys[i])
        it, rnd = self._word(i, "it"), self._word(i, "round")
        flag, applied = self._word(i, "flag"), self._word(i, "applied")

        # One eager run of every segment on the carry (outputs dropped, the
        # candidates kept as the rounds' carry): lazy uploads happen here.
        seg.active(S, C)
        if seg.drains:
            seg.drain(S, C, key, rnd)
        c, ce, pend = seg.propose(S, C, key, it)
        cand = (_clone(c), ce.clone(), pend.clone())
        seg.round(S, C, *cand)
        seg.stack(S, C)

        # KX writes the converged test into the carry itself
        def active():
            seg.active(S, C, flag=flag)

        # KM writes the drain and apply rounds into the carry itself
        def drain():
            flag.copy_(seg.drain(S, C, key, rnd, out=S)[1])

        # KW writes the proposal and the flag into the carry itself
        def propose():
            seg.propose(S, C, key, it, out=cand, flag=flag)

        def round_():
            _st, pend2, n, more = seg.round(S, C, *cand, out=S)
            cand[2].copy_(pend2)
            applied.add_(n)
            flag.copy_(more)

        def out():
            seg.stack(S, C, out=self.bounds[i])
            self.moves[i].copy_(S.moves_applied)
            self.iters[i].copy_(it)

        name = f"{i}:{seg.goal.name}"
        caps = {"active": active, "propose": propose, "round": round_,
                "out": out}
        if seg.drains:
            caps["drain"] = drain
        out_segs = {k: self.backend.segment(f"{name}.{k}", fn)
                    for k, fn in caps.items()}
        out_segs["cand"] = cand
        return out_segs

    def _capture_fused(self) -> dict:
        G = len(self.segments)
        S, C = self.state, self.ctx
        off, scales, v0 = (t.clone() for t in self.aux_fn(S, C))
        self.aux = (off, scales, v0)
        readings = [off, scales, v0, self.iters, self.bounds, self.moves,
                    self.ctr[:, _EXEC_SLOTS]]
        self._readings = readings
        self.packed = torch.empty(sum(t.numel() * t.element_size()
                                      for t in readings),
                                  dtype=torch.uint8, device=off.device)

        def aux():
            self.aux_fn(S, C, out=self.aux)

        def fold(i):
            def f():
                self.keys[i].copy_(_random.fold(self.root, i).key())
            return f

        def pack():
            self.packed.copy_(_pack([off, scales, v0, self.iters,
                                     self.bounds, self.moves,
                                     self.ctr[:, _EXEC_SLOTS]]))
            self.ctr[:, _EXEC_SLOTS].zero_()

        fold(0)()                           # eager: the draw's first use
        seg = self.backend.segment
        segs = {"aux": seg("chain.aux", aux), "pack": seg("chain.pack", pack),
                "fold": [seg(f"{i}.fold", fold(i)) for i in range(G)]}
        return segs

    # ----------------------------------------------------------- graphs
    def _build_pass(self, pg: ParentGraph, body, i: int) -> None:
        """Append pass i to ``body``: its converged test (IF), the drain
        (WHILE), the fine loop (WHILE) with the apply rounds (WHILE) in it,
        then its boundary readings."""
        seg, segs, ctr = self.segments[i], self.segs[i], self.ctr[i]
        cfg = seg.cfg
        pg.child(body, segs["active"])
        h = pg.handle(body)
        pg.loop(body, ctr, "active", handle=h)
        act = pg.cond(body, h, loop=False)
        if seg.drains:
            h = pg.handle(act)
            pg.loop(act, ctr, "drain_enter", cfg.drain_rounds, handle=h)
            dr = pg.cond(act, h, loop=True)
            pg.child(dr, segs["drain"])
            pg.loop(dr, ctr, "drain_step", cfg.drain_rounds, seg.min_applied,
                    handle=h)
        limits = (cfg.stall_patience, cfg.max_iters_per_goal)
        hf = pg.handle(act)
        pg.loop(act, ctr, "fine_enter", *limits, handle=hf)
        fine = pg.cond(act, hf, loop=True)
        pg.child(fine, segs["propose"])
        hr = pg.handle(fine)
        pg.loop(fine, ctr, "rounds_enter", cfg.apply_groups, handle=hr)
        rounds = pg.cond(fine, hr, loop=True)
        pg.child(rounds, segs["round"])
        pg.loop(rounds, ctr, "rounds_step", cfg.apply_groups, handle=hr)
        pg.loop(fine, ctr, "fine_step", *limits, handle=hf)
        pg.child(body, segs["out"])

    def _pass_graph(self, i: int) -> ParentGraph:
        pg = self._pass_graphs[i]
        if pg is None:
            t0 = time.perf_counter()
            pg = self.backend.graph()
            self._build_pass(pg, pg.root, i)
            pg.instantiate()
            self._pass_graphs[i] = pg
            self.graphs_s += time.perf_counter() - t0
        return pg

    def _fused(self) -> ParentGraph:
        if self._fused_graph is None:
            if self.aux_fn is None:
                raise RuntimeError("this goal-loop graph has no aux readings "
                                   "for the fused chain")
            t0 = time.perf_counter()
            self._fused_segs = self._capture_fused()
            pg = self.backend.graph()
            pg.child(pg.root, self._fused_segs["aux"])
            for i in range(len(self.segments)):
                pg.child(pg.root, self._fused_segs["fold"][i])
                self._build_pass(pg, pg.root, i)
            pg.child(pg.root, self._fused_segs["pack"])
            pg.instantiate()
            self._fused_graph = pg
            self.graphs_s += time.perf_counter() - t0
        return self._fused_graph

    # ---------------------------------------------------------- launches
    def run_pass(self, i: int, state, ctx, key):
        """Pass i on ``state`` with ``key`` (a key or a key path): (state,
        int64 iters, f32 violations over all goals, int64 moves), on the
        device; nothing is read back."""
        pg = self._pass_graph(i)
        self.load(state, ctx)
        self.keys[i].copy_(_random.path(key).key())
        pg.launch()
        self._pending_pass[i] += 1
        return (_clone(self.state), self.iters[i].clone(),
                self.bounds[i].clone(), self.moves[i].clone())

    def run_fused(self, state, ctx, key):
        """The whole chain in one graph launch and one packed read: (state,
        aux, iters, boundary stacks, moves) as :meth:`~.engine.
        CompiledGoalChain.fused` returns them."""
        pg = self._fused()
        self.load(state, ctx)
        self.root.copy_(_random.path(key).key())
        pg.launch()
        self._pending_fused += 1
        out = _clone(self.state)
        host = _unpack(self.packed.cpu().numpy(), self._readings)
        self._credit(host[6])
        return out, (host[0], host[1], host[2]), host[3], host[4], host[5]

    # ------------------------------------------------------ launch counts
    def _credit(self, execs) -> None:
        """Add to ``kernels.LAUNCHES`` the kernels replayed since the last
        credit (and to ``engine.APPLY_ROUNDS`` the rounds): each segment's
        captured launches times its executions."""
        add: dict[str, int] = {}

        def count(seg, times):
            for k, v in seg.launches.items():
                add[k] = add.get(k, 0) + v * int(times)
            engine.APPLY_ROUNDS += seg.rounds * int(times)

        for i, segs in enumerate(self.segs):
            ran = self._pending_pass[i] + self._pending_fused
            count(segs["active"], ran)
            count(segs["out"], ran)
            for (slot, name), n in zip(_EXEC, execs[i]):
                if name is None:
                    add["goal_loop"] = add.get("goal_loop", 0) + int(n)
                elif name in segs:
                    count(segs[name], n)
            self._pending_pass[i] = 0
        if self._fused_segs is not None:
            for seg in (self._fused_segs["aux"], self._fused_segs["pack"],
                        *self._fused_segs["fold"]):
                count(seg, self._pending_fused)
        self._pending_fused = 0
        for k, v in add.items():
            kernels.LAUNCHES[k] += v

    def settle(self) -> None:
        """Credit the launches of the pass graphs run since the last fused
        call or settle (one read of the counters)."""
        if not any(self._pending_pass) and not self._pending_fused:
            return
        execs = self.ctr[:, _EXEC_SLOTS].cpu().numpy().copy()
        self.ctr[:, _EXEC_SLOTS].zero_()
        self._credit(execs)


def settle() -> None:
    """Credit every live goal-loop graph's replayed kernels to
    ``kernels.LAUNCHES`` (the fused chain credits its own at its read)."""
    for gl in list(_LIVE):
        gl.settle()


def _record_capture(gl: GraphLoop, seconds: float) -> None:
    from ..core.runtime_obs import default_collector
    names = ",".join(s.goal.name for s in gl.segments)
    default_collector().record_capture(
        f"goal_loop[{len(gl.segments)}:{zlib.crc32(names.encode()):08x}]",
        seconds)
