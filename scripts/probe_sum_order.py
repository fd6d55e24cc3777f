"""Probe the float32 summation orders that XLA's CPU backend gives the JAX
package's intra-broker (JBOD) sums and the population's weighted row,
which the PyTorch port reproduces:

1. the mean over the D disks of each broker (``[B, D]`` row sums), eagerly
   as ``analyzer/intra.py:_violations`` computes it and inside the compiled
   ``lax.while_loop`` body of ``optimize_intra_broker`` (D = 2-256);
2. the eager whole-matrix ``jnp.sum`` of a small ``[b, d]`` matrix (b <= 32
   rows, d <= 8 columns), which LLVM vectorizes over f row accumulators;
3. ``--padded``: the eager ``jnp.sum`` of a matrix with an axis of 31 mod
   32 elements (63, 95, 127), whose last 32-wide window holds one padding
   element: read from the dumped reduce-window kernel (XLA peels the
   window's last column, or its last row), then confirmed against numpy
   models of the peeled orders (``utils/ordered.py:matrix_sum``);
4. ``--weighted``: the weighted row ``(norm * w).sum(-1)`` of the
   population program (``parallel/population.py:_scores``: the normalized
   stacks also feed the Pareto ranks) at 20-64 goals, K = 2 and 16 plans,
   with and without a move weight, for unit, shared and mixed weights:
   the vector widths read from the dumped fusion, then the loop shapes
   (``analyzer/engine.py:WEIGHTED_ROW_LOOPS``) that matched every trial.
   With mixed weights every product feeding an add is an FMA; with two
   accumulators the x86 backend re-associates the second one's chain onto
   the first's (read from the object code with ``objdump -d``: one
   ``vfmadd`` chain over chunks 0, 2, 4, 3, 1, 5 at 28 goals).

Each probe feeds float32 values spread over 30 binades, or within one
binade (so that any two orders give other bits), through XLA and through
numpy models of candidate orders, and prints which candidates matched
every trial. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/probe_sum_order.py [--trials N]
        [--padded] [--weighted] [--single] [--dump DIR]
"""

from __future__ import annotations

import argparse
import atexit
import glob
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA reads its flags when JAX starts: the dump directory is set first
_PRE = argparse.ArgumentParser(add_help=False)
_PRE.add_argument("--dump", default=None)
DUMP = _PRE.parse_known_args()[0].dump
if DUMP is None:
    DUMP = tempfile.mkdtemp(prefix="xla_dump_")
    atexit.register(shutil.rmtree, DUMP, ignore_errors=True)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_dump_to={DUMP}").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

f32 = np.float32


def _in_order(values) -> np.float32:
    acc = f32(0)
    for v in values:
        acc = f32(acc + v)
    return acc


def _tree(row) -> np.float32:
    """XLA's CPU tree order: windows of 32 (padding split evenly in front
    and behind) summed in order, repeated until at most 32 sums remain."""
    x = list(row)
    while len(x) > 32:
        n = len(x)
        w = -(-n // 32)
        pad = w * 32 - n
        x = [f32(0)] * (pad // 2) + x + [f32(0)] * (pad - pad // 2)
        x = [_in_order(x[i * 32:(i + 1) * 32]) for i in range(w)]
    return _in_order(x)


def _lanes(x, f) -> np.float32:
    """f accumulators over the whole f-row groups (lane l: rows l, l + f,
    ...), folded by halves, then the leftover rows in order."""
    b, d = x.shape
    full = b // f * f if f > 1 else 0
    acc = [f32(0)] * max(f, 1)
    for r in range(full):
        for c in range(d):
            acc[r % f] = f32(acc[r % f] + x[r, c])
    while len(acc) > 1:
        half = len(acc) // 2
        acc = [f32(acc[k] + acc[k + half]) for k in range(half)]
    return _in_order([acc[0]] + list(x[full:].reshape(-1)))


def _spread(rng, shape):
    return (rng.random(shape) * 2.0 ** rng.integers(-10, 20, shape)
            ).astype(f32)


def _while_body_mean(util, live):
    """The mean of ``optimize_intra_broker``'s pressure, inside a compiled
    while loop whose util comes from a scatter-add, as in the reference."""
    B, D = util.shape

    @jax.jit
    def run(vals, live):
        idx = jnp.arange(B * D)

        def body(carry):
            it, _, _ = carry
            u = jnp.zeros((B * D,), jnp.float32).at[idx].add(vals).reshape(
                B, D)
            n_live = jnp.maximum(live.sum(axis=1, keepdims=True), 1)
            avg = jnp.where(live, u, 0.0).sum(axis=1, keepdims=True) / n_live
            pres = jnp.where(live, u - avg, -jnp.inf)
            return it + 1, jnp.argmax(pres, axis=1).sum() < 0, pres

        return jax.lax.while_loop(
            lambda c: c[1], body,
            (jnp.zeros((), jnp.int32), jnp.ones((), bool),
             jnp.zeros((B, D), jnp.float32)))[2]
    return np.asarray(run(jnp.asarray(util.reshape(-1)), jnp.asarray(live)))


def probe_rows(trials: int) -> None:
    print("D-axis mean: candidates matching every trial (eager | while body)")
    for D in (2, 5, 6, 8, 9, 12, 16, 24, 31, 32, 33, 40, 48, 63, 64,
              65, 95, 96, 128, 256):
        rng = np.random.default_rng(D)
        eager = {"in order": True, "tree": True}
        body = dict(eager)
        for _ in range(trials):
            util = _spread(rng, (8, D))
            live = rng.random((8, D)) < 0.9
            masked = np.where(live, util, f32(0))
            n_live = np.maximum(live.sum(1), 1).astype(f32)
            want_eager = np.asarray(jnp.where(live, util, 0.0).sum(axis=1))
            want_body = _while_body_mean(util, live)
            for name, order in (("in order", _in_order), ("tree", _tree)):
                sums = np.array([order(r) for r in masked], f32)
                eager[name] &= np.array_equal(sums, want_eager)
                pres = np.where(live, util - (sums / n_live)[:, None],
                                -np.inf).astype(f32)
                body[name] &= np.array_equal(pres, want_body)
        print(f"  D={D:2d}: {[k for k, v in eager.items() if v]} | "
              f"{[k for k, v in body.items() if v]}")


def probe_small_matrices(trials: int) -> None:
    print("eager jnp.sum of [b, d]: accumulators f matching every trial "
          "(1 = in order)")
    total = jax.jit(jnp.sum)
    for b in range(2, 33):
        row = []
        for d in range(2, 9):
            rng = np.random.default_rng(b * 100 + d)
            ok = {f: True for f in (1, 2, 4, 8, 16)}
            for _ in range(trials):
                x = _spread(rng, (b, d))
                want = f32(total(x))
                for f in ok:
                    ok[f] &= _lanes(x, f) == want
            row.append([f for f, v in ok.items() if v])
        print(f"  b={b:2d}: " + " ".join(
            f"d{d}:{'/'.join(map(str, fs)) or '-'}"
            for d, fs in zip(range(2, 9), row)))


def _ir_summary(tag, kind):
    """The vector ops of a dumped kernel of program ``tag`` whose file
    name holds ``kind``: counts of ``fadd reassoc`` by width and of
    horizontal ``reduce.fadd``, or "scalar"."""
    import re
    from collections import Counter
    files = [f for f in sorted(glob.glob(os.path.join(
        DUMP, f"*jit_{tag}.*{kind}*ir-with-opt.ll")))]
    if not files:
        return "no kernel"
    text = open(files[-1]).read()
    ops = Counter(re.findall(r"fadd reassoc (<\d+ x float>)", text))
    ops.update(re.findall(r"reduce\.fadd\.(v\d+f32)", text))
    blocks = len(re.findall(r"^\S+:", text, flags=re.M))
    return (", ".join(f"{n} x {k}" for k, n in sorted(ops.items()))
            or "scalar") + f"; {blocks} blocks"


def _window_sum(win, valid, peel_col, peel_row):
    """One window of the padded reduce-window in the order read from the
    IR: the peeled column last (down the rows), or the first b - 1 rows in
    lanes then the peeled row, or every element in row order."""
    b, d = win.shape
    if peel_col:
        order = [(r, c) for r in range(b) for c in range(d - 1)] + \
            [(r, d - 1) for r in range(b)]
        return _in_order([win[r, c] for r, c in order if valid[r, c]])
    if peel_row and 2 <= d <= 8:
        f = _matrix_lanes(b - 1, d)
        full = (b - 1) // f * f if f > 1 else 0
        head = _lanes(win[:full], f) if full else np.float32(0)
        rest = [win[r, c] for r in range(full, b) for c in range(d)
                if valid[r, c]]
        return _in_order([head] + rest)
    return _in_order([win[r, c] for r in range(b) for c in range(d)
                      if valid[r, c]])


def _matrix_lanes(b, d):
    """``utils/ordered.py:_lanes``: LLVM's row accumulators of a [b, d]
    eager sum (fitted by :func:`probe_small_matrices`)."""
    if d >= 9:
        return 1
    if b < 16:
        return b if b in (2, 4, 8) else 1
    if d >= 7:
        return 4
    return 8 if b % 8 < 4 or (d == 2 and b >= 28) else 4


def _padded_model(x, peel):
    """The windowed eager sum of x[B, D] (one axis of 31 mod 32 over 32):
    window sums in the peeled order, then the window matrix in row order
    (it is at most 4 x 4 here and matches the small-matrix rule)."""
    B, D = x.shape
    wb, wd = min(B, 32), min(D, 32)
    nb, nd = -(-B // wb), -(-D // wd)
    pb, pd = nb * wb - B, nd * wd - D
    xp = np.zeros((nb * wb, nd * wd), np.float32)
    ok = np.zeros_like(xp, bool)
    xp[pb // 2:pb // 2 + B, pd // 2:pd // 2 + D] = x
    ok[pb // 2:pb // 2 + B, pd // 2:pd // 2 + D] = True
    parts = np.array([[_window_sum(
        xp[i * wb:(i + 1) * wb, j * wd:(j + 1) * wd],
        ok[i * wb:(i + 1) * wb, j * wd:(j + 1) * wd],
        peel and pd == 1, peel and pb == 1 and pd == 0)
        for j in range(nd)] for i in range(nb)], np.float32)
    if nb == 1 or nd == 1:
        return _tree(parts.reshape(-1))
    return _lanes(parts, _matrix_lanes(nb, nd)) if nb <= 32 else None


def probe_padded(trials: int) -> None:
    print("eager jnp.sum with one padding element: the reduce-window "
          "kernel's vector ops; models matching every trial")
    for B, D in ((8, 63), (104, 63), (63, 63), (8, 95), (40, 95), (63, 4),
                 (63, 8), (95, 4), (95, 2), (127, 4), (63, 33)):
        tag = f"padded_{B}_{D}"

        def total(x):
            return jnp.sum(x)
        total.__name__ = tag
        run = jax.jit(total)
        rng = np.random.default_rng(B * 100 + D)
        ok = {"row order": True, "peeled": True}
        for _ in range(trials):
            x = _spread(rng, (B, D))
            x[rng.random((B, D)) < 0.2] = 0
            want = np.float32(run(x))
            ok["row order"] &= _padded_model(x, False) == want
            ok["peeled"] &= _padded_model(x, True) == want
        print(f"  [{B:3d}, {D:3d}]: {_ir_summary(tag, 'reduce-window'):<40}"
              f" {[k for k, v in ok.items() if v]}")


def _fma(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _halves(v):
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [np.float32(v[k] + v[k + h]) for k in range(h)]
    return v[0]


def _chain_order(G, vf, ic):
    """Chunk order of an FMA loop of vf lanes by ic accumulators: the first
    accumulator's chain, then each other one's (its second chunk first:
    the backend contracts its first add into an FMA whose addend is the
    second chunk's product, then re-associates the whole chain onto the
    previous accumulator)."""
    iters = G // (vf * ic)
    if iters == 1 or ic == 1:
        return list(range(iters * ic))
    accs = [[it * ic + k for it in range(iters)] for k in range(ic)]
    order = list(accs[0])
    for a in accs[1:]:
        order += [a[1], a[0]] + a[2:]
    return order


def _weighted_models(G, mixed):
    """Candidate orders of the weighted row: name -> f(norm_row, w)."""
    def in_order(x, w):
        acc = np.float32(0)
        for g in range(G):
            acc = (_fma(x[g], w[g], acc) if mixed
                   else np.float32(acc + np.float32(x[g] * w[g])))
        return acc
    models = {"in order": in_order}
    if G > 32:
        models = {"tree": lambda x, w: _tree(
            np.array([np.float32(x[g] * w[g]) for g in range(G)]))}
        return models
    for vf in (2, 4, 8):
        for ic in (1, 2, 4):
            iters = G // (vf * ic)
            if not iters:
                continue
            if mixed:
                order = _chain_order(G, vf, ic)

                def chain(x, w, vf=vf, order=order):
                    lanes = [np.float32(0)] + [np.float32(-0.0)] * (vf - 1)
                    for c in order:
                        lanes = [_fma(x[c * vf + l], w[c * vf + l], lanes[l])
                                 for l in range(vf)]
                    acc = _halves(lanes)
                    for g in range(len(order) * vf, G):
                        acc = _fma(x[g], w[g], acc)
                    return acc
                models[f"fma {vf} lanes, chunks {order}"] = chain
            else:
                def loop(x, w, vf=vf, ic=ic, iters=iters):
                    p = [np.float32(x[g] * w[g]) for g in range(G)]
                    lanes = []
                    for l in range(vf):
                        s = None
                        for k in range(ic):
                            a = np.float32(0 if k == 0 and l == 0 else -0.0)
                            for it in range(iters):
                                a = np.float32(a + p[(it * ic + k) * vf + l])
                            s = a if s is None else np.float32(s + a)
                        lanes.append(s)
                    acc = _halves(lanes)
                    for g in range(iters * vf * ic, G):
                        acc = np.float32(acc + p[g])
                    return acc
                models[f"({vf}, {ic}, 0, 0)"] = loop
    return models


def probe_weighted(trials: int) -> None:
    import cruise_control_tpu.analyzer.engine as jeng
    print("population program's weighted row: the fusion's vector ops at "
          "K = 16, then the models matching every trial at K = 2 and 16, "
          "with and without a move weight")
    for G in (20, 22, 23, 24, 25, 27, 28, 29, 30, 31, 32, 33, 40, 64):
        for kind in ("one", "shared", "mixed"):
            rng = np.random.default_rng(G * 10 + len(kind))
            hard = {"one": np.zeros(G, bool), "shared": np.ones(G, bool),
                    "mixed": rng.random(G) < 0.4}[kind]
            w = np.where(hard, np.float32(1000.0), np.float32(1.0)).astype(
                np.float32)
            models = _weighted_models(G, kind == "mixed")
            ok = dict.fromkeys(models, True)
            summary = ""
            for K in (16, 2):
                for mw in (0.0, 0.1):
                    tag = f"weighted_{G}_{kind}_{K}_{int(mw * 10)}"

                    def scores(b, m, s, K=K, mw=mw, hard=hard):
                        weighted = jeng.weighted_objective(
                            b, s, hard, hard_weight=1000.0,
                            move_weight=mw, moves=m)
                        ranks = jeng.pareto_ranks(b, s)
                        return weighted, jnp.lexsort(
                            (jnp.arange(K), weighted,
                             ranks.astype(jnp.float32)))
                    scores.__name__ = tag
                    run = jax.jit(scores)
                    norm_fn = jax.jit(jeng.normalized_stacks)
                    for t in range(trials):
                        scales = _spread(rng, (G,)) % 100 + 1
                        if t % 2:
                            b = _spread(rng, (K, G))
                        else:
                            b = ((1 + rng.random((K, G))) * scales * 4
                                 ).astype(np.float32)
                        m = rng.integers(0, 1000, K).astype(np.int32)
                        want = np.asarray(run(b, m, scales)[0])
                        norm = np.asarray(norm_fn(b, scales))
                        for name, f in models.items():
                            if not ok[name]:
                                continue
                            got = np.array([f(norm[j], w) for j in range(K)],
                                           np.float32)
                            if mw:
                                got = np.array([_fma(np.float32(mw), np.float32(
                                    m[j]), got[j]) for j in range(K)])
                            ok[name] = np.array_equal(got, want)
                    if K == 16 and not mw:
                        summary = _ir_summary(tag, "multiply_reduce") if (
                            kind != "one") else _ir_summary(tag,
                                                            "select_reduce")
            print(f"  G={G:2d} {kind:<6} {summary:<44} "
                  f"{[k for k, v in ok.items() if v][:2]}", flush=True)


def probe_single_plan(trials: int) -> None:
    """A single plan (K = 1): the weighted row compiled in three forms of
    the scoring program: returning the scores and their lexsort order (as
    ``--weighted`` compiles K >= 2), and returning the scores, the Pareto
    ranks and the survivor permutation with the Pareto or a zero primary
    key (``_survivor_perm``). Unlike K >= 2, whose loops ``--weighted``
    finds the same at every K and move weight, the loop LLVM picks for one
    row changes with the form, so the port refuses K = 1 at 23-32 goals."""
    import cruise_control_tpu.analyzer.engine as jeng
    print("single plan (K = 1): models matching every trial in each form "
          "of the program")
    for G in (23, 24, 25, 27, 28, 29, 32):
        for kind in ("one", "shared", "mixed"):
            rng = np.random.default_rng(G * 10 + len(kind))
            hard = {"one": np.zeros(G, bool), "shared": np.ones(G, bool),
                    "mixed": rng.random(G) < 0.4}[kind]
            w = np.where(hard, np.float32(1000.0), np.float32(1.0)).astype(
                np.float32)
            line = []
            for form in ("order", "perm-pareto", "perm-zero"):
                models = _weighted_models(G, kind == "mixed")
                ok = dict.fromkeys(models, True)

                def scores(b, m, s, hard=hard, form=form):
                    weighted = jeng.weighted_objective(
                        b, s, hard, hard_weight=1000.0, move_weight=0.0,
                        moves=m)
                    ranks = jeng.pareto_ranks(b, s)
                    primary = (jnp.zeros_like(weighted) if form == "perm-zero"
                               else ranks.astype(jnp.float32))
                    order = jnp.lexsort((jnp.arange(1), weighted, primary))
                    if form == "order":
                        return weighted, order
                    return weighted, ranks, order[:1].at[0].set(0)
                scores.__name__ = f"single_{G}_{kind}_{form.replace('-', '_')}"
                run = jax.jit(scores)
                for t in range(trials):
                    scales = _spread(rng, (G,)) % 100 + 1
                    b = (_spread(rng, (1, G)) if t % 2 else
                         ((1 + rng.random((1, G))) * scales * 4).astype(
                             np.float32))
                    want = np.asarray(run(b, np.zeros(1, np.int32),
                                          scales)[0])
                    norm = np.asarray(jax.jit(jeng.normalized_stacks)(
                        b, scales))
                    for name, f in models.items():
                        if ok[name]:
                            ok[name] = f(norm[0], w) == want[0]
                line.append(f"{form}: {[k for k, v in ok.items() if v][:1]}")
            print(f"  G={G:2d} {kind:<6} " + " | ".join(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--padded", action="store_true",
                    help="only the matrix sums with one padding element")
    ap.add_argument("--weighted", action="store_true",
                    help="only the population program's weighted row")
    ap.add_argument("--single", action="store_true",
                    help="only the weighted row of a single plan (K = 1)")
    ap.add_argument("--dump", default=None,
                    help="keep XLA's dump in this directory")
    args = ap.parse_args()
    print("jax", jax.__version__, "dump", DUMP)
    if args.padded or args.weighted or args.single:
        if args.padded:
            probe_padded(args.trials)
        if args.weighted:
            probe_weighted(args.trials)
        if args.single:
            probe_single_plan(args.trials)
        return
    probe_rows(args.trials)
    probe_small_matrices(args.trials)
    probe_padded(args.trials)


if __name__ == "__main__":
    main()
