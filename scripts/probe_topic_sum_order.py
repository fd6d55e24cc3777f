#!/usr/bin/env python3
"""Probe the float32 order in which XLA's CPU backend sums
TopicReplicaDistributionGoal's ``[T, B1]`` violation cells, which the
PyTorch port reproduces (``cruise_control_tpu_torch/utils/ordered.py``:
``topic_cell_sum``, ``_topic_loop``).

The goal's violation is ``pen.sum()`` over a ``[T, B1]`` penalty plane
(``cruise_control_tpu/analyzer/goals.py:1215-1219``). XLA's tree rewrite
splits any reduced axis longer than 32 into windows, which leaves an
unfused reduction (the eager ``jnp.sum`` order, ``ordered.py:
matrix_sum``); a plane of at most 32 x 32 reduces inside the penalty's
fusion, where LLVM's loop vectorizer picks the order: either it vectorizes
the loop over a row (each row a vector loop seeded with the running
total), or it unrolls the row and vectorizes the loop over rows (lanes
holding whole rows).

For each shape the script feeds topic counts spread over 14 binades (any
two orders give other bits) through the reference's jitted violation —
unbatched, or vmapped once or twice as the what-if and fleet scorers run
it — and through numpy models of both loop families (VF 1-16 lanes, 1-4
accumulators, 0/4/8-lane epilogues, a scalar tail of 0 or 1) and of the
eager order, prints the models that matched every trial, and says whether
the port's ``topic_cell_sum`` matched every trial. Runs on the CPU (about
a second a shape):

    JAX_PLATFORMS=cpu python scripts/probe_topic_sum_order.py \\
        [--shapes 8x9,8x23,200x104x3] [--trials N]

A shape is ``TxB1`` with an optional ``xS`` (one vmap) or ``xCxS`` (two).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cruise_control_tpu.analyzer.constraint import BalancingConstraint  # noqa: E402
from cruise_control_tpu.analyzer.goals import TopicReplicaDistributionGoal  # noqa: E402
from cruise_control_tpu_torch.utils.ordered import (matrix_sum,  # noqa: E402
                                                    topic_cell_sum)

f32 = np.float32
DEFAULT_SHAPES = (
    "1x9,4x9,5x9,7x12,8x9,9x17,12x22,15x16,16x9,17x20,24x22,31x16,32x9,"
    "8x10,8x11,8x13,8x14,8x15,8x18,8x19,8x21,16x13,4x21,"
    "1x23,8x23,8x24,8x25,8x28,8x32,31x31,"
    "8x33,40x25,200x104,"
    "1x22x3,4x9x3,8x22x3,9x17x3,18x23x3,8x25x3,200x104x3,"
    "1x22x2x3,16x31x2x3,40x25x2x3")
LOOPS = [(vf, ic, epi, tail) for vf in (1, 2, 4, 8, 16) for ic in (1, 2, 4)
         for epi in (0, 4, 8) for tail in (0, 1)
         if not (vf == 1 and (ic > 1 or epi or tail))]


def _fold(lanes):
    lanes = list(lanes)
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [f32(lanes[i] + lanes[i + h]) for i in range(h)]
    return lanes[0]


def _loop(items, add, vf, ic, epi, tail, seed):
    """A vectorized reduction loop over ``items`` (LLVM's shape): ``add``
    accumulates one item into a lane."""
    n, pos, total = len(items), 0, seed
    chunk = vf * ic
    iters = (n - tail) // chunk if vf > 1 else 0
    if iters:
        acc = [[f32(-0.0)] * vf for _ in range(ic)]
        acc[0][0] = seed
        for it in range(iters):
            for k in range(ic):
                for lane in range(vf):
                    acc[k][lane] = add(acc[k][lane],
                                       items[(it * ic + k) * vf + lane])
        lanes = acc[0]
        for a in acc[1:]:
            lanes = [f32(p + q) for p, q in zip(lanes, a)]
        total, pos = _fold(lanes), iters * chunk
    if epi and n - pos - tail >= epi:
        lanes = [total] + [f32(-0.0)] * (epi - 1)
        while n - pos - tail >= epi:
            lanes = [add(a, items[pos + i]) for i, a in enumerate(lanes)]
            pos += epi
        total = _fold(lanes)
    for i in range(pos, n):
        total = add(total, items[i])
    return total


def _add_value(acc, x):
    return f32(acc + x)


def _add_row(acc, row):
    for x in row:
        acc = f32(acc + x)
    return acc


def candidates(pen):
    """{model name: float32 sum} for one [T, B1] plane."""
    out = {"eager (matrix_sum)": f32(matrix_sum(torch.from_numpy(pen)))}
    for shape in LOOPS:
        total = f32(0.0)
        for row in pen:
            total = _loop(list(row), _add_value, *shape, seed=total)
        out[f"rows {shape}"] = total
        out[f"lanes {shape}"] = _loop(list(pen), _add_row, *shape,
                                      seed=f32(0.0))
    return out


def trial(rng, goal, T, B1, lead):
    """(the reference's violations, the penalty planes, the port's sums)."""
    shape = lead + (T, B1)
    tc = np.exp(rng.uniform(0, 14, shape)).astype(np.int32)
    tc[..., -1] = 0
    alive = rng.random(lead + (B1,)) < 0.85
    alive[..., -1] = False
    valid = alive | (rng.random(lead + (B1,)) < 0.5)
    valid[..., -1] = False

    def ns(tc, alive, valid):
        return (types.SimpleNamespace(topic_counts=tc),
                types.SimpleNamespace(broker_alive=alive, broker_valid=valid))
    fn = lambda *a: goal.violation(*ns(*a))          # noqa: E731
    bounds = lambda *a: goal._bounds(*ns(*a))        # noqa: E731
    for _ in lead:
        fn, bounds = jax.vmap(fn), jax.vmap(bounds)
    got = np.asarray(jax.jit(fn)(tc, alive, valid))
    lo, up = (np.asarray(a) for a in jax.jit(bounds)(tc, alive, valid))
    c = tc.astype(f32)
    pen = np.where(alive[..., None, :],
                   np.maximum(c - up[..., :, None], f32(0))
                   + np.maximum(lo[..., :, None] - c, f32(0)),
                   f32(0)).astype(f32)
    port = topic_cell_sum(torch.from_numpy(pen)).numpy()
    return got, pen, port


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=DEFAULT_SHAPES)
    ap.add_argument("--trials", type=int, default=4)
    args = ap.parse_args()
    goal = TopicReplicaDistributionGoal(BalancingConstraint())
    rng = np.random.default_rng(0)
    failures = 0
    for spec in args.shapes.split(","):
        dims = [int(x) for x in spec.split("x")]
        T, B1, lead = dims[0], dims[1], tuple(dims[2:])
        matched, port_ok = None, True
        for _ in range(args.trials):
            got, pen, port = trial(rng, goal, T, B1, lead)
            port_ok &= got.tobytes() == port.astype(f32).tobytes()
            for g, p in zip(got.reshape(-1), pen.reshape(-1, T, B1)):
                ok = {k for k, v in candidates(p).items()
                      if f32(v).tobytes() == f32(g).tobytes()}
                matched = ok if matched is None else matched & ok
        named = sorted(matched, key=lambda k: (len(k), k))[:4]
        failures += not port_ok
        print(f"{spec:>12}: port {'matches' if port_ok else 'DIFFERS'}; "
              f"{len(matched)} models matched, e.g. {named}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
