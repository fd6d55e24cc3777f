"""Probe the float32 summation orders that XLA's CPU backend gives the JAX
package's intra-broker (JBOD) sums, which the PyTorch port reproduces:

1. the mean over the D disks of each broker (``[B, D]`` row sums), eagerly
   as ``analyzer/intra.py:_violations`` computes it and inside the compiled
   ``lax.while_loop`` body of ``optimize_intra_broker``;
2. the eager whole-matrix ``jnp.sum`` of a small ``[b, d]`` matrix (b <= 32
   rows, d <= 8 columns), which LLVM vectorizes over f row accumulators.

Each probe feeds float32 values spread over 30 binades (so that any two
orders give other bits) through XLA and through numpy models of candidate
orders, and prints which candidates matched every trial. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/probe_sum_order.py [--trials N]
"""

from __future__ import annotations

import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

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
    for D in (2, 5, 6, 8, 9, 12, 16, 24, 31, 32, 33, 40, 48, 63, 64):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=8)
    args = ap.parse_args()
    print("jax", jax.__version__)
    probe_rows(args.trials)
    probe_small_matrices(args.trials)


if __name__ == "__main__":
    main()
