"""The population program's weighted row past 22 goals: KI's twin
(``kernels.population_select`` on the CPU) and ``engine._fused_weighted_sum``
against the reference's compiled population scoring
(``parallel/population.py:_scores`` and ``_survivor_perm``, as
``test_torch_population.py:_reference_select`` compiles them) at 33-128
goals, with mixed, shared and unit weights, a move weight, several
population sizes and goals listed more than once; and at 23-32 goals,
where LLVM vectorizes the row, against the reference population
program's own weighted-row fusions, compiled alone from their committed
HLO text (``tests/weighted_row_fusions``). Equal means bit for bit."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.engine as jeng
import cruise_control_tpu_torch.analyzer.engine as teng
from cruise_control_tpu_torch import kernels

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import probe_row_fusion as prf  # noqa: E402

torch.set_num_threads(1)


def _reference(boundary, moves, scales, hard, hard_weight, move_weight,
               n_surv, pareto):
    K = boundary.shape[0]

    @jax.jit
    def run(b, m, s):
        weighted = jeng.weighted_objective(
            b, s, hard, hard_weight=hard_weight, move_weight=move_weight,
            moves=m)
        ranks = jeng.pareto_ranks(b, s)
        primary = (ranks.astype(jnp.float32) if pareto
                   else jnp.zeros_like(weighted))
        order = jnp.lexsort((jnp.arange(K), weighted, primary))
        perm = order[:n_surv][jnp.arange(K) % n_surv]
        return ranks, weighted, perm.at[0].set(0)
    return [np.asarray(x) for x in run(boundary, moves, scales)]


def _inputs(G, K, rng, similar):
    scales = (rng.random(G) * 10.0 ** rng.integers(-2, 3, G)).astype(
        np.float32)
    if similar:
        # magnitudes within one binade, so that every order rounds apart
        boundary = ((1 + rng.random((K, G))) * np.maximum(scales, 1)
                    * 4).astype(np.float32)
    else:
        boundary = (rng.random((K, G)) * 2.0 ** rng.integers(-10, 20, (K, G))
                    ).astype(np.float32)
    moves = rng.integers(0, 100_000, K).astype(np.int32)
    return boundary, moves, scales


@pytest.mark.parametrize("G", [33, 34, 40, 47, 48, 63, 64, 65, 95, 96, 128])
@pytest.mark.parametrize("weights", ["one", "shared", "mixed"])
def test_weighted_row_matches_the_population_program(G, weights):
    """XLA's windowed tree of the rounded products past 32 goals (one to
    four windows, the padding split front and back), K = 2, 5 and 16, with
    and without a move weight."""
    rng = np.random.default_rng(G * 3 + len(weights))
    hard = {"one": np.zeros(G, bool), "shared": np.ones(G, bool),
            "mixed": rng.random(G) < 0.4}[weights]
    for K, mw, similar in ((2, 0.0, True), (5, 0.1, False),
                           (16, 0.0, True), (16, 0.1, False)):
        boundary, moves, scales = _inputs(G, K, rng, similar)
        want = _reference(boundary, moves, scales, hard, 1000.0, mw,
                          max(1, K // 2), True)
        got = kernels.population_select(
            torch.from_numpy(boundary), torch.from_numpy(moves),
            torch.from_numpy(scales), torch.from_numpy(hard), 1000.0, mw,
            max(1, K // 2), True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("G", [22, 33, 64])
def test_fused_weighted_sum_with_repeated_goals(G):
    """A chain that lists goals more than once (as a user can): the goal
    axis repeats columns of seven goals' stacks and weights, and the row
    ``_fused_weighted_sum`` gives equals the reference's compiled one."""
    rng = np.random.default_rng(G)
    pick = rng.integers(0, 7, G)
    hard = (rng.random(7) < 0.5)[pick]
    K = 8
    for similar in (True, False):
        base, moves, scales = _inputs(7, K, rng, similar)
        boundary = np.ascontiguousarray(base[:, pick])
        scales = np.ascontiguousarray(scales[pick])
        want = _reference(boundary, moves, scales, hard, 1000.0, 0.0, 4,
                          False)[1]
        norm = teng.normalized_stacks(boundary, scales, contract=True)
        w = torch.where(torch.from_numpy(hard), torch.tensor(1000.0),
                        torch.tensor(1.0))
        np.testing.assert_array_equal(
            teng._fused_weighted_sum(norm, w).numpy(), want)


#: the reference population program's weighted-row fusions at 23 goals,
#: each as a module of its own (``scripts/probe_row_fusion.py --save``):
#: (site, form) -> (text, plans it was read at, plans tested, move weight,
#: the weights it compiles). Sites: the final scores, a polish round's and
#: the walk's end; forms: weights that differ (a buffer of the program),
#: with a move weight of 0.1 (the move term added after the row), one plan
#: (the plan axis dropped; its final scores only), every weight 1000
#: (``_hard``) and every weight 1 (``_soft``), of several plans or one:
#: splat constants of the program
FUSIONS = {(site, form): (
    (Path(__file__).parent / "weighted_row_fusions"
     / f"weighted_row_{site}_23{form}.hlo").read_text(),
    1 if "k1" in form else 4,
    1 if "k1" in form else 8 if site == "polish" else 4,
    0.1 if "mw" in form else 0.0,
    ("shared",) if "hard" in form else ("one",) if "soft" in form
    else ("mixed", "repeated"))
    for site in ("final", "polish", "walk_end")
    for form in ("", "_mw", "_k1", "_k1_mw", "_hard", "_soft", "_k1_hard",
                 "_k1_soft")
    if site == "final" or "k1" not in form}


def _feed(roles, shapes, arrays):
    """The fusion's parameters from named arrays (a fusion of one plan
    takes its rows without the plan axis)."""
    return [arrays[r] if len(shape) == arrays[r].ndim else arrays[r][0]
            for r, shape in zip(roles, shapes)]


@pytest.mark.parametrize("G", range(23, 33))
def test_weighted_row_refuses_23_to_32_goals(G):
    """(Named for the refusal it replaced.) At 23-32 goals LLVM
    vectorizes the row, differently at the generation boundaries, at the
    final scores, for a single plan and for equal weights: the fused sum,
    the weighted objective and KI's twin equal each of the program's
    fusions compiled alone (their shapes set to G goals), bit for bit,
    with mixed weights, goals listed more than once, all-hard and
    all-soft chains, and with and without a move weight."""
    rng = np.random.default_rng(G)
    for (site, form), (text, K0, K, mw, kinds) in FUSIONS.items():
        module = prf.at_shape(text, 23, G, K0, K)
        run, shapes = prf.compile_module(module)
        roles = prf._roles(module)
        final = site == "final"
        for weights in kinds:
            if weights == "repeated":
                pick = rng.integers(0, 7, G)
                # seven goals, hard and soft both among those picked
                hard = (np.arange(7) % 2 == 0)[pick]
                hard[:2] = (True, False)
                base, moves, scales = _inputs(7, K, rng, False)
                boundary = np.ascontiguousarray(base[:, pick])
                scales = np.ascontiguousarray(scales[pick])
            else:
                hard = {"one": np.zeros(G, bool), "shared": np.ones(G, bool),
                        "mixed": rng.random(G) < 0.4}[weights]
                boundary, moves, scales = _inputs(G, K, rng,
                                                  weights != "mixed")
            boundary[:, rng.random(G) < 0.2] = 0.0      # converged goals
            norm = teng.normalized_stacks(boundary, scales, contract=True)
            w = np.where(hard, np.float32(1000.0), np.float32(1.0))
            bounds = (rng.random((K, G, G)) * 100).astype(np.float32)
            bounds[:, G - 1] = boundary
            # cumulative moves a goal; a plan's moves are its last column
            walk = rng.integers(0, 100_000, (K, G)).astype(np.int32)
            walk[:, -1] = moves
            want = run(*_feed(roles, shapes, dict(
                norm=norm.numpy(), stacks=boundary, w=w, scales=scales,
                bounds=bounds, moves=walk))).reshape(-1)
            got = teng.weighted_objective(
                boundary, scales, hard, hard_weight=1000.0, move_weight=mw,
                moves=moves, contract=True, final=final)
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
            if not mw:
                got = teng._fused_weighted_sum(norm, torch.from_numpy(w),
                                               final)
                np.testing.assert_array_equal(got.numpy().view(np.int32),
                                              want.view(np.int32))
            _, weighted, _ = kernels.population_select(
                torch.from_numpy(boundary), torch.from_numpy(moves),
                torch.from_numpy(scales), torch.from_numpy(hard), 1000.0,
                mw, max(1, K // 2), True, final)
            np.testing.assert_array_equal(weighted.numpy().view(np.int32),
                                          want.view(np.int32))
