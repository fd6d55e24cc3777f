"""The population search of the port over an all-hard chain against every
output of the JAX package's population program: DiskCapacityGoal,
NetworkInboundCapacityGoal, NetworkOutboundCapacityGoal and
CpuCapacityGoal, every threshold below the load, so every goal keeps a
residual and every weight is ``hard_weight`` (1000, not a power of two).
With every weight equal, the compiled program rounds each product of the
weighted row on its own (up to 22 goals); the test also shows that the
contracted row (each product an FMA into the running sum) would differ
on these inputs, so it tells the two forms apart. K = 4 plans, 4 goals,
the cluster and search of ``scripts/probe_population_goals.py --hard``;
the port runs on ``device="cpu"``, where KI takes its plain twin; equal
means bit for bit. At 23 goals the port's population of one plan, or
with a move weight, scores its final rows as the reference program's own
fusion does."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import probe_population_goals as ppg  # noqa: E402
from torch_parity_util import build_both  # noqa: E402

torch.set_num_threads(1)

NAMES = ("states", "aux") + ppg.NAMES


@pytest.fixture(scope="module")
def runs():
    (jm, jmd), (tm, tmd) = build_both(12, 240, seed=3)
    jopt, topt = ppg.optimizers(4, "hard")
    got = ppg.run_port(topt, tm, tmd)
    want, K = ppg.run_reference(jopt, jm, jmd)
    return got, want, K, topt


def test_all_hard_population_matches_every_output(runs):
    got, want, K, _ = runs
    assert K == 4 and len(got) == len(want) == len(NAMES) == 10
    tstates, taux, *trest = got
    jstates, jaux, *jrest = want
    for m in range(K):
        np.testing.assert_array_equal(tstates[m].rb.numpy(),
                                      np.asarray(jstates.rb[m]))
        np.testing.assert_array_equal(tstates[m].pos.numpy(),
                                      np.asarray(jstates.pos[m]))
    for t, j in zip(taux, jaux):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    for name, t, j in zip(ppg.NAMES, trest, jrest):
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        np.testing.assert_array_equal(t, np.asarray(j), name)
    # every goal keeps a residual, so every product of the row is weighted
    assert (trest[2][-1] > 0).all()


def test_the_contracted_row_would_differ(runs):
    """The run can tell the forms apart: the final scores (and a polish
    round's) differ between the rounded and the contracted row."""
    got, _, _, topt = runs
    differs = ppg.contraction_differs(got, topt.population.hard_weight)
    assert "final" in differs


@pytest.mark.parametrize("plans,move_weight", [(1, 0.0), (1, 0.1),
                                               (4, 0.1)])
def test_population_at_23_goals_scores_as_the_program(plans, move_weight):
    """One plan, or a move weight, at 23 goals (refused before): the
    port's population search over the probe's mixed chain answers, and its
    final weighted scores equal the reference program's own final-score
    fusion (``tests/weighted_row_fusions``, compiled alone) on the port's
    final rows and moves."""
    import probe_row_fusion as prf
    from cruise_control_tpu_torch.analyzer import engine as teng
    _, (tm, tmd) = build_both(12, 240, seed=3)
    _, topt = ppg.optimizers(23, "mixed", plans, move_weight)
    got = ppg.run_port(topt, tm, tmd)
    _states, aux, _iters, _wb, polish_rows, moves, *_, weighted = got
    assert polish_rows.shape == (2, plans, 23)
    form = ("_k1" if plans == 1 else "") + ("_mw" if move_weight else "")
    text = (Path(__file__).parent / "weighted_row_fusions"
            / f"weighted_row_final_23{form}.hlo").read_text()
    module = prf.at_shape(text, 23, 23, 4 if plans > 1 else 1, plans)
    run, shapes = prf.compile_module(module)
    stacks = polish_rows[-1]
    scales = aux[1].numpy()
    hard = np.array([g.hard for g in topt.goals])
    w = np.where(hard, np.float32(1000.0), np.float32(1.0))
    walk = np.zeros((plans, 23), np.int32)
    walk[:, -1] = moves
    feed = dict(norm=teng.normalized_stacks(stacks, scales,
                                            contract=True).numpy(),
                stacks=stacks, w=w, scales=scales, moves=walk)
    want = run(*[feed[r] if len(shape) == feed[r].ndim else feed[r][0]
                 for r, shape in zip(prf._roles(module), shapes)])
    np.testing.assert_array_equal(weighted.numpy().view(np.int32),
                                  want.reshape(-1).view(np.int32))
