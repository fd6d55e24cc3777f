"""KE's twin (``kernels.first_fit`` on the CPU) against the reference's
first-fit program (``executor/schedule.py:_first_fit_program``) in the
regimes the redesigned kernel must keep: a row whose cap is 0 (no batch
ever admits its moves), a single batch slot (K = 1), and a bandwidth
budget under which moves spill (assigned K), with padding moves and a
repeated padding row. Equal means element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.executor.schedule import _first_fit_program
from cruise_control_tpu_torch import kernels

torch.set_num_threads(1)


def _moves(rng, M, W, B):
    rows = rng.integers(0, B + 1, (M, W)).astype(np.int32)
    dest = np.where(rng.random((M, W)) < 0.5, rows, B).astype(np.int32)
    sizes = (rng.random(M) * 100).astype(np.float32)
    valid = rng.random(M) < 0.9
    caps = rng.integers(1, 4, B + 1).astype(np.int32)
    caps[B] = 1 << 30
    return rows, dest, sizes, valid, caps


@pytest.mark.parametrize("case", ["cap_zero", "single_slot", "budget_spill"])
def test_first_fit_regimes_match_reference_program(case):
    rng = np.random.default_rng(len(case))
    M, W, B, K, cluster_cap, budget = 200, 4, 12, 32, 16, np.float32(np.inf)
    rows, dest, sizes, valid, caps = _moves(rng, M, W, B)
    if case == "cap_zero":
        caps[3] = 0
        rows[::4, 0] = 3                          # a quarter touch row 3
    elif case == "single_slot":
        K = 1
    else:
        budget = np.float32(90.0)
        dest[:, 1] = rng.integers(0, 2, M)        # two hot destinations
        sizes = (rng.random(M) * 200).astype(np.float32)
        K = 16
    want = np.asarray(_first_fit_program(M, W, K)(
        jnp.asarray(rows), jnp.asarray(dest), jnp.asarray(sizes),
        jnp.asarray(valid), jnp.asarray(caps), jnp.int32(cluster_cap),
        jnp.float32(budget)))
    got = kernels.first_fit(*(torch.from_numpy(a) for a in
                              (rows, dest, sizes, valid, caps)),
                            cluster_cap, float(budget), K)
    np.testing.assert_array_equal(got.numpy(), want)
    spilled = want[valid] == K
    if case == "cap_zero":
        assert spilled[(rows[valid] == 3).any(axis=1)].all()
    else:
        assert spilled.any()
