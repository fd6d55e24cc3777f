"""The intra-broker walk and its violation sums past 64 disks a broker, and
the eager matrix sums with one padding element (an axis of 63 or 95): the
port's ``optimize_intra_broker`` (KH's twin on the CPU), ``_violations``
and ``utils.ordered.matrix_sum`` against the JAX package's. Equal means bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cruise_control_tpu.analyzer.intra as ji
import cruise_control_tpu_torch.analyzer.intra as ti
from cruise_control_tpu_torch.utils.ordered import matrix_sum
from test_torch_intra import _assert_states_equal, _random_jbod

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,D", [(300, 63), (302, 65), (304, 65),
                                    (301, 96), (300, 96), (303, 128)])
def test_walk_past_64_disks(seed, D):
    """Random layouts of 63-128 disks a broker: the mean over the D axis
    sums in windows of 32 (two to four of them) in the compiled loop body
    and eagerly, and ``_violations``' matrix sums take the peeled-column
    order at 63 disks."""
    arrays, max_iters = _random_jbod(seed, D)
    jstate = ji.DiskState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = ti.DiskState.from_numpy(device="cpu", **arrays)
    jfinal, jit = ji.optimize_intra_broker(jstate, max_iters=max_iters)
    tfinal, tit = ti.optimize_intra_broker(tstate, max_iters=max_iters)
    assert int(tit) == int(jit)
    _assert_states_equal(jfinal, tfinal)
    for thresholds in ((0.8, 1.10), (0.5, 1.02)):
        for js, ts in ((jstate, tstate), (jfinal, tfinal)):
            assert [float(x) for x in ti._violations(ts, *thresholds)] == [
                float(x) for x in ji._violations(js, *thresholds)]


@pytest.mark.parametrize("shape", [(8, 63), (104, 63), (63, 63), (8, 95),
                                   (63, 4), (63, 8), (95, 4), (95, 2),
                                   (63, 33), (40, 95)])
def test_matrix_sum_with_one_padding_element(shape):
    """An axis of 63 or 95 elements leaves one padding element in its last
    32-wide window: XLA peels that column (the window's first 31 columns
    in row order, then the last one down the rows) or that row (the first
    31 rows in lanes, then the peeled row)."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    for _ in range(4):
        x = (rng.random(shape) * 2.0 ** rng.integers(-10, 20, shape)
             ).astype(np.float32)
        x[rng.random(shape) < 0.2] = 0.0
        assert float(matrix_sum(torch.from_numpy(x))) == float(
            jnp.asarray(x).sum())
