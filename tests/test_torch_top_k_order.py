"""``lax.top_k``'s order in the port: ``utils/ordered.py:top_k`` (KU's
twin, ``kernels.top_k`` on the CPU) against ``jax.lax.top_k`` on crafted
rows. ``lax.top_k`` sorts by IEEE total order: +0.0 ranks above -0.0, NaN
above +inf and -NaN below -inf, and equal bits keep the lower index
first. A stable sort of the float values alone ties +0.0 with -0.0 and
puts -NaN first, so the port sorts the values' total-order images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.utils import ordered

torch.set_num_threads(1)

NAN = np.float32("nan")
INF = np.float32("inf")


def _bits(*words):
    return np.array(words, dtype=np.uint32).view(np.float32)


ROWS = {
    "signed zeros": (np.array([-0.0, 0.0, -0.0, 0.0], np.float32),
                     [1, 3, 0, 2]),
    "nans and infinities": (np.array([1.0, -NAN, -INF, NAN, 0.5],
                                     np.float32), [3, 0, 4, 2, 1]),
    "nan payloads": (_bits(0x7FC00001, 0xFFC00001, 0x7F800000, 0x7FC00000,
                           0xFF800000, 0x80000000, 0x00000000), None),
    "infinities": (np.array([INF, -INF, INF, -INF, 0.0, -0.0], np.float32),
                   None),
    "all ties": (np.full(9, 3.5, np.float32), None),
    "one element": (np.array([-2.0], np.float32), [0]),
    "denormals": (_bits(0x00000001, 0x80000001, 0x00000000, 0x80000000,
                        0x00800000), None),
}


def _same_bits(want, got, what):
    want = np.asarray(want, np.float32).view(np.int32)
    got = got.numpy().astype(np.float32).view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("fn", ["ordered", "kernels"])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_top_k_follows_lax_top_k_on_crafted_rows(name, fn):
    """Every k from 1 to N (K = N included): the indices equal
    ``jax.lax.top_k``'s and the values their bits."""
    x, order = ROWS[name]
    top = ordered.top_k if fn == "ordered" else kernels.top_k
    for k in range(1, x.shape[0] + 1):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top(torch.from_numpy(x.copy()), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i),
                                      err_msg=f"{name} k={k}")
        _same_bits(want_v, got_v, f"{name} k={k}")
        assert got_i.dtype == torch.int64
    if order is not None:
        np.testing.assert_array_equal(
            np.asarray(jax.lax.top_k(jnp.asarray(x), x.shape[0])[1]), order)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_rows_of_a_batch(seed):
    """A [S, N] batch is S rows' top-k (the interval swap's two planes in
    one call), each as ``jax.lax.top_k`` gives it: values quantized to a
    few levels (long runs of ties), signed zeros, -inf masks and NaNs."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (3, 257)).astype(np.float32) * 0.5
    x[x == 0.0] = np.where(rng.random((x == 0.0).sum()) < 0.5, -0.0, 0.0)
    x[rng.random(x.shape) < 0.3] = -INF
    x[rng.random(x.shape) < 0.02] = NAN
    x[rng.random(x.shape) < 0.02] = -NAN
    for k in (1, 17, 128, 257):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = ordered.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        _same_bits(want_v, got_v, f"k={k}")


def test_total_order_key_orders_every_class():
    """The integer image sorts -NaN < -inf < -1 < -denormal < -0.0 < +0.0
    < +denormal < 1 < +inf < NaN."""
    x = _bits(0xFFC00000, 0xFF800000, 0xBF800000, 0x80000001, 0x80000000,
              0x00000000, 0x00000001, 0x3F800000, 0x7F800000, 0x7FC00000)
    key = ordered.total_order_key(torch.from_numpy(x)).numpy()
    assert (np.diff(key.astype(np.int64)) > 0).all()
