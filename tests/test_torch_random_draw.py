"""KA's fused draw (``kernels.threefry_draw`` through ``_random``'s key
paths) against ``jax.random`` on the CPU: the key derived by a path of
fold-ins and splits inside the draw, every output form, and the search's
candidate noise as the main path draws it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import _random, kernels
from cruise_control_tpu_torch.analyzer.goals import _noise
from cruise_control_tpu_torch.utils.ordered import fma

torch.set_num_threads(1)

SHAPES = [(), (1,), (31,), (40_192,), (20_096, 2)]

# A path is a list of steps: ("fold", d) or ("split", n, i).
PATHS = {
    "none": [],
    "fold": [("fold", 3)],
    "split": [("split", 2, 1)],
    "engine": [("fold", 2), ("fold", 17), ("split", 2, 0), ("split", 2, 1)],
    "population": [("fold", 7_919 + 3), ("fold", 1000 * 2 + 1),
                   ("fold", 4), ("split", 2, 1), ("split", 3, 2)],
    "wide": [("fold", 2**32 - 1), ("split", 5, 4), ("fold", 70_003)],
    "long": [("fold", k) for k in range(6)] + [("split", 3, 2)] * 6,
}


def _bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def _chains(seed, steps, device_word=False):
    """(jax key, port KeyPath) after the same steps; with ``device_word``
    the fold-in data are integer tensors (read inside the draw)."""
    jk, tk = jax.random.PRNGKey(seed), _random.PRNGKey(seed)
    tk = _random.path(tk)
    for step in steps:
        if step[0] == "fold":
            jk = jax.random.fold_in(jk, step[1])
            d = step[1]
            tk = tk.fold_in(torch.tensor(d) if device_word else d)
        else:
            _, n, i = step
            jk = jax.random.split(jk, n)[i]
            tk = _random.subkeys(tk, n)[i]
    return jk, tk


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("device_word", [False, True])
def test_derived_key_equals_jax(path, device_word):
    jk, tk = _chains(5, PATHS[path], device_word)
    np.testing.assert_array_equal(_bits(jk), tk.key().numpy())
    np.testing.assert_array_equal(_bits(jax.random.split(jk, 3)),
                                  _random.split(tk, 3).numpy())
    np.testing.assert_array_equal(_bits(jax.random.fold_in(jk, 9)),
                                  _random.fold_in(tk, 9).numpy())


@pytest.mark.parametrize("path", ["none", "engine", "long"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_form(path, shape):
    jk, tk = _chains(11, PATHS[path])
    want = np.asarray(jax.random.uniform(jk, shape))
    got = _random.uniform(tk, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("path", ["fold", "population"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_form(path, shape):
    jk, tk = _chains(12, PATHS[path])
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(
        np.int64)
    np.testing.assert_array_equal(_random.random_bits(tk, shape).numpy(),
                                  want)
    raw = kernels.threefry_draw(tk.root, tk.words, shape, "bits")
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy().view(np.uint32), want)


@pytest.mark.parametrize("scale", [1e-3, 0.37, 3.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scaled_noise_form(scale, shape):
    """``scale * uniform``: the Python scale is a float32 constant and the
    product rounds once, as JAX's weak-typed float32 multiply does."""
    jk, tk = _chains(13, PATHS["engine"])
    want = np.asarray(scale * jax.random.uniform(jk, shape))
    got = _random.affine(tk, shape, scale, 0.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # and as the search drew it before, a separate multiply
    old = (scale * _random.uniform(tk, shape)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), old.view(np.int32))


@pytest.mark.parametrize("shape", [(31,), (20_096, 2), (20_096,)], ids=str)
def test_drain_noise_form(shape):
    """The bulk drain's ``fma(0.01, uniform, 1.0)`` in one launch."""
    _, tk = _chains(14, PATHS["engine"])
    want = fma(0.01, _random.uniform(tk, shape), 1.0).numpy()
    got = _random.affine(tk, shape, 0.01, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 7), (0, 512), (3, 77)])
@pytest.mark.parametrize("shape", [(), (9,)], ids=str)
def test_randint_form(lo, hi, shape):
    jk, tk = _chains(15, PATHS["population"])
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, shape, lo, hi)),
        _random.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("it", [0, 5])
@pytest.mark.parametrize("pass_index", [0, 3])
def test_candidate_noise_of_the_main_path(it, pass_index):
    """The noise of ``goals.py:_top_replica_dest_grid`` /
    ``_flow_candidates`` as the engine draws it — key fold_in(i), then
    fold_in(it), then split — is the reference's (one launch a tensor)."""
    P, R, B1 = 20_096, 2, 101
    scale = 1e-3
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1),
                                               pass_index), it)
    jrep, jdst = jax.random.split(jk)
    k = _random.fold(_random.fold(_random.PRNGKey(1), pass_index), it)
    krep, kdst = _random.subkeys(k)
    for got, want in ((_noise(krep, (P, R), scale),
                       scale * jax.random.uniform(jrep, (P, R))),
                      (_noise(kdst, (B1,), scale),
                       scale * jax.random.uniform(jdst, (B1,)))):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_paths_draw_nothing_until_a_draw(monkeypatch):
    """Fold-ins and splits of a path compute nothing; a draw is one call
    of the draw (one launch on the card; its twin here)."""
    calls = []
    plain = kernels.threefry_draw_plain
    monkeypatch.setattr(kernels, "threefry_draw_plain",
                        lambda *a, **kw: calls.append(a) or plain(*a, **kw))
    k = _random.PRNGKey(3)
    p = _random.fold(_random.fold(k, 1), 2)
    a, b = _random.subkeys(p)
    assert calls == []
    _random.uniform(b, (4,))
    _random.affine(a, (4,), 1e-3, 0.0)
    assert len(calls) == 2


def test_draw_refuses_long_paths_and_bad_words():
    k = _random.PRNGKey(0)
    with pytest.raises(ValueError):
        kernels.threefry_draw(k, tuple(range(kernels.MAX_PATH + 1)), (2,))
    with pytest.raises(ValueError):
        kernels.threefry_draw(k, (torch.tensor(1.5),), (2,))
    with pytest.raises(ValueError):
        kernels.threefry_draw(k, (), (2,), "gauss")
