"""Explicit-key random numbers, bit-identical to ``jax.random``.

The reference's candidate generators draw seeded tie-break noise from
``jax.random`` (threefry2x32 with ``jax_threefry_partitionable=True``). The
port reproduces that stream exactly: keys are ``uint32[2]`` pairs held in
int64 tensors masked to 32 bits, every draw is one KA launch
(:func:`kernels.threefry_draw`), and the conversions to floats and integers
follow ``jax._src.random``. No global RNG state is read or written.

Counter layout (partitionable threefry): a draw of shape ``s`` hashes the
row-major 64-bit iota over ``s``; ``split(key, n)[i]`` and
``fold_in(key, i)`` both hash counter ``i`` and keep both output words.

So a key derived by fold-ins and splits is its root key and a list of
32-bit words. :class:`KeyPath` keeps it that way: :func:`fold` and
:func:`subkeys` launch nothing, and a draw from a path derives the key
inside its own launch. ``fold_in`` and ``split`` return key tensors (one
launch each), as ``jax.random`` does.
"""

from __future__ import annotations

import torch

from . import kernels

_M32 = 0xFFFFFFFF


class KeyPath:
    """A key named by a root key tensor (int64[2]) and the words folded into
    it (Python ints or integer scalar tensors on the root's device)."""

    __slots__ = ("root", "words")

    def __init__(self, root: torch.Tensor, words: tuple = ()):
        if len(words) > kernels.MAX_PATH:
            root, words = _materialize(root, words), ()
        self.root = root
        self.words = words

    def fold_in(self, data) -> "KeyPath":
        return KeyPath(self.root, self.words + (data,))

    def split(self, num: int = 2) -> tuple["KeyPath", ...]:
        return tuple(self.fold_in(i) for i in range(num))

    def key(self) -> torch.Tensor:
        """The int64[2] key tensor (one launch; the root for no words)."""
        return _materialize(self.root, self.words)


def _materialize(root: torch.Tensor, words: tuple) -> torch.Tensor:
    if not words:
        return root
    *head, last = words
    if isinstance(last, torch.Tensor):
        return kernels.threefry_draw(root, head, form="keys",
                                     counters=_word(last).reshape(1))[0]
    return kernels.threefry_draw(root, head, (1,), "keys",
                                 base=int(last) & _M32)[0]


def _word(data: torch.Tensor) -> torch.Tensor:
    return data.reshape(()).to(torch.int64) & _M32


def path(key) -> KeyPath:
    """``key`` (a key tensor or a :class:`KeyPath`) as a path."""
    return key if isinstance(key, KeyPath) else KeyPath(key)


def fold(key, data) -> KeyPath:
    """``fold_in(key, data)`` as a path: nothing is launched."""
    return path(key).fold_in(data)


def subkeys(key, num: int = 2) -> tuple[KeyPath, ...]:
    """``split(key, num)`` as paths: nothing is launched."""
    return path(key).split(num)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """int64[2] key for an integer seed (``jax.random.PRNGKey``)."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if not -2**31 <= seed < 2**32 else 0
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[0] = hi
    key[1] = seed & _M32
    return key


def split(key, num: int = 2) -> torch.Tensor:
    """int64[num, 2] subkeys (``jax.random.split``)."""
    p = path(key)
    return kernels.threefry_draw(p.root, p.words, (num,), "keys")


def fold_in(key, data) -> torch.Tensor:
    """int64[2] key with ``data`` (a Python or 0-dim integer) folded in."""
    return fold(key, data).key()


def random_bits(key, shape) -> torch.Tensor:
    """int64 tensor of ``shape`` holding uniform 32-bit words."""
    p = path(key)
    bits = kernels.threefry_draw(p.root, p.words, tuple(shape), "bits")
    return bits.to(torch.int64) & _M32


def uniform(key, shape) -> torch.Tensor:
    """float32 in [0, 1) (``jax.random.uniform`` with the defaults): the top
    23 bits become the mantissa of a float in [1, 2), minus one."""
    return affine(key, shape, 1.0, 0.0)


def affine(key, shape, a: float, b: float) -> torch.Tensor:
    """float32 ``a * uniform(key, shape) + b`` with ``a`` and ``b`` float32
    constants, rounded once (``b = 0``: the float32 product, as
    ``scale * uniform`` rounds it; else ``utils.ordered.fma``'s
    contraction), in the draw's own launch."""
    p = path(key)
    return kernels.threefry_draw(p.root, p.words, tuple(shape), "affine",
                                 a=a, b=b)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """int64 values in [minval, maxval) (``jax.random.randint`` for int32):
    two 32-bit draws combined modulo the span, in one launch."""
    p = path(key)
    return kernels.threefry_draw(p.root, p.words, tuple(shape), "randint",
                                 minval=minval, maxval=maxval)
