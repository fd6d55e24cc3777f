"""Fixed-order float reductions, scans and tie-breaking sorts.

The reference's search is an XLA program, and XLA fixes the order of every
float32 sum it compiles. The port reproduces those orders explicitly, on
the CPU and on the card alike, so the same seed gives the same proposals on
both and from run to run:

- :func:`tree_sum` — XLA's CPU reduction: windows of 32 summed in order
  (padding split evenly in front and behind), repeated until at most 32
  partial sums remain, which are summed in order; :func:`tree_sum_last`
  reduces the last axis of a batch of rows the same way, and
  :func:`lane_row_sum` as XLA reduces a fused row of 24 to 32 elements,
  and :func:`matrix_sum` as an eager ``jnp.sum`` reduces a whole matrix;
- :func:`scan_sum` — XLA's CPU cumulative sum: sequential prefix sums in
  blocks of 16, the block totals scanned the same way and added back;
- :func:`fma` — one rounding for ``a * b + c``, where the reference's
  compiled program contracts the two operations;
- :func:`top_k`, :func:`argsort`, :func:`lexsort` — stable orders (the
  lower index first among ties, as ``lax.top_k``/``jnp.argsort`` give).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..kernels import ordered_range_sum, ordered_segment_sum

_WINDOW = 32
_SCAN_BLOCK = 16


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """0-dim float32 sum of a 1-D tensor in XLA's CPU tree order."""
    return tree_sum_last(x.reshape(-1))


def tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[...]`` sums of ``x[..., n]`` along its last axis, each row
    in XLA's CPU tree order (a vmapped ``jnp.sum`` reduces every row as the
    unbatched sum does): 32-wide windows with each row's padding split
    evenly in front and behind, one segment-sum launch per level over all
    rows at once."""
    lead = x.shape[:-1]
    rows = math.prod(lead)
    x = x.reshape(rows, x.shape[-1]).to(torch.float32)
    while True:
        n = x.shape[1]
        if n == 0 or rows == 0:
            return x.new_zeros(lead)
        if n <= _WINDOW:
            offsets = torch.arange(0, rows * n + 1, n, device=x.device)
            return ordered_range_sum(x.reshape(-1), offsets).reshape(lead)
        windows = -(-n // _WINDOW)
        pad = windows * _WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        offsets = torch.arange(0, rows * windows * _WINDOW + 1, _WINDOW,
                               device=x.device)
        x = ordered_range_sum(x.reshape(-1), offsets).reshape(rows, windows)


def lane_row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[...]`` sums of ``x[..., n]`` in the order XLA's CPU backend
    gives a row reduction fused with its elementwise producer when the row
    holds 24 to 32 elements: eight lane accumulators over the whole
    8-element chunks, folded by halves (lanes 0-3 + 4-7, then 0-1 + 2-3,
    then 0 + 1), then the leftover elements added in order. Other widths
    reduce as :func:`tree_sum_last`. (Probed on XLA's CPU backend: rows of
    at most 22 and at least 33 elements follow the tree order; a single
    row of 24 follows it too, and rows of 23 follow neither. Brokers pad
    to multiples of 8, so a broker row has 8k + 1 elements.)"""
    n = x.shape[-1]
    if not 24 <= n <= 32:
        return tree_sum_last(x)
    x = x.to(torch.float32)
    full = n // 8 * 8
    acc = x[..., 0:8]
    for i in range(8, full, 8):
        acc = acc + x[..., i:i + 8]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    out = acc[..., 0]
    for i in range(full, n):
        out = out + x[..., i]
    return out


def _lanes(b: int, d: int) -> int:
    """Accumulators XLA's CPU backend gives an eager sum of a [b, d] matrix
    (2 <= b, d <= 32): LLVM vectorizes the row loop when a row holds at
    most 8 elements. Fitted on every shape of 2-32 rows by 2-8 columns
    (``scripts/probe_sum_order.py``); 1 means in order from zero."""
    if d >= 9:
        return 1
    if b < 16:
        return b if b in (2, 4, 8) else 1
    if d >= 7:
        return 4
    return 8 if b % 8 < 4 or (d == 2 and b >= 28) else 4


def _small_sums(xs: torch.Tensor) -> torch.Tensor:
    """float32[n] sums of n matrices xs[n, b, d] (2 <= b, d <= 32), each in
    XLA's eager order: f = :func:`_lanes` accumulators, lane l adding the
    elements of rows l, l + f, ... of the whole f-row groups in order, the
    lanes folded by halves, then the leftover rows' elements added in
    order; with f = 1 every element in order from zero."""
    n, b, d = xs.shape
    f = _lanes(b, d)
    full = b // f * f if f > 1 else 0
    flat = xs.reshape(n, b * d)
    if full:
        lane = (torch.arange(n, device=xs.device)[:, None] * f
                + (torch.arange(full, device=xs.device) % f
                   ).repeat_interleave(d)[None, :])
        acc = ordered_segment_sum(flat[:, :full * d].reshape(-1),
                                  lane.reshape(-1), n * f).reshape(n, f)
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = acc[:, :half] + acc[:, half:]
        flat = torch.cat([acc, flat[:, full * d:]], dim=1)
    m = flat.shape[1]
    return ordered_range_sum(flat.reshape(-1), torch.arange(
        0, n * m + 1, m, device=xs.device))


def matrix_sum(x: torch.Tensor) -> torch.Tensor:
    """0-dim float32 sum of a matrix x[B, D] in the order XLA's CPU backend
    gives an eager ``jnp.sum`` over both axes (probed). One column or one
    row reduces as a vector (:func:`tree_sum`), at most 32 x 32 as one
    :func:`_small_sums` matrix. Larger: windows of min(n, 32) along each
    axis, each axis' padding split evenly in front and behind; without
    padding each window reduces as a small matrix, with it each window's
    elements add in row order from zero; the window sums then reduce as a
    matrix again. A padding of exactly 1 on an axis over 32 (31, 63, ...
    mod 32) follows an order not reproduced here, and raises."""
    x = x.to(torch.float32)
    B, D = x.shape
    if B == 1 or D == 1:
        return tree_sum(x.reshape(-1))
    if B <= _WINDOW and D <= _WINDOW:
        return _small_sums(x[None])[0]
    if any(n > _WINDOW and n % _WINDOW == _WINDOW - 1 for n in (B, D)):
        raise ValueError(f"matrix_sum does not reproduce XLA's order for a "
                         f"[{B}, {D}] matrix (one padding element)")
    wb, wd = min(B, _WINDOW), min(D, _WINDOW)
    nb, nd = -(-B // wb), -(-D // wd)
    pb, pd = nb * wb - B, nd * wd - D
    xp = torch.nn.functional.pad(x, (pd // 2, pd - pd // 2,
                                     pb // 2, pb - pb // 2))
    windows = xp.reshape(nb, wb, nd, wd).transpose(1, 2).reshape(
        nb * nd, wb, wd)
    if pb or pd:
        parts = ordered_range_sum(windows.reshape(-1), torch.arange(
            0, nb * nd * wb * wd + 1, wb * wd, device=x.device))
    else:
        parts = _small_sums(windows)
    return matrix_sum(parts.reshape(nb, nd))


def scan_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums of a 1-D tensor in XLA's CPU order.
    Integer and bool inputs are exact in any order and use ``cumsum``."""
    if not x.is_floating_point():
        return torch.cumsum(x, 0)
    n = x.shape[0]
    blocks = max(-(-n // _SCAN_BLOCK), 1)
    m = torch.nn.functional.pad(x, (0, blocks * _SCAN_BLOCK - n)).reshape(
        blocks, _SCAN_BLOCK)
    acc = torch.zeros(blocks, dtype=x.dtype, device=x.device)
    cols = []
    for k in range(_SCAN_BLOCK):
        acc = acc + m[:, k]
        cols.append(acc)
    inner = torch.stack(cols, dim=1)
    if blocks > 1:
        totals = scan_sum(inner[:, -1])
        carry = torch.cat([totals.new_zeros(1), totals[:-1]])
        inner = inner + carry[:, None]
    return inner.reshape(-1)[:n]


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product is exact in float64,
    so only the final float32 rounding remains). Python scalars are float32
    constants, as in the reference's program."""
    def f64(v):
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v, dtype=torch.float32)
        return v.to(torch.float64)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest, lower index first among ties."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def argsort(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    return torch.sort(x, descending=descending, stable=True)[1]


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices sorting by ``keys[-1]`` first, then ``keys[-2]``, ...
    (``jnp.lexsort``): stable sorts, least significant key first."""
    order = argsort(keys[0].to(torch.int8) if keys[0].dtype == torch.bool
                    else keys[0])
    for key in keys[1:]:
        k = key[order]
        if k.dtype == torch.bool:
            k = k.to(torch.int8)
        order = order[argsort(k)]
    return order
