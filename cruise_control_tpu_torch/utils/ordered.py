"""Fixed-order float reductions, scans and tie-breaking sorts.

The reference's search is an XLA program, and XLA fixes the order of every
float32 sum it compiles. The port reproduces those orders explicitly, on
the CPU and on the card alike, so the same seed gives the same proposals on
both and from run to run:

- :func:`tree_sum` — XLA's CPU reduction: windows of 32 summed in order
  (padding split evenly in front and behind), repeated until at most 32
  partial sums remain, which are summed in order; :func:`tree_sum_last`
  reduces the last axis of a batch of rows the same way,
  :func:`violation_row_sum` as XLA reduces a goal's fused penalty row
  (:func:`vector_loop_sum`, below), :func:`matrix_sum` as an eager
  ``jnp.sum`` reduces a whole matrix, and :func:`topic_cell_sum` as XLA
  reduces the topic goal's ``[T, B1]`` penalty cells;
- :func:`scan_sum` — XLA's CPU cumulative sum: sequential prefix sums in
  blocks of 16, the block totals scanned the same way and added back;
- :func:`fma` — one rounding for ``a * b + c``, where the reference's
  compiled program contracts the two operations;
- :func:`top_k`, :func:`argsort`, :func:`lexsort` — stable orders (the
  lower index first among ties, as ``lax.top_k``/``jnp.argsort`` give;
  ``top_k`` compares floats in IEEE total order, as ``lax.top_k`` does).

**A goal's violation row** (``IntervalGoal.violation``: the penalty of B1 =
padded brokers + 1 elements, summed in the fusion that computes it). XLA's
CPU backend emits the fusion as a loop over the row, and LLVM's loop
vectorizer, not XLA, picks the order. Read from the optimized IR of each
program (``XLA_FLAGS=--xla_dump_to``, file
``*.jit_violation.select_reduce_fusion_kernel_module.ir-with-opt.ll``) and
confirmed against values (``scripts/probe_violation_order.py``), the order
is one of:

- in order from zero: a scalar loop, every row of at most 32 elements that
  the list below does not name (wider rows reduce as :func:`tree_sum`);
- a vector loop, :func:`vector_loop_sum` with (VF, IC, epilogue, tail):
  IC accumulators of VF lanes over the whole VF x IC chunks (XLA's init
  0.0 enters lane 0 of the first; the others start at -0.0), combined
  ``((a0 + a1) + a2) + a3``, then one ``llvm.vector.reduce.fadd``
  (``reassoc``, start -0.0), which the x86 backend lowers by halves —
  lanes 0-3 + 4-7, then 0-1 + 2-3, then 0 + 1; a VF-lane epilogue seeded
  with that total in lane 0 (the other lanes -0.0) over the whole chunks
  left, reduced the same way; the rest added one at a time in order. A
  row read through a stride (a column of ``util[B1, 4]``) keeps at least
  one element (``tail``) for the scalar loop, so a width that VF divides
  runs one vector chunk fewer.

The program's shape — which plane the penalty reads, against which bound
— and whether it is vmapped over scenarios pick the loop, by width
(:data:`ROW_LOOPS`):

- ``plane``, a [B1] plane with both bounds scalar (replica and leader
  counts): unbatched 23: (4, 4, 4, 0), 24-32: (8, 1, 0, 0); vmapped (the
  what-if scorer) 22-23: (4, 4, 4, 0), 24-32: (8, 1, 0, 0);
- ``column``, a ``util`` column with both bounds scalar (the usage
  goals): 23: (4, 4, 4, 1), 24-32: (8, 1, 0, 1), either way;
- ``column-capacity``, a NW_IN, NW_OUT or DISK column against capacity x
  threshold: 25-32: (8, 1, 0, 1), either way;
- ``cpu-capacity``, the CPU column against its capacity: unbatched 28-32,
  vmapped 25-32: (8, 1, 0, 1);
- ``plane-capacity``, a float plane against a capacity column (potential
  NW_OUT): unbatched 28-32, vmapped 25-32: (8, 1, 0, 1);
- ``counts-upper``, the replica count against a scalar upper bound only:
  in order unbatched, vmapped 30-32: (8, 1, 0, 0);
- ``plane-upper``, a float plane against a scalar upper bound only (the
  leaders' NW_IN): in order.

So B1 = 25, the default padding's 24 brokers, already runs vector loops,
and 23, 24 and 32 are where an eight-lane fold with its remainder in order
(the earlier rule for every 24-32 row) and the programs part: 23 runs VF 4
with an epilogue, and a strided row of 24 or 32 keeps eight elements for
its scalar tail. A program not in the table raises :class:`ValueError` for
rows of 9-32 elements rather than guess.
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


def vector_loop_sum(x: torch.Tensor, vf: int, ic: int = 1, epi: int = 0,
                    tail: int = 0, seed: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """float32 ``[...]`` sums of ``x[..., n]`` in the order of LLVM's
    vectorized reduction loop (see the module docstring): ``ic``
    accumulators of ``vf`` lanes over the whole ``vf * ic`` chunks (at
    least ``tail`` elements left for the scalar loop), combined in order
    and folded by halves; a ``epi``-lane epilogue seeded with that total;
    then the rest in order. Every step is an element-wise float32 add.
    ``seed`` (``[...]``) is the running total the loop starts from, in
    place of XLA's init 0.0 (the row loop inside a loop over rows)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    total = x.new_zeros(x.shape[:-1]) if seed is None else seed
    pos = 0
    chunk = vf * ic
    iters = (n - tail) // chunk if vf > 1 else 0
    if iters:
        # XLA's init 0.0 (or the seed) enters lane 0 of the first
        # accumulator, -0.0 the others (only a -0.0 element can tell them
        # apart)
        init = torch.cat([total[..., None], x.new_full(
            x.shape[:-1] + (vf - 1,), -0.0)], dim=-1)
        acc = [x[..., k * vf:(k + 1) * vf] for k in range(ic)]
        acc[0] = acc[0] + init
        for it in range(1, iters):
            acc = [a + x[..., (it * ic + k) * vf:(it * ic + k + 1) * vf]
                   for k, a in enumerate(acc)]
        lanes = acc[0]
        for a in acc[1:]:
            lanes = lanes + a
        total = _fold_halves(lanes)
        pos = iters * chunk
    if epi and n - pos - tail >= epi:
        lanes = torch.cat([total[..., None], x.new_full(
            x.shape[:-1] + (epi - 1,), -0.0)], dim=-1)
        while n - pos - tail >= epi:
            lanes = lanes + x[..., pos:pos + epi]
            pos += epi
        total = _fold_halves(lanes)
    for i in range(pos, n):
        total = total + x[..., i]
    return total


def fma_loop_sum(x: torch.Tensor, w: torch.Tensor, vf: int, ic: int = 1,
                 epi: int = 0) -> torch.Tensor:
    """float32 ``[...]`` sums of ``x[..., g] * w[g]`` in the order of LLVM's
    vectorized loop with every product contracted into its add (an FMA):
    ``ic`` accumulators of ``vf`` lanes over the whole ``vf * ic`` chunks,
    which the backend re-associates into one chain — the first
    accumulator's chunks in order, then each other one's with its second
    chunk first (its first add became an FMA whose addend is that chunk's
    product) — folded by halves; an ``epi``-lane epilogue seeded with that
    total; then the rest in order. ``vf = 1`` is goal order."""
    x = x.to(torch.float32)
    G = x.shape[-1]
    chunk = vf * ic
    iters = G // chunk
    total = x.new_zeros(x.shape[:-1])
    pos = iters * chunk
    if iters:
        lanes = x.new_full(x.shape[:-1] + (vf,), -0.0)
        lanes[..., 0] = 0.0
        for k in range(ic):
            its = list(range(iters))
            if k and iters > 1:
                its[:2] = [1, 0]
            for it in its:
                c = (it * ic + k) * vf
                lanes = fma(x[..., c:c + vf], w[c:c + vf], lanes)
        total = _fold_halves(lanes)
    if epi and G - pos >= epi:
        lanes = torch.cat([total[..., None], x.new_full(
            x.shape[:-1] + (epi - 1,), -0.0)], dim=-1)
        while G - pos >= epi:
            lanes = fma(x[..., pos:pos + epi], w[pos:pos + epi], lanes)
            pos += epi
        total = _fold_halves(lanes)
    for g in range(pos, G):
        total = fma(x[..., g], w[g], total)
    return total


def _fold_halves(lanes: torch.Tensor) -> torch.Tensor:
    """x86's lowering of a ``reassoc`` ``llvm.vector.reduce.fadd``: lanes
    folded by halves (0-3 + 4-7, 0-1 + 2-3, 0 + 1)."""
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    return lanes[..., 0]


#: (program, vmapped) -> ((first width, last width, (vf, ic, epi, tail)),
#: ...): the vector loops of a goal's fused violation row (the module
#: docstring's table); a width not listed sums in order (n <= 32)
ROW_LOOPS = {
    ("plane", False): ((23, 23, (4, 4, 4, 0)), (24, 32, (8, 1, 0, 0))),
    ("plane", True): ((22, 23, (4, 4, 4, 0)), (24, 32, (8, 1, 0, 0))),
    ("column", False): ((23, 23, (4, 4, 4, 1)), (24, 32, (8, 1, 0, 1))),
    ("column", True): ((23, 23, (4, 4, 4, 1)), (24, 32, (8, 1, 0, 1))),
    ("column-capacity", False): ((25, 32, (8, 1, 0, 1)),),
    ("column-capacity", True): ((25, 32, (8, 1, 0, 1)),),
    ("cpu-capacity", False): ((28, 32, (8, 1, 0, 1)),),
    ("cpu-capacity", True): ((25, 32, (8, 1, 0, 1)),),
    ("plane-capacity", False): ((28, 32, (8, 1, 0, 1)),),
    ("plane-capacity", True): ((25, 32, (8, 1, 0, 1)),),
    ("counts-upper", False): (),
    ("counts-upper", True): ((30, 32, (8, 1, 0, 0)),),
    ("plane-upper", False): (),
    ("plane-upper", True): (),
}


def row_loop(program: str, batched: bool, n: int):
    """(vf, ic, epi, tail) of the vector loop XLA's CPU backend gives
    ``program``'s fused violation row of ``n`` elements (vmapped where
    ``batched``), None where the row reduces as :func:`tree_sum_last`
    (wider than 32, narrower than 9, or a width :data:`ROW_LOOPS` does not
    list); raises for a program whose loops were not read."""
    if n > _WINDOW or n < 9:
        return None
    key = (program, batched)
    if key not in ROW_LOOPS:
        raise ValueError(f"XLA's order for the {'vmapped ' if batched else ''}"
                         f"{program!r} violation row of {n} elements is not "
                         f"identified (scripts/probe_violation_order.py)")
    for first, last, shape in ROW_LOOPS[key]:
        if first <= n <= last:
            return shape
    return None


def violation_row_sum(x: torch.Tensor, program: str) -> torch.Tensor:
    """float32 ``[...]`` sums of a goal's penalty rows ``x[..., B1]`` in the
    order XLA's CPU backend gives ``program``'s fused row reduction —
    vmapped when ``x`` has a leading scenario axis (:func:`row_loop`).
    Rows wider than 32 reduce as :func:`tree_sum_last`."""
    shape = row_loop(program, x.dim() > 1, x.shape[-1])
    if shape is None:
        return tree_sum_last(x)
    return vector_loop_sum(x, *shape)


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


def _small_sums(xs: torch.Tensor, split: bool = False) -> torch.Tensor:
    """float32[n] sums of n matrices xs[n, b, d] (2 <= b, d <= 32), each in
    XLA's eager order: f = :func:`_lanes` accumulators, lane l adding the
    elements of rows l, l + f, ... of the whole f-row groups in order, the
    lanes folded by halves, then the leftover rows' elements added in
    order; with f = 1 every element in order from zero. ``split``: the
    last row is a window's peeled row (one padding row on that axis), so
    the lanes cover the whole f-row groups of the first b - 1 rows only."""
    n, b, d = xs.shape
    rows = b - 1 if split else b
    f = _lanes(rows, d)
    full = rows // f * f if f > 1 else 0
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
    """float32 ``[...]`` sums of matrices ``x[..., B, D]`` in the order XLA's
    CPU backend gives an eager ``jnp.sum`` over both axes (probed,
    ``scripts/probe_sum_order.py``), vmapped or not. One column or one row
    reduces as a vector (:func:`tree_sum`), at most 32 x 32 as one
    :func:`_small_sums` matrix. Larger: windows of min(n, 32) along each
    axis, each axis' padding split evenly in front and behind, and the
    window sums reduce as a matrix again. Each window:

    - without padding: as a small matrix (:func:`_small_sums`);
    - one padding column (D = 31 mod 32, D > 32): XLA peels the window's
      last column, so the first wd - 1 columns add in row order, then the
      last column down the rows;
    - one padding row (B = 31 mod 32, B > 32) and no column padding: the
      last row is peeled and the first 31 rows reduce as a small matrix
      of 31 rows (:func:`_lanes` accumulators), the peeled row last;
    - any other padding: the elements in row order from zero."""
    x = x.to(torch.float32)
    lead = x.shape[:-2]
    B, D = x.shape[-2:]
    return _matrix_sums(x.reshape((math.prod(lead), B, D))).reshape(lead)


def _matrix_sums(xs: torch.Tensor) -> torch.Tensor:
    """float32[n] :func:`matrix_sum` of each of n matrices xs[n, B, D]."""
    n, B, D = xs.shape
    if B == 1 or D == 1:
        return tree_sum_last(xs.reshape(n, B * D))
    if B <= _WINDOW and D <= _WINDOW:
        return _small_sums(xs)
    wb, wd = min(B, _WINDOW), min(D, _WINDOW)
    nb, nd = -(-B // wb), -(-D // wd)
    pb, pd = nb * wb - B, nd * wd - D
    xp = torch.nn.functional.pad(xs, (pd // 2, pd - pd // 2,
                                      pb // 2, pb - pb // 2))
    windows = xp.reshape(n, nb, wb, nd, wd).transpose(2, 3).reshape(
        n * nb * nd, wb, wd)
    if pd == 1:
        windows = torch.cat([windows[:, :, :-1].reshape(n * nb * nd, -1),
                             windows[:, :, -1]], dim=1)
    if pb == 1 and pd == 0:
        parts = _small_sums(windows, split=True)
    elif pb or pd:
        parts = ordered_range_sum(windows.reshape(-1), torch.arange(
            0, n * nb * nd * wb * wd + 1, wb * wd, device=xs.device))
    else:
        parts = _small_sums(windows)
    return _matrix_sums(parts.reshape(n, nb, nd))


#: The loop XLA's CPU backend gives TopicReplicaDistributionGoal's fused
#: [T, B1] violation sum when both axes hold at most 32 cells (probed:
#: ``scripts/probe_topic_sum_order.py``): at B1 = 23-32 LLVM vectorizes
#: the row loop, each row a :func:`vector_loop_sum` seeded with the
#: running total (23: (4, 4, 4, 0), 24-32: (8, 1, 0, 0)); at B1 = 9-22 it
#: unrolls the row and vectorizes the loop over rows: VF lanes each adding
#: whole rows, in column order (rows l, l + VF, ...), folded by halves,
#: the rows left over added in order. VF by T: 4 rows: 4; 8 rows or 16-32:
#: 8; any other count: no vector loop (every cell in row order). The
#: vmapped program (the what-if and fleet scorers) differs at one shape:
#: a single topic at B1 = 22 runs the row loop (4, 4, 4, 0).
def _topic_loop(T: int, B1: int, batched: bool):
    """("rows", (vf, ic, epi, tail)) or ("lanes", vf) for a fused [T, B1]
    sum (T, B1 <= 32); raises where the loop was not read."""
    if B1 >= 23:
        return "rows", ((4, 4, 4, 0) if B1 == 23 else (8, 1, 0, 0))
    if batched and T == 1 and B1 == 22:
        return "rows", (4, 4, 4, 0)
    if B1 < 9:
        raise ValueError(f"XLA's order for a [{T}, {B1}] topic-cell sum is "
                         "not identified (scripts/probe_topic_sum_order.py)")
    if T == 4:
        return "lanes", 4
    if T == 8 or T >= 16:
        return "lanes", 8
    return "lanes", 1


def topic_sum_form(T: int, B1: int, batched: bool):
    """How :func:`topic_cell_sum` reduces a ``[T, B1]`` table: ("matrix",
    None) past 32 on either axis (:func:`matrix_sum`), else
    :func:`_topic_loop`'s ("rows", (vf, ic, epi, tail)) or ("lanes",
    vf); raises where that loop was not read."""
    if T > _WINDOW or B1 > _WINDOW:
        return "matrix", None
    return _topic_loop(T, B1, batched)


def topic_cell_sum(x: torch.Tensor, form=None) -> torch.Tensor:
    """float32 ``[...]`` sums of ``x[..., T, B1]`` (a topic goal's penalty
    cells) in the order XLA's CPU backend gives the reference's
    ``pen.sum()``, unbatched or under ``vmap`` (a leading axis). Past 32
    on either axis XLA's tree rewrite leaves an eager reduction
    (:func:`matrix_sum`, probed at 8 x 33 to 400 x 1,009, vmapped and
    nested); otherwise the fused loop of :func:`_topic_loop`. ``form``:
    :func:`topic_sum_form`'s answer, where the caller resolved it."""
    x = x.to(torch.float32)
    lead = x.shape[:-2]
    T, B1 = x.shape[-2:]
    form, shape = form or topic_sum_form(T, B1, len(lead) > 0)
    if form == "matrix":
        return matrix_sum(x)
    n = math.prod(lead)
    xs = x.reshape(n, T, B1)
    if form == "rows":
        total = xs.new_zeros(n)
        for r in range(T):
            total = vector_loop_sum(xs[:, r], *shape, seed=total)
        return total.reshape(lead)
    vf = shape
    full = T // vf * vf if vf > 1 else 0
    runs = []
    if full:
        # lane l: rows l, l + vf, ... each in column order, from 0.0 (the
        # other lanes' -0.0 start changes no bit of a non-negative sum)
        lanes = xs[:, :full].reshape(n, full // vf, vf, B1).transpose(1, 2)
        lanes = ordered_range_sum(lanes.reshape(-1), torch.arange(
            0, n * full * B1 + 1, full // vf * B1, device=x.device))
        runs.append(_fold_halves(lanes.reshape(n, vf))[:, None])
    runs.append(xs[:, full:].reshape(n, -1))
    seq = torch.cat(runs, dim=1)
    m = seq.shape[1]
    return ordered_range_sum(seq.reshape(-1), torch.arange(
        0, n * m + 1, m, device=x.device)).reshape(lead)


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


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """The signed integer image of float ``x`` whose order is IEEE total
    order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN): the sign
    bit's flip of the magnitude bits of a negative float. Integer inputs
    are their own key."""
    if not x.is_floating_point():
        return x
    itype = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.float16: torch.int16, torch.bfloat16: torch.int16}[x.dtype]
    bits = x.contiguous().view(itype)
    magnitude = torch.iinfo(itype).max
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & magnitude)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis in
    ``lax.top_k``'s order: IEEE total order, descending (+0.0 above -0.0,
    NaN above +inf and -NaN below -inf), the lower index first among equal
    bits."""
    _, idx = torch.sort(total_order_key(x), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


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
