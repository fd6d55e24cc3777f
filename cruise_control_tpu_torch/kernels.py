"""The port's hand-written CUDA kernels, their wrappers and plain twins.

Four kernels carry the dry-run proposal path (sources in ``csrc/``):

- **KA** ``threefry2x32`` — counter-mode threefry2x32 draws (the
  ``jax.random`` stream the goal kernels draw tie-break noise from), the
  key's fold-ins and splits and the float conversion fused into the one
  launch (:func:`threefry_draw`);
- **KB** ``ordered_segment_sum`` — float32 segment sums that add each
  segment's rows in ascending row order (broker aggregates without float
  atomics, so a seed reproduces its proposals run after run), with an
  optional batch axis (each scenario's rows into its own segments): the
  rows are grouped by segment on chip, tile by tile, and one thread a
  (segment, column) chain adds them from shared memory; no global sort and
  no host sync. ``ordered_range_sum`` is its form for rows already
  grouped into contiguous runs (a warp a run);
- **KC** ``net_broker_flow`` — the collective guard's pessimistic net flow
  per candidate, without the four ``[M, M]`` float masks: a warp a row,
  the mask row read in 16-byte loads, the matching terms added in
  ascending j by ballot;
- **KK** ``cell_net_flow`` — the same prefix accounting on (topic, broker)
  cells for the topic goals' guards: several one-sided queries against
  several cell slots in one launch, a warp a row (integer-valued terms,
  exact in any order).

Two more carry the what-if sweep and the move scheduler:

- **KD** ``scenario_failover`` — each scenario's placement edit and
  leadership failover: one cluster of KJ's tiled kernel, the placement
  kept in registers across a scenario chunk or read per scenario;
- **KE** ``first_fit`` — the move schedule's first-fit batch assignment,
  one block walking the moves in order.

Two more carry the monitor's device-resident model cycle:

- **KF** ``delta_row_scatter`` — a metric-only cycle's changed partition
  rows, uploaded as one packed payload (:func:`pack_delta_rows`), written
  into fresh copies of both resident load planes in one launch;
- **KG** ``cluster_stats`` — per-resource statistics over the alive
  brokers, summed in XLA's CPU tree order, and the alive, replica and
  leader counts, into one buffer in one launch (any broker count).

Two more carry the search modes built on the analyzer:

- **KH** ``intra_broker_walk`` — the intra-broker disk walk, every
  iteration of every broker in one launch (one block per broker);
- **KI** ``population_select`` — one generation boundary of the population
  search: joint scoring, Pareto ranks and the survivor permutation, a
  warp a plan over the others (one block, or a grid of plan tiles and a
  second launch past what one block holds).

One more carries the fleet's scenario sweeps:

- **KJ** ``fleet_scenario_failover`` — KD's placement edit and failover
  over a fleet's ``[C, S]`` grid in one launch of the same kernel
  (``csrc/failover.cu``): a block a (cluster, partition tile, scenario
  chunk), the chunk's broker masks as bits in shared memory, a thread's
  partitions in registers across the scenarios, 16-byte stores.

Each wrapper takes the plain twin for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises: there is no fallback. Each launch
adds one to ``LAUNCHES[name]``.

The kernels are built from ``csrc/*.cu`` at first use with ``nvcc`` into
``build/torch_kernels/`` (one ``nvcc`` per source, all started together,
then one link), keyed by a hash of the sources and the flags, and loaded
with ctypes. Each C entry returns ``cudaGetLastError()``. Each build or
load is reported to the default device-runtime collector, which counts it
as a compile event.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("threefry.cu", "segment_sum.cu", "net_flow.cu", "cell_flow.cu",
           "failover.cu", "first_fit.cu", "delta_scatter.cu",
           "cluster_stats.cu", "intra_walk.cu", "population_select.cu",
           "launch_floor.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"threefry2x32": 0, "ordered_segment_sum": 0,
            "net_broker_flow": 0, "cell_net_flow": 0,
            "scenario_failover": 0, "first_fit": 0,
            "delta_row_scatter": 0, "cluster_stats": 0,
            "intra_broker_walk": 0, "population_select": 0,
            "fleet_scenario_failover": 0}
#: ``nvcc``/ptxas output of the build this process loaded (register and
#: spill counts per kernel), empty when the library came from the cache
BUILD_LOG: list[str] = []

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcc_kernels-{source_digest()}.so"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``libcc_kernels-<digest>.so`` (cached by
    the digest of the sources and flags). Raises on any compiler error."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG.append(f"[{name}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} (rc {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / lib.name),
             *[str(obj) for _n, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp / lib.name, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load_library():
    """The loaded kernel library, built first if its sources changed; the
    first call in a process reports a ``build`` (nvcc ran) or ``load`` (the
    cached library) to the default device-runtime collector."""
    from .core.runtime_obs import default_collector
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            kind = "load" if library_path().exists() else "build"
            lib = ctypes.CDLL(str(build_library()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.cc_threefry_draw.argtypes = [
                p, _DrawPath, p, i64, i64, ctypes.c_int32, ctypes.c_float,
                ctypes.c_float, i64, ctypes.c_uint32, ctypes.c_uint32, p, p]
            lib.cc_ordered_segment_sum.argtypes = [p, p, ctypes.c_int, p, p,
                                                   i64, i64, i64, i64, p, p,
                                                   p]
            lib.cc_ordered_segment_sum_scratch.argtypes = [i64, i64, i64, i64,
                                                           p]
            lib.cc_ordered_segment_sum_scratch.restype = None
            lib.cc_ordered_range_sum.argtypes = [p, p, p, i64, i64, p]
            lib.cc_net_broker_flow.argtypes = [p, p, p, p, p, p, p, p, i64, p]
            lib.cc_cell_net_flow.argtypes = [p, p, p, p, p, i64, i64, i64, p]
            lib.cc_failover.argtypes = [p] * 12 + [i64] * 8 + [p]
            lib.cc_failover_chunk.argtypes = [i64, i64, i64, i64, i64]
            lib.cc_failover_chunk.restype = i64
            lib.cc_first_fit.argtypes = [p, p, p, p, p, i64, ctypes.c_float,
                                         p, p, p, p, i64, i64, i64, i64, p]
            lib.cc_first_fit_shared_slots.argtypes = [i64, i64, i64]
            lib.cc_first_fit_shared_slots.restype = i64
            lib.cc_delta_row_scatter.argtypes = [p, p, p, p, p, i64, i64,
                                                 i64, ctypes.c_int, p]
            lib.cc_cluster_stats.argtypes = [p, p, p, p, p, p, i64, p, i64,
                                             p, p, i64, p]
            lib.cc_cluster_stats_scratch.argtypes = [i64]
            lib.cc_cluster_stats_scratch.restype = i64
            lib.cc_empty_kernel.argtypes = [p]
            lib.cc_intra_broker_walk.argtypes = [p, p, p, p, p, p, p, p, p,
                                                 i64, i64, i64, i64, p, p, p]
            lib.cc_intra_broker_walk_shared.argtypes = [i64, i64]
            lib.cc_intra_broker_walk_shared.restype = i64
            f32 = ctypes.c_float
            lib.cc_population_select.argtypes = [p, p, p, p, f32, f32,
                                                 *[i64] * 14, p, p, p, p]
            lib.cc_population_select_single.argtypes = [i64, i64]
            lib.cc_population_select_single.restype = i64
            for fn in (lib.cc_threefry_draw, lib.cc_ordered_segment_sum,
                       lib.cc_ordered_range_sum,
                       lib.cc_net_broker_flow, lib.cc_cell_net_flow,
                       lib.cc_failover,
                       lib.cc_first_fit, lib.cc_delta_row_scatter,
                       lib.cc_cluster_stats, lib.cc_intra_broker_walk,
                       lib.cc_population_select, lib.cc_empty_kernel):
                fn.restype = ctypes.c_int
            _LIB = lib
            default_collector().record_library(kind,
                                               time.perf_counter() - t0)
        return _LIB


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all be on cpu or all on cuda, "
                     f"got {sorted(devices)}")


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def empty_launch() -> None:
    """Launch the empty kernel (``csrc/launch_floor.cu``) on the current
    stream: a launch's floor, timed beside the kernels. Counted nowhere."""
    _check(load_library().cc_empty_kernel(_stream()), "empty_kernel")


# ---------------------------------------------------------------------------
# KA: threefry2x32 draws
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: words a draw's derivation path holds (``csrc/threefry.cu:kMaxPath``)
MAX_PATH = 8
#: output forms of a draw (``csrc/threefry.cu:Form``)
DRAW_FORMS = {"keys": 0, "bits": 1, "affine": 2, "randint": 3}


class _DrawPath(ctypes.Structure):
    _fields_ = [("words", ctypes.c_uint32 * MAX_PATH),
                ("ptrs", ctypes.c_void_p * MAX_PATH),
                ("n", ctypes.c_int32)]


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32_plain(key, counters):
    """Twin of KA's hash: the twenty rounds on int64 tensors (or Python
    ints) masked to 32 bits (the counter's high word enters as x0, its low
    word as x1)."""
    k0 = key[0] & _M32
    k1 = key[1] & _M32
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = ((counters >> 32) + k0) & _M32
    x1 = ((counters & _M32) + k1) & _M32
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    for block in range(5):
        for r in rots[block % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def _randint_span(minval: int, maxval: int):
    """(span, multiplier) of ``jax.random.randint`` for int32: the span as
    uint32 (1 for an empty range) and ``(2**16 % span)**2 % span`` with
    uint32 wrap."""
    span = (maxval - minval) & _M32 if maxval > minval else 1
    return span, (((2 ** 16) % span) ** 2 & _M32) % span


def threefry_draw_plain(key, words=(), shape=(), form="bits", *, a=1.0,
                        b=0.0, minval=0, maxval=1, base=0, counters=None):
    """Twin of KA (:func:`threefry_draw`): the path's key folded in on the
    host (Python ints), then the draw's hashes and form on tensors."""
    k = (int(key[0]) & _M32, int(key[1]) & _M32)
    for w in words:
        k = threefry2x32_plain(k, int(w) & _M32)
    dev = key.device
    shape = tuple(shape) if counters is None else tuple(counters.shape)
    if counters is None:
        counters = base + torch.arange(math.prod(shape), device=dev)
    ktensor = torch.tensor(k, dtype=torch.int64, device=dev)
    if form == "keys":
        x0, x1 = threefry2x32_plain(ktensor, counters)
        return torch.stack([x0, x1], dim=-1).reshape(*shape, 2)
    if form == "randint":
        span, mult = _randint_span(minval, maxval)
        hi, lo = (threefry2x32_plain(
            torch.tensor(threefry2x32_plain(k, i), device=dev), counters)
            for i in (0, 1))
        hi, lo = hi[0] ^ hi[1], lo[0] ^ lo[1]
        off = ((hi % span) * mult) & _M32
        off = (off + lo % span) & _M32
        return (minval + off % span).reshape(shape)
    x0, x1 = threefry2x32_plain(ktensor, counters)
    bits = (x0 ^ x1).to(torch.int32).reshape(shape)
    if form == "bits":
        return bits
    if form != "affine":
        raise ValueError(f"unknown draw form {form!r}")
    u = torch.clamp(((bits >> 9) & 0x7FFFFF | 0x3F800000).view(
        torch.float32) - 1.0, min=0.0)
    f64 = (torch.tensor(a, dtype=torch.float32).double() * u.double()
           + torch.tensor(b, dtype=torch.float32).double())
    return f64.to(torch.float32)


def threefry_draw(key, words=(), shape=(), form="bits", *, a=1.0, b=0.0,
                  minval=0, maxval=1, base=0, counters=None):
    """One draw from the key ``key`` (int64[2]) with the words ``words``
    folded in (``fold_in(key, w)`` and ``split(key, n)[w]`` alike; at most
    :data:`MAX_PATH`; a word is a Python int or an integer scalar tensor),
    over counters ``base + i`` for i < prod(``shape``) or the int64
    ``counters`` (whose shape is then the draw's), in the output form
    ``form``:

    - ``"keys"``: int64[*shape, 2] keys (both hash words);
    - ``"bits"``: int32[*shape] random bits (``x0 ^ x1``, as uint32 bits);
    - ``"affine"``: float32[*shape] ``a * uniform + b`` rounded once
      (``a=1, b=0`` is ``jax.random.uniform``);
    - ``"randint"``: int64[*shape] ``jax.random.randint(key, shape,
      minval, maxval)`` for int32.

    See ``csrc/threefry.cu``."""
    if key.numel() != 2:
        raise ValueError("threefry2x32 takes a key of two words")
    if form not in DRAW_FORMS:
        raise ValueError(f"unknown draw form {form!r}")
    if len(words) > MAX_PATH:
        raise ValueError(f"a draw folds in at most {MAX_PATH} words, "
                         f"got {len(words)}")
    shape = tuple(shape) if counters is None else tuple(counters.shape)
    n = math.prod(shape)
    tensors = [w for w in words if isinstance(w, torch.Tensor)]
    if any(w.numel() != 1 or w.dtype.is_floating_point or w.is_complex()
           for w in tensors):
        raise ValueError("a word must be an integer scalar")
    if _on_cpu(key, counters, *tensors):
        return threefry_draw_plain(key, words, shape, form, a=a, b=b,
                                   minval=minval, maxval=maxval, base=base,
                                   counters=counters)
    if key.dtype != torch.int64:
        raise TypeError("threefry_draw takes an int64 key")
    path = _DrawPath(n=len(words))
    keep = []                   # the scalars the kernel reads, alive
    for j, w in enumerate(words):
        if isinstance(w, torch.Tensor):
            w = w.reshape(1).to(torch.int64)
            keep.append(w)
            path.ptrs[j] = w.data_ptr()
        else:
            path.words[j] = int(w) & _M32
    if counters is not None:
        if counters.dtype != torch.int64:
            raise TypeError("threefry_draw takes int64 counters")
        counters = counters.contiguous()
    dev = key.device
    out_dtype = {"keys": torch.int64, "bits": torch.int32,
                 "affine": torch.float32, "randint": torch.int64}[form]
    out = torch.empty(shape + ((2,) if form == "keys" else ()),
                      dtype=out_dtype, device=dev)
    span, mult = _randint_span(minval, maxval)
    key = key.contiguous()
    rc = load_library().cc_threefry_draw(
        key.data_ptr(), path,
        None if counters is None else counters.data_ptr(), int(base), n,
        DRAW_FORMS[form], float(a), float(b), int(minval), span, mult,
        out.data_ptr(), _stream())
    LAUNCHES["threefry2x32"] += 1
    _check(rc, "threefry2x32")
    return out


def threefry2x32(key: torch.Tensor, counters: torch.Tensor):
    """(x0, x1) int64[N] in [0, 2**32): threefry2x32 of ``key`` (int64[2])
    over 64-bit ``counters`` (int64[N]) — KA's ``"keys"`` form."""
    if key.numel() != 2:
        raise ValueError("threefry2x32 takes a key of two words")
    if _on_cpu(key, counters):
        return threefry2x32_plain(key, counters)
    if key.dtype != torch.int64 or counters.dtype != torch.int64:
        raise TypeError("threefry2x32 takes int64 key and counters")
    pairs = threefry_draw(key, (), form="keys", counters=counters)
    return pairs[:, 0], pairs[:, 1]


# ---------------------------------------------------------------------------
# KB: ordered segment sum
# ---------------------------------------------------------------------------

def _segment_layout(values: torch.Tensor, seg: torch.Tensor):
    """(batch shape, rows, columns, column shape) of a KB call: ``seg`` is
    ``[*L, N]``, ``values`` ``[*L, N]`` or ``[*L, N, C]``."""
    if seg.dim() < 1 or values.shape[:seg.dim()] != seg.shape:
        raise ValueError("seg must hold one segment index per row of values")
    cols = tuple(values.shape[seg.dim():])
    if len(cols) > 1:
        raise ValueError("values must be [*L, N] or [*L, N, C]")
    return seg.shape[:-1], seg.shape[-1], (cols[0] if cols else 1), cols


def _ordered_segment_sum_1d(v: torch.Tensor, seg: torch.Tensor, S: int,
                            base: torch.Tensor | None) -> torch.Tensor:
    """The twin's unbatched pass over ``v`` [N, C] and ``seg`` [N]: step k
    adds every segment's k-th row at once (distinct segments, so each step
    is an exact float32 add per cell)."""
    out = (torch.zeros((S, v.shape[1]), dtype=v.dtype, device=v.device)
           if base is None else base.reshape(S, -1).clone())
    seg = seg.long()
    rows = torch.nonzero((seg >= 0) & (seg < S)).squeeze(1)
    segs, order = torch.sort(seg[rows], stable=True)
    rows = rows[order]
    if rows.numel():
        first = torch.searchsorted(segs, segs)          # segment starts
        rank = torch.arange(rows.numel(), device=v.device) - first
        by_rank = torch.argsort(rank, stable=True)
        counts = torch.bincount(rank).tolist()
        start = 0
        for n in counts:
            sel = by_rank[start:start + n]
            start += n
            s = segs[sel]
            out[s] = out[s] + v[rows[sel]]
    return out


def ordered_segment_sum_plain(values: torch.Tensor, seg: torch.Tensor,
                              num_segments: int,
                              base: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Twin of KB: one sequential pass in row order. A batch axis (``seg``
    ``[*L, N]``) becomes segment ids offset by the item's index, so each
    item's rows stay in order and never meet another item's."""
    lead, N, C, cols = _segment_layout(values, seg)
    S = int(num_segments)
    items = math.prod(lead)
    ids = seg.reshape(items, N).long()
    ids = torch.where((ids >= 0) & (ids < S), ids + torch.arange(
        items, device=ids.device)[:, None] * S, -1)
    out = _ordered_segment_sum_1d(
        values.reshape(items * N, C), ids.reshape(-1), items * S,
        None if base is None else base.reshape(items * S, C))
    return out.reshape(lead + (S,) + cols)


def ordered_segment_sum(values: torch.Tensor, seg: torch.Tensor,
                        num_segments: int,
                        base: torch.Tensor | None = None) -> torch.Tensor:
    """float32 ``[*L, S]`` or ``[*L, S, C]``: ``base`` (or zeros) plus each
    segment's rows added in ascending row order — see
    ``csrc/segment_sum.cu``. ``seg`` (int32 or int64) is ``[N]`` or, with a
    batch axis, ``[*L, N]``: each item sums its own rows into its own S
    segments. ``values`` is ``seg``'s shape, or that shape plus a column
    axis. Rows whose segment lies outside [0, S) are dropped."""
    lead, N, C, cols = _segment_layout(values, seg)
    S = int(num_segments)
    out_shape = lead + (S,) + cols
    if base is not None and tuple(base.shape) != out_shape:
        raise ValueError(f"base must be {list(out_shape)}, got "
                         f"{list(base.shape)}")
    if _on_cpu(values, seg, base):
        return ordered_segment_sum_plain(values, seg, S, base)
    if values.dtype != torch.float32:
        raise TypeError("ordered_segment_sum takes float32 values")
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError("ordered_segment_sum takes int32 or int64 ids")
    items = math.prod(lead)
    v = values.contiguous()
    ids = seg.contiguous()
    if base is not None:
        base = base.to(torch.float32).contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=v.device)
    lib = load_library()
    sizes = (ctypes.c_int64 * 2)()
    lib.cc_ordered_segment_sum_scratch(items, N, S, C, sizes)
    sorted_rows = torch.empty(sizes[0], dtype=torch.float32, device=v.device)
    table = torch.empty(sizes[1], dtype=torch.int32, device=v.device)
    rc = lib.cc_ordered_segment_sum(
        v.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
        None if base is None else base.data_ptr(), out.data_ptr(), items, N,
        S, C, sorted_rows.data_ptr() if sizes[0] else None,
        table.data_ptr() if sizes[1] else None, _stream())
    LAUNCHES["ordered_segment_sum"] += 1
    _check(rc, "ordered_segment_sum")
    return out


def ordered_range_sum_plain(values: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """Twin of KB's range form: the runs as segment ids, one ordered pass."""
    n = values.shape[0]
    seg = torch.searchsorted(offsets, torch.arange(n, device=values.device),
                             right=True) - 1
    return ordered_segment_sum_plain(values, seg, offsets.shape[0] - 1)


def ordered_range_sum(values: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """float32[S, C] (or [S]): segment s is the run of rows
    ``offsets[s] <= i < offsets[s + 1]`` (int64, ascending), added in row
    order — KB for callers whose segments are already contiguous: one warp
    a run, no grouping."""
    if _on_cpu(values, offsets):
        return ordered_range_sum_plain(values, offsets)
    if values.dtype != torch.float32:
        raise TypeError("ordered_range_sum takes float32 values")
    flat = values.dim() == 1
    v = values.reshape(values.shape[0], -1).contiguous()
    S = offsets.shape[0] - 1
    offsets = offsets.long().contiguous()
    out = torch.empty((S, v.shape[1]), dtype=torch.float32, device=v.device)
    rc = load_library().cc_ordered_range_sum(
        v.data_ptr(), offsets.data_ptr(), out.data_ptr(), S, v.shape[1],
        _stream())
    LAUNCHES["ordered_segment_sum"] += 1
    _check(rc, "ordered_range_sum")
    return out.reshape(S) if flat else out


# ---------------------------------------------------------------------------
# KC: net broker flow
# ---------------------------------------------------------------------------

def net_broker_flow_plain(src, dst, earlier, d_src, d_dst):
    """Twin of KC: the literal masked-matmul formula of
    ``goals.py:_net_broker_flow``/``_net_src_hi``."""
    e = earlier.to(d_src.dtype)
    same_dd = e * (dst[:, None] == dst[None, :])
    same_ds = e * (dst[:, None] == src[None, :])
    same_sd = e * (src[:, None] == dst[None, :])
    same_ss = e * (src[:, None] == src[None, :])
    pos_s, pos_d = d_src.clamp(min=0.0), d_dst.clamp(min=0.0)
    neg_s, neg_d = d_src.clamp(max=0.0), d_dst.clamp(max=0.0)
    net_dst_hi = same_dd @ pos_d + same_ds @ pos_s
    net_src_lo = same_ss @ neg_s + same_sd @ neg_d
    net_src_hi = same_ss @ pos_s + same_sd @ pos_d
    return net_src_lo, net_dst_hi, net_src_hi


def net_broker_flow_ascending(src, dst, earlier, d_src, d_dst):
    """KC's own order in plain torch: each of the six partial sums adds its
    terms in ascending j (one vectorised step per j, every row at once;
    a row without a term at j adds +0.0, which changes no bit of a sum
    that starts at +0.0), then the pairs. The card's result must equal it
    bit for bit."""
    m = src.shape[0]
    zero = torch.zeros(m, dtype=torch.float32, device=src.device)
    dd, ds, ss_lo, sd_lo, ss_hi, sd_hi = (zero.clone() for _ in range(6))
    a, b = d_src.to(torch.float32), d_dst.to(torch.float32)
    for j in range(m):
        e = earlier[:, j]
        m_dd, m_ds = e & (dst[j] == dst), e & (src[j] == dst)
        m_ss, m_sd = e & (src[j] == src), e & (dst[j] == src)
        dd = dd + torch.where(m_dd, b[j].clamp(min=0.0), zero)
        ds = ds + torch.where(m_ds, a[j].clamp(min=0.0), zero)
        ss_lo = ss_lo + torch.where(m_ss, a[j].clamp(max=0.0), zero)
        ss_hi = ss_hi + torch.where(m_ss, a[j].clamp(min=0.0), zero)
        sd_lo = sd_lo + torch.where(m_sd, b[j].clamp(max=0.0), zero)
        sd_hi = sd_hi + torch.where(m_sd, b[j].clamp(min=0.0), zero)
    return ss_lo + sd_lo, dd + ds, ss_hi + sd_hi


def net_broker_flow(src, dst, earlier, d_src, d_dst):
    """(net_src_lo, net_dst_hi, net_src_hi) float32[M] — see
    ``csrc/net_flow.cu``."""
    m = src.shape[0]
    if earlier.shape != (m, m) or earlier.dtype != torch.bool:
        raise ValueError("earlier must be bool[M, M]")
    if not all(t.shape == (m,) for t in (src, dst, d_src, d_dst)):
        raise ValueError("src, dst, d_src and d_dst must all be [M]")
    if _on_cpu(src, dst, earlier, d_src, d_dst):
        return net_broker_flow_plain(src, dst, earlier, d_src, d_dst)
    src = src.long().contiguous()
    dst = dst.long().contiguous()
    earlier = earlier.contiguous()
    d_src = d_src.to(torch.float32).contiguous()
    d_dst = d_dst.to(torch.float32).contiguous()
    outs = [torch.empty(m, dtype=torch.float32, device=src.device)
            for _ in range(3)]
    rc = load_library().cc_net_broker_flow(
        src.data_ptr(), dst.data_ptr(), earlier.data_ptr(), d_src.data_ptr(),
        d_dst.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr(), m, _stream())
    LAUNCHES["net_broker_flow"] += 1
    _check(rc, "net_broker_flow")
    return outs[0], outs[1], outs[2]


# ---------------------------------------------------------------------------
# KK: net flow on (topic, broker) cells
# ---------------------------------------------------------------------------

#: queries and cell slots KK takes at most (``csrc/cell_flow.cu:kMax``)
CELL_FLOW_MAX = 4


def cell_net_flow_plain(query, key, val, earlier):
    """Twin of KK: the literal masked-matmul form of the reference's topic
    guards — for each query, ``acc = 0`` plus one ``(earlier * (query ==
    key[k])) @ val[a, k]`` product per cell slot k, in slot order."""
    e = earlier.to(torch.float32)
    out = []
    for a in range(val.shape[0]):
        acc = torch.zeros(query.shape[1], dtype=torch.float32,
                          device=query.device)
        for k in range(val.shape[1]):
            acc = acc + (e * (query[a][:, None] == key[k][None, :])) @ val[a, k]
        out.append(acc)
    return torch.stack(out)


def cell_net_flow(query, key, val, earlier):
    """float32[A, M] ``out[a, i] = sum_j earlier[i, j] sum_k [query[a, i] ==
    key[k, j]] val[a, k, j]`` — see ``csrc/cell_flow.cu``. ``query``
    int[A, M] and ``key`` int[K, M] are cell ids, ``val`` float32[A, K, M]
    each query's terms, ``earlier`` bool[M, M]; A and K are 1-4."""
    A, M = query.shape
    if not (1 <= A <= CELL_FLOW_MAX and 1 <= key.shape[0] <= CELL_FLOW_MAX):
        raise ValueError(f"cell_net_flow takes 1-{CELL_FLOW_MAX} queries and "
                         f"cell slots, got {A} and {key.shape[0]}")
    K = key.shape[0]
    if key.shape != (K, M) or val.shape != (A, K, M):
        raise ValueError("key must be [K, M] and val [A, K, M] for query "
                         "[A, M]")
    if earlier.shape != (M, M) or earlier.dtype != torch.bool:
        raise ValueError("earlier must be bool[M, M]")
    if _on_cpu(query, key, val, earlier):
        return cell_net_flow_plain(query, key, val, earlier)
    query = query.long().contiguous()
    key = key.long().contiguous()
    val = val.to(torch.float32).contiguous()
    earlier = earlier.contiguous()
    out = torch.empty((A, M), dtype=torch.float32, device=query.device)
    rc = load_library().cc_cell_net_flow(
        query.data_ptr(), key.data_ptr(), val.data_ptr(), earlier.data_ptr(),
        out.data_ptr(), M, A, K, _stream())
    LAUNCHES["cell_net_flow"] += 1
    _check(rc, "cell_net_flow")
    return out


# ---------------------------------------------------------------------------
# KD: scenario failover
# ---------------------------------------------------------------------------

def _failover_rows_plain(rb, off, pref, up, pvalid):
    """The literal array form of ``whatif/engine.py``'s placement edit and
    failover over rows ``[*L, P]`` (``csrc/failover.cu``): ``up``
    bool[*L, B] is each row's broker-up mask; ``rb``/``off``/``pref``
    broadcast to ``[*L, P, R]`` and ``pvalid`` to ``[*L, P]``."""
    *lead, B = up.shape
    P, R = rb.shape[-2:]
    shape = (*lead, P, R)
    up1 = torch.cat([up, torch.zeros((*lead, 1), dtype=torch.bool,
                                     device=up.device)], dim=-1)

    def on_up(brokers):
        # an id outside [0, B) reads the sentinel column, which is down
        # (JAX wraps -1 onto it and clamps ids past it)
        ids = brokers.reshape(*lead, -1).long()
        ids = torch.where((ids < 0) | (ids > B), B, ids)
        return torch.gather(up1, -1, ids).reshape(brokers.shape)

    pv = pvalid[..., None]
    rb = torch.where(pv, rb, B).expand(shape).to(torch.int32)
    off = (off & pv).expand(shape)
    pref = pref.expand(shape).to(torch.int32)
    electable = (rb < B) & on_up(rb) & ~off
    score = torch.where(electable, pref, R + 1)
    j = torch.argmin(score, dim=-1, keepdim=True)     # first minimum
    has_alive = electable.any(dim=-1)
    need = (has_alive & ~electable[..., 0] & pvalid)[..., None]
    slot = torch.arange(R, device=rb.device)
    src = torch.where(need & (slot == 0), j,
                      torch.where(need & (slot == j), 0, slot))
    rb = torch.gather(rb, -1, src)
    pref = torch.gather(pref, -1, src)
    off = torch.gather(off, -1, src)
    off = off | ((rb < B) & ~on_up(rb))
    return rb, pref, off, has_alive


def scenario_failover_plain(rb, off, pref, broker_valid, broker_alive, dead,
                            add, pvalid):
    """Twin of KD: the literal array form of ``whatif/engine.py``'s
    placement edit and failover, over the whole ``[S, P, R]`` batch."""
    up = ((broker_valid | add) & (broker_alive | add) & ~dead)      # [S, B]
    return _failover_rows_plain(rb, off, pref, up, pvalid)


def failover_chunk(C: int, S: int, P: int, R: int, B: int) -> int:
    """Scenarios a block of KD's and KJ's tiled kernel serves at this shape
    on the current card; 0 where the row kernel runs (R past 4, or one
    scenario's broker mask past the shared-memory allotment)."""
    return int(load_library().cc_failover_chunk(C, S, P, R, B))


def _shared_row(t: torch.Tensor) -> torch.Tensor | None:
    """``t [S, ...]``'s first row where every scenario is a view of it (an
    ``expand``ed stride of 0, or one scenario), else None."""
    if t.shape[0] == 1 or (t.shape[0] > 1 and t.stride(0) == 0):
        return t[0]
    return None


def _failover(name, rb, off, pref, valid, alive, dead, add, pvalid,
              in_per_s: bool, pv_per_s: bool):
    """One launch of ``csrc/failover.cu`` over the ``[C, S, P]`` rows of
    ``dead [C, S, B]``: outputs ``[C, S, P, R]`` and ``[C, S, P]``."""
    if any(t.dtype != torch.bool for t in (off, valid, alive, dead, add,
                                           pvalid)):
        raise TypeError(f"{name} takes bool masks")
    C, S, B = dead.shape
    P, R = rb.shape[-2:]
    rb = rb.to(torch.int32).contiguous()
    pref = pref.to(torch.int32).contiguous()
    off, valid, alive, dead, add, pvalid = (
        t.contiguous() for t in (off, valid, alive, dead, add, pvalid))
    dev = rb.device
    rb_out = torch.empty((C, S, P, R), dtype=torch.int32, device=dev)
    pref_out = torch.empty((C, S, P, R), dtype=torch.int32, device=dev)
    off_out = torch.empty((C, S, P, R), dtype=torch.bool, device=dev)
    has_alive = torch.empty((C, S, P), dtype=torch.bool, device=dev)
    rc = load_library().cc_failover(
        rb.data_ptr(), off.data_ptr(), pref.data_ptr(), valid.data_ptr(),
        alive.data_ptr(), dead.data_ptr(), add.data_ptr(), pvalid.data_ptr(),
        rb_out.data_ptr(), pref_out.data_ptr(), off_out.data_ptr(),
        has_alive.data_ptr(), C, S, P, R, B, int(in_per_s), int(pv_per_s),
        -1, _stream())
    LAUNCHES[name] += 1
    _check(rc, name)
    return rb_out, pref_out, off_out, has_alive


def scenario_failover(rb, off, pref, broker_valid, broker_alive, dead, add,
                      pvalid):
    """(rb int32, pref int32, off bool [S, P, R], has_alive bool [S, P]):
    the placements of S scenarios after their broker kills/adds, partition
    enables and leadership failover — see ``csrc/failover.cu`` (one
    cluster of its grid). ``rb``/``off``/``pref`` are the template's
    ``[P, R]`` (shared by every scenario) or one ``[S, P, R]`` placement per
    scenario; ``broker_valid``/``broker_alive`` ``[B]``; ``dead``/``add``
    ``[S, B]``; ``pvalid`` ``[S, P]``, read once where it is one row
    expanded over the scenarios (the move scheduler's boundary audit)."""
    S, B = dead.shape
    P, R = rb.shape[-2:]
    if rb.dim() not in (2, 3) or (rb.dim() == 3 and rb.shape[0] != S):
        raise ValueError("rb must be [P, R] or [S, P, R]")
    if off.shape != rb.shape or pref.shape != rb.shape:
        raise ValueError("rb, off and pref must share one shape")
    if (add.shape != (S, B) or pvalid.shape != (S, P)
            or broker_valid.shape != (B,) or broker_alive.shape != (B,)):
        raise ValueError("dead/add must be [S, B], pvalid [S, P] and "
                         "broker_valid/broker_alive [B]")
    args = (rb, off, pref, broker_valid, broker_alive, dead, add, pvalid)
    if _on_cpu(*args):
        return scenario_failover_plain(*args)
    pv = _shared_row(pvalid)
    outs = _failover("scenario_failover", rb, off, pref, broker_valid[None],
                     broker_alive[None], dead[None], add[None],
                     pvalid if pv is None else pv, rb.dim() == 3,
                     pv is None)
    return tuple(o[0] for o in outs)


# ---------------------------------------------------------------------------
# KE: first-fit batch assignment
# ---------------------------------------------------------------------------

def first_fit_shared_slots(W: int, num_batches: int, B1: int) -> int:
    """Batch slots a KE launch of W touched rows a move, ``num_batches``
    slots and B1 broker rows keeps in shared memory on the current card
    (the rest live in its global arrays)."""
    return int(load_library().cc_first_fit_shared_slots(W, num_batches, B1))


def first_fit_plain(rows, dest_rows, size_mb, valid, caps, cluster_cap: int,
                    budget: float, num_batches: int) -> torch.Tensor:
    """Twin of KE: the reference's loop body, one move at a time, every
    batch slot tested at once."""
    M = rows.shape[0]
    K = int(num_batches)
    B1 = caps.shape[0]
    dev = rows.device
    count = torch.zeros((B1, K), dtype=torch.int32, device=dev)
    size = torch.zeros(K, dtype=torch.int32, device=dev)
    mb = torch.zeros((B1, K), dtype=torch.float32, device=dev)
    assign = torch.full((M,), K, dtype=torch.int32, device=dev)
    budget = torch.tensor(budget, dtype=torch.float32, device=dev)
    rows, dest_rows = rows.long(), dest_rows.long()
    size_mb = size_mb.to(torch.float32)
    for i in range(M):
        if not bool(valid[i]):
            continue
        r, d = rows[i], dest_rows[i]
        cap_ok = (count[r] < caps[r][:, None]).all(dim=0)
        is_dest = (d < B1 - 1)[:, None]
        dmb = mb[d]
        bw_ok = (~is_dest | (dmb + size_mb[i] <= budget)
                 | (dmb == 0.0)).all(dim=0)
        ok = cap_ok & (size < cluster_cap) & bw_ok
        hits = torch.nonzero(ok)
        if hits.numel() == 0:
            continue
        k = int(hits[0, 0])
        assign[i] = k
        count[:, k].index_add_(0, r, torch.ones_like(r, dtype=torch.int32))
        size[k] += 1
        dd = d[d < B1 - 1]
        mb.index_put_((dd, torch.full_like(dd, k)),
                      size_mb[i].expand(dd.shape), accumulate=True)
    return assign


def first_fit(rows, dest_rows, size_mb, valid, caps, cluster_cap: int,
              budget: float, num_batches: int) -> torch.Tensor:
    """int32[M] batch index per move (``num_batches`` where none admits it)
    — see ``csrc/first_fit.cu``. ``rows``/``dest_rows`` int32[M, W] touched
    and destination broker rows (padding: row B1 - 1), ``size_mb``
    float32[M], ``valid`` bool[M], ``caps`` int32[B1]."""
    M, W = rows.shape
    if dest_rows.shape != (M, W) or size_mb.shape != (M,) or \
            valid.shape != (M,) or caps.dim() != 1:
        raise ValueError("first_fit takes rows/dest_rows [M, W], size_mb and "
                         "valid [M], caps [B1]")
    args = (rows, dest_rows, size_mb, valid, caps)
    if _on_cpu(*args):
        return first_fit_plain(*args, cluster_cap, budget, num_batches)
    if valid.dtype != torch.bool:
        raise TypeError("first_fit takes a bool valid mask")
    K = int(num_batches)
    B1 = caps.shape[0]
    dev = rows.device
    rows, dest_rows, caps = (t.to(torch.int32).contiguous()
                             for t in (rows, dest_rows, caps))
    size_mb = size_mb.to(torch.float32).contiguous()
    valid = valid.to(torch.int32)
    count = torch.zeros((B1, K), dtype=torch.int32, device=dev)
    size = torch.zeros(K, dtype=torch.int32, device=dev)
    mb = torch.zeros((B1, K), dtype=torch.float32, device=dev)
    assign = torch.empty(M, dtype=torch.int32, device=dev)
    rc = load_library().cc_first_fit(
        rows.data_ptr(), dest_rows.data_ptr(), size_mb.data_ptr(),
        valid.data_ptr(), caps.data_ptr(), int(cluster_cap),
        float(budget), count.data_ptr(), size.data_ptr(), mb.data_ptr(),
        assign.data_ptr(), M, W, K, B1, _stream())
    LAUNCHES["first_fit"] += 1
    _check(rc, "first_fit")
    return assign


# ---------------------------------------------------------------------------
# KF: delta row scatter
# ---------------------------------------------------------------------------

def delta_payload_words(num_rows: int, num_cols: int) -> int:
    """4-byte words of a packed payload of ``num_rows`` rows of
    ``num_cols`` columns: both row blocks, then the indices."""
    return num_rows * (2 * num_cols + 1)


def pack_delta_rows(idx, lead_rows, foll_rows, out=None):
    """KF's payload on the host: ``lead_rows`` and ``foll_rows``
    (float32[K, C]) then ``idx`` (int32[K]) as one float32 array of
    :func:`delta_payload_words` words, the rows in ascending index order
    (a stable sort; indices must be unique). Written into ``out`` (a
    float32 array at least that long) where given; returns the packed
    words."""
    idx = np.asarray(idx)
    K, C = np.shape(lead_rows)
    if idx.shape != (K,) or np.shape(foll_rows) != (K, C):
        raise ValueError("pack_delta_rows takes idx [K] and rows [K, C]")
    n = delta_payload_words(K, C)
    buf = np.empty(n, np.float32) if out is None else out[:n]
    order = np.argsort(idx, kind="stable")
    buf[:K * C].reshape(K, C)[:] = np.asarray(lead_rows)[order]
    buf[K * C:2 * K * C].reshape(K, C)[:] = np.asarray(foll_rows)[order]
    buf[2 * K * C:].view(np.int32)[:] = idx[order]
    return buf


def _unpack_delta(payload, num_cols: int):
    """(idx int32[K], lead_rows, foll_rows float32[K, C]): views of a
    packed payload."""
    words = payload.shape[0]
    if payload.dim() != 1 or words % (2 * num_cols + 1):
        raise ValueError(f"a delta payload of {num_cols} columns holds "
                         f"K * {2 * num_cols + 1} words, got "
                         f"{tuple(payload.shape)}")
    K = words // (2 * num_cols + 1)
    return (payload[2 * K * num_cols:].view(torch.int32),
            payload[:K * num_cols].view(K, num_cols),
            payload[K * num_cols:2 * K * num_cols].view(K, num_cols))


def delta_row_scatter_plain(lead, foll, payload):
    """Twin of KF: copies of both planes with the payload's rows whose
    index lies in [0, P) copied in (``clone`` + ``index_copy_`` of the
    kept rows)."""
    idx, lead_rows, foll_rows = _unpack_delta(payload, lead.shape[1])
    keep = (idx >= 0) & (idx < lead.shape[0])
    rows = idx[keep].long()
    return (lead.clone().index_copy_(0, rows, lead_rows[keep]),
            foll.clone().index_copy_(0, rows, foll_rows[keep]))


def delta_row_scatter(lead, foll, payload):
    """(lead_out, foll_out): fresh float32[P, C] copies of the planes
    ``lead``/``foll`` with the rows of ``payload`` (float32 words packed by
    :func:`pack_delta_rows`: rows sorted by unique index) written at their
    indices, indices outside [0, P) dropped; the inputs are not written —
    see ``csrc/delta_scatter.cu``."""
    P, C = lead.shape
    if foll.shape != (P, C):
        raise ValueError("delta_row_scatter takes two planes [P, C]")
    _unpack_delta(payload, C)
    if _on_cpu(lead, foll, payload):
        return delta_row_scatter_plain(lead, foll, payload)
    if any(t.dtype != torch.float32 for t in (lead, foll, payload)):
        raise TypeError("delta_row_scatter takes float32 planes and payload")
    lead, foll, payload = (t.contiguous() for t in (lead, foll, payload))
    row16 = C == 4 and all(t.data_ptr() % 16 == 0
                           for t in (lead, foll, payload))
    lead_out, foll_out = torch.empty_like(lead), torch.empty_like(foll)
    rc = load_library().cc_delta_row_scatter(
        lead.data_ptr(), foll.data_ptr(), payload.data_ptr(),
        lead_out.data_ptr(), foll_out.data_ptr(),
        payload.shape[0] // (2 * C + 1), C, P, int(row16), _stream())
    LAUNCHES["delta_row_scatter"] += 1
    _check(rc, "delta_row_scatter")
    return lead_out, foll_out


# ---------------------------------------------------------------------------
# KG: cluster statistics
# ---------------------------------------------------------------------------

#: KG's seven value columns, in output order
STATS_COLUMNS = ("cpu", "nw_in", "nw_out", "disk", "replica_count",
                 "leader_count", "potential_nw_out")
#: KG's output counts, after the table, in order
STATS_COUNTS = ("num_alive_brokers", "num_replicas", "num_leaders")
_TABLE_WORDS = 4 * len(STATS_COLUMNS)


def _tree_sum_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """float32[R] sums of x[R, n] in XLA's CPU tree order (windows of 32,
    padding split evenly in front and behind, each window summed in order
    from zero), in plain torch."""
    rows, n = x.shape
    while n > 32:
        windows = -(-n // 32)
        pad = windows * 32 - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(
            rows, windows, 32)
        acc = x.new_zeros((rows, windows))
        for j in range(32):
            acc = acc + x[:, :, j]
        x, n = acc, windows
    acc = x.new_zeros(rows)
    for j in range(n):
        acc = acc + x[:, j]
    return acc


def split_cluster_stats(out):
    """(table float32[4, 7], counts int32[3]): views of KG's output buffer
    — rows avg, std, max, min of :data:`STATS_COLUMNS`, then
    :data:`STATS_COUNTS`. No copy: on the card, nothing is read."""
    return (out[:_TABLE_WORDS].view(4, len(STATS_COLUMNS)),
            out[_TABLE_WORDS:].view(torch.int32))


def cluster_stats_plain(util, replicas, leaders, potential, alive,
                        replica_valid, partition_valid):
    """Twin of KG: ``model/stats.py``'s masked mean, variance, max and min
    per column, the sums in tree order, and the counts, in KG's buffer."""
    vals = torch.cat([util.to(torch.float32),
                      replicas.to(torch.float32)[:, None],
                      leaders.to(torch.float32)[:, None],
                      potential.to(torch.float32)[:, None]], dim=1)
    count = alive.sum(dtype=torch.int32)
    n = torch.clamp(count, min=1).to(torch.float32)
    mask = alive[:, None]
    mean = _tree_sum_rows_plain(torch.where(mask, vals, 0.0).T) / n
    d = vals - mean
    var = _tree_sum_rows_plain(torch.where(mask, d * d, 0.0).T) / n
    big = torch.where(mask, vals, float("-inf")).amax(dim=0)
    small = torch.where(mask, vals, float("inf")).amin(dim=0)
    # torch's vectorized float32 sqrt on the CPU is not always correctly
    # rounded; the float64 root rounded once to float32 is.
    std = torch.sqrt(var.to(torch.float64)).to(torch.float32)
    out = vals.new_empty(_TABLE_WORDS + len(STATS_COUNTS))
    table, counts = split_cluster_stats(out)
    table.copy_(torch.stack([mean, std, big, small]))
    counts.copy_(torch.stack([count, replica_valid.sum(dtype=torch.int32),
                              partition_valid.sum(dtype=torch.int32)]))
    return out


def cluster_stats(util, replicas, leaders, potential, alive, replica_valid,
                  partition_valid):
    """KG's buffer float32[31] (:func:`split_cluster_stats` views it): the
    avg, std, max and min of the columns :data:`STATS_COLUMNS` over the
    brokers where ``alive`` (bool[B]) is set, then the alive count and the
    set entries of ``replica_valid`` (bool[P, R]) and ``partition_valid``
    (bool[P]). ``util`` float32[B, 4], ``replicas``/``leaders`` int32[B],
    ``potential`` float32[B]. One launch at any B — see
    ``csrc/cluster_stats.cu``."""
    B = alive.shape[0]
    if util.shape != (B, 4) or replicas.shape != (B,) or \
            leaders.shape != (B,) or potential.shape != (B,):
        raise ValueError("cluster_stats takes util [B, 4] and replicas, "
                         "leaders, potential and alive [B]")
    args = (util, replicas, leaders, potential, alive, replica_valid,
            partition_valid)
    if _on_cpu(*args):
        return cluster_stats_plain(*args)
    if any(t.dtype != torch.bool
           for t in (alive, replica_valid, partition_valid)):
        raise TypeError("cluster_stats takes bool masks")
    util, potential = (t.to(torch.float32).contiguous()
                       for t in (util, potential))
    if util.data_ptr() % 16:
        util = util.clone()             # KG reads a broker's row in 16 bytes
    replicas, leaders = (t.to(torch.int32).contiguous()
                         for t in (replicas, leaders))
    alive, replica_valid, partition_valid = (
        t.contiguous() for t in (alive, replica_valid, partition_valid))
    dev = util.device
    lib = load_library()
    out = torch.empty(_TABLE_WORDS + len(STATS_COUNTS), dtype=torch.float32,
                      device=dev)
    scratch_bytes = lib.cc_cluster_stats_scratch(B)
    scratch = (torch.empty(scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if scratch_bytes else None)
    rc = lib.cc_cluster_stats(
        util.data_ptr(), replicas.data_ptr(), leaders.data_ptr(),
        potential.data_ptr(), alive.data_ptr(), replica_valid.data_ptr(),
        replica_valid.numel(), partition_valid.data_ptr(),
        partition_valid.numel(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, _stream())
    LAUNCHES["cluster_stats"] += 1
    _check(rc, "cluster_stats")
    return out


# ---------------------------------------------------------------------------
# KH: intra-broker disk walk
# ---------------------------------------------------------------------------

def _ordered_sums_dense(seg: torch.Tensor, vals: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """float32[S]: each segment's values added from zero in row order (rows
    whose segment lies outside [0, S) dropped) — one vectorised add per
    row rank over a [S, longest] matrix of the segments' rows."""
    S = int(num_segments)
    keep = torch.nonzero((seg >= 0) & (seg < S)).squeeze(1)
    s, order = torch.sort(seg[keep], stable=True)
    rows = keep[order]
    out = vals.new_zeros(S)
    if rows.numel() == 0:
        return out
    rank = torch.arange(rows.numel(), device=seg.device) - torch.searchsorted(
        s, s)
    dense = vals.new_zeros((S, int(rank.max()) + 1))
    dense[s, rank] = vals[rows]
    for k in range(dense.shape[1]):
        out = out + dense[:, k]
    return out


def intra_broker_walk_plain(rd, size, rb, capacity, valid, max_iters: int):
    """Twin of KH: ``intra.py:optimize_intra_broker``'s loop body, one
    iteration at a time over the whole cluster; the clamped gathers of the
    padding replicas (``replica_broker == B``) made explicit. The live
    disks' mean sums the D axis as the compiled loop body does (XLA's tree
    order, probed at D = 1-256)."""
    from .utils.ordered import tree_sum_last
    B, D = capacity.shape
    P, R = rd.shape
    dev = rd.device
    rd = rd.to(torch.int64)
    rbf = rb.reshape(-1).to(torch.int64)
    rbc = torch.clamp(rbf, max=B - 1)
    sizef = size.reshape(-1).to(torch.float32)
    live = valid & (capacity > 0)
    n_live = torch.clamp(live.sum(dim=1), min=1).to(torch.float32)
    arange_b = torch.arange(B, device=dev)
    flat_index = torch.arange(P * R, device=dev)
    it, moved = 0, True
    while moved and it < max_iters:
        rdf = rd.reshape(-1)
        seg = torch.where(rdf >= 0, rbf * D + rdf, B * D)
        util = _ordered_sums_dense(seg, sizef, B * D).reshape(B, D)
        avg = tree_sum_last(torch.where(live, util, 0.0)) / n_live
        pres = torch.where(valid & (capacity <= 0) & (util > 0),
                           float("inf"),
                           torch.where(live, util - avg[:, None],
                                       float("-inf")))
        src = torch.argmax(pres, dim=1)
        dst = torch.argmin(torch.where(live, util, float("inf")), dim=1)
        gap = util[arange_b, src] - util[arange_b, dst]
        drain = capacity[arange_b, src] <= 0
        on_src = (rdf == src[rbc]) & (rdf >= 0)
        fits = (sizef <= gap[rbc] * 0.5) | drain[rbc]
        movable = on_src & fits & ((sizef > 0) | drain[rbc])
        score = torch.where(movable, sizef, float("-inf"))
        seg_best = torch.full((B + 1,), float("-inf"), device=dev
                              ).scatter_reduce(0, rbf, score, "amax")
        is_best = (score == seg_best[rbf]) & torch.isfinite(score)
        order = torch.where(is_best, flat_index, P * R)
        first = torch.full((B + 1,), P * R, device=dev).scatter_reduce(
            0, rbf, order, "amin")[:B]
        ok = (first < P * R) & (dst != src)
        new = rdf.clone()
        new[first[ok]] = dst[ok]
        moved = bool((new != rdf).any())
        rd = new.reshape(P, R)
        it += 1
    return rd.to(torch.int32), torch.tensor(it, dtype=torch.int32,
                                            device=dev)


def intra_broker_walk(rd, size, rb, capacity, valid, max_iters: int):
    """(replica_disk int32[P, R], iterations int32[]): the intra-broker walk
    of ``intra.py:optimize_intra_broker`` from disk slots ``rd`` (int32[P,
    R], -1 none), replica sizes ``size`` (float32[P, R]), replica brokers
    ``rb`` (int[P, R], B = padding) and the disks' ``capacity``
    (float32[B, D]) and ``valid`` mask (bool[B, D]) — see
    ``csrc/intra_walk.cu``."""
    B, D = capacity.shape
    if size.shape != rd.shape or rb.shape != rd.shape or \
            valid.shape != (B, D) or rd.dim() != 2:
        raise ValueError("intra_broker_walk takes rd, size and rb [P, R], "
                         "capacity and valid [B, D]")
    if _on_cpu(rd, size, rb, capacity, valid):
        return intra_broker_walk_plain(rd, size, rb, capacity, valid,
                                       max_iters)
    if valid.dtype != torch.bool:
        raise TypeError("intra_broker_walk takes a bool valid mask")
    if D < 1:
        raise ValueError("intra_broker_walk needs at least one disk a broker")
    dev = rd.device
    PR = rd.numel()
    # Each broker's replica flat indices in increasing order (CSR); the
    # padding replicas (broker B) sort last, past offsets[B]. No value is
    # read back: the scratch is sized from P x R, and each block decides
    # from its own count whether its lists fit the shared allotment.
    brokers, rows = torch.sort(rb.reshape(-1).long(), stable=True)
    offsets = torch.searchsorted(brokers, torch.arange(B + 1, device=dev))
    out = rd.to(torch.int32).contiguous().clone()
    size = size.to(torch.float32).contiguous()
    capacity = capacity.to(torch.float32).contiguous()
    valid = valid.contiguous()
    scratch_sz = torch.empty(PR, dtype=torch.float32, device=dev)
    scratch_ix = torch.empty(PR, dtype=torch.int32, device=dev)
    scratch_pre = torch.empty(PR, dtype=torch.float32, device=dev)
    moves = torch.empty(B, dtype=torch.int32, device=dev)
    max_moves = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = load_library()
    # lists for up to 4x the mean broker (at least 1,024 replicas) in
    # shared memory; a larger broker walks from the global scratch
    shared = lib.cc_intra_broker_walk_shared(
        D, max(1024, 4 * -(-PR // max(B, 1))))
    if shared < 0:
        raise ValueError(f"intra_broker_walk: {D} disks a broker do not fit "
                         f"one block's shared memory")
    rc = lib.cc_intra_broker_walk(
        offsets.data_ptr(), rows.data_ptr(), size.data_ptr(), out.data_ptr(),
        capacity.data_ptr(), valid.data_ptr(), scratch_sz.data_ptr(),
        scratch_ix.data_ptr(), scratch_pre.data_ptr(), B, D, int(max_iters),
        shared, moves.data_ptr(), max_moves.data_ptr(),
        _stream())
    LAUNCHES["intra_broker_walk"] += 1
    _check(rc, "intra_broker_walk")
    iters = torch.clamp(max_moves[0] + 1, max=int(max_iters))
    return out, iters


# ---------------------------------------------------------------------------
# KI: population selection
# ---------------------------------------------------------------------------

_MAX_POPULATION = 1024
_MAX_POPULATION_GOALS = 1024


def population_select_plain(boundary, moves, scales, hard, hard_weight: float,
                            move_weight: float, n_surv: int, pareto: bool,
                            final: bool = False):
    """Twin of KI: the reference program's ``_scores`` and
    ``_survivor_perm`` through ``analyzer/engine.py``'s scoring helpers in
    their contracted (compiled) form."""
    from .analyzer.engine import pareto_ranks, weighted_objective
    from .utils.ordered import lexsort
    K = boundary.shape[0]
    weighted = weighted_objective(boundary, scales, hard,
                                  hard_weight=hard_weight,
                                  move_weight=move_weight, moves=moves,
                                  contract=True, final=final)
    ranks = pareto_ranks(boundary, scales, contract=True)
    primary = (ranks.to(torch.float32) if pareto
               else torch.zeros_like(weighted))
    arange = torch.arange(K, device=boundary.device)
    order = lexsort((arange, weighted, primary))
    perm = order[:n_surv][arange % n_surv]
    perm[0] = 0
    return ranks, weighted, perm.to(torch.int32)


def population_select_single(K: int, G: int) -> bool:
    """Whether one block of KI serves K plans of G goals in one launch on
    the current card (else a grid of plan tiles and a second launch)."""
    return bool(load_library().cc_population_select_single(K, G))


def population_select(boundary, moves, scales, hard, hard_weight: float,
                      move_weight: float, n_surv: int, pareto: bool,
                      final: bool = False):
    """(ranks int32[K], weighted float32[K], perm int32[K]) of one
    generation boundary (``final``: the scores the search returns, whose
    weighted row the reference compiles in another loop at some goal
    counts): ``boundary`` float32[K, G] violation stacks, ``moves`` int[K]
    cumulative moves, ``scales`` float32[G], ``hard`` bool[G] — see
    ``csrc/population_select.cu``."""
    K, G = boundary.shape
    if moves.shape != (K,) or scales.shape != (G,) or hard.shape != (G,):
        raise ValueError("population_select takes boundary [K, G], moves [K], "
                         "scales and hard [G]")
    if not 1 <= n_surv <= max(K, 1):
        raise ValueError(f"n_surv must lie in [1, K], got {n_surv}")
    if G > _MAX_POPULATION_GOALS:
        raise ValueError(f"population_select sums at most "
                         f"{_MAX_POPULATION_GOALS} goals (one level of "
                         f"32-goal windows), got {G}")
    from .analyzer.engine import WEIGHT_FORMS, weighted_row_loop
    loops = [v for form in WEIGHT_FORMS
             for v in weighted_row_loop(G, final, K, form) or (0, 0, 0)]
    args = (boundary, moves, scales, hard)
    if _on_cpu(*args):
        return population_select_plain(*args, hard_weight, move_weight,
                                       n_surv, pareto, final)
    if hard.dtype != torch.bool:
        raise TypeError("population_select takes a bool hard mask")
    if not 1 <= K <= _MAX_POPULATION:
        raise ValueError(f"population_select places 1...{_MAX_POPULATION} "
                         f"plans (their scores in one block's shared "
                         f"memory), got K={K}")
    dev = boundary.device
    boundary = boundary.to(torch.float32).contiguous()
    scales = scales.to(torch.float32).contiguous()
    moves = moves.to(torch.int32).contiguous()
    hard = hard.contiguous()
    ranks = torch.empty(K, dtype=torch.int32, device=dev)
    weighted = torch.empty(K, dtype=torch.float32, device=dev)
    perm = torch.empty(K, dtype=torch.int32, device=dev)
    rc = load_library().cc_population_select(
        boundary.data_ptr(), moves.data_ptr(), scales.data_ptr(),
        hard.data_ptr(), float(hard_weight), float(move_weight),
        int(bool(move_weight)), K, G, *loops,
        int(n_surv), int(bool(pareto)), ranks.data_ptr(),
        weighted.data_ptr(), perm.data_ptr(), _stream())
    LAUNCHES["population_select"] += 1
    _check(rc, "population_select")
    return ranks, weighted, perm


# ---------------------------------------------------------------------------
# KJ: fleet scenario failover
# ---------------------------------------------------------------------------

def fleet_scenario_failover_plain(rb, off, pref, broker_valid, broker_alive,
                                  dead, add, pvalid):
    """Twin of KJ: KD's twin with a leading cluster axis, over the whole
    ``[C, S, P, R]`` grid (each cluster's placement and masks broadcast
    over its S scenarios)."""
    up = ((broker_valid[:, None] | add) & (broker_alive[:, None] | add)
          & ~dead)                                              # [C, S, B]
    return _failover_rows_plain(rb[:, None], off[:, None], pref[:, None],
                                up, pvalid[:, None])


def fleet_scenario_failover(rb, off, pref, broker_valid, broker_alive, dead,
                            add, pvalid):
    """(rb int32, pref int32, off bool [C, S, P, R], has_alive bool
    [C, S, P]): the placements of S scenarios of each of C clusters after
    their broker kills/adds and leadership failover — see
    ``csrc/failover.cu``. ``rb``/``off``/``pref`` are each cluster's
    ``[C, P, R]`` placement; ``broker_valid``/``broker_alive`` ``[C, B]``;
    ``dead``/``add`` ``[C, S, B]``; ``pvalid`` ``[C, P]``."""
    if rb.dim() != 3 or dead.dim() != 3:
        raise ValueError("rb must be [C, P, R] and dead [C, S, B]")
    C, S, B = dead.shape
    P, R = rb.shape[-2:]
    if rb.shape[0] != C or off.shape != rb.shape or pref.shape != rb.shape:
        raise ValueError("rb, off and pref must share one [C, P, R] shape")
    if (add.shape != (C, S, B) or pvalid.shape != (C, P)
            or broker_valid.shape != (C, B)
            or broker_alive.shape != (C, B)):
        raise ValueError("dead/add must be [C, S, B], pvalid [C, P] and "
                         "broker_valid/broker_alive [C, B]")
    args = (rb, off, pref, broker_valid, broker_alive, dead, add, pvalid)
    if _on_cpu(*args):
        return fleet_scenario_failover_plain(*args)
    return _failover("fleet_scenario_failover", *args, False, False)
