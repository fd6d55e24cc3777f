"""The port's hand-written CUDA kernels, their wrappers and plain twins.

Three kernels carry the dry-run proposal path (sources in ``csrc/``):

- **KA** ``threefry2x32`` — counter-mode threefry2x32 bits (the
  ``jax.random`` stream the goal kernels draw tie-break noise from);
- **KB** ``ordered_segment_sum`` — float32 segment sums that add each
  segment's rows in ascending row order (broker aggregates without float
  atomics, so a seed reproduces its proposals run after run);
  ``ordered_range_sum`` launches it without the sort for rows already
  grouped into contiguous runs;
- **KC** ``net_broker_flow`` — the collective guard's pessimistic net flow
  per candidate, without the four ``[M, M]`` float masks.

Two more carry the what-if sweep and the move scheduler:

- **KD** ``scenario_failover`` — each scenario's placement edit and
  leadership failover, one thread per (scenario, partition) row;
- **KE** ``first_fit`` — the move schedule's first-fit batch assignment,
  one block walking the moves in order.

Two more carry the monitor's device-resident model cycle:

- **KF** ``delta_row_scatter`` — a metric-only cycle's changed partition
  rows written into both resident load planes in place;
- **KG** ``cluster_stats`` — per-resource and count statistics over the
  alive brokers, summed in XLA's CPU tree order.

Two more carry the search modes built on the analyzer:

- **KH** ``intra_broker_walk`` — the intra-broker disk walk, every
  iteration of every broker in one launch (one block per broker);
- **KI** ``population_select`` — one generation boundary of the population
  search: joint scoring, Pareto ranks and the survivor permutation.

One more carries the fleet's scenario sweeps:

- **KJ** ``fleet_scenario_failover`` — KD's placement edit and failover
  over a fleet's ``[C, S]`` grid in one launch, one thread per (cluster,
  scenario, partition) row.

Each wrapper takes the plain twin for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises: there is no fallback. Each launch
adds one to ``LAUNCHES[name]``.

The kernels are built from ``csrc/*.cu`` at first use with ``nvcc`` into
``build/torch_kernels/`` (one ``nvcc`` per source, all started together,
then one link), keyed by a hash of the sources, the headers they include
and the flags, and loaded with ctypes. Each C entry returns
``cudaGetLastError()``. Each build or load is reported to the default
device-runtime collector, which counts it as a compile event.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("threefry.cu", "segment_sum.cu", "net_flow.cu",
           "scenario_failover.cu", "first_fit.cu", "delta_scatter.cu",
           "cluster_stats.cu", "intra_walk.cu", "population_select.cu",
           "fleet_failover.cu")
#: headers the sources include: part of the build's digest
HEADERS = ("failover_row.cuh",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"threefry2x32": 0, "ordered_segment_sum": 0,
            "net_broker_flow": 0, "scenario_failover": 0, "first_fit": 0,
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
    for name in SOURCES + HEADERS:
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
            lib.cc_threefry2x32.argtypes = [p, p, p, p, i64, p]
            lib.cc_ordered_segment_sum.argtypes = [p, p, p, p, p, i64, i64, p]
            lib.cc_net_broker_flow.argtypes = [p, p, p, p, p, p, p, p, i64, p]
            lib.cc_scenario_failover.argtypes = [p, p, p, i64, p, p, p, p, p,
                                                 p, p, p, p, i64, i64, i64,
                                                 i64, p]
            lib.cc_first_fit.argtypes = [p, p, p, p, p, i64, ctypes.c_float,
                                         p, p, p, p, i64, i64, i64, i64, p]
            lib.cc_delta_row_scatter.argtypes = [p, p, p, p, p, i64, i64,
                                                 i64, p]
            lib.cc_cluster_stats.argtypes = [p, p, p, p, p, p, p, i64, p]
            lib.cc_intra_broker_walk.argtypes = [p, p, p, p, p, p, p, p, i64,
                                                 i64, i64, i64, p, p, p]
            f32 = ctypes.c_float
            lib.cc_population_select.argtypes = [p, p, p, p, f32, f32, i64,
                                                 i64, i64, i64, i64, p, p, p,
                                                 p]
            lib.cc_fleet_scenario_failover.argtypes = [p, p, p, p, p, p, p,
                                                       p, p, p, p, p, i64,
                                                       i64, i64, i64, i64, p]
            for fn in (lib.cc_threefry2x32, lib.cc_ordered_segment_sum,
                       lib.cc_net_broker_flow, lib.cc_scenario_failover,
                       lib.cc_first_fit, lib.cc_delta_row_scatter,
                       lib.cc_cluster_stats, lib.cc_intra_broker_walk,
                       lib.cc_population_select,
                       lib.cc_fleet_scenario_failover):
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


# ---------------------------------------------------------------------------
# KA: threefry2x32
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32_plain(key: torch.Tensor, counters: torch.Tensor):
    """Twin of KA: the same twenty rounds on int64 tensors masked to 32
    bits (the counter's high word enters as x0, its low word as x1)."""
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


def threefry2x32(key: torch.Tensor, counters: torch.Tensor):
    """(x0, x1) int64[N] in [0, 2**32): threefry2x32 of ``key`` (int64[2])
    over 64-bit ``counters`` (int64[N])."""
    if key.numel() != 2:
        raise ValueError("threefry2x32 takes a key of two words")
    if _on_cpu(key, counters):
        return threefry2x32_plain(key, counters)
    if key.dtype != torch.int64 or counters.dtype != torch.int64:
        raise TypeError("threefry2x32 takes int64 key and counters")
    key = key.contiguous()
    counters = counters.contiguous()
    out0 = torch.empty_like(counters)
    out1 = torch.empty_like(counters)
    rc = load_library().cc_threefry2x32(
        key.data_ptr(), counters.data_ptr(), out0.data_ptr(),
        out1.data_ptr(), counters.numel(), _stream())
    LAUNCHES["threefry2x32"] += 1
    _check(rc, "threefry2x32")
    return out0, out1


# ---------------------------------------------------------------------------
# KB: ordered segment sum
# ---------------------------------------------------------------------------

def ordered_segment_sum_plain(values: torch.Tensor, seg: torch.Tensor,
                              num_segments: int,
                              base: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Twin of KB: a sequential pass in row order, vectorised across
    segments — step k adds every segment's k-th row at once (distinct
    segments, so each step is an exact float32 add per cell)."""
    flat = values.dim() == 1
    v = values.reshape(values.shape[0], -1)
    S = num_segments
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
    return out.reshape(S) if flat else out


def ordered_segment_sum(values: torch.Tensor, seg: torch.Tensor,
                        num_segments: int,
                        base: torch.Tensor | None = None) -> torch.Tensor:
    """float32[S, C] (or [S] for 1-D ``values``): ``base`` (or zeros) plus
    each segment's rows added in ascending row order. Rows whose segment
    lies outside [0, S) are dropped."""
    if seg.shape != values.shape[:1]:
        raise ValueError("seg must hold one segment index per row of values")
    if _on_cpu(values, seg, base):
        return ordered_segment_sum_plain(values, seg, num_segments, base)
    S = int(num_segments)
    seg = seg.long()
    seg = torch.where((seg >= 0) & (seg < S), seg, S)
    sorted_seg, perm = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(
        sorted_seg, torch.arange(S + 1, device=seg.device))
    return _launch_segment_sum(values, perm, offsets, base)


def ordered_range_sum(values: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """float32[S, C] (or [S]): segment s is the run of rows
    ``offsets[s] <= i < offsets[s + 1]``, added in row order — KB without
    the sort, for callers whose segments are already contiguous."""
    if _on_cpu(values, offsets):
        n = values.shape[0]
        seg = torch.searchsorted(offsets, torch.arange(n), right=True) - 1
        return ordered_segment_sum_plain(values, seg, offsets.shape[0] - 1)
    return _launch_segment_sum(values, None, offsets.long(), None)


def _launch_segment_sum(values, perm, offsets, base):
    if values.dtype != torch.float32:
        raise TypeError("ordered_segment_sum takes float32 values")
    flat = values.dim() == 1
    v = values.reshape(values.shape[0], -1).contiguous()
    S = offsets.shape[0] - 1
    offsets = offsets.contiguous()
    if base is not None:
        base = base.reshape(S, -1).to(torch.float32).contiguous()
        if base.shape[1] != v.shape[1]:
            raise ValueError("base and values disagree on the column count")
    out = torch.empty((S, v.shape[1]), dtype=torch.float32, device=v.device)
    rc = load_library().cc_ordered_segment_sum(
        v.data_ptr(), None if perm is None else perm.data_ptr(),
        offsets.data_ptr(), None if base is None else base.data_ptr(),
        out.data_ptr(), S, v.shape[1], _stream())
    LAUNCHES["ordered_segment_sum"] += 1
    _check(rc, "ordered_segment_sum")
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
# KD: scenario failover
# ---------------------------------------------------------------------------

def _failover_rows_plain(rb, off, pref, up, pvalid):
    """The literal array form of ``whatif/engine.py``'s placement edit and
    failover over rows ``[*L, P]`` (``csrc/failover_row.cuh``): ``up``
    bool[*L, B] is each row's broker-up mask; ``rb``/``off``/``pref``
    broadcast to ``[*L, P, R]`` and ``pvalid`` to ``[*L, P]``."""
    *lead, B = up.shape
    P, R = rb.shape[-2:]
    shape = (*lead, P, R)
    up1 = torch.cat([up, torch.zeros((*lead, 1), dtype=torch.bool,
                                     device=up.device)], dim=-1)

    def on_up(brokers):
        return torch.gather(up1, -1, brokers.reshape(*lead, -1).long()
                            ).reshape(brokers.shape)

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


def scenario_failover(rb, off, pref, broker_valid, broker_alive, dead, add,
                      pvalid):
    """(rb int32, pref int32, off bool [S, P, R], has_alive bool [S, P]):
    the placements of S scenarios after their broker kills/adds, partition
    enables and leadership failover — see ``csrc/scenario_failover.cu``.
    ``rb``/``off``/``pref`` are the template's ``[P, R]`` (shared by every
    scenario) or one ``[S, P, R]`` placement per scenario;
    ``broker_valid``/``broker_alive`` ``[B]``; ``dead``/``add`` ``[S, B]``;
    ``pvalid`` ``[S, P]``."""
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
    if any(t.dtype != torch.bool for t in (off, broker_valid, broker_alive,
                                           dead, add, pvalid)):
        raise TypeError("scenario_failover takes bool masks")
    rb = rb.to(torch.int32).contiguous()
    pref = pref.to(torch.int32).contiguous()
    off, broker_valid, broker_alive, dead, add, pvalid = (
        t.contiguous() for t in (off, broker_valid, broker_alive, dead, add,
                                 pvalid))
    dev = rb.device
    rb_out = torch.empty((S, P, R), dtype=torch.int32, device=dev)
    pref_out = torch.empty((S, P, R), dtype=torch.int32, device=dev)
    off_out = torch.empty((S, P, R), dtype=torch.bool, device=dev)
    has_alive = torch.empty((S, P), dtype=torch.bool, device=dev)
    rc = load_library().cc_scenario_failover(
        rb.data_ptr(), off.data_ptr(), pref.data_ptr(),
        P * R if rb.dim() == 3 else 0, broker_valid.data_ptr(),
        broker_alive.data_ptr(), dead.data_ptr(), add.data_ptr(),
        pvalid.data_ptr(), rb_out.data_ptr(), pref_out.data_ptr(),
        off_out.data_ptr(), has_alive.data_ptr(), S, P, R, B, _stream())
    LAUNCHES["scenario_failover"] += 1
    _check(rc, "scenario_failover")
    return rb_out, pref_out, off_out, has_alive


# ---------------------------------------------------------------------------
# KE: first-fit batch assignment
# ---------------------------------------------------------------------------

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
    valid = valid.contiguous()
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

def delta_row_scatter_plain(lead, foll, idx, lead_rows, foll_rows):
    """Twin of KF: the rows whose index lies in [0, P) copied into both
    planes in place (``index_copy_`` of the kept rows)."""
    P = lead.shape[0]
    keep = (idx >= 0) & (idx < P)
    rows = idx[keep].long()
    lead.index_copy_(0, rows, lead_rows[keep])
    foll.index_copy_(0, rows, foll_rows[keep])
    return lead, foll


def delta_row_scatter(lead, foll, idx, lead_rows, foll_rows):
    """Write ``lead_rows``/``foll_rows`` (float32[K, C]) into rows ``idx``
    (int32[K], unique) of the planes ``lead``/``foll`` (float32[P, C]) in
    place, dropping indices outside [0, P); returns the two planes — see
    ``csrc/delta_scatter.cu``."""
    P, C = lead.shape
    K = idx.shape[0]
    if foll.shape != (P, C) or lead_rows.shape != (K, C) or \
            foll_rows.shape != (K, C) or idx.dim() != 1:
        raise ValueError("delta_row_scatter takes planes [P, C], idx [K] and "
                         "rows [K, C]")
    if _on_cpu(lead, foll, idx, lead_rows, foll_rows):
        return delta_row_scatter_plain(lead, foll, idx, lead_rows, foll_rows)
    if any(t.dtype != torch.float32 for t in (lead, foll, lead_rows,
                                              foll_rows)):
        raise TypeError("delta_row_scatter takes float32 planes and rows")
    if not (lead.is_contiguous() and foll.is_contiguous()):
        raise ValueError("delta_row_scatter writes contiguous planes in place")
    idx = idx.to(torch.int32).contiguous()
    lead_rows = lead_rows.contiguous()
    foll_rows = foll_rows.contiguous()
    rc = load_library().cc_delta_row_scatter(
        lead.data_ptr(), foll.data_ptr(), idx.data_ptr(),
        lead_rows.data_ptr(), foll_rows.data_ptr(), K, C, P, _stream())
    LAUNCHES["delta_row_scatter"] += 1
    _check(rc, "delta_row_scatter")
    return lead, foll


# ---------------------------------------------------------------------------
# KG: cluster statistics
# ---------------------------------------------------------------------------

#: KG's seven value columns, in output order
STATS_COLUMNS = ("cpu", "nw_in", "nw_out", "disk", "replica_count",
                 "leader_count", "potential_nw_out")
_MAX_STATS_BROKERS = 16_384


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


def cluster_stats_plain(util, replicas, leaders, potential, alive):
    """Twin of KG: ``model/stats.py``'s masked mean, variance, max and min
    per column, the sums in tree order."""
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
    return torch.stack([mean, std, big, small]), count


def cluster_stats(util, replicas, leaders, potential, alive):
    """(stats float32[4, 7], num_alive int32[]): rows avg, std, max, min of
    the columns :data:`STATS_COLUMNS` over the brokers where ``alive``
    (bool[B]) is set. ``util`` float32[B, 4], ``replicas``/``leaders``
    int32[B], ``potential`` float32[B] — see ``csrc/cluster_stats.cu``."""
    B = alive.shape[0]
    if util.shape != (B, 4) or replicas.shape != (B,) or \
            leaders.shape != (B,) or potential.shape != (B,):
        raise ValueError("cluster_stats takes util [B, 4] and replicas, "
                         "leaders, potential and alive [B]")
    args = (util, replicas, leaders, potential, alive)
    if _on_cpu(*args):
        return cluster_stats_plain(*args)
    if alive.dtype != torch.bool:
        raise TypeError("cluster_stats takes a bool alive mask")
    if B > _MAX_STATS_BROKERS:
        raise ValueError(f"cluster_stats runs one block: at most "
                         f"{_MAX_STATS_BROKERS} brokers, got {B}")
    util, potential = (t.to(torch.float32).contiguous()
                       for t in (util, potential))
    replicas, leaders = (t.to(torch.int32).contiguous()
                         for t in (replicas, leaders))
    alive = alive.contiguous()
    out = torch.empty((4, len(STATS_COLUMNS)), dtype=torch.float32,
                      device=util.device)
    count = torch.empty((), dtype=torch.int32, device=util.device)
    rc = load_library().cc_cluster_stats(
        util.data_ptr(), replicas.data_ptr(), leaders.data_ptr(),
        potential.data_ptr(), alive.data_ptr(), out.data_ptr(),
        count.data_ptr(), B, _stream())
    LAUNCHES["cluster_stats"] += 1
    _check(rc, "cluster_stats")
    return out, count


# ---------------------------------------------------------------------------
# KH: intra-broker disk walk
# ---------------------------------------------------------------------------

_MAX_DISKS = 64


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
    order, probed at D = 1-64)."""
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
    if D > _MAX_DISKS:
        raise ValueError(f"intra_broker_walk handles at most {_MAX_DISKS} "
                         f"disks a broker, got {D}")
    dev = rd.device
    rbf = rb.reshape(-1).long()
    # Each broker's replica flat indices in increasing order (CSR).
    brokers, rows = torch.sort(rbf, stable=True)
    n_rows = int(torch.searchsorted(brokers, B))
    rows = rows[:n_rows].contiguous()
    offsets = torch.searchsorted(brokers[:n_rows].contiguous(),
                                 torch.arange(B + 1, device=dev))
    max_rows = int((offsets[1:] - offsets[:-1]).max()) if B else 0
    out = rd.to(torch.int32).contiguous().clone()
    size = size.to(torch.float32).contiguous()
    capacity = capacity.to(torch.float32).contiguous()
    valid = valid.contiguous()
    scratch_size = torch.empty(n_rows, dtype=torch.float32, device=dev)
    scratch_rd = torch.empty(n_rows, dtype=torch.int32, device=dev)
    moves = torch.empty(B, dtype=torch.int32, device=dev)
    max_moves = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = load_library().cc_intra_broker_walk(
        offsets.data_ptr(), rows.data_ptr(), size.data_ptr(), out.data_ptr(),
        capacity.data_ptr(), valid.data_ptr(), scratch_size.data_ptr(),
        scratch_rd.data_ptr(), B, D, int(max_iters), max_rows,
        moves.data_ptr(), max_moves.data_ptr(), _stream())
    LAUNCHES["intra_broker_walk"] += 1
    _check(rc, "intra_broker_walk")
    iters = torch.clamp(max_moves[0] + 1, max=int(max_iters))
    return out, iters


# ---------------------------------------------------------------------------
# KI: population selection
# ---------------------------------------------------------------------------

_MAX_POPULATION = 1024


def population_select_plain(boundary, moves, scales, hard, hard_weight: float,
                            move_weight: float, n_surv: int, pareto: bool):
    """Twin of KI: the reference program's ``_scores`` and
    ``_survivor_perm`` through ``analyzer/engine.py``'s scoring helpers in
    their contracted (compiled) form."""
    from .analyzer.engine import pareto_ranks, weighted_objective
    from .utils.ordered import lexsort
    K = boundary.shape[0]
    weighted = weighted_objective(boundary, scales, hard,
                                  hard_weight=hard_weight,
                                  move_weight=move_weight, moves=moves,
                                  contract=True)
    ranks = pareto_ranks(boundary, scales, contract=True)
    primary = (ranks.to(torch.float32) if pareto
               else torch.zeros_like(weighted))
    arange = torch.arange(K, device=boundary.device)
    order = lexsort((arange, weighted, primary))
    perm = order[:n_surv][arange % n_surv]
    perm[0] = 0
    return ranks, weighted, perm.to(torch.int32)


def population_select(boundary, moves, scales, hard, hard_weight: float,
                      move_weight: float, n_surv: int, pareto: bool):
    """(ranks int32[K], weighted float32[K], perm int32[K]) of one
    generation boundary: ``boundary`` float32[K, G] violation stacks,
    ``moves`` int[K] cumulative moves, ``scales`` float32[G], ``hard``
    bool[G] — see ``csrc/population_select.cu``."""
    K, G = boundary.shape
    if moves.shape != (K,) or scales.shape != (G,) or hard.shape != (G,):
        raise ValueError("population_select takes boundary [K, G], moves [K], "
                         "scales and hard [G]")
    if not 1 <= n_surv <= max(K, 1):
        raise ValueError(f"n_surv must lie in [1, K], got {n_surv}")
    from .analyzer.engine import MAX_FUSED_GOALS
    if G > MAX_FUSED_GOALS:
        raise ValueError(f"population_select reproduces the reference for "
                         f"at most {MAX_FUSED_GOALS} goals, got {G}")
    args = (boundary, moves, scales, hard)
    if _on_cpu(*args):
        return population_select_plain(*args, hard_weight, move_weight,
                                       n_surv, pareto)
    if hard.dtype != torch.bool:
        raise TypeError("population_select takes a bool hard mask")
    if not 1 <= K <= _MAX_POPULATION:
        raise ValueError(f"population_select runs one block: 1..."
                         f"{_MAX_POPULATION} plans, got K={K}")
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
        int(bool(move_weight)), K, G, int(n_surv), int(bool(pareto)),
        ranks.data_ptr(), weighted.data_ptr(), perm.data_ptr(), _stream())
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
    ``csrc/fleet_failover.cu``. ``rb``/``off``/``pref`` are each cluster's
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
    if any(t.dtype != torch.bool for t in (off, broker_valid, broker_alive,
                                           dead, add, pvalid)):
        raise TypeError("fleet_scenario_failover takes bool masks")
    rb = rb.to(torch.int32).contiguous()
    pref = pref.to(torch.int32).contiguous()
    off, broker_valid, broker_alive, dead, add, pvalid = (
        t.contiguous() for t in (off, broker_valid, broker_alive, dead, add,
                                 pvalid))
    dev = rb.device
    rb_out = torch.empty((C, S, P, R), dtype=torch.int32, device=dev)
    pref_out = torch.empty((C, S, P, R), dtype=torch.int32, device=dev)
    off_out = torch.empty((C, S, P, R), dtype=torch.bool, device=dev)
    has_alive = torch.empty((C, S, P), dtype=torch.bool, device=dev)
    rc = load_library().cc_fleet_scenario_failover(
        rb.data_ptr(), off.data_ptr(), pref.data_ptr(),
        broker_valid.data_ptr(), broker_alive.data_ptr(), dead.data_ptr(),
        add.data_ptr(), pvalid.data_ptr(), rb_out.data_ptr(),
        pref_out.data_ptr(), off_out.data_ptr(), has_alive.data_ptr(),
        C, S, P, R, B, _stream())
    LAUNCHES["fleet_scenario_failover"] += 1
    _check(rc, "fleet_scenario_failover")
    return rb_out, pref_out, off_out, has_alive
