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

An apply round on the card computes its guards in KQ (below); KC and KK
remain the goals' ``collective_guard`` sums where those are called, as in
KQ's twin.

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

One more carries the goal loops:

- **KL** ``goal_loop`` — one step of a goal pass's loop control (its
  counters and the next loop test, written into a CUDA graph conditional
  handle), the node that closes each loop of a pass's graph
  (``analyzer/graph_loop.py``); ``csrc/goal_loop.cu`` also holds the
  functions that build those graphs.

Fourteen more carry a goal pass's own rounds and proposals (each in a
few launches where plain torch took dozens):

- **KM** ``apply_group`` — one partition-disjoint group of candidates
  applied out of place or into the caller's buffers: the slot writes, the
  float aggregates in KB's order (the rows bucketed by broker, then a
  warp a broker), the integer counts and topic tables;
- **KN** ``candidate_eligibility`` — base legality, the acceptance of
  every earlier goal of the chain (a table of rows, one kind a goal form,
  :class:`GoalChecks`), the pass goal's delta and the verdict, a thread a
  candidate, the broker planes the table reads staged in each block's
  shared memory (the topic rows' bounds a launch of their own ahead);
- **KO** ``flow_priority`` / ``flow_match`` — an interval goal's flow
  candidates around the top-k: the [P, R] priorities with their noise
  (a map over the card, ``_unit01``'s range read from the context's
  table, which ``replica_weight_range`` builds once a context), then the
  destination match (one block, from shared memory);
- **KP** ``bulk_drain_fill`` — a replica drain round after its sort: the
  segmented shed, the first slot a partition, the capped budgets and the
  deficit-first fill (seven launches over the whole card);
- **KZ** ``drain_order`` — a replica drain round up to KP: the shed quota
  (one block, KY's planes), every slot's weight, candidacy and noise, and
  the slots' stable order by (broker, must-move first, weight descending
  with noise): a segmented sort, each broker's run sorted in shared memory
  (a run past 4,096 slots in chunks, then merged);
- **KAA** ``leadership_drain`` — a leadership drain round whole: the quota
  and intake budgets, each partition's best follower, the two quota passes
  (KZ's segmented sort, KP's cumulative weights) with the capacity cap
  between them, and the batch's slots for KT;
- **KQ** ``round_guards`` — the body of an apply round between KN and KM:
  the blocked and prefix masks, every chain goal's collective guard (a
  table of rows, one kind a guard form, :class:`GuardTable`; the flows
  summed once a distinct metric, the bounds the ones KN left at the same
  state) and the round's ``do``, ``pending`` and continuation flag, a
  warp a candidate (one launch after a memset). The goals' guards on the
  CPU, its twin, still run through KC and KK;
- **KR** ``replica_priority`` — a candidate generator's noised [P, R]
  source priorities, one row kind a goal's form (:data:`PRIORITY_KINDS`):
  the grid's and the leadership transfers' transforms over each goal's
  base, an interval goal's two swap planes, the topic goal's planes (a map
  over the card; the topic kind's bounds and ranges two launches ahead);
- **KS** ``dest_select`` — the generators' destinations: the grid's
  short-list (one block), TopicReplicaDistribution's per-candidate
  destination and its swap's light partner (a warp a candidate);
- **KT** ``assemble_candidates`` — a proposal's candidates from its parts
  (:class:`Part`: flow moves, the grid's cross, swaps with their random
  roll, leadership transfers), every field of every part in one launch;
- **KU** ``top_k`` — ``lax.top_k`` over the generators' priority planes
  (several rows a launch): a radix select of unique 64-bit keys in each
  block's shared memory over a chunk of a row, the row's last block
  selecting from the chunks' keys and sorting the K kept;
- **KV** ``steer_dest`` — a pass's steered destinations: every earlier
  goal's receptive test (a table of rows, :class:`SteerTable`) and the
  fallback, one block;
- **KW** ``proposal_select`` — a proposal's score, its top M (KU's
  select), the winners' fields, ``pending``, the loop flag and the
  [M, M] partition conflicts, into the goal loop's carry (two launches).

Each wrapper takes the plain twin for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises: there is no fallback. Each launch
adds one to ``LAUNCHES[name]``; a kernel replayed inside a goal pass's
CUDA graph is added when the graph's counters are read (the fused chain's
packed read, ``graph_loop.settle`` and :func:`reset_launch_counts`).

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
import sys
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
           "launch_floor.cu", "goal_loop.cu", "apply_group.cu",
           "eligibility.cu", "flow_candidates.cu", "drain_fill.cu",
           "round_guards.cu", "replica_priority.cu", "dest_select.cu",
           "candidates.cu", "top_k.cu", "steer.cu", "proposal_select.cu",
           "violation.cu", "drain_order.cu", "leadership_drain.cu")
#: headers the sources include (hashed with them)
HEADERS = ("threefry.cuh", "ordered.cuh", "select.cuh", "bounds.cuh",
           "drain.cuh")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of single sources: the goal-pass kernels round every float32
#: product and sum on its own, as the reference's program does, and
#: contract only where they write ``__fmaf_rn`` themselves
SOURCE_FLAGS = {name: ("-fmad=false",) for name in (
    "apply_group.cu", "eligibility.cu", "flow_candidates.cu",
    "drain_fill.cu", "round_guards.cu", "replica_priority.cu",
    "dest_select.cu", "candidates.cu", "top_k.cu", "steer.cu",
    "proposal_select.cu", "violation.cu", "drain_order.cu",
    "leadership_drain.cu")}

#: launches per kernel since the last ``reset_launch_counts()``
LAUNCHES = {"threefry2x32": 0, "ordered_segment_sum": 0,
            "net_broker_flow": 0, "cell_net_flow": 0,
            "scenario_failover": 0, "first_fit": 0,
            "delta_row_scatter": 0, "cluster_stats": 0,
            "intra_broker_walk": 0, "population_select": 0,
            "fleet_scenario_failover": 0, "goal_loop": 0,
            "apply_group": 0, "candidate_eligibility": 0,
            "replica_weight_range": 0, "flow_priority": 0, "flow_match": 0,
            "bulk_drain_fill": 0, "round_guards": 0,
            "replica_priority": 0, "dest_select": 0,
            "assemble_candidates": 0, "top_k": 0, "steer_dest": 0,
            "proposal_select": 0, "violation_rows": 0,
            "interval_planes": 0, "drain_order": 0, "leadership_drain": 0}
#: ``nvcc``/ptxas output of the build this process loaded (register and
#: spill counts per kernel), empty when the library came from the cache
BUILD_LOG: list[str] = []

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES``, after crediting (and so dropping) the kernels the
    goal-loop graphs replayed since they were last counted."""
    graph_loop = sys.modules.get(f"{__package__}.analyzer.graph_loop")
    if graph_loop is not None:
        graph_loop.settle()
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
        h.update(" ".join(SOURCE_FLAGS.get(name, ())).encode())
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
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
                 str(CSRC / name), "-o", str(obj)],
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
            lib.cc_dependent_add.argtypes = [p, i64, ctypes.c_int, p, p]
            lib.cc_intra_broker_walk.argtypes = [p, p, p, p, p, p, p, p, p,
                                                 i64, i64, i64, i64, p, p, p]
            lib.cc_intra_broker_walk_shared.argtypes = [i64, i64]
            lib.cc_intra_broker_walk_shared.restype = i64
            f32 = ctypes.c_float
            lib.cc_population_select.argtypes = [p, p, p, p, f32, f32,
                                                 *[i64] * 14, p, p, p, p]
            lib.cc_population_select_single.argtypes = [i64, i64]
            lib.cc_population_select_single.restype = i64
            lib.cc_goal_loop_step.argtypes = [p, ctypes.c_int, i64, i64, p]
            lib.cc_graph_create.argtypes = [ctypes.POINTER(p)]
            lib.cc_graph_destroy.argtypes = [p]
            lib.cc_graph_check_body.argtypes = [p, ctypes.c_char_p,
                                                ctypes.c_int]
            lib.cc_graph_add_child.argtypes = [p, p, p, ctypes.POINTER(p)]
            lib.cc_graph_add_loop.argtypes = [p, p, p, ctypes.c_int, i64, i64,
                                              ctypes.c_uint64, ctypes.c_int,
                                              ctypes.POINTER(p)]
            lib.cc_graph_handle.argtypes = [p, ctypes.POINTER(ctypes.c_uint64)]
            lib.cc_graph_add_cond.argtypes = [p, p, ctypes.c_int,
                                              ctypes.c_uint64,
                                              ctypes.POINTER(p),
                                              ctypes.POINTER(p)]
            lib.cc_graph_instantiate.argtypes = [p, ctypes.POINTER(p)]
            lib.cc_graph_upload.argtypes = [p, p]
            lib.cc_graph_launch.argtypes = [p, p]
            lib.cc_graph_exec_destroy.argtypes = [p]
            lib.cc_cuda_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
            lib.cc_apply_group.argtypes = [p, p]
            lib.cc_apply_runs_size.argtypes = [i64, i64]
            lib.cc_apply_runs_size.restype = i64
            lib.cc_candidate_eligibility.argtypes = [p, p, ctypes.c_int32,
                                                     ctypes.c_float, p]
            lib.cc_eligibility_scratch.argtypes = [i64]
            lib.cc_eligibility_scratch.restype = i64
            lib.cc_eligibility_staged.argtypes = [p, ctypes.c_int32, i64]
            lib.cc_eligibility_staged.restype = ctypes.c_int
            lib.cc_weight_range.argtypes = [p, p]
            lib.cc_weight_range_scratch.argtypes = [i64]
            lib.cc_weight_range_scratch.restype = i64
            lib.cc_flow_priority.argtypes = [p, _DrawPath, p]
            lib.cc_flow_match.argtypes = [p, _DrawPath, p]
            lib.cc_flow_match_workspace.argtypes = [i64, i64, i64]
            lib.cc_flow_match_workspace.restype = i64
            lib.cc_drain_fill.argtypes = [p, p]
            lib.cc_drain_fill_scratch.argtypes = [i64, i64]
            lib.cc_drain_fill_scratch.restype = i64
            lib.cc_round_guards.argtypes = [p, p]
            lib.cc_replica_priority.argtypes = [p, p]
            lib.cc_dest_select.argtypes = [p, p]
            lib.cc_assemble_candidates.argtypes = [p, p]
            lib.cc_top_k.argtypes = [p, p]
            lib.cc_top_k_chunk.argtypes = [i64, i64]
            lib.cc_top_k_chunk.restype = i64
            lib.cc_steer_dest.argtypes = [p, p]
            lib.cc_steer_scratch.argtypes = [i64, i64]
            lib.cc_steer_scratch.restype = i64
            lib.cc_proposal_select.argtypes = [p, p]
            lib.cc_violation_rows.argtypes = [p, p]
            lib.cc_interval_planes.argtypes = [p, p]
            lib.cc_drain_order.argtypes = [p, _DrawPath, p]
            lib.cc_drain_order_scratch.argtypes = [i64]
            lib.cc_drain_order_scratch.restype = i64
            lib.cc_leadership_drain.argtypes = [p, _DrawPath, p]
            lib.cc_leadership_drain_scratch.argtypes = [i64, i64]
            lib.cc_leadership_drain_scratch.restype = i64
            for fn in (lib.cc_goal_loop_step,
                       lib.cc_graph_create, lib.cc_graph_destroy,
                       lib.cc_graph_check_body, lib.cc_graph_add_child,
                       lib.cc_graph_add_loop, lib.cc_graph_handle,
                       lib.cc_graph_add_cond,
                       lib.cc_graph_instantiate, lib.cc_graph_upload,
                       lib.cc_graph_launch, lib.cc_graph_exec_destroy,
                       lib.cc_cuda_versions):
                fn.restype = ctypes.c_int
            for fn in (lib.cc_threefry_draw, lib.cc_ordered_segment_sum,
                       lib.cc_ordered_range_sum,
                       lib.cc_net_broker_flow, lib.cc_cell_net_flow,
                       lib.cc_failover,
                       lib.cc_first_fit, lib.cc_delta_row_scatter,
                       lib.cc_cluster_stats, lib.cc_intra_broker_walk,
                       lib.cc_population_select, lib.cc_empty_kernel,
                       lib.cc_dependent_add,
                       lib.cc_apply_group, lib.cc_candidate_eligibility,
                       lib.cc_weight_range, lib.cc_flow_priority,
                       lib.cc_flow_match,
                       lib.cc_drain_fill, lib.cc_round_guards,
                       lib.cc_replica_priority, lib.cc_dest_select,
                       lib.cc_assemble_candidates, lib.cc_top_k,
                       lib.cc_steer_dest, lib.cc_proposal_select,
                       lib.cc_violation_rows, lib.cc_interval_planes,
                       lib.cc_drain_order, lib.cc_leadership_drain):
                fn.restype = ctypes.c_int
            _LIB = lib
            default_collector().record_library(kind,
                                               time.perf_counter() - t0)
        return _LIB


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _pass_library():
    """The kernel library, KM-KAA's argument structs checked once against
    the C structs they mirror (their sizes, from the library)."""
    lib = load_library()
    if not getattr(lib, "_cc_structs_checked", False):
        for fn, struct in (("cc_apply_args_size", _ApplyArgs),
                           ("cc_elig_args_size", _EligArgs),
                           ("cc_goal_row_size", _GoalRow),
                           ("cc_range_args_size", _RangeArgs),
                           ("cc_priority_args_size", _PriorityArgs),
                           ("cc_match_args_size", _MatchArgs),
                           ("cc_drain_args_size", _DrainArgs),
                           ("cc_guard_args_size", _GuardArgs),
                           ("cc_guard_row_size", _GuardRow),
                           ("cc_prio_args_size", _PrioArgs),
                           ("cc_dest_args_size", _DestArgs),
                           ("cc_cand_args_size", _CandArgs),
                           ("cc_top_k_args_size", _TopKArgs),
                           ("cc_steer_args_size", _SteerArgs),
                           ("cc_steer_row_size", _SteerRow),
                           ("cc_select_args_size", _SelectArgs),
                           ("cc_viol_args_size", _ViolArgs),
                           ("cc_viol_row_size", _ViolRow),
                           ("cc_planes_args_size", _PlanesArgs),
                           ("cc_order_args_size", _OrderArgs),
                           ("cc_lead_args_size", _LeadArgs)):
            size = getattr(lib, fn)
            size.argtypes, size.restype = [], ctypes.c_int64
            if size() != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} is {ctypes.sizeof(struct)} bytes "
                    f"here and {size()} in the kernel library")
        lib._cc_structs_checked = True
    return lib


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


#: the dependent-add probe's forms (``csrc/launch_floor.cu``)
DEPENDENT_ADD_FORMS = {"registers": 0, "loads": 1}


def dependent_add_launch(x: torch.Tensor, n: int, form: str,
                         out: torch.Tensor) -> None:
    """Launch the dependent-add probe on the current stream: ``n`` float32
    adds, each on the one before (``form``: of ``x[0]`` from a register,
    or one load of ``x[i]`` a step), the sum into ``out[0]``. A chain's
    floor on the card, timed beside the kernels; counted nowhere."""
    if x.dtype != torch.float32 or out.dtype != torch.float32 or (
            x.numel() < (n if form == "loads" else 1)):
        raise ValueError("dependent_add takes float32 x of n (loads) or 1 "
                         "value and a float32 out")
    _check(load_library().cc_dependent_add(
        x.data_ptr(), n, DEPENDENT_ADD_FORMS[form], out.data_ptr(),
        _stream()), "dependent_add")


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


def _draw_path(words):
    """(the ``_DrawPath`` of ``words``, the int64 scalars it points at,
    which must stay alive while the launch reads them)."""
    if len(words) > MAX_PATH:
        raise ValueError(f"a draw folds in at most {MAX_PATH} words, "
                         f"got {len(words)}")
    path = _DrawPath(n=len(words))
    keep = []
    for j, w in enumerate(words):
        if isinstance(w, torch.Tensor):
            w = w.reshape(1).to(torch.int64)
            keep.append(w)
            path.ptrs[j] = w.data_ptr()
        else:
            path.words[j] = int(w) & _M32
    return path, keep


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
    path, keep = _draw_path(words)
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


# ---------------------------------------------------------------------------
# KL: goal-loop control (the loop tests of a goal pass, on the device)
# ---------------------------------------------------------------------------

#: a goal pass's int64 loop counters (``csrc/goal_loop.cu:Slot``)
GOAL_LOOP_SLOTS = ("flag", "it", "stalls", "round", "rounds", "applied",
                   "exec_active", "exec_drain", "exec_fine", "exec_round",
                   "exec_loop", "cond")
#: KL's steps (``csrc/goal_loop.cu:Op``)
GOAL_LOOP_OPS = {"active": 0, "drain_enter": 1, "drain_step": 2,
                 "fine_enter": 3, "rounds_enter": 4, "rounds_step": 5,
                 "fine_step": 6}


def goal_loop_step_plain(ctr: torch.Tensor, op: str, a: int = 0,
                         b: int = 0) -> torch.Tensor:
    """Twin of KL: one step ``op`` of a goal pass's loop control over the
    counters ``ctr`` (int64[len(GOAL_LOOP_SLOTS)], updated in place) with
    the limits ``a`` and ``b``; returns the loop test (also stored in the
    ``cond`` slot), a bool scalar on ``ctr``'s device. It reads nothing back
    to the host and copies nothing to the device, so it captures into a
    CUDA graph as it stands."""
    s = {name: i for i, name in enumerate(GOAL_LOOP_SLOTS)}
    c = ctr

    def get(name):
        return c[s[name]]

    def put(name, v):
        c[s[name]] = v

    if op == "active":
        for name in ("it", "stalls", "round", "rounds", "applied"):
            put(name, 0)
        cond = get("flag") != 0
        put("exec_active", get("exec_active") + cond.long())
    elif op == "drain_enter":
        put("round", 0)
        cond = torch.full((), a > 0, dtype=torch.bool, device=c.device)
    elif op == "drain_step":
        put("exec_drain", get("exec_drain") + 1)
        put("round", get("round") + 1)
        cond = (get("round") < a) & (get("flag") >= b)
    elif op == "fine_enter":
        put("it", 0)
        put("stalls", 0)
        cond = torch.full((), a > 0 and b > 0, dtype=torch.bool,
                          device=c.device)
    elif op == "rounds_enter":
        put("exec_fine", get("exec_fine") + 1)
        put("rounds", 0)
        put("applied", 0)
        cond = (get("flag") != 0) & (a > 0)
    elif op == "rounds_step":
        put("exec_round", get("exec_round") + 1)
        put("rounds", get("rounds") + 1)
        cond = (get("rounds") < a) & (get("flag") != 0)
    elif op == "fine_step":
        put("stalls", torch.where(get("applied") == 0, get("stalls") + 1, 0))
        put("it", get("it") + 1)
        cond = (get("stalls") < a) & (get("it") < b)
    else:
        raise ValueError(f"unknown goal-loop step {op!r}")
    put("exec_loop", get("exec_loop") + 1)
    put("cond", cond.long())
    return cond.clone()


def goal_loop_step(ctr: torch.Tensor, op: str, a: int = 0,
                   b: int = 0) -> torch.Tensor:
    """One eager step of KL (``csrc/goal_loop.cu``) over a pass's counters
    (int64[len(GOAL_LOOP_SLOTS)], updated in place); returns the loop test
    as a bool scalar on ``ctr``'s device. Inside a goal pass's graph the
    same kernel runs as a node that also sets the conditional handle
    (``analyzer/graph_loop.py``); this form holds it to its twin."""
    if ctr.shape != (len(GOAL_LOOP_SLOTS),) or ctr.dtype != torch.int64:
        raise ValueError(f"goal-loop counters must be int64"
                         f"[{len(GOAL_LOOP_SLOTS)}]")
    if op not in GOAL_LOOP_OPS:
        raise ValueError(f"unknown goal-loop step {op!r}")
    if _on_cpu(ctr):
        return goal_loop_step_plain(ctr, op, a, b)
    if not ctr.is_contiguous():
        raise ValueError("goal-loop counters must be contiguous")
    rc = load_library().cc_goal_loop_step(ctr.data_ptr(), GOAL_LOOP_OPS[op],
                                          int(a), int(b), _stream())
    LAUNCHES["goal_loop"] += 1
    _check(rc, "goal_loop")
    return ctr[GOAL_LOOP_SLOTS.index("cond")] != 0


# ---------------------------------------------------------------------------
# Argument structs of the goal-pass kernels (KM-KP): every pointer a
# c_void_p, passed to the C entry by address
# ---------------------------------------------------------------------------

def _struct(name: str, *parts):
    """A ctypes Structure of the fields ``parts`` in order: a string names
    pointer fields (split on whitespace), a list holds (name, ctype)
    fields."""
    fields = []
    for part in parts:
        fields += ([(f, ctypes.c_void_p) for f in part.split()]
                   if isinstance(part, str) else list(part))
    return type(name, (ctypes.Structure,), {"_fields_": fields})


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied where its data is not 16-byte aligned
    (the kernels read its rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fill(args, **tensors):
    """Set the pointer fields of ``args`` from ``tensors`` (None: null)."""
    for name, t in tensors.items():
        setattr(args, name, _ptr(t))
    return args


_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_I32 = ctypes.c_int32


# ---------------------------------------------------------------------------
# KM: apply one partition-disjoint group of candidates
# ---------------------------------------------------------------------------

_ApplyArgs = _struct(
    "_ApplyArgs",
    "rb pos off util pot lni cnt lead tc tlc moves topic p r p2 r2 src dst "
    "kind d_util_src d_util_dst d_cnt d_lead d_pot d_lni do_ rb_out pos_out "
    "off_out util_out pot_out lni_out cnt_out lead_out tc_out tlc_out "
    "moves_out count_out runs terms",
    [(f, _I64) for f in ("P", "R", "B1", "T", "N")])


#: KM's outputs: the kernel argument of each state field it writes (the
#: others pass through unchanged)
_APPLY_OUTS = dict(rb_out="rb", pos_out="pos", off_out="offline",
                   util_out="util", pot_out="potential_nw_out",
                   lni_out="leader_nw_in", cnt_out="replica_count",
                   lead_out="leader_count", tc_out="topic_counts",
                   tlc_out="topic_leader_counts",
                   moves_out="moves_applied")


def _write_into(out, new):
    """``out`` with ``new``'s values of KM's fields copied into its
    buffers (the twin's in-place form)."""
    for name in _APPLY_OUTS.values():
        dst, src = getattr(out, name), getattr(new, name)
        if (dst is None) != (src is None):
            raise ValueError(f"apply_group: out.{name} does not match the "
                             f"state's")
        if dst is not None:
            dst.copy_(src)
    return out


def apply_group_plain(state, ctx, c, do, out=None):
    """Twin of KM: ``state.py:apply_group`` in plain torch, and the count
    of ``do``. With ``out`` (a state of buffers shaped like ``state``'s,
    which may be ``state`` itself) the result is written into ``out``'s
    buffers and ``out`` is returned.

    Precondition (the engine's grouping): among candidates with
    ``do=True`` all partition rows (``p`` and swap counterpart ``p2``) are
    distinct. Slot writes of candidates with ``do=False`` go to a discard
    row ``P`` (sliced off), so they can never clobber a real update. Broker
    aggregates take every candidate's delta (zero when not applied) in
    candidate order — all source rows, then all destination rows — through
    the ordered segment sum, exactly the reference's two scatter-adds.
    """
    from .core.resources import NUM_RESOURCES
    from .model.flat import MOVE_INTER_BROKER, MOVE_LEADERSHIP, MOVE_SWAP
    p, r = c.p, c.r
    is_move = (c.kind == MOVE_INTER_BROKER) & do
    is_lead = (c.kind == MOVE_LEADERSHIP) & do
    is_swap = (c.kind == MOVE_SWAP) & do
    mv = is_move | is_swap

    rb, pos, off = state.rb, state.pos, state.offline
    P, R = rb.shape
    pw = torch.where(do, p, P)
    cur_slot = rb[p, r]
    cur0 = rb[p, 0]
    new_slot = torch.where(mv, c.dst, cur0)
    new0 = torch.where(is_lead, cur_slot,
                       torch.where(mv & (r == 0), c.dst, cur0))
    rbx = torch.cat([rb, rb.new_zeros((1, R))])
    rbx[pw, r] = new_slot
    rbx[pw, 0] = new0
    p2w = torch.where(is_swap, c.p2, P)
    rbx[p2w, c.r2] = c.src

    pos_r, pos_0 = pos[p, r], pos[p, 0]
    posx = torch.cat([pos, pos.new_zeros((1, R))])
    posx[pw, r] = torch.where(is_lead, pos_0, pos_r)
    posx[pw, 0] = torch.where(is_lead, pos_r, pos_0)

    off_r, off_0 = off[p, r], off[p, 0]
    new_off_r = ~mv & torch.where(is_lead, off_0, off_r)
    new_off_0 = torch.where(is_lead, off_r, ~(mv & (r == 0)) & off_0)
    offx = torch.cat([off, off.new_zeros((1, R))])
    offx[pw, r] = new_off_r
    offx[pw, 0] = new_off_0
    offx[p2w, c.r2] = torch.zeros((), dtype=torch.bool, device=off.device)

    # Float aggregates: util (4 planes), potential NW_OUT and leader NW_IN
    # ride one ordered segment sum — every source row first, then every
    # destination row, each in candidate order (zero deltas for candidates
    # that do not apply, like the reference's masked scatter-adds).
    dof = do[:, None]
    dpot = torch.where(mv, c.d_pot, 0.0)
    dlni = torch.where(do, c.d_lni, 0.0)
    src_planes = torch.cat([torch.where(dof, c.d_util_src, 0.0),
                            -dpot[:, None], -dlni[:, None]], dim=1)
    dst_planes = torch.cat([torch.where(dof, c.d_util_dst, 0.0),
                            dpot[:, None], dlni[:, None]], dim=1)
    base = torch.cat([state.util, state.potential_nw_out[:, None],
                      state.leader_nw_in[:, None]], dim=1)
    B1 = base.shape[0]
    agg = ordered_segment_sum(torch.cat([src_planes, dst_planes]),
                              torch.cat([c.src, c.dst]), B1, base=base)
    util = agg[:, :NUM_RESOURCES]
    potential = agg[:, NUM_RESOURCES]
    lni = agg[:, NUM_RESOURCES + 1]

    def int_delta(agg_int, d):
        return (agg_int.index_add(0, c.src, -d)
                .index_add(0, c.dst, d))

    counts = int_delta(state.replica_count,
                       torch.where(is_move, c.d_cnt, 0))
    leaders = int_delta(state.leader_count, torch.where(do, c.d_lead, 0))

    def topic_delta(agg_tb, moves):
        """Signed adds into a [T, B1] table through its flat index; rows of
        padding partitions (topic -1) go to a discard cell, sliced off."""
        T = agg_tb.shape[0]
        flat = torch.cat([agg_tb.reshape(-1), agg_tb.new_zeros(1)])
        for topic, broker, d in moves:
            ok = (topic >= 0) & (topic < T)
            flat = flat.index_add(0, torch.where(ok, topic * B1 + broker,
                                                 T * B1), d)
        return flat[:-1].reshape(agg_tb.shape)

    t1 = ctx.partition_topic[p].long()
    t2 = ctx.partition_topic[c.p2].long()
    topic_counts = state.topic_counts
    if topic_counts is not None:
        tc = torch.where(mv, 1, 0).to(torch.int32)
        tc2 = torch.where(is_swap, 1, 0).to(torch.int32)
        # the swap counterpart's topic travels the other way
        topic_counts = topic_delta(topic_counts, (
            (t1, c.src, -tc), (t1, c.dst, tc),
            (t2, c.dst, -tc2), (t2, c.src, tc2)))

    topic_leader_counts = state.topic_leader_counts
    if topic_leader_counts is not None:
        # Leadership of p lands on dst for transfers and leader-replica
        # (r == 0) moves/swaps; a swap counterpart with r2 == 0 hauls p2's
        # leadership to src.
        d1 = torch.where(is_lead | (mv & (r == 0)), 1, 0).to(torch.int32)
        d2 = torch.where(is_swap & (c.r2 == 0), 1, 0).to(torch.int32)
        topic_leader_counts = topic_delta(topic_leader_counts, (
            (t1, c.src, -d1), (t1, c.dst, d1),
            (t2, c.dst, -d2), (t2, c.src, d2)))

    count = do.sum()
    new = state.replace(rb=rbx[:P], pos=posx[:P], offline=offx[:P],
                        util=util, replica_count=counts,
                        leader_count=leaders,
                        potential_nw_out=potential, leader_nw_in=lni,
                        topic_counts=topic_counts,
                        topic_leader_counts=topic_leader_counts,
                        moves_applied=state.moves_applied + count)
    return (new if out is None else _write_into(out, new)), count


def apply_group(state, ctx, c, do, out=None):
    """(state, int64 count of ``do``): ``state`` (an ``analyzer/state.py``
    SearchState, unbatched) after the partition-disjoint group of
    candidates ``c`` where ``do`` (bool[N]) is set — see
    ``csrc/apply_group.cu`` (two launches). Out of place by default (the
    caller's state is not written); with ``out`` (a state of contiguous
    buffers of ``state``'s shapes and the kernel's dtypes, possibly
    ``state`` itself) KM writes into ``out``'s buffers and returns
    ``out``: a plane that is its input is updated in place, any other is
    copied first."""
    P, R = state.rb.shape
    N = do.shape[0]
    if c.p.shape != (N,) or c.d_util_src.shape != (N, 4):
        raise ValueError("apply_group takes N candidates and do [N]")
    if _on_cpu(state.rb, do, c.p):
        return apply_group_plain(state, ctx, c, do, out=out)
    if do.dtype != torch.bool or state.offline.dtype != torch.bool:
        raise TypeError("apply_group takes bool do and offline masks")
    B1 = state.util.shape[0]
    tc, tlc = state.topic_counts, state.topic_leader_counts
    T = tc.shape[0] if tc is not None else (
        tlc.shape[0] if tlc is not None else 0)
    lib = _pass_library()
    runs = lib.cc_apply_runs_size(N, B1)
    if N < 1 or runs < 0:
        raise ValueError(f"apply_group takes at least one candidate, and a "
                         f"broker id and a row of a tile in one 32-bit key "
                         f"(any B1 below 2^20), got N {N}, B1 {B1}")

    def as_(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    ins = dict(
        rb=as_(state.rb, i64), pos=as_(state.pos, i64),
        off=state.offline.contiguous(), util=as_(state.util, f32),
        pot=as_(state.potential_nw_out, f32), lni=as_(state.leader_nw_in, f32),
        cnt=as_(state.replica_count, i32), lead=as_(state.leader_count, i32),
        tc=as_(tc, i32), tlc=as_(tlc, i32),
        moves=as_(state.moves_applied, i64),
        topic=as_(ctx.partition_topic, i32),
        p=as_(c.p, i64), r=as_(c.r, i64), p2=as_(c.p2, i64),
        r2=as_(c.r2, i64), src=as_(c.src, i64), dst=as_(c.dst, i64),
        kind=as_(c.kind, i64), d_util_src=as_(c.d_util_src, f32),
        d_util_dst=as_(c.d_util_dst, f32), d_cnt=as_(c.d_cnt, i32),
        d_lead=as_(c.d_lead, i32), d_pot=as_(c.d_pot, f32),
        d_lni=as_(c.d_lni, f32), do_=do.contiguous())
    dev = state.rb.device
    if out is None:
        outs = dict(
            rb_out=torch.empty_like(ins["rb"]),
            pos_out=torch.empty_like(ins["pos"]),
            off_out=torch.empty_like(ins["off"]),
            util_out=torch.empty((B1, 4), dtype=f32, device=dev),
            pot_out=torch.empty(B1, dtype=f32, device=dev),
            lni_out=torch.empty(B1, dtype=f32, device=dev),
            cnt_out=torch.empty(B1, dtype=i32, device=dev),
            lead_out=torch.empty(B1, dtype=i32, device=dev),
            tc_out=None if tc is None else torch.empty_like(ins["tc"]),
            tlc_out=None if tlc is None else torch.empty_like(ins["tlc"]),
            moves_out=torch.empty((), dtype=i64, device=dev))
    else:
        outs = {k: getattr(out, f) for k, f in _APPLY_OUTS.items()}
        for k, t in outs.items():
            want = ins[k[:-4]]                  # rb_out -> rb, ...
            if (t is None) != (want is None) or (t is not None and (
                    t.dtype != want.dtype or t.shape != want.shape
                    or t.device != dev or not t.is_contiguous())):
                raise ValueError(f"apply_group: out.{_APPLY_OUTS[k]} must "
                                 f"be a contiguous buffer of the state's "
                                 f"shape and the kernel's dtype")
    count = torch.empty((), dtype=i64, device=dev)
    scratch = dict(runs=torch.empty(runs, dtype=i32, device=dev),
                   terms=torch.empty((2 * N, 8), dtype=f32, device=dev))
    args = _fill(_ApplyArgs(P=P, R=R, B1=B1, T=T, N=N), **ins, **outs,
                 count_out=count, **scratch)
    rc = lib.cc_apply_group(ctypes.byref(args), _stream())
    LAUNCHES["apply_group"] += 1
    _check(rc, "apply_group")
    if out is not None:
        return out, count
    return state.replace(**{_APPLY_OUTS[k]: t for k, t in outs.items()}), \
        count


# ---------------------------------------------------------------------------
# KN: a goal pass's candidate eligibility
# ---------------------------------------------------------------------------

#: goal rows one launch of KN holds (``csrc/eligibility.cu:kMaxGoals``); a
#: longer chain position is read in chunks of this many rows
MAX_GOAL_ROWS = 48
#: topic rows of distinct gap constants one chain position may hold
#: (``csrc/eligibility.cu:kMaxTopicSlots``)
MAX_TOPIC_SLOTS = 8
#: KN's row kinds, by their code (``csrc/eligibility.cu:Kind``): the
#: interval family's two acceptance forms, then one a goal outside it
ROW_KINDS = ("interval", "hard_cap", "rack_aware", "rack_spread",
             "topic_replica", "topic_leaders", "broker_set",
             "preferred_leader", "nothing")
#: kinds that accept every candidate: no row as an earlier goal
_ACCEPTS_ALL = ("preferred_leader", "nothing")

_GoalRow = _struct("_GoalRow", [(f, _I32) for f in (
    "kind", "metric", "form", "upper_only", "integer", "cap_col", "param")]
    + [("t", _F32), ("lower", _F32), ("hi", _F32)], "aux")
_EligArgs = _struct(
    "_EligArgs",
    "rb off util cnt lead pot lni movable dest lead_dest lead_movable bvalid "
    "balive cap p r p2 r2 src dst kind valid must d_util_src d_util_dst "
    "d_cnt d_lead d_pot d_lni pos rack bset ptopic tc tlc tbounds elig delta "
    "bounds",
    [(f, _I64) for f in ("P", "R", "B1", "N", "T")])


class GoalChecks:
    """What a chain position checks a candidate against: the pass goal
    (its delta) and the earlier goals (their acceptance), with
    ``epsilon``. Every goal of the catalog has a row of KN's table
    (``eligibility_row``), built once here: rows[0] the pass goal's, then
    one an earlier goal's, but for earlier goals that accept every
    candidate. ``outside`` lists the goals with no row (a goal kind KN does
    not know), which KN refuses; the twin takes any goal."""

    def __init__(self, goal, prev_goals, epsilon: float):
        self.goal = goal
        self.prev_goals = list(prev_goals)
        self.epsilon = float(epsilon)
        #: goals with no row of KN's table
        self.outside = []
        #: each goal's row in the table ([goal, *prev_goals] order; -1:
        #: none)
        self.row_index = []
        rows = []
        for k, g in enumerate([goal, *self.prev_goals]):
            row = g.eligibility_row()
            if row is None:
                self.outside.append(g)
            elif k == 0 or row["kind"] not in _ACCEPTS_ALL:
                self.row_index.append(len(rows))
                rows.append(row)
                continue
            self.row_index.append(-1)
        #: the topic rows' distinct (threshold - 1, min gap, max gap): the
        #: slots of the launch's topic bounds
        self.topic_gaps = []
        self.n = len(rows)
        self.rows = (_GoalRow * max(self.n, 1))()
        #: (row index, the goal's bound array) of the rows that read one
        self._aux = []
        for k, row in enumerate(rows):
            row = dict(row)
            row["kind"] = ROW_KINDS.index(row["kind"])
            if row["kind"] == ROW_KINDS.index("topic_replica"):
                gaps = tuple(float(_F32(row[f]).value)
                             for f in ("t", "lower", "hi"))
                if gaps not in self.topic_gaps:
                    self.topic_gaps.append(gaps)
                row["param"] = self.topic_gaps.index(gaps)
            aux = row.pop("aux", None)
            if aux is not None:
                self._aux.append((k, aux))
            self.rows[k] = _GoalRow(**row)
        self._on = {}

    def rows_on(self, device):
        """The rows with each bound array's pointer on ``device`` (a copy
        of ``rows`` a device, the arrays uploaded once), and the arrays'
        lengths by row."""
        got = self._on.get(device)
        if got is None:
            rows = (_GoalRow * max(self.n, 1))()
            ctypes.memmove(rows, self.rows, ctypes.sizeof(self.rows))
            lengths = {}
            for k, aux in self._aux:
                t = aux.on(device)
                rows[k].aux = t.data_ptr()
                lengths[k] = t.shape[0]
            got = self._on[device] = (rows, lengths)
        return got

    def round_bounds(self, state):
        """Buffers for KN to leave its bounds in, on the card, for KQ
        (:func:`round_guards`) to read in the same apply round: (f32[n, 2]
        each average row's (lower, upper), f32[slots, 2, T] the topic
        rows' bounds or None); None on the CPU, where the twins compute
        their own."""
        if state.rb.device.type != "cuda":
            return None
        dev = state.rb.device
        rows = torch.empty((max(self.n, 1), 2), dtype=torch.float32,
                           device=dev)
        topics = None
        if self.topic_gaps:
            topics = torch.empty((len(self.topic_gaps), 2, _topic_rows(state)),
                                 dtype=torch.float32, device=dev)
        return rows, topics


def _topic_rows(state) -> int:
    """T: the rows of the state's topic tables (0 without them)."""
    tc, tlc = state.topic_counts, state.topic_leader_counts
    return tc.shape[0] if tc is not None else (
        tlc.shape[0] if tlc is not None else 0)


def candidate_eligibility_plain(state, ctx, c, checks: GoalChecks):
    """Twin of KN: ``engine.py``'s eligibility composed in torch — base
    legality, every earlier goal's acceptance, the pass goal's delta."""
    from .analyzer.state import base_legality
    ok = base_legality(state, ctx, c)
    for g in checks.prev_goals:
        ok = ok & g.accepts(state, ctx, c)
    delta = checks.goal.delta(state, ctx, c)
    return ok & ((delta < -checks.epsilon) | c.must), delta


def candidate_eligibility(state, ctx, c, checks: GoalChecks, bounds=None):
    """(bool[N] eligible, float32[N] the pass goal's delta) of candidates
    ``c`` against ``state``, ``ctx`` and the chain position ``checks`` —
    see ``csrc/eligibility.cu`` (one launch, a chunk of rows each past
    ``MAX_GOAL_ROWS``, and the topic rows' bounds ahead where there is
    one). ``bounds`` (``checks.round_bounds(state)``): buffers the launch
    leaves the rows' bounds in, for KQ; ignored on the CPU."""
    N = c.p.shape[0]
    if _on_cpu(state.rb, c.p):
        return candidate_eligibility_plain(state, ctx, c, checks)
    if checks.outside:
        raise ValueError(f"KN has no row for "
                         f"{[g.name for g in checks.outside]}")
    if len(checks.topic_gaps) > MAX_TOPIC_SLOTS:
        raise ValueError(f"KN takes at most {MAX_TOPIC_SLOTS} topic rows of "
                         f"distinct gaps a chain position")
    P, R = state.rb.shape
    B1 = state.util.shape[0]
    tc, tlc = state.topic_counts, state.topic_leader_counts
    T = _topic_rows(state)
    dev = state.rb.device
    rows, lengths = checks.rows_on(dev)
    for k, n in lengths.items():
        if rows[k].kind == ROW_KINDS.index("topic_leaders") and n != T:
            raise ValueError(f"{checks.goal.name}'s chain: an interested "
                             f"topic mask of {n} topics against T {T}")
    i64, i32, f32 = torch.int64, torch.int32, torch.float32

    def as_(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    elig = torch.empty(N, dtype=torch.bool, device=dev)
    delta = torch.empty(N, dtype=f32, device=dev)
    row_bounds = None
    if bounds is not None:
        row_bounds, tbounds = bounds
        if (row_bounds.shape != (max(checks.n, 1), 2)
                or (tbounds is None) != (not checks.topic_gaps)
                or (tbounds is not None and tbounds.shape != (
                    len(checks.topic_gaps), 2, T))):
            raise ValueError("candidate_eligibility: bounds must be "
                             "checks.round_bounds(state)")
    else:
        tbounds = (torch.empty((len(checks.topic_gaps), 2, T), dtype=f32,
                               device=dev) if checks.topic_gaps else None)
    ins = dict(
        rb=as_(state.rb, i64), off=state.offline.contiguous(),
        util=as_(state.util, f32), cnt=as_(state.replica_count, i32),
        lead=as_(state.leader_count, i32),
        pot=as_(state.potential_nw_out, f32),
        lni=as_(state.leader_nw_in, f32), movable=ctx.movable.contiguous(),
        dest=ctx.dest_allowed.contiguous(),
        lead_dest=ctx.leader_dest_allowed.contiguous(),
        lead_movable=ctx.leadership_movable.contiguous(),
        bvalid=ctx.broker_valid.contiguous(),
        balive=ctx.broker_alive.contiguous(),
        cap=as_(ctx.broker_capacity, f32), p=as_(c.p, i64), r=as_(c.r, i64),
        p2=as_(c.p2, i64), r2=as_(c.r2, i64), src=as_(c.src, i64),
        dst=as_(c.dst, i64), kind=as_(c.kind, i64), valid=c.valid.contiguous(),
        must=c.must.contiguous(),
        d_util_src=_aligned16(as_(c.d_util_src, f32)),
        d_util_dst=_aligned16(as_(c.d_util_dst, f32)),
        d_cnt=as_(c.d_cnt, i32),
        d_lead=as_(c.d_lead, i32), d_pot=as_(c.d_pot, f32),
        d_lni=as_(c.d_lni, f32), pos=as_(state.pos, i64),
        rack=as_(ctx.broker_rack, i32), bset=as_(ctx.broker_set, i32),
        ptopic=as_(ctx.partition_topic, i32), tc=as_(tc, i32),
        tlc=as_(tlc, i32), tbounds=tbounds)
    args = _fill(_EligArgs(P=P, R=R, B1=B1, N=N, T=T), **ins, elig=elig,
                 delta=delta, bounds=row_bounds)
    rc = _pass_library().cc_candidate_eligibility(
        ctypes.byref(args), rows, checks.n, -checks.epsilon, _stream())
    LAUNCHES["candidate_eligibility"] += 1
    _check(rc, "candidate_eligibility")
    return elig, delta


# ---------------------------------------------------------------------------
# KQ: an apply round's guards and masks
# ---------------------------------------------------------------------------

#: KQ's guard kinds, by their code (``csrc/round_guards.cu:GuardKind``):
#: the interval family's two guard forms, the topic goals' cell guards,
#: and the engine's default for a goal without a guard of its own
GUARD_KINDS = ("interval", "hard_cap", "topic_replica", "topic_leaders",
               "serialize")
#: distinct metrics one guard table holds (``csrc/round_guards.cu:
#: kMaxSlots``): every metric code
MAX_GUARD_SLOTS = 8

_GuardRow = _struct("_GuardRow", [(f, _I32) for f in (
    "kind", "slot", "form", "upper_only", "cap_col", "bound_row", "param",
    "must")] + [("t", _F32)], "aux")
_GuardArgs = _struct(
    "_GuardArgs",
    "p p2 r r2 src dst kind must d_util_src d_util_dst d_cnt d_lead d_pot "
    "d_lni elig pending conflict util cnt lead pot lni cap balive ptopic tc "
    "tlc bounds tbounds rows scratch do_out pending_out more_out",
    [(f, _I64) for f in ("M", "P", "B1", "T")]
    + [("n_rows", _I32), ("n_slots", _I32),
       ("metric", _I32 * MAX_GUARD_SLOTS), ("reads", _I32)])


class GuardTable:
    """KQ's table of a chain position, built once beside its
    :class:`GoalChecks` (whose bounds the rows read): one row a guard goal
    — the pass goal's first, then the earlier goals' — with a kind of
    ``GUARD_KINDS`` (``goal.guard_row()``). A partition-local goal has no
    row; ``outside`` lists the goals with no kind, which KQ refuses (the
    twin takes any goal). ``metrics`` holds the interval rows' distinct
    metric codes, one a slot: their flows are summed once a slot."""

    def __init__(self, checks: GoalChecks):
        self.goal = checks.goal
        self.guard_goals = [checks.goal, *checks.prev_goals]
        #: goals KQ has no guard kind for
        self.outside = []
        self.metrics = []
        #: the topic tables the rows read (``round_guards.cu:Reads``)
        self.reads = 0
        self.kinds = []
        rows, self._aux = [], []
        for k, g in enumerate(self.guard_goals):
            row = g.guard_row()
            if row is None:
                self.outside.append(g)
                continue
            if row["kind"] == "local":
                continue
            out = dict(kind=GUARD_KINDS.index(row["kind"]),
                       must=int(g is self.goal))
            if row["kind"] in ("interval", "hard_cap"):
                if row["metric"] not in self.metrics:
                    self.metrics.append(row["metric"])
                out.update(slot=self.metrics.index(row["metric"]),
                           form=row["form"], upper_only=row["upper_only"],
                           cap_col=row["cap_col"], t=row["t"],
                           bound_row=checks.row_index[k])
            elif row["kind"] == "topic_replica":
                out["slot"] = checks.rows[checks.row_index[k]].param
                self.reads |= 1
            elif row["kind"] == "topic_leaders":
                out["param"] = row["param"]
                self._aux.append((len(rows), row["aux"]))
                self.reads |= 2
            self.kinds.append(row["kind"])
            rows.append(_GuardRow(**out))
        self.n = len(rows)
        self.rows = (_GuardRow * max(self.n, 1))(*rows)
        self._on = {}

    def rows_on(self, device):
        """The rows on ``device`` (uint8, uploaded once a device, each
        bound array's pointer set) and the bound arrays' lengths; raises
        for a goal KQ has no kind for."""
        if self.outside:
            raise ValueError(f"KQ has no guard kind for "
                             f"{[g.name for g in self.outside]}")
        got = self._on.get(device)
        if got is None:
            if (torch.device(device).type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("KQ's guard table must be uploaded before "
                                   "a CUDA graph captures it")
            rows = (_GuardRow * max(self.n, 1))()
            ctypes.memmove(rows, self.rows, ctypes.sizeof(self.rows))
            lengths = []
            for k, aux in self._aux:
                t = aux.on(device)
                rows[k].aux = t.data_ptr()
                lengths.append(t.shape[0])
            table = torch.frombuffer(bytearray(rows), dtype=torch.uint8)
            got = self._on[device] = (table.to(device), lengths)
        return got


def round_guards_plain(state, ctx, c, conflict_earlier, pending, elig,
                       guards: GuardTable):
    """Twin of KQ: the apply round's masks and every guard goal's
    ``collective_guard`` (KC's and KK's wrappers inside them), composed as
    ``cruise_control_tpu/analyzer/engine.py``'s round does."""
    M = elig.shape[0]
    elig = pending & elig
    blocked = (conflict_earlier & elig[None, :]).any(dim=1)
    # Guards see exactly the earlier, eligible candidates.
    gmask = torch.tril(torch.ones((M, M), dtype=torch.bool,
                                  device=elig.device), diagonal=-1)
    gmask = gmask & elig[None, :]
    ok = torch.ones_like(elig)
    for g in guards.guard_goals:
        gok = g.collective_guard(state, ctx, c, gmask)
        if gok is None:
            gok = ~(((c.src[:, None] == c.src[None, :])
                     | (c.dst[:, None] == c.dst[None, :])) & gmask).any(dim=1)
        if g is guards.goal:
            # The goal may not veto its own mandatory moves.
            gok = gok | c.must
        ok = ok & gok
    do = elig & ~blocked & ok
    pending = pending & ~do
    return do, pending, pending.any() & do.any()


def round_guards(state, ctx, c, conflict_earlier, pending, elig,
                 guards: GuardTable, bounds=None):
    """(bool[M] do, bool[M] pending after the round, bool scalar: still
    pending and some applied) of one apply round over the M candidates
    ``c``: KN's verdict ``elig`` and ``pending`` masked, partition
    conflicts with earlier eligible candidates (``conflict_earlier``
    bool[M, M]) blocked, and every guard goal of ``guards`` holding its
    bounds — see ``csrc/round_guards.cu`` (one launch after a memset).
    ``bounds``: the buffers KN filled this round at this state
    (``GoalChecks.round_bounds``); the twin needs none."""
    M = pending.shape[0]
    if (elig.shape != (M,) or conflict_earlier.shape != (M, M)
            or c.p.shape != (M,) or c.d_util_src.shape != (M, 4)):
        raise ValueError("round_guards takes M candidates, elig and pending "
                         "[M] and conflict_earlier [M, M]")
    if _on_cpu(state.rb, c.p, pending, elig, conflict_earlier):
        return round_guards_plain(state, ctx, c, conflict_earlier, pending,
                                  elig, guards)
    if (pending.dtype != torch.bool or elig.dtype != torch.bool
            or conflict_earlier.dtype != torch.bool):
        raise TypeError("round_guards takes bool masks")
    dev = state.rb.device
    rows, lengths = guards.rows_on(dev)
    if bounds is None:
        raise ValueError("KQ reads the bounds KN wrote this round: pass "
                         "checks.round_bounds(state) to both")
    P = state.rb.shape[0]
    B1 = state.util.shape[0]
    T = _topic_rows(state)
    if any(n != T for n in lengths):
        raise ValueError(f"{guards.goal.name}'s chain: an interested topic "
                         f"mask against T {T}")
    do = torch.empty(M, dtype=torch.bool, device=dev)
    pending_out = torch.empty(M, dtype=torch.bool, device=dev)
    more = torch.empty((), dtype=torch.bool, device=dev)
    if M == 0:
        return do, pending_out, more.fill_(False)
    i64, i32, f32 = torch.int64, torch.int32, torch.float32

    def as_(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    ins = dict(
        p=as_(c.p, i64), p2=as_(c.p2, i64), r=as_(c.r, i64),
        r2=as_(c.r2, i64), src=as_(c.src, i64), dst=as_(c.dst, i64),
        kind=as_(c.kind, i64), must=c.must.contiguous(),
        d_util_src=_aligned16(as_(c.d_util_src, f32)),
        d_util_dst=_aligned16(as_(c.d_util_dst, f32)),
        d_cnt=as_(c.d_cnt, i32), d_lead=as_(c.d_lead, i32),
        d_pot=as_(c.d_pot, f32), d_lni=as_(c.d_lni, f32),
        elig=elig.contiguous(), pending=pending.contiguous(),
        conflict=conflict_earlier.contiguous(), util=as_(state.util, f32),
        cnt=as_(state.replica_count, i32), lead=as_(state.leader_count, i32),
        pot=as_(state.potential_nw_out, f32),
        lni=as_(state.leader_nw_in, f32),
        cap=_aligned16(as_(ctx.broker_capacity, f32)),
        balive=ctx.broker_alive.contiguous(),
        ptopic=as_(ctx.partition_topic, i32),
        tc=as_(state.topic_counts, i32),
        tlc=as_(state.topic_leader_counts, i32),
        bounds=bounds[0], tbounds=bounds[1], rows=rows)
    metric = (_I32 * MAX_GUARD_SLOTS)(*guards.metrics)
    scratch = torch.empty(3, dtype=i32, device=dev)
    args = _fill(_GuardArgs(M=M, P=P, B1=B1, T=T, n_rows=guards.n,
                            n_slots=len(guards.metrics), metric=metric,
                            reads=guards.reads), **ins, scratch=scratch,
                 do_out=do, pending_out=pending_out, more_out=more)
    rc = _pass_library().cc_round_guards(ctypes.byref(args), _stream())
    LAUNCHES["round_guards"] += 1
    _check(rc, "round_guards")
    return do, pending_out, more


# ---------------------------------------------------------------------------
# KO: flow candidates (the weights' range a context, the priorities, then
# the destination match)
# ---------------------------------------------------------------------------

#: ``IntervalGoal._replica_weight``'s forms, by their row in the weight
#: range (``csrc/flow_candidates.cu:Weight``): the four util columns,
#: potential NW_OUT, the count goals' -disk
WEIGHT_FORMS = (("util", 0), ("util", 1), ("util", 2), ("util", 3),
                ("potential", None), ("count", None))

_RangeArgs = _struct("_RangeArgs", "leader_load follower_load out scratch",
                     [(f, _I64) for f in ("L", "P", "R")])
_PriorityArgs = _struct(
    "_PriorityArgs",
    "rb movable off leader_load follower_load values lo up excess deficit "
    "range key prio",
    [(f, _I64) for f in ("P", "R", "B1", "values_step", "lo_step", "up_step",
                         "excess_step", "deficit_step")],
    [("weight", _I32), ("leader_scoped", _I32), ("noise_scale", _F32)])
_MatchArgs = _struct(
    "_MatchArgs", "values lo up deficit dest cap",
    [("thr", _F32), ("upper_only", _I32), ("load", _I32)], "key",
    [("noise_scale", _F32)],
    "idx vals rb off leader_load follower_load p_out r_out dst_out "
    "valid_out work",
    [(f, _I64) for f in ("P", "R", "B1", "K", "values_step", "lo_step",
                         "up_step", "deficit_step", "cap_step")])


def replica_weight_range_plain(leader_load, follower_load, R: int):
    """Twin of KO's range launch: float32[*L, 6, 2], the (min, max) of the
    finite ``goals.replica_weight`` of each of ``WEIGHT_FORMS`` from a
    context's ``[*L, P, 4]`` loads and R slots, as ``goals._unit01``
    computes them, -0.0 taken as +0.0 (which changes no priority)."""
    from .analyzer.goals import replica_weight
    rows = []
    for metric in WEIGHT_FORMS:
        w = replica_weight(metric, leader_load, follower_load, R)
        w = torch.where(w == 0.0, 0.0, w).flatten(-2)
        finite = torch.isfinite(w)
        # one more column of the identity each: an empty plane's range is
        # (+inf, -inf)
        inf = torch.full((*w.shape[:-1], 1), math.inf, dtype=w.dtype,
                         device=w.device)
        rows.append(torch.stack([
            torch.cat([torch.where(finite, w, math.inf), inf], -1).amin(-1),
            torch.cat([torch.where(finite, w, -math.inf), -inf],
                      -1).amax(-1)], -1))
    return torch.stack(rows, -2)


def replica_weight_range(leader_load, follower_load, R: int):
    """float32[*L, 6, 2]: the (min, max) of the finite replica weights of
    each of ``WEIGHT_FORMS`` — ``_unit01``'s range in KO's priorities,
    built once a search context — see ``csrc/flow_candidates.cu`` (one
    launch)."""
    if _on_cpu(leader_load, follower_load):
        return replica_weight_range_plain(leader_load, follower_load, R)
    lead = _aligned16(leader_load.to(torch.float32).contiguous())
    foll = _aligned16(follower_load.to(torch.float32).contiguous())
    lead_shape = tuple(lead.shape[:-2])
    L = math.prod(lead_shape)
    P = lead.shape[-2]
    dev = lead.device
    out = torch.empty((*lead_shape, len(WEIGHT_FORMS), 2),
                      dtype=torch.float32, device=dev)
    if L == 0:
        return out
    lib = _pass_library()
    scratch = torch.empty(lib.cc_weight_range_scratch(L), dtype=torch.int32,
                          device=dev)
    args = _fill(_RangeArgs(L=L, P=P, R=R), leader_load=lead,
                 follower_load=foll, out=out, scratch=scratch)
    rc = lib.cc_weight_range(ctypes.byref(args), _stream())
    LAUNCHES["replica_weight_range"] += 1
    _check(rc, "replica_weight_range")
    return out


def _weight_range_of(ctx):
    """The context's weight range; raises for one built without it."""
    if ctx.weight_range is None:
        raise ValueError("this search context was built without its weight "
                         "range (build_context(with_weight_range=False)): "
                         "it scores, it cannot propose")
    return ctx.weight_range


def _weight_form(goal) -> int:
    """``IntervalGoal._replica_weight`` as KO names it: its row of
    ``WEIGHT_FORMS``: a util column, potential NW_OUT (4) or the
    small-disk preference (5)."""
    which, res = goal.metric
    if which == "util":
        return int(res)
    return 4 if which == "potential" else 5


def _cap_factor(goal, ctx):
    """(float32[B1] capacity column or None, threshold): the factors of a
    goal's upper bound where it is their per-broker product (its
    ``_upper_minus`` then rounds once)."""
    factor = goal._cap_factor(ctx)
    if factor is None:
        return None, 0.0
    return factor


def _planes(values, *planes):
    """``planes`` (broker planes or scalar bounds) as contiguous float32
    tensors of ``values``' shape."""
    return [torch.broadcast_to(t, values.shape).to(torch.float32)
            .contiguous() for t in planes]


def _plane(t, n: int):
    """(float32 tensor, element step) of a broker plane or scalar bound
    over ``n`` brokers, read in place where it can be: a bound broadcast
    to every broker as its one value (step 0), a column of a ``[B1, 4]``
    table with its stride; anything else contiguous (step 1)."""
    if t is None:
        return None, 0
    t = torch.broadcast_to(t, (n,))
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    return (t, t.stride(0)) if t.stride(0) in (0, 1, 4) else \
        (t.contiguous(), 1)


def _fill_planes(args, n, **planes):
    """Set the plane pointers of KO's ``args`` and their ``*_step``
    fields; returns the tensors, to keep them alive over the launch."""
    kept = {}
    for name, t in planes.items():
        kept[name], step = _plane(t, n)
        setattr(args, name, _ptr(kept[name]))
        setattr(args, f"{name}_step", step)
    return kept


def flow_priority_plain(goal, state, ctx, key, cfg, values, lo, up, excess,
                        deficit):
    """Twin of KO's first launch: ``goals.py:_flow_candidates``' source
    replicas' priority (offline > excess-broker > deficit-assist tiers,
    with tie-break noise), in plain torch; ``_unit01``'s range read from
    the context's ``weight_range``."""
    from .analyzer.goals import (_NEG, _TIER_ASSIST, _TIER_EXCESS,
                                 _TIER_OFFLINE, _noise, _tier_plus_norm01)
    R = state.rb.shape[1]
    dev = state.rb.device
    _weight_range_of(ctx)
    w = goal._replica_weight(state, ctx)                        # [P, R]
    finite = torch.isfinite(w)
    xmin, xmax = ctx.weight_range[..., _weight_form(goal), :].unbind(-1)
    span = torch.clamp(xmax - xmin, min=1e-12)
    q = (w - xmin[..., None, None]) / span[..., None, None]
    src_b = state.rb
    any_deficit = (deficit > 0.0).any()
    mid = torch.where(torch.isfinite(lo), (lo + up) * 0.5, up * 0.5)
    assist = any_deficit & (values[src_b] > mid[src_b])
    prio = torch.where(excess[src_b] > 0.0,
                       _tier_plus_norm01(_TIER_EXCESS, q, finite),
                       torch.where(assist,
                                   _tier_plus_norm01(_TIER_ASSIST, q,
                                                     finite), _NEG))
    if goal.metric[0] in ("leaders", "leader_nw_in"):
        prio = torch.where((torch.arange(R, device=dev) == 0)[None, :],
                           prio, _NEG)
    prio = torch.where(ctx.movable, prio, _NEG)
    prio = torch.where(state.offline,
                       _tier_plus_norm01(_TIER_OFFLINE, q, finite), prio)
    return prio + torch.where(torch.isfinite(prio),
                              _noise(key, prio.shape, cfg.noise_scale), 0.0)


def flow_priority(goal, state, ctx, key, cfg, values, lo, up, excess,
                  deficit):
    """float32[P, R] source-replica priorities of an interval goal's flow
    candidates, the noise drawn from ``key`` (a key or key path) — see
    ``csrc/flow_candidates.cu`` (one launch over the card)."""
    from . import _random
    if _on_cpu(state.rb, values):
        return flow_priority_plain(goal, state, ctx, key, cfg, values, lo,
                                   up, excess, deficit)
    P, R = state.rb.shape
    B1 = values.shape[0]
    kp = _random.path(key)
    path, keep = _draw_path(kp.words)
    dev = state.rb.device
    prio = torch.empty((P, R), dtype=torch.float32, device=dev)
    args = _fill(
        _PriorityArgs(P=P, R=R, B1=B1, weight=_weight_form(goal),
                      leader_scoped=int(goal.metric[0] in (
                          "leaders", "leader_nw_in")),
                      noise_scale=cfg.noise_scale),
        rb=state.rb.to(torch.int64).contiguous(),
        movable=ctx.movable.contiguous(), off=state.offline.contiguous(),
        leader_load=ctx.leader_load.to(torch.float32).contiguous(),
        follower_load=ctx.follower_load.to(torch.float32).contiguous(),
        range=_weight_range_of(ctx).to(torch.float32).contiguous(),
        key=kp.root.contiguous(), prio=prio)
    kept = _fill_planes(args, B1, values=values, lo=lo, up=up,
                        excess=excess, deficit=deficit)
    rc = _pass_library().cc_flow_priority(ctypes.byref(args), path, _stream())
    LAUNCHES["flow_priority"] += 1
    _check(rc, "flow_priority")
    return prio


def flow_match_plain(goal, state, ctx, key, cfg, values, lo, up, deficit,
                     vals, idx):
    """Twin of KO's second launch: ``goals.py:_flow_candidates``'
    destination matching by cumulative headroom (to the midpoint for
    balance goals, the ceiling for capacity-style goals), the round-robin
    fallback of mandatory moves and the re-route of candidates whose
    matched broker already hosts the partition; (p, r, dst, valid)."""
    from .analyzer.goals import (_NEG, _TIER_EXCESS, _legal_dest_argmax,
                                 _noise, _norm01)
    from .utils.ordered import argsort, scan_sum
    R = state.rb.shape[1]
    B1 = values.shape[0]
    dev = state.rb.device
    K = idx.shape[0]
    p, r = idx // R, idx % R
    sel = torch.isfinite(vals)
    mid = torch.where(torch.isfinite(lo), (lo + up) * 0.5, up * 0.5)
    ceiling = torch.where(ctx.dest_allowed,
                          torch.clamp(goal._upper_minus(values, up, ctx),
                                      min=0.0), 0.0)
    if goal.upper_only:
        headroom = ceiling
    else:
        to_mid = torch.where(ctx.dest_allowed,
                             torch.clamp(mid - values, min=0.0), 0.0)
        headroom = torch.where((to_mid > 0.0).any(), to_mid, ceiling)
    dprio = torch.where(ctx.dest_allowed,
                        torch.where(deficit > 0.0, _TIER_EXCESS, 0.0)
                        + _norm01(headroom, ctx.dest_allowed), _NEG)
    dprio = dprio + torch.where(torch.isfinite(dprio),
                                _noise(key, dprio.shape, cfg.noise_scale),
                                0.0)
    order = argsort(-dprio)                                     # [B1]
    cum_head = scan_sum(headroom[order])
    load = torch.where(sel, goal._replica_metric_load(ctx, p, r), 0.0)
    cum_load = scan_sum(load) - 0.5 * load                      # midpoints
    slot = torch.searchsorted(cum_head, cum_load)
    covered = slot < B1
    matched = order[torch.clamp(slot, max=B1 - 1)]
    # Mandatory (offline) moves get a round-robin destination even when
    # no headroom is left.
    n_ok = torch.clamp(ctx.dest_allowed.sum(), min=1)
    fallback = order[torch.arange(K, device=dev) % n_ok]
    must = state.offline[p, r] & sel
    dst = torch.where(covered, matched, fallback)
    # Re-route candidates whose matched broker already hosts the
    # partition to their best legal destination.
    hosts_dst = (state.rb[p] == dst[:, None]).any(dim=1)
    alt, alt_ok = _legal_dest_argmax(
        state, ctx, p, torch.broadcast_to(dprio[None, :], (K, B1)))
    dst = torch.where(hosts_dst & alt_ok, alt, dst)
    valid = sel & (covered | must) & ctx.dest_allowed[dst]
    return p, r, dst, valid


def flow_match(goal, state, ctx, key, cfg, values, lo, up, deficit, vals,
               idx):
    """(p, r, dst int64[K], valid bool[K]): the destinations of an
    interval goal's top-K source replicas (``idx`` int64[K] flat [P, R]
    indices, ``vals`` float32[K] their priorities), the noise drawn from
    ``key`` — see ``csrc/flow_candidates.cu`` (one block, its arrays in
    shared memory or, past 227 KB, in a global workspace)."""
    from . import _random
    if _on_cpu(state.rb, values, idx):
        return flow_match_plain(goal, state, ctx, key, cfg, values, lo, up,
                                deficit, vals, idx)
    P, R = state.rb.shape
    B1 = values.shape[0]
    K = idx.shape[0]
    kp = _random.path(key)
    path, keep = _draw_path(kp.words)
    dev = state.rb.device
    cap, thr = _cap_factor(goal, ctx)
    lib = _pass_library()
    work_bytes = lib.cc_flow_match_workspace(B1, K, R)
    work = (torch.empty(work_bytes, dtype=torch.uint8, device=dev)
            if work_bytes else None)
    outs = dict(p_out=torch.empty(K, dtype=torch.int64, device=dev),
                r_out=torch.empty(K, dtype=torch.int64, device=dev),
                dst_out=torch.empty(K, dtype=torch.int64, device=dev),
                valid_out=torch.empty(K, dtype=torch.bool, device=dev))
    args = _fill(
        _MatchArgs(thr=thr, upper_only=int(goal.upper_only),
                   load=goal.metric_code(), noise_scale=cfg.noise_scale,
                   P=P, R=R, B1=B1, K=K),
        dest=ctx.dest_allowed.contiguous(),
        key=kp.root.contiguous(), idx=idx.to(torch.int64).contiguous(),
        vals=vals.to(torch.float32).contiguous(),
        rb=state.rb.to(torch.int64).contiguous(),
        off=state.offline.contiguous(),
        leader_load=ctx.leader_load.to(torch.float32).contiguous(),
        follower_load=ctx.follower_load.to(torch.float32).contiguous(),
        work=work, **outs)
    kept = _fill_planes(args, B1, values=values, lo=lo, up=up,
                        deficit=deficit, cap=cap)
    rc = lib.cc_flow_match(ctypes.byref(args), path, _stream())
    LAUNCHES["flow_match"] += 1
    _check(rc, "flow_match")
    return outs["p_out"], outs["r_out"], outs["dst_out"], outs["valid_out"]


# ---------------------------------------------------------------------------
# KP: the replica bulk drain's fill
# ---------------------------------------------------------------------------

_DrainArgs = _struct(
    "_DrainArgs",
    "order rb w cand must quota deficit values up alive dest bvalid "
    "capacity util cnt leader_load follower_load", [("thr", _F32 * 4)],
    "cap", [("cap_thr", _F32), ("count_goal", _I32), ("rbt", _F32)],
    "p_out r_out dst_out ok_out sb sw flags inv grank loc0 loc1 loc2 t3 "
    "out3 kept pmax wsum run_start per_key oscan rank perm budget "
    "cum_budget scr",
    [(f, _I64) for f in ("n", "P", "R", "B1", "N")])


def bulk_drain_fill_plain(goal, state, ctx, cfg, values, up, deficit, quota,
                          order, flat_b, flat_w, flat_cand, flat_must):
    """Twin of KP: ``goals.py:_replica_bulk_drain`` after its lexsort in
    plain torch — shed while a broker's cumulative shed (before the
    replica) is below its quota, the first taken slot of each partition,
    the receivers' budgets capped by the replica-count ceiling and every
    capacity hard goal, the deficit-first prefix-sum fill; (p, r, dst,
    ok) scattered into ``cfg.drain_batch`` slots."""
    from .analyzer.goals import _capacity_budget_cap, _segment_cum_before
    from .utils.ordered import argsort, scan_sum, tree_sum
    N = cfg.drain_batch
    dev = state.rb.device
    alive = ctx.broker_alive
    n_alive = torch.clamp(alive.sum(), min=1)
    P, R = state.rb.shape
    B1 = values.shape[0]
    sb = flat_b[order]
    smask = flat_cand[order]
    sw = torch.where(smask, flat_w[order], 0.0)
    smust = flat_must[order]

    # Shed while the broker's cumulative shed (before this replica) is
    # still below its quota; must-moves shed unconditionally.
    within_before = _segment_cum_before(sw, sb, B1)
    take = smask & ((within_before < quota[sb]) | smust)

    # Partition-disjoint: first taken slot per partition row only.
    sp = order // R
    pos = torch.arange(P * R, device=dev)
    first_pos = torch.full((P,), P * R, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, sp, torch.where(take, pos, P * R), reduce="amin")
    take = take & (first_pos[sp] == pos)

    grank = torch.cumsum(take, 0) - 1
    take = take & (grank < N)
    tw = torch.where(take, sw, 0.0)
    total_w = torch.clamp(tree_sum(tw), min=1e-9)
    n_take = torch.clamp(take.sum().to(torch.float32), min=1.0)

    budget = torch.where(alive & ctx.dest_allowed & ctx.broker_valid,
                         torch.clamp(goal._upper_minus(values, up, ctx),
                                     min=0.0), 0.0)
    is_slot0 = (torch.arange(R, device=dev) == 0)[None, :, None]
    loads = torch.where(is_slot0, ctx.leader_load[:, None, :],
                        ctx.follower_load[:, None, :])         # [P, R, 4]
    sorted_loads = loads.reshape(-1, 4)[order]
    ratio = sorted_loads / torch.clamp(sw, min=1e-9)[:, None]
    per_unit_max = torch.where(take[:, None], ratio, 0.0).amax(dim=0)
    cst = goal.constraint
    budget = _capacity_budget_cap(budget, per_unit_max, cst,
                                  ctx.broker_capacity, state.util)
    if goal.metric[0] != "count":
        cnt = state.replica_count.to(torch.float32)
        cnt_total = tree_sum(torch.where(ctx.broker_valid, cnt, 0.0))
        cnt_avg = cnt_total / n_alive
        cnt_up = torch.maximum(cnt_avg * cst.replica_balance_threshold,
                               torch.ceil(cnt_avg))
        mean_w = total_w / n_take
        budget = torch.minimum(
            budget, torch.clamp(cnt_up - cnt, min=0.0) * mean_w)
    budget = torch.clamp(budget, min=0.0)

    # Prefix-sum fill over DEFICIT-FIRST receivers.
    perm = argsort(-deficit)
    cum_budget = scan_sum(budget[perm])
    target = scan_sum(tw) - 0.5 * tw
    pos_in_perm = torch.searchsorted(cum_budget, target)
    dst = perm[torch.clamp(pos_in_perm, max=B1 - 1)]
    ok = take & (pos_in_perm < B1) & (target < cum_budget[B1 - 1])

    # Scatter into the fixed-size batch (slot = global rank); rows that
    # are not ok park in the discard slot N, which is sliced off.
    slot = torch.where(ok, grank, N)

    def scatter(vals, dtype):
        out = torch.zeros(N + 1, dtype=dtype, device=dev)
        return out.scatter_(0, slot, vals.to(dtype))[:N]
    return (scatter(sp, torch.int64), scatter(order % R, torch.int64),
            scatter(dst, torch.int64), scatter(ok, torch.bool))


def bulk_drain_fill(goal, state, ctx, cfg, values, up, deficit, quota, order,
                    flat_b, flat_w, flat_cand, flat_must):
    """(p, r, dst int64[N], ok bool[N]), N = ``cfg.drain_batch``: one
    replica bulk-drain round of an interval goal from the lexsort ``order``
    of the flat [P, R] slots (``flat_b`` their brokers — the order's first
    key —, ``flat_w`` weights, ``flat_cand`` candidates, ``flat_must``
    mandatory moves) and the brokers' ``quota`` and ``deficit`` — see
    ``csrc/drain_fill.cu`` (seven launches)."""
    if _on_cpu(state.rb, values, order):
        return bulk_drain_fill_plain(goal, state, ctx, cfg, values, up,
                                     deficit, quota, order, flat_b, flat_w,
                                     flat_cand, flat_must)
    P, R = state.rb.shape
    n = P * R
    B1 = values.shape[0]
    N = int(cfg.drain_batch)
    if order.shape != (n,) or flat_b.shape != (n,):
        raise ValueError("bulk_drain_fill takes the [P * R] slots' order")
    dev = state.rb.device
    values, up, deficit, quota = _planes(values, values, up, deficit,
                                            quota)
    cap, cap_thr = _cap_factor(goal, ctx)
    cst = goal.constraint
    lib = _pass_library()
    i64, f32 = torch.int64, torch.float32
    outs = dict(p_out=torch.empty(N, dtype=i64, device=dev),
                r_out=torch.empty(N, dtype=i64, device=dev),
                dst_out=torch.empty(N, dtype=i64, device=dev),
                ok_out=torch.empty(N, dtype=torch.bool, device=dev))
    i32, u8 = torch.int32, torch.uint8
    nch = -(-n // 4096)                 # chunks of 16^3 slots

    def buf(size, dtype=f32):
        return torch.empty(size, dtype=dtype, device=dev)
    scratch = dict(
        sb=buf(n, i32), sw=buf(n), flags=buf(n, u8), inv=buf(n, i32),
        grank=buf(n, i32), loc0=buf(n), loc1=buf(-(-n // 16)),
        loc2=buf(-(-n // 256)), t3=buf(nch), out3=buf(nch),
        kept=buf(nch, i32), pmax=buf((nch, 4)),
        wsum=buf(max(-(-n // 32), min(n, 32))), run_start=buf(B1 + 1, i32),
        per_key=buf(B1), oscan=buf(B1), rank=buf(B1, i32),
        perm=buf(B1, i64), budget=buf(B1), cum_budget=buf(B1),
        scr=buf(lib.cc_drain_fill_scratch(n, B1)))
    args = _fill(
        _DrainArgs(thr=(_F32 * 4)(*cst.capacity_threshold),
                   cap_thr=cap_thr,
                   count_goal=int(goal.metric[0] == "count"),
                   rbt=cst.replica_balance_threshold, n=n, P=P, R=R, B1=B1,
                   N=N),
        order=order.to(i64).contiguous(), rb=flat_b.to(i64).contiguous(),
        w=flat_w.to(f32).contiguous(), cand=flat_cand.contiguous(),
        must=flat_must.contiguous(), cap=cap, quota=quota, deficit=deficit,
        values=values, up=up, alive=ctx.broker_alive.contiguous(),
        dest=ctx.dest_allowed.contiguous(),
        bvalid=ctx.broker_valid.contiguous(),
        capacity=ctx.broker_capacity.to(f32).contiguous(),
        util=state.util.to(f32).contiguous(),
        cnt=state.replica_count.to(torch.int32).contiguous(),
        leader_load=ctx.leader_load.to(f32).contiguous(),
        follower_load=ctx.follower_load.to(f32).contiguous(),
        **outs, **scratch)
    rc = lib.cc_drain_fill(ctypes.byref(args), _stream())
    LAUNCHES["bulk_drain_fill"] += 1
    _check(rc, "bulk_drain_fill")
    return outs["p_out"], outs["r_out"], outs["dst_out"], outs["ok_out"]


# ---------------------------------------------------------------------------
# KZ: a replica drain round up to its fill; KAA: a leadership drain round
# ---------------------------------------------------------------------------

_OrderArgs = _struct(
    "_OrderArgs",
    "util cnt lead pot lni cap bvalid balive rows rb off movable leader_load "
    "follower_load key planes w cand must order counts start chunk_first "
    "keys runs scratch",
    [(f, _I64) for f in ("P", "R", "B1")], [("weight", _I32)])
_LeadArgs = _struct(
    "_LeadArgs",
    "util cnt lead pot lni cap bvalid balive rows ldest rb off lmov pvalid "
    "leader_load follower_load key", [("thr", _F32 * 4)],
    "p_out r_out ok_out planes scratch counts start chunk_first keys runs "
    "order sw can take t2 dstb rsel wv wn loc0 loc1 loc2 t3 out3 per_key "
    "oscan pmax kept",
    [(f, _I64) for f in ("P", "R", "B1", "N")], [("weight", _I32)])


def drain_order_plain(goal, state, ctx, key):
    """Twin of KZ: ``IntervalGoal.drain_sort`` in plain torch — the goal's
    planes and shed quota, the slots' weights, candidates and noise, and
    ``lexsort`` by (broker, must-first, weight-desc-with-noise)."""
    from . import _random
    from .utils.ordered import lexsort
    values, lo, up = goal._bounds_b1(state, ctx)
    _, deficit, quota, _ = goal._shed_quota(values, lo, up, ctx)

    P, R = state.rb.shape
    src_b = state.rb
    w = goal._replica_drain_weight(ctx, state.rb)              # [P, R]
    cand = (ctx.movable & ((w > 0.0) | state.offline)
            & ((quota[src_b] > 0.0) | state.offline))

    # Sort by (broker, must-first, weight-desc-with-noise).
    noise = _random.affine(key, (P, R), 0.01, 1.0)
    flat_b = src_b.reshape(-1)
    flat_w = w.reshape(-1)
    flat_cand = cand.reshape(-1)
    flat_must = state.offline.reshape(-1) & flat_cand
    sort_w = torch.where(flat_cand, flat_w * noise.reshape(-1), -1.0)
    order = lexsort((-sort_w, ~flat_must, flat_b))
    return (values, up, deficit, quota, order, flat_b, flat_w, flat_cand,
            flat_must)


def _planes_inputs(state, ctx, what: str) -> dict:
    """The broker planes KY's row code reads (``csrc/bounds.cuh``), each
    checked contiguous and of its dtype."""
    ins = dict(util=state.util, cnt=state.replica_count,
               lead=state.leader_count, pot=state.potential_nw_out,
               lni=state.leader_nw_in, cap=ctx.broker_capacity,
               bvalid=ctx.broker_valid, balive=ctx.broker_alive)
    for name, t in ins.items():
        if t.dtype != _VIOL_DTYPES[name] or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be a contiguous "
                            f"{_VIOL_DTYPES[name]}")
    return ins


def _interval_rows(goal, state, what: str):
    """The goal's one-row table (``IntervalGoal.planes_rows``) on the
    state's device; raises where the goal has no interval row."""
    table = goal.planes_rows
    if table.specs[0] is None or table.specs[0]["kind"] not in (
            "interval", "hard_cap"):
        raise ValueError(f"{what} has no interval row for {goal.name}")
    return table.rows_on(state.rb.device, state.util.shape[0],
                         _topics(state), False)[0]


def drain_order(goal, state, ctx, key):
    """(values, up, deficit, quota f32[B1], order int64[n], flat_b
    int64[n], flat_w f32[n], flat_cand bool[n], flat_must bool[n]) of an
    interval goal's replica drain round over the n = P x R slots, the
    noise drawn from ``key`` (a key or key path) — what KP
    (:func:`bulk_drain_fill`) takes; see ``csrc/drain_order.cu`` (a memset
    and five launches: the quota, the slots' keys grouped by broker, each
    broker's run sorted in shared memory)."""
    from . import _random
    if _on_cpu(state.rb):
        return drain_order_plain(goal, state, ctx, key)
    which, res = goal.metric
    if which not in ("count", "util") or _leading(state):
        raise ValueError(f"drain_order drains an unbatched count or util "
                         f"goal, not {goal.name}")
    P, R = state.rb.shape
    B1 = state.util.shape[0]
    n = P * R
    dev = state.rb.device
    rows = _interval_rows(goal, state, "drain_order")
    ins = _planes_inputs(state, ctx, "drain_order")
    kp = _random.path(key)
    path, keep = _draw_path(kp.words)
    lib = _pass_library()
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def buf(size, dtype):
        return torch.empty(size, dtype=dtype, device=dev)
    planes = buf((6, B1), f32)
    outs = dict(w=buf(n, f32), cand=buf(n, torch.bool),
                must=buf(n, torch.bool), order=buf(n, i64))
    scratch = dict(counts=buf(2 * B1, i32), start=buf(B1 + 1, i32),
                   chunk_first=buf(B1 + 1, i32), keys=buf(n, i64),
                   runs=buf(n, i64),
                   scratch=buf(lib.cc_drain_order_scratch(B1), f32))
    args = _fill(
        _OrderArgs(P=P, R=R, B1=B1,
                   weight=-1 if which == "count" else int(res)),
        **ins, rows=rows, rb=state.rb.to(i64).contiguous(),
        off=state.offline.contiguous(), movable=ctx.movable.contiguous(),
        leader_load=ctx.leader_load.to(f32).contiguous(),
        follower_load=ctx.follower_load.to(f32).contiguous(),
        key=kp.root.contiguous(), planes=planes, **outs, **scratch)
    rc = lib.cc_drain_order(ctypes.byref(args), path, _stream())
    LAUNCHES["drain_order"] += 1
    _check(rc, "drain_order")
    return (planes[0], planes[1], planes[2], planes[3], outs["order"],
            state.rb.reshape(-1), outs["w"], outs["cand"], outs["must"])


def leadership_drain_plain(goal, state, ctx, key, cfg, w_all):
    """Twin of KAA: ``IntervalGoal._leadership_bulk_drain`` up to its
    candidates in plain torch — the shed quota and intake budgets, each
    partition's best-headroom follower, the two quota passes (shed per
    source, intake per destination, each a lexsort and
    ``_segment_cum_before``) with the capacity cap between them, and (p,
    r, ok) scattered into ``cfg.drain_batch`` slots."""
    from . import _random
    from .analyzer.goals import (_NEG, _capacity_budget_cap,
                                 _segment_cum_before)
    from .utils.ordered import lexsort
    N = cfg.drain_batch
    dev = state.rb.device
    values, lo, up = goal._bounds_b1(state, ctx)
    alive = ctx.broker_alive
    excess, deficit, quota, n_alive = goal._shed_quota(values, lo, up, ctx)
    budget_b = torch.where(alive & ctx.leader_dest_allowed
                           & ctx.broker_valid,
                           torch.clamp(goal._upper_minus(values, up, ctx),
                                       min=0.0), 0.0)

    P, R = state.rb.shape
    B1 = values.shape[0]
    src = state.rb[:, 0]                                       # [P]
    w = torch.clamp(w_all, min=0.0)
    can = (ctx.leadership_movable & ctx.partition_valid & alive[src]
           & (quota[src] > 0.0) & (w > 0.0))

    fb = state.rb                                              # [P, R]
    slot_ok = ((torch.arange(R, device=dev) != 0)[None, :]
               & (fb < B1 - 1) & alive[fb] & ctx.leader_dest_allowed[fb]
               & ~state.offline)
    dscore = torch.where(slot_ok, budget_b[fb], _NEG)
    r_sel = torch.argmax(dscore, dim=1)
    has_dst = torch.isfinite(dscore.amax(dim=1))
    can = can & has_dst
    dstb = fb[torch.arange(P, device=dev), r_sel]

    noise = _random.affine(key, (P,), 0.01, 1.0)
    sort_w = torch.where(can, w * noise, -1.0)

    # Pass 1 — shed quota per source broker (heaviest transfers first).
    o1 = lexsort((-sort_w, src))
    sw1 = torch.where(can[o1], w[o1], 0.0)
    before1 = _segment_cum_before(sw1, src[o1], B1)
    t1_sorted = can[o1] & (before1 < quota[src[o1]])
    take1 = torch.zeros(P, dtype=torch.bool, device=dev)
    take1[o1] = t1_sorted

    # Aggregate hard-capacity cap, like the replica drain.
    dload = torch.clamp(ctx.leader_load - ctx.follower_load, min=0.0)
    ratio = dload / torch.clamp(w, min=1e-9)[:, None]
    per_unit_max = torch.where(take1[:, None], ratio, 0.0).amax(dim=0)
    budget_b = _capacity_budget_cap(budget_b, per_unit_max, goal.constraint,
                                    ctx.broker_capacity, state.util)

    # Pass 2 — intake budget per destination broker.
    sort_w2 = torch.where(take1, w * noise, -1.0)
    o2 = lexsort((-sort_w2, dstb))
    sw2 = torch.where(take1[o2], w[o2], 0.0)
    before2 = _segment_cum_before(sw2, dstb[o2], B1)
    t2_sorted = take1[o2] & (before2 < budget_b[dstb[o2]])

    grank = torch.cumsum(t2_sorted, 0) - 1
    ok = t2_sorted & (grank < N)
    slot = torch.where(ok, grank, N)

    def scatter(vals, dtype):
        out = torch.zeros(N + 1, dtype=dtype, device=dev)
        return out.scatter_(0, slot, vals.to(dtype))[:N]
    return (scatter(o2, torch.int64), scatter(r_sel[o2], torch.int64),
            scatter(ok, torch.bool))


def leadership_drain(goal, state, ctx, key, cfg):
    """(p, r int64[N], ok bool[N]), N = ``cfg.drain_batch``: one leadership
    drain round of an interval goal, each partition weighing the goal's
    ``_leadership_drain_weight`` (the kernel reads it from the context),
    the noise drawn from ``key`` (a key or key path) — what KT's
    ``Part("leadership", ...)`` takes; see ``csrc/leadership_drain.cu`` (a
    memset and fourteen launches)."""
    from . import _random
    if _on_cpu(state.rb):
        return leadership_drain_plain(goal, state, ctx, key, cfg,
                                      goal._leadership_drain_weight(ctx))
    which, _res = goal.metric
    if _leading(state) or which not in ("leaders", "leader_nw_in"):
        raise ValueError(f"leadership_drain drains an unbatched leader "
                         f"count or leader NW_IN goal, not {goal.name}")
    P, R = state.rb.shape
    B1 = state.util.shape[0]
    N = int(cfg.drain_batch)
    dev = state.rb.device
    rows = _interval_rows(goal, state, "leadership_drain")
    ins = _planes_inputs(state, ctx, "leadership_drain")
    kp = _random.path(key)
    path, keep = _draw_path(kp.words)
    lib = _pass_library()
    f32, i32, i64, u8 = torch.float32, torch.int32, torch.int64, torch.uint8

    def buf(size, dtype=f32):
        return torch.empty(size, dtype=dtype, device=dev)
    outs = dict(p_out=buf(N, i64), r_out=buf(N, i64),
                ok_out=buf(N, torch.bool))
    blocks = -(-P // 256)
    nch = -(-P // 4096)
    scratch = dict(
        planes=buf((8, B1)),
        scratch=buf(lib.cc_leadership_drain_scratch(P, B1)),
        counts=buf(4 * B1, i32), start=buf(2 * (B1 + 1), i32),
        chunk_first=buf(2 * (B1 + 1), i32), keys=buf(P, i64),
        runs=buf(P, i64), order=buf(2 * P, i64), sw=buf(P),
        can=buf(P, u8), take=buf(P, u8), t2=buf(P, u8), dstb=buf(P, i32),
        rsel=buf(P, i32), wv=buf(P), wn=buf(P), loc0=buf(P),
        loc1=buf(-(-P // 16)), loc2=buf(-(-P // 256)), t3=buf(nch),
        out3=buf(nch), per_key=buf(B1), oscan=buf(B1),
        pmax=buf((blocks, 4)), kept=buf(blocks, i32))
    args = _fill(
        _LeadArgs(thr=(_F32 * 4)(*goal.constraint.capacity_threshold),
                  P=P, R=R, B1=B1, N=N,
                  weight=-1 if which == "leaders" else 1),
        **ins, rows=rows, ldest=ctx.leader_dest_allowed.contiguous(),
        rb=state.rb.to(i64).contiguous(), off=state.offline.contiguous(),
        lmov=ctx.leadership_movable.contiguous(),
        pvalid=ctx.partition_valid.contiguous(),
        leader_load=ctx.leader_load.to(f32).contiguous(),
        follower_load=ctx.follower_load.to(f32).contiguous(),
        key=kp.root.contiguous(), **outs, **scratch)
    rc = lib.cc_leadership_drain(ctypes.byref(args), path, _stream())
    LAUNCHES["leadership_drain"] += 1
    _check(rc, "leadership_drain")
    return outs["p_out"], outs["r_out"], outs["ok_out"]


# ---------------------------------------------------------------------------
# KR: the candidate generators' replica priorities
# ---------------------------------------------------------------------------

#: KR's row kinds, by their code (``csrc/replica_priority.cu:Kind``): four
#: bases of the grid's source transform (RackAware's duplicate racks, the
#: rack spread over its limit, a replica outside its broker set,
#: MinTopicLeaders' leader relocation), four of the leadership transform
#: (an interval goal's gain, MinTopicLeaders, its inactive all -inf form,
#: the preferred leader), an interval goal's two swap planes (heavy,
#: light) and TopicReplicaDistribution's move plane with, given a second
#: key, its swap's heavy plane
PRIORITY_KINDS = ("rack_aware", "rack_spread", "broker_set",
                  "topic_leaders_move", "interval_leadership",
                  "topic_leaders", "no_leadership", "preferred_leader",
                  "interval_swap", "topic")
#: the kinds whose planes are the grid's source transform
_GRID_KINDS = PRIORITY_KINDS[:4]
#: the kinds whose planes are the leadership transform
_LEADERSHIP_KINDS = PRIORITY_KINDS[4:8]

_PrioArgs = _struct(
    "_PrioArgs",
    "rb pos movable off lead_movable topic rack bset alive bvalid raw_dest "
    "cells interested topic_set leader_load follower_load range values lo "
    "up excess deficit key prio bounds scratch",
    [(f, _I64) for f in ("P", "R", "B1", "T", "n_sets", "values_step",
                         "lo_step", "up_step", "excess_step",
                         "deficit_step")],
    [(f, _I32) for f in ("kind", "weight", "leader_scoped", "min_count",
                         "planes")],
    [(f, _F32) for f in ("noise_scale", "gap_c", "gap_lo", "gap_hi")],
    [("path", _DrawPath * 2)])


def _fill_paths(args, keys):
    """Set ``args.path`` to the draw paths of ``keys`` (keys or key paths
    of one root); returns (the root, the word tensors the paths point at,
    which must stay alive over the launch)."""
    from . import _random
    paths = [_random.path(k) for k in keys]
    keep = []
    for j, kp in enumerate(paths):
        if kp.root is not paths[0].root:
            raise ValueError("the keys of one launch share one root")
        args.path[j], held = _draw_path(kp.words)
        keep += held
    return paths[0].root.contiguous(), keep


def grid_source_plain(state, ctx, base, key, cfg):
    """``goals.py:_top_replica_dest_grid``'s source transform of a [P, R]
    base priority: movable replicas only, an offline replica at 8 plus its
    finite base clamped into [0, 1], and the tie-break noise of ``key``
    added where finite."""
    from .analyzer.goals import _NEG, _TIER_OFFLINE, _noise
    rp = torch.where(ctx.movable, base, _NEG)
    rp = torch.where(state.offline,
                     _TIER_OFFLINE + torch.clamp(
                         torch.where(torch.isfinite(rp), rp, 0.0), 0.0, 1.0),
                     rp)
    return rp + torch.where(torch.isfinite(rp),
                            _noise(key, rp.shape, cfg.noise_scale), 0.0)


def leadership_source_plain(state, ctx, base, key, cfg):
    """``goals.py:_top_leadership``'s transform of a [P, R] base priority:
    a slot above 0 of a partition whose leadership may move, and the
    tie-break noise of ``key`` added where finite."""
    from .analyzer.goals import _NEG, _noise
    R = base.shape[-1]
    slot_ok = ((torch.arange(R, device=base.device)[None, :] > 0)
               & ctx.leadership_movable[:, None])
    pr = torch.where(slot_ok, base, _NEG)
    return pr + torch.where(torch.isfinite(pr),
                            _noise(key, pr.shape, cfg.noise_scale), 0.0)


def _interval_swap_plain(goal, state, ctx, keys, cfg, values, lo, up, excess,
                         deficit):
    """``IntervalGoal._swap_candidates``' heavy and light planes, q read
    from the context's weight range (the same q as ``_unit01``'s, but for
    the sign of a zero, which no priority shows)."""
    from .analyzer.goals import _NEG, _TIER_EXCESS, _noise, _tier_plus_norm01
    from .utils.ordered import fma
    R = state.rb.shape[1]
    dev = state.rb.device
    _weight_range_of(ctx)
    w = goal._replica_weight(state, ctx)                         # [P, R]
    finite = torch.isfinite(w)
    xmin, xmax = ctx.weight_range[_weight_form(goal), :].unbind(-1)
    q = (w - xmin) / torch.clamp(xmax - xmin, min=1e-12)
    src_b = state.rb
    swappable = (ctx.movable & ~state.offline
                 & ctx.raw_dest_allowed[src_b])
    is_slot0 = (torch.arange(R, device=dev) == 0)[None, :]
    mid = torch.where(torch.isfinite(lo), (lo + up) * 0.5, up * 0.5)
    any_deficit = (deficit > 0.0).any()
    hmask = swappable & ((excess[src_b] > 0.0)
                         | (any_deficit & (values[src_b] > mid[src_b])))
    lmask = swappable & (values[src_b] < mid[src_b])
    if goal.metric[0] in ("leaders", "leader_nw_in"):
        hmask = hmask & is_slot0
        lmask = lmask & ~is_slot0
    hprio = torch.where(hmask, _tier_plus_norm01(_TIER_EXCESS, q, finite),
                        _NEG)
    hprio = hprio + torch.where(torch.isfinite(hprio),
                                _noise(keys[0], hprio.shape,
                                       cfg.noise_scale), 0.0)
    # 0.99 - w contracts too: 0.99 - q * 0.99 rounds once.
    light = torch.where(finite, fma(-q, 0.99, 0.99), 0.99 - 0.0)
    lprio = torch.where(lmask,
                        torch.where(deficit[src_b] > 0.0, _TIER_EXCESS,
                                    0.0) + light, _NEG)
    lprio = lprio + torch.where(torch.isfinite(lprio),
                                _noise(keys[1], lprio.shape,
                                       cfg.noise_scale), 0.0)
    return [hprio, lprio]


def _topic_plain(goal, state, ctx, keys, cfg):
    """TopicReplicaDistributionGoal's move priority (``propose``) and,
    given a second key, its swap's heavy priority (``_swap_candidates``),
    and the topics' (lower, upper)."""
    from .analyzer.goals import (_NEG, _TIER_EXCESS, _TIER_OFFLINE,
                                 _jax_index, _noise, _tier_plus_norm01,
                                 _unit01)
    lower, upper = goal._bounds(state, ctx)
    tc = state.topic_counts.to(torch.float32)                   # [T, B1]
    T = tc.shape[0]
    alive = ctx.broker_alive[None, :]
    excess = torch.where(alive, torch.clamp(tc - upper[:, None], min=0.0),
                         tc)
    t_of_p = _jax_index(ctx.partition_topic, T)                  # [P]
    src_excess = excess[t_of_p[:, None], state.rb]              # [P, R]
    q, finite = _unit01(src_excess)
    prio = torch.where(src_excess > 0.0,
                       _tier_plus_norm01(_TIER_EXCESS, q, finite), _NEG)
    prio = torch.where(ctx.movable, prio, _NEG)
    prio = torch.where(state.offline, _TIER_OFFLINE, prio)
    prio = prio + torch.where(torch.isfinite(prio),
                              _noise(keys[0], prio.shape, cfg.noise_scale),
                              0.0)
    planes = [prio]
    if len(keys) > 1:
        src_b = state.rb
        swappable = (ctx.movable & ~state.offline
                     & ctx.raw_dest_allowed[src_b])
        src_over = torch.clamp(tc - upper[:, None], min=0.0)[t_of_p[:, None],
                                                             src_b]
        q, finite = _unit01(src_over)
        hprio = torch.where(swappable & (src_over > 0.0),
                            _tier_plus_norm01(_TIER_EXCESS, q, finite), _NEG)
        planes.append(hprio + torch.where(
            torch.isfinite(hprio), _noise(keys[1], hprio.shape,
                                          cfg.noise_scale), 0.0))
    return planes, torch.stack([lower, upper])


def replica_priority_plain(kind, goal, state, ctx, keys, cfg, **planes):
    """Twin of KR: the goal's base priority of ``kind`` composed in torch
    from the goal's own methods, then its transform — the grid's source
    (:func:`grid_source_plain`), the leadership one
    (:func:`leadership_source_plain`), an interval goal's swap planes or
    TopicReplicaDistribution's planes."""
    from .analyzer.goals import _NEG, _norm01
    if kind == "topic":
        prios, bounds = _topic_plain(goal, state, ctx, keys, cfg)
        return torch.stack(prios), bounds
    if kind == "interval_swap":
        return torch.stack(_interval_swap_plain(goal, state, ctx, keys, cfg,
                                                **planes))
    if kind == "interval_leadership":
        excess, deficit = planes["excess"], planes["deficit"]
        src_b = state.rb[:, 0:1]                                 # [P, 1]
        dst_b = state.rb                                         # [P, R]
        gain = _norm01(excess)[src_b] + _norm01(deficit)[dst_b]
        base = torch.where((excess[src_b] > 0.0) | (deficit[dst_b] > 0.0),
                           gain, _NEG)
    elif kind == "no_leadership":
        base = torch.full(state.rb.shape, _NEG, device=state.rb.device)
    else:
        base = goal.priority_base(kind, state, ctx)
    transform = (grid_source_plain if kind in _GRID_KINDS
                 else leadership_source_plain)
    return transform(state, ctx, base, keys[0], cfg)[None]


def replica_priority(kind, goal, state, ctx, keys, cfg, **planes):
    """float32[len(keys), P, R]: a candidate generator's noised source
    priorities of ``kind`` (:data:`PRIORITY_KINDS`), one plane a key (a key
    or key path each); for "topic" also float32[2, T], the topics'
    (lower, upper). ``planes``: an interval goal's broker planes (values,
    lo, up, excess, deficit; "interval_leadership" reads excess and
    deficit) — see ``csrc/replica_priority.cu`` (one map over the card;
    "topic" a bounds and a range launch ahead of it)."""
    if kind not in PRIORITY_KINDS:
        raise ValueError(f"unknown priority kind {kind!r}")
    if _on_cpu(state.rb, *planes.values()):
        return replica_priority_plain(kind, goal, state, ctx, keys, cfg,
                                      **planes)
    P, R = state.rb.shape
    B1 = ctx.broker_alive.shape[0]
    dev = state.rb.device
    n_planes = len(keys)
    if n_planes not in {"interval_swap": (2,), "topic": (1, 2)}.get(kind,
                                                                    (1,)):
        raise ValueError(f"replica_priority: {n_planes} keys for {kind!r}")
    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    prio = torch.empty((n_planes, P, R), dtype=f32, device=dev)
    args = _PrioArgs(P=P, R=R, B1=B1, kind=PRIORITY_KINDS.index(kind),
                     planes=n_planes, noise_scale=cfg.noise_scale)
    root, keep = _fill_paths(args, keys)
    ins = dict(rb=state.rb.to(i64).contiguous(), key=root,
               movable=ctx.movable.contiguous(),
               off=state.offline.contiguous(), prio=prio)
    bounds = None
    if kind in _LEADERSHIP_KINDS:
        ins["lead_movable"] = ctx.leadership_movable.contiguous()
    if kind == "preferred_leader":
        ins["pos"] = state.pos.to(i64).contiguous()
    if kind in ("rack_aware", "rack_spread"):
        ins["rack"] = ctx.broker_rack.to(i32).contiguous()
        ins["alive"] = ctx.broker_alive.contiguous()
    if kind == "broker_set" and goal.topic_set is not None:
        sets = goal.topic_set.on(dev)
        ins.update(bset=ctx.broker_set.to(i32).contiguous(),
                   topic=ctx.partition_topic.to(i32).contiguous(),
                   topic_set=sets)
        args.n_sets = sets.shape[0]
    if kind in ("topic_leaders_move", "topic_leaders"):
        tlc = state.topic_leader_counts
        ins.update(cells=tlc.to(i32).contiguous(),
                   topic=ctx.partition_topic.to(i32).contiguous(),
                   alive=ctx.broker_alive.contiguous(),
                   interested=goal.interested_topics.on(dev))
        args.T = tlc.shape[0]
        args.min_count = int(goal.min_count)
    if kind == "topic":
        tc = state.topic_counts
        T = tc.shape[0]
        cst = goal.constraint
        args.T = T
        args.gap_c = cst.topic_replica_balance_threshold - 1.0
        args.gap_lo = float(cst.topic_replica_balance_min_gap)
        args.gap_hi = float(cst.topic_replica_balance_max_gap)
        bounds = torch.empty((2, T), dtype=f32, device=dev)
        ins.update(cells=tc.to(i32).contiguous(),
                   topic=ctx.partition_topic.to(i32).contiguous(),
                   alive=ctx.broker_alive.contiguous(),
                   bvalid=ctx.broker_valid.contiguous(),
                   raw_dest=ctx.raw_dest_allowed.contiguous(), bounds=bounds,
                   scratch=torch.empty(4 * n_planes, dtype=i32, device=dev))
    if kind == "interval_swap":
        ins.update(leader_load=_aligned16(ctx.leader_load.to(f32)
                                          .contiguous()),
                   follower_load=_aligned16(ctx.follower_load.to(f32)
                                            .contiguous()),
                   range=_weight_range_of(ctx).to(f32).contiguous(),
                   raw_dest=ctx.raw_dest_allowed.contiguous())
        args.weight = _weight_form(goal)
        args.leader_scoped = int(goal.metric[0] in ("leaders",
                                                    "leader_nw_in"))
    _fill(args, **ins)
    kept = _fill_planes(args, B1, **{k: planes.get(k) for k in (
        "values", "lo", "up", "excess", "deficit")})
    rc = _pass_library().cc_replica_priority(ctypes.byref(args), _stream())
    LAUNCHES["replica_priority"] += 1
    _check(rc, "replica_priority")
    return prio if bounds is None else (prio, bounds)


# ---------------------------------------------------------------------------
# KS: the destinations of the generators' candidates
# ---------------------------------------------------------------------------

#: KS's forms (``csrc/dest_select.cu:Form``): the grid's destination
#: short-list, TopicReplicaDistribution's per-candidate destination and
#: its swap's light partner
DEST_FORMS = ("shortlist", "topic_move_dest", "topic_swap_dest")
#: the short-list's priority planes (``csrc/dest_select.cu:Plane``): the
#: emptier brokers first (``goals._count_replicas_norm``), or
#: MinTopicLeaders' missing leaders a broker
SHORTLIST_PLANES = ("count", "topic_leaders")

_DestArgs = _struct(
    "_DestArgs",
    "dest cnt cells interested alive topic rb movable off bounds idx key "
    "vals_out idx_out dst_out ok_out partner_out rowrange best scratch",
    [(f, _I64) for f in ("P", "R", "B1", "T", "K", "D")],
    [(f, _I32) for f in ("form", "plane", "min_count")],
    [("noise_scale", _F32)], [("path", _DrawPath * 2)])


def shortlist_source_plain(ctx, dest_priority, key, cfg):
    """``goals.py:_top_replica_dest_grid``'s destination priority: barred
    brokers at -inf, the tie-break noise of ``key`` added where finite."""
    from .analyzer.goals import _NEG, _noise
    dp = torch.where(ctx.dest_allowed, dest_priority, _NEG)
    return dp + torch.where(torch.isfinite(dp),
                            _noise(key, dp.shape, cfg.noise_scale), 0.0)


def dest_select_plain(form, goal, state, ctx, keys, cfg, *, plane="count",
                      n=0, idx=None, bounds=None):
    """Twin of KS in torch: "shortlist" (values, indices) of the ``n``
    best destinations; "topic_move_dest" (dst, ok) of the candidates
    ``idx``; "topic_swap_dest" (ok, partner) of the heavy replicas
    ``idx``."""
    from .analyzer.goals import (_NEG, _count_replicas_norm, _jax_index,
                                 _legal_dest_argmax, _norm01, _plus_noise)
    from .utils.ordered import top_k
    if form == "shortlist":
        if plane == "count":
            dprio = _count_replicas_norm(state)
        else:
            dprio = _norm01(goal._deficit(state, ctx).sum(dim=0)
                            .to(torch.float32))
        return top_k(shortlist_source_plain(ctx, dprio, keys[0], cfg), n)
    R = state.rb.shape[1]
    tc = state.topic_counts.to(torch.float32)                    # [T, B1]
    T, B1 = tc.shape
    t_of_p = _jax_index(ctx.partition_topic, T)
    p = idx // R
    if form == "topic_move_dest":
        deficit = torch.where(ctx.broker_alive[None, :],
                              torch.clamp(bounds[0][:, None] - tc, min=0.0),
                              0.0)
        base = (2.0 * _norm01(deficit[t_of_p[p]])
                + _count_replicas_norm(state)[None, :])
        score = _plus_noise(base, keys[0], cfg.noise_scale)
        return _legal_dest_argmax(state, ctx, p, score)
    # One light partner per broker: a segment max of a uniform draw over
    # in-bounds replicas, then the highest slot holding it. An empty
    # segment keeps the max's identity (-inf, INT32_MIN).
    from . import _random
    dev = tc.device
    P = state.rb.shape[0]
    K = idx.shape[0]
    src_b = state.rb
    swappable = (ctx.movable & ~state.offline
                 & ctx.raw_dest_allowed[src_b])
    src_over = torch.clamp(tc - bounds[1][:, None], min=0.0)[t_of_p[:, None],
                                                             src_b]
    light = (swappable & (src_over <= 0.0)).reshape(-1)
    lraw = torch.where(light, _random.uniform(keys[0], (P * R,)), _NEG)
    broker_of = src_b.reshape(-1)
    best_val = torch.full((B1,), _NEG, device=dev).scatter_reduce(
        0, broker_of, lraw, "amax")
    slots = torch.arange(P * R, device=dev)
    tied = torch.isfinite(lraw) & (lraw == best_val[broker_of])
    best_slot = torch.full((B1,), -2**31, dtype=torch.int64,
                           device=dev).scatter_reduce(
        0, broker_of, torch.where(tied, slots, -1), "amax")
    has_light = best_slot >= 0
    # Destination: the broker where the heavy candidate's topic is
    # scarcest and that offers a partner, masked against the raw
    # destination filter and the brokers hosting the partition.
    hosting = torch.zeros((K, B1), dtype=torch.bool, device=dev)
    hosting.scatter_(1, state.rb[p], True)  # sentinel column B is in range
    scarcity = _norm01(-tc)[t_of_p[p]]                          # [K, B1]
    score = torch.where(
        has_light[None, :] & ctx.raw_dest_allowed[None, :] & ~hosting,
        _plus_noise(scarcity, keys[1], cfg.noise_scale), _NEG)
    dst = torch.argmax(score, dim=1)
    return torch.isfinite(score.amax(dim=1)), best_slot[dst]


def dest_select(form, goal, state, ctx, keys, cfg, *, plane="count", n=0,
                idx=None, bounds=None):
    """The destination side of a candidate generator, in the form ``form``
    (:data:`DEST_FORMS`), the noise drawn from ``keys`` (a key or key path
    each):

    - "shortlist": (float32[n], int64[n]) the ``n`` best destinations by
      the ``plane`` (:data:`SHORTLIST_PLANES`) with noise, descending, the
      lower index first among ties (one block);
    - "topic_move_dest": (int64[K] dst, bool[K] ok) of
      TopicReplicaDistribution's top-K replicas ``idx`` (flat [P, R]),
      ``bounds`` its topics' (lower, upper) from KR (two launches);
    - "topic_swap_dest": (bool[K] ok, int64[K] partner slot) of its swap's
      heavy replicas ``idx`` (keys: the light draw's, the score's; after
      a memset, two launches).

    See ``csrc/dest_select.cu``."""
    if form not in DEST_FORMS:
        raise ValueError(f"unknown destination form {form!r}")
    if _on_cpu(state.rb, idx, bounds):
        return dest_select_plain(form, goal, state, ctx, keys, cfg,
                                 plane=plane, n=n, idx=idx, bounds=bounds)
    P, R = state.rb.shape
    B1 = ctx.broker_alive.shape[0]
    dev = state.rb.device
    i64, i32, f32 = torch.int64, torch.int32, torch.float32
    if len(keys) != (2 if form == "topic_swap_dest" else 1):
        raise ValueError(f"dest_select: {len(keys)} keys for {form!r}")
    args = _DestArgs(P=P, R=R, B1=B1, form=DEST_FORMS.index(form),
                     noise_scale=cfg.noise_scale)
    root, keep = _fill_paths(args, keys)
    ins = dict(key=root, dest=ctx.dest_allowed.contiguous(),
               cnt=state.replica_count.to(i32).contiguous())
    if form == "shortlist":
        if not 0 < n <= B1:
            raise ValueError(f"dest_select: a short-list of {n} of {B1}")
        args.D = n
        args.plane = SHORTLIST_PLANES.index(plane)
        outs = (torch.empty(n, dtype=f32, device=dev),
                torch.empty(n, dtype=i64, device=dev))
        ins.update(vals_out=outs[0], idx_out=outs[1],
                   best=torch.empty(B1, dtype=i64, device=dev))
        if plane == "topic_leaders":
            tlc = state.topic_leader_counts
            ins.update(cells=tlc.to(i32).contiguous(),
                       alive=ctx.broker_alive.contiguous(),
                       interested=goal.interested_topics.on(dev))
            args.T = tlc.shape[0]
            args.min_count = int(goal.min_count)
    else:
        tc = state.topic_counts
        K = idx.shape[0]
        args.T, args.K = tc.shape[0], K
        ins.update(cells=tc.to(i32).contiguous(),
                   alive=ctx.broker_alive.contiguous(),
                   topic=ctx.partition_topic.to(i32).contiguous(),
                   rb=state.rb.to(i64).contiguous(),
                   bounds=bounds.to(f32).contiguous(),
                   idx=idx.to(i64).contiguous())
        if form == "topic_move_dest":
            outs = (torch.empty(K, dtype=i64, device=dev),
                    torch.empty(K, dtype=torch.bool, device=dev))
            ins.update(dst_out=outs[0], ok_out=outs[1],
                       rowrange=torch.empty((max(K, 1), 2), dtype=f32,
                                            device=dev))
        else:
            outs = (torch.empty(K, dtype=torch.bool, device=dev),
                    torch.empty(K, dtype=i64, device=dev))
            ins.update(ok_out=outs[0], partner_out=outs[1],
                       dest=ctx.raw_dest_allowed.contiguous(),
                       movable=ctx.movable.contiguous(),
                       off=state.offline.contiguous(),
                       best=torch.empty(B1, dtype=i64, device=dev),
                       scratch=torch.empty(2, dtype=i32, device=dev))
    _fill(args, **ins)
    rc = _pass_library().cc_dest_select(ctypes.byref(args), _stream())
    LAUNCHES["dest_select"] += 1
    _check(rc, "dest_select")
    return outs


# ---------------------------------------------------------------------------
# KT: a proposal's candidates assembled from its parts
# ---------------------------------------------------------------------------

#: KT's part kinds (``csrc/candidates.cu:PartKind``): moves of given
#: destinations, the grid's top-K x top-D cross, leadership transfers, an
#: interval goal's heavy-for-light swaps (the light list rolled by a random
#: shift) and TopicReplicaDistribution's swaps with a light partner
PART_KINDS = ("move", "grid", "leadership", "swap", "topic_swap")
#: parts one assembly takes (``csrc/candidates.cu:kMaxParts``)
MAX_PARTS = 4


class Part:
    """One part of a proposal: ``kind`` of :data:`PART_KINDS` and its
    index and value lists, as ``top_k``, KO's match and KS leave them.
    The first replica is ``idx`` (flat [P, R] indices) or (``p``, ``r``);
    a row is valid where ``vals`` is finite (if given) and ``ok`` is set
    (if given). ``dst``: a move's destinations; ``didx``/``dvals``: the
    grid's short-listed destinations; ``idx2``/``vals2``: an interval
    swap's light list, rolled by ``randint(shift, (), 0, K)``;
    ``partner``: a topic swap's partner slot (negative: none)."""

    __slots__ = ("kind", "p", "r", "idx", "vals", "ok", "dst", "didx",
                 "dvals", "idx2", "vals2", "shift", "partner")

    def __init__(self, kind, **fields):
        if kind not in PART_KINDS:
            raise ValueError(f"unknown part kind {kind!r}")
        self.kind = kind
        for name in self.__slots__[1:]:
            setattr(self, name, fields.pop(name, None))
        if fields:
            raise TypeError(f"Part has no fields {sorted(fields)}")

    @property
    def rows(self) -> int:
        first = self.idx if self.idx is not None else self.p
        n = first.shape[0]
        return n * self.didx.shape[0] if self.kind == "grid" else n

    def tensors(self):
        return [getattr(self, f) for f in self.__slots__[1:]
                if isinstance(getattr(self, f), torch.Tensor)]


#: the Candidates fields in KT's output order, with their dtypes and the
#: number of values a row (``csrc/candidates.cu:Out``)
CANDIDATE_FIELDS = (("p", torch.int64, 1), ("r", torch.int64, 1),
                    ("p2", torch.int64, 1), ("r2", torch.int64, 1),
                    ("src", torch.int64, 1), ("dst", torch.int64, 1),
                    ("kind", torch.int64, 1), ("valid", torch.bool, 1),
                    ("must", torch.bool, 1), ("d_util_src", torch.float32, 4),
                    ("d_util_dst", torch.float32, 4),
                    ("d_cnt", torch.int32, 1), ("d_lead", torch.int32, 1),
                    ("d_pot", torch.float32, 1), ("d_lni", torch.float32, 1))

_PartDesc = _struct(
    "_PartDesc", [("kind", _I32)],
    [(f, _I64) for f in ("n", "offset", "K", "D")],
    "p r idx vals ok dst didx dvals idx2 vals2 partner",
    [("shift", _DrawPath)])
_CandArgs = _struct(
    "_CandArgs", "rb off leader_load follower_load key",
    " ".join(f for f, _d, _w in CANDIDATE_FIELDS),
    [(f, _I64) for f in ("P", "R", "N")], [("n_parts", _I32)],
    [("parts", _PartDesc * MAX_PARTS)])


def _part_split(part, R):
    if part.idx is not None:
        return part.idx // R, part.idx % R
    return part.p, part.r


def _part_valid(vals, ok):
    valid = torch.isfinite(vals) if vals is not None else None
    if ok is None:
        return valid
    return ok if valid is None else valid & ok


def assemble_candidates_plain(state, ctx, parts):
    """Twin of KT: each part's candidates by ``state.py``'s
    ``make_*_candidates``, concatenated in the parts' order."""
    from . import _random
    from .analyzer.goals import _jax_index
    from .analyzer.state import (concat_candidates,
                                 make_leadership_candidates,
                                 make_move_candidates, make_swap_candidates)
    P, R = state.rb.shape
    out = None
    for part in parts:
        p, r = _part_split(part, R)
        valid = _part_valid(part.vals, part.ok)
        if part.kind == "move":
            c = make_move_candidates(state, ctx, p, r, part.dst, valid)
        elif part.kind == "grid":
            K, D = p.shape[0], part.didx.shape[0]
            c = make_move_candidates(
                state, ctx, torch.repeat_interleave(p, D),
                torch.repeat_interleave(r, D), part.didx.repeat(K),
                torch.repeat_interleave(valid, D)
                & torch.isfinite(part.dvals).repeat(K))
        elif part.kind == "leadership":
            c = make_leadership_candidates(state, ctx, p, r, valid)
        elif part.kind == "swap":
            K = p.shape[0]
            shift = _random.randint(part.shift, (), 0, K)
            rolled = (torch.arange(K, device=p.device) - shift) % K  # roll
            lidx = part.idx2[rolled]
            c = make_swap_candidates(
                state, ctx, p, r, lidx // R, lidx % R,
                valid & torch.isfinite(part.vals2[rolled]))
        else:
            partner = part.partner
            c = make_swap_candidates(state, ctx, p, r,
                                     _jax_index(partner // R, P),
                                     partner % R,
                                     valid & (partner >= 0))
        out = c if out is None else concat_candidates(out, c)
    return out


def assemble_candidates(state, ctx, parts):
    """The ``Candidates`` of a proposal's ``parts`` (:class:`Part`, at most
    :data:`MAX_PARTS`), each part's rows at its offset in the parts'
    order — see ``csrc/candidates.cu`` (one launch writing every field,
    each a view of one buffer)."""
    from . import _random
    from .analyzer.state import Candidates
    if not 0 < len(parts) <= MAX_PARTS:
        raise ValueError(f"assemble_candidates takes 1-{MAX_PARTS} parts")
    if _on_cpu(state.rb, *[t for part in parts for t in part.tensors()]):
        return assemble_candidates_plain(state, ctx, parts)
    P, R = state.rb.shape
    dev = state.rb.device
    N = sum(part.rows for part in parts)
    # one buffer, each field's view 256-byte aligned
    offsets, at = [], 0
    for _name, dtype, width in CANDIDATE_FIELDS:
        offsets.append(at)
        size = N * width * torch.empty((), dtype=dtype).element_size()
        at += -(-size // 256) * 256
    buf = torch.empty(max(at, 1), dtype=torch.uint8, device=dev)
    fields = {}
    for (name, dtype, width), off in zip(CANDIDATE_FIELDS, offsets):
        size = N * width * torch.empty((), dtype=dtype).element_size()
        view = buf[off:off + size].view(dtype)
        fields[name] = view.reshape(N, 4) if width == 4 else view
    i64, f32 = torch.int64, torch.float32
    args = _CandArgs(P=P, R=R, N=N, n_parts=len(parts))
    keep, roots, offset = [], [], 0
    for j, part in enumerate(parts):
        desc = _PartDesc(kind=PART_KINDS.index(part.kind), n=part.rows,
                         offset=offset)
        first = part.idx if part.idx is not None else part.p
        desc.K = first.shape[0]
        if part.kind == "grid":
            desc.D = part.didx.shape[0]
        if part.kind == "swap":
            kp = _random.path(part.shift)
            path, held = _draw_path(kp.words)
            desc.shift = path
            keep += held
            roots.append(kp.root)
        tensors = {}
        for name in ("p", "r", "idx", "dst", "didx", "idx2", "partner"):
            t = getattr(part, name)
            tensors[name] = None if t is None else t.to(i64).contiguous()
        for name in ("vals", "dvals", "vals2"):
            t = getattr(part, name)
            tensors[name] = None if t is None else t.to(f32).contiguous()
        tensors["ok"] = None if part.ok is None else part.ok.contiguous()
        keep += [t for t in tensors.values() if t is not None]
        _fill(desc, **tensors)
        args.parts[j] = desc
        offset += part.rows
    if len({id(r) for r in roots}) > 1:
        raise ValueError("assemble_candidates: one swap part a call")
    _fill(args, rb=state.rb.to(i64).contiguous(),
          off=state.offline.contiguous(),
          leader_load=_aligned16(ctx.leader_load.to(f32).contiguous()),
          follower_load=_aligned16(ctx.follower_load.to(f32).contiguous()),
          key=roots[0] if roots else None, **fields)
    rc = _pass_library().cc_assemble_candidates(ctypes.byref(args),
                                                _stream())
    LAUNCHES["assemble_candidates"] += 1
    _check(rc, "assemble_candidates")
    return Candidates(**fields)


# ---------------------------------------------------------------------------
# KU: lax.top_k
# ---------------------------------------------------------------------------

#: the largest k KU takes (``csrc/top_k.cu:kMaxK``)
TOP_K_MAX = 4096

_TopKArgs = _struct("_TopKArgs", "x vals idx cand",
                    [(f, _I64) for f in ("S", "N", "K", "ld", "chunk")])


def top_k_plain(x, k: int):
    """Twin of KU: ``utils/ordered.py:top_k`` (a stable sort of the
    values' total-order images)."""
    from .utils.ordered import top_k as sorted_top_k
    return sorted_top_k(x, k)


def top_k(x, k: int):
    """(float32[..., k] values, int64[..., k] indices) of the ``k`` largest
    of float32 ``x`` ([N], or [S, N]: S rows in one launch) in
    ``lax.top_k``'s order: IEEE total order, descending, the lower index
    first among equal bits — see ``csrc/top_k.cu`` (one launch: a block a
    chunk of a row, the row's last block selecting from the chunks'
    keys)."""
    if _on_cpu(x):
        return top_k_plain(x, k)
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise TypeError("top_k takes float32 [N] or [S, N]")
    N = x.shape[-1]
    if not 0 <= k <= min(N, TOP_K_MAX):
        raise ValueError(f"top_k: k {k} of N {N} (at most {TOP_K_MAX})")
    rows = x if x.dim() == 2 else x[None]
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    S = rows.shape[0]
    dev = x.device
    vals = torch.empty((S, k), dtype=torch.float32, device=dev)
    idx = torch.empty((S, k), dtype=torch.int64, device=dev)
    if k and S:
        lib = _pass_library()
        chunk = lib.cc_top_k_chunk(N, k)
        chunks = -(-N // chunk)
        cand = (torch.empty((S, chunks, k), dtype=torch.int64, device=dev)
                if chunks > 1 else None)
        args = _fill(_TopKArgs(S=S, N=N, K=k, ld=rows.stride(0),
                               chunk=chunk), x=rows, vals=vals, idx=idx,
                     cand=cand)
        rc = lib.cc_top_k(ctypes.byref(args), _stream())
        LAUNCHES["top_k"] += 1
        _check(rc, "top_k")
    return (vals, idx) if x.dim() == 2 else (vals[0], idx[0])


# ---------------------------------------------------------------------------
# KV: a pass's steered destinations
# ---------------------------------------------------------------------------

_SteerRow = _struct("_SteerRow", [(f, _I32) for f in (
    "metric", "form", "integer", "cap_col")] + [("t", _F32)])
_SteerArgs = _struct(
    "_SteerArgs",
    "util cnt lead pot lni cap bvalid balive dest rows scratch out",
    [("B1", _I64), ("n_rows", _I32)])


class SteerTable:
    """KV's table of a chain position: one row an earlier goal whose
    ``receptive_dest`` is an interval goal's (``goal.steer_row()``: its
    metric and upper bound, the fields of its row of KN's table); a goal
    that receives everywhere has none. ``outside`` lists the goals KV has
    no form for, which it refuses (the twin takes any goal)."""

    def __init__(self, prev_goals):
        self.prev_goals = list(prev_goals)
        #: goals with no row form
        self.outside = []
        rows = []
        for g in self.prev_goals:
            row = g.steer_row()
            if row is None:
                self.outside.append(g)
            elif row["kind"] != "everywhere":
                rows.append(_SteerRow(
                    metric=row["metric"], form=row["form"],
                    integer=int(row["integer"]), cap_col=row["cap_col"],
                    t=row["t"]))
        self.n = len(rows)
        self.rows = (_SteerRow * max(self.n, 1))(*rows)
        self._on = {}

    def rows_on(self, device):
        """The rows on ``device`` (uint8, uploaded once a device); raises
        for a goal KV has no form for."""
        if self.outside:
            raise ValueError(f"KV has no row for "
                             f"{[g.name for g in self.outside]}")
        got = self._on.get(device)
        if got is None:
            if (torch.device(device).type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("KV's table must be uploaded before a "
                                   "CUDA graph captures it")
            got = self._on[device] = torch.frombuffer(
                bytearray(self.rows), dtype=torch.uint8).to(device)
        return got


def steer_dest_plain(state, ctx, prev_goals):
    """Twin of KV: ``engine.py:steer_ctx``'s mask composed in torch — the
    AND of every earlier goal's ``receptive_dest`` with ``dest_allowed``,
    or ``dest_allowed`` where that leaves no broker."""
    recv = torch.ones_like(ctx.broker_alive)
    for g in prev_goals:
        recv = recv & g.receptive_dest(state, ctx)
    dest = recv & ctx.dest_allowed
    return torch.where(dest.any(), dest, ctx.dest_allowed)


def steer_dest(state, ctx, table: SteerTable, out=None):
    """bool[B1]: the destinations every earlier goal of ``table`` can
    receive a replica on, within ``ctx.dest_allowed`` (all of it where
    none is left) — see ``csrc/steer.cu`` (one block). ``out``: a bool[B1]
    buffer to write (the goal loop's fixed address); the twin copies into
    it."""
    if _on_cpu(state.rb, out):
        mask = steer_dest_plain(state, ctx, table.prev_goals)
        return mask if out is None else out.copy_(mask)
    rows = table.rows_on(state.rb.device)
    if not table.n:
        raise ValueError("steer_dest: no earlier goal steers (the mask is "
                         "ctx.dest_allowed)")
    B1 = state.util.shape[0]
    dev = state.rb.device
    if out is None:
        out = torch.empty(B1, dtype=torch.bool, device=dev)
    elif out.shape != (B1,) or out.dtype != torch.bool or not (
            out.is_contiguous()):
        raise ValueError("steer_dest: out must be a contiguous bool[B1]")
    i32, f32 = torch.int32, torch.float32
    lib = _pass_library()
    need = lib.cc_steer_scratch(B1, table.n)
    scratch = (torch.empty(need, dtype=f32, device=dev) if need else None)
    args = _fill(_SteerArgs(B1=B1, n_rows=table.n),
                 util=state.util.to(f32).contiguous(),
                 cnt=state.replica_count.to(i32).contiguous(),
                 lead=state.leader_count.to(i32).contiguous(),
                 pot=state.potential_nw_out.to(f32).contiguous(),
                 lni=state.leader_nw_in.to(f32).contiguous(),
                 cap=ctx.broker_capacity.to(f32).contiguous(),
                 bvalid=ctx.broker_valid.contiguous(),
                 balive=ctx.broker_alive.contiguous(),
                 dest=ctx.dest_allowed.contiguous(), rows=rows,
                 scratch=scratch, out=out)
    rc = lib.cc_steer_dest(ctypes.byref(args), _stream())
    LAUNCHES["steer_dest"] += 1
    _check(rc, "steer_dest")
    return out


# ---------------------------------------------------------------------------
# KW: a proposal's selection
# ---------------------------------------------------------------------------

#: the most candidates KW selects (``csrc/proposal_select.cu:kMaxM``)
PROPOSAL_MAX = 4096
#: ordering sentinel only (never added to a metric value): mandatory moves
#: sort ahead of every improving move
_MUST_FIRST = -1e30

_SelectArgs = _struct(
    "_SelectArgs",
    " ".join(f for f, _d, _w in CANDIDATE_FIELDS), "elig delta",
    " ".join(f + "_out" for f, _d, _w in CANDIDATE_FIELDS),
    "conflict pending flag order", [("N", _I64), ("M", _I64)])


def _earlier(m: int, device) -> torch.Tensor:
    """bool[m, m]: j < i (candidate j is earlier than candidate i)."""
    return torch.tril(torch.ones((m, m), dtype=torch.bool, device=device),
                      diagonal=-1)


def proposal_select_plain(cands, elig, delta, M: int, out=None, flag=None):
    """Twin of KW: ``engine.py``'s proposal selection in torch — the
    score, the top ``M`` of -score (``top_k_plain``), the winners taken,
    their partition conflicts with earlier winners and ``pending``; with
    ``out`` copied into its buffers, ``flag`` set to ``pending.any()``."""
    # Mandatory (offline) moves outrank everything; otherwise the most
    # negative deltas apply first.
    score = torch.where(
        elig,
        torch.where(cands.must, _MUST_FIRST,
                    torch.clamp(delta, -1e29, 1e29)),
        float("inf"))
    neg_best, order = top_k_plain(-score, M)
    c = cands.take(order)

    def same(a, b):
        return a[:, None] == b[None, :]

    # Structural conflicts: shared partition rows only (primary or swap
    # counterpart); broker sharing is left to the collective guards.
    conflict = (same(c.p, c.p) | same(c.p, c.p2)
                | same(c.p2, c.p) | same(c.p2, c.p2))
    conflict = conflict & _earlier(M, score.device)
    pending = torch.isfinite(neg_best)
    if out is not None:
        for f, _d, _w in CANDIDATE_FIELDS:
            getattr(out[0], f).copy_(getattr(c, f))
        out[1].copy_(conflict)
        out[2].copy_(pending)
        c, conflict, pending = out
    if flag is not None:
        flag.copy_(pending.any())
    return c, conflict, pending


def proposal_select(cands, elig, delta, M: int, out=None, flag=None):
    """(the best ``M`` candidates in score order, bool[M, M] partition
    conflicts with earlier ones, bool[M] pending) of a proposal's
    candidates and KN's (``elig``, ``delta``): mandatory moves first, then
    the most negative deltas, ineligible ones last and not pending — see
    ``csrc/proposal_select.cu`` (a one-block select, then the gather and
    the conflicts over the card). ``out``: (Candidates, conflicts,
    pending) buffers to write (the goal loop's carry); ``flag``: an int64
    scalar set to ``pending.any()``."""
    from .analyzer.state import Candidates
    if _on_cpu(cands.p, elig, delta):
        return proposal_select_plain(cands, elig, delta, M, out, flag)
    N = cands.p.shape[0]
    if elig.shape != (N,) or delta.shape != (N,):
        raise ValueError("proposal_select takes elig and delta [N]")
    if not 0 <= M <= min(N, PROPOSAL_MAX):
        raise ValueError(f"proposal_select: M {M} of N {N} (at most "
                         f"{PROPOSAL_MAX})")
    if flag is not None and (flag.dtype != torch.int64 or flag.dim()):
        raise ValueError("proposal_select: flag must be an int64 scalar")
    dev = cands.p.device
    if out is None:
        out = (Candidates(**{f: torch.empty((M, w) if w > 1 else (M,),
                                            dtype=d, device=dev)
                             for f, d, w in CANDIDATE_FIELDS}),
               torch.empty((M, M), dtype=torch.bool, device=dev),
               torch.empty(M, dtype=torch.bool, device=dev))
    c_out, conflict, pending = out
    outs = {f + "_out": getattr(c_out, f) for f, _d, _w in CANDIDATE_FIELDS}
    for (name, t), (_f, d, w) in zip(outs.items(), CANDIDATE_FIELDS):
        if (t.dtype != d or t.shape != ((M, w) if w > 1 else (M,))
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"proposal_select: out's {name[:-4]} must be a "
                             f"contiguous, 16-byte aligned {d} of {M} rows")
    if (conflict.shape != (M, M) or conflict.dtype != torch.bool
            or not conflict.is_contiguous() or pending.shape != (M,)
            or pending.dtype != torch.bool):
        raise ValueError("proposal_select: out's conflicts must be bool "
                         "[M, M] and pending bool [M], contiguous")
    if M == 0:
        if flag is not None:
            flag.zero_()
        return out
    ins = {}
    for f, d, _w in CANDIDATE_FIELDS:
        ins[f] = _aligned16(getattr(cands, f).to(d).contiguous())
    args = _fill(_SelectArgs(N=N, M=M), **ins, **outs,
                 elig=elig.contiguous(),
                 delta=delta.to(torch.float32).contiguous(),
                 conflict=conflict, pending=pending, flag=flag,
                 order=torch.empty(M, dtype=torch.int64, device=dev))
    rc = _pass_library().cc_proposal_select(ctypes.byref(args), _stream())
    LAUNCHES["proposal_select"] += 1
    _check(rc, "proposal_select")
    return out


# ---------------------------------------------------------------------------
# KX: every goal's violation (and scale) of a goal list; KY: an interval
# goal's proposal planes
# ---------------------------------------------------------------------------

#: the sum forms of a topic row (``csrc/violation.cu:TopicSum``): XLA's
#: eager matrix order past 32 on either axis, else the fused loop's rows
#: or lanes (``utils/ordered.py:topic_sum_form``)
TOPIC_SUM_FORMS = ("matrix", "rows", "lanes")

_ViolRow = _struct("_ViolRow", [(f, _I32) for f in (
    "kind", "metric", "form", "upper_only", "integer", "cap_col", "param",
    "vf", "ic", "epi", "tail", "sum")]
    + [("t", _F32), ("lower", _F32), ("hi", _F32)], "aux")
#: a field KX reads and its step between scenarios, in elements (0: one
#: copy for every scenario)
_Plane = _struct("_Plane", "p", [("s", _I64)])
_VIOL_PLANES = ("rb", "pos", "off", "util", "cnt", "lead", "pot", "lni",
                "cap", "bvalid", "balive", "rack", "bset", "pvalid",
                "ptopic", "tc", "tlc")
_ViolArgs = _struct(
    "_ViolArgs", [(f, _Plane) for f in _VIOL_PLANES],
    "rows viol scale flag",
    [(f, _I64) for f in ("S", "P", "R", "B1", "T")]
    + [("n_rows", _I32), ("eps", _F32), ("windows", _I32),
       ("staged", _I32)])
_PlanesArgs = _struct(
    "_PlanesArgs", "util cnt lead pot lni cap bvalid balive rows out",
    [("B1", _I64)])

#: a row's fields as the table carries them (``_ViolRow``), from the goal's
#: ``violation_row()``
_ROW_FIELDS = ("metric", "form", "upper_only", "integer", "cap_col",
               "param", "t", "lower", "hi")
#: metrics whose violation scale is 0 (exact counts)
_COUNT_METRICS = (4, 5)


class ViolationTable:
    """KX's table of a goal list: one row a goal (``goal.violation_row()``:
    a kind of ``ROW_KINDS`` and its fields — an interval goal's metric,
    bounds form and the program its fused row reads, a topic goal's gap
    constants, the bound arrays), built once by the caller that reads it
    and kept there, since a CUDA graph that captured a launch reads its
    rows at every replay (``PassSegments``, ``CompiledGoalChain`` and
    ``IntervalGoal`` hold theirs); its loop shapes resolved and uploaded
    once a (device, B1, T, batched), as XLA's CPU backend sums the row at
    that width (``utils/ordered.py:row_loop`` and ``topic_sum_form``,
    which raise where the loop was not read).
    ``outside`` lists the goals with no row, which KX refuses; the twin
    takes their own ``violation``."""

    def __init__(self, goals):
        self.goals = list(goals)
        self.outside = []
        #: each goal's row fields (None: outside)
        self.specs = []
        for g in self.goals:
            row = g.violation_row()
            if row is None:
                self.outside.append(g)
            self.specs.append(row)
        self.n = len(self.goals)
        self._on = {}

    def resolve(self, B1: int, T: int, batched: bool):
        """The ctypes rows at this width: each interval row's vector loop
        (vf 0: XLA's tree), each topic row's sum form."""
        from .utils.ordered import row_loop, topic_sum_form
        rows = (_ViolRow * max(self.n, 1))()
        for k, spec in enumerate(self.specs):
            if spec is None:
                continue
            fields = {f: spec[f] for f in _ROW_FIELDS if f in spec}
            kind = spec["kind"]
            row = _ViolRow(kind=ROW_KINDS.index(kind), **fields)
            if kind in ("interval", "hard_cap"):
                loop = row_loop(spec["program"], batched, B1)
                if loop is not None:
                    row.vf, row.ic, row.epi, row.tail = loop
            elif kind == "topic_replica":
                form, shape = topic_sum_form(T, B1, batched)
                row.sum = TOPIC_SUM_FORMS.index(form)
                if form == "rows":
                    row.vf, row.ic, row.epi, row.tail = shape
                elif form == "lanes":
                    row.vf = shape
            rows[k] = row
        return rows

    def rows_on(self, device, B1: int, T: int, batched: bool):
        """(the rows on ``device`` as uint8, each bound array's pointer
        set: uploaded once a shape; the rows as resolved). Raises for a
        goal KX has no row for, and inside a CUDA graph capture for a
        shape not uploaded before it."""
        if self.outside:
            raise ValueError(f"KX has no row for "
                             f"{[g.name for g in self.outside]}")
        key = (torch.device(device), B1, T, batched)
        got = self._on.get(key)
        if got is None:
            if (key[0].type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("KX's table must be uploaded before a "
                                   "CUDA graph captures it")
            rows = self.resolve(B1, T, batched)
            for k, spec in enumerate(self.specs):
                aux = spec.get("aux")
                if aux is not None:
                    t = aux.on(key[0])
                    if spec["kind"] == "topic_leaders" and t.shape[0] != T:
                        raise ValueError(
                            f"{self.goals[k].name}: an interested topic "
                            f"mask of {t.shape[0]} topics against T {T}")
                    rows[k].aux = t.data_ptr()
            table = torch.frombuffer(bytearray(rows), dtype=torch.uint8)
            got = self._on[key] = (table.to(key[0]), rows)
        return got


def _metric_plane(state, m: int) -> torch.Tensor:
    """float32 ``[*L, B1]`` metric ``m`` (``state.metric_values``)."""
    if m < 4:
        return state.util[..., m]
    plane = (state.replica_count, state.leader_count, state.potential_nw_out,
             state.leader_nw_in)[m - 4]
    return plane.to(torch.float32)


def _interval_bounds_plain(row, values, ctx):
    """(lower, upper) of an interval row: ``[*L, 1]`` (0-dim unbatched)
    for an average row, else the capacity column times t or t a broker."""
    from .utils.ordered import tree_sum_last
    inf = float("inf")
    if row.form == 0:
        total = tree_sum_last(torch.where(ctx.broker_valid, values, 0.0))
        n = torch.clamp(ctx.broker_alive.sum(-1), min=1)
        avg = total / n
        if avg.dim():
            avg = avg[..., None]
        upper = avg * row.t
        lower = (torch.full_like(avg, -inf) if row.upper_only
                 else avg * row.lower)
        if row.integer:
            upper = torch.maximum(upper, torch.ceil(avg))
            if not row.upper_only:
                lower = torch.minimum(lower, torch.floor(avg))
        return lower, upper
    if row.form == 1:
        upper = ctx.broker_capacity[..., row.cap_col] * row.t
    else:
        upper = torch.full(ctx.broker_capacity.shape[:-1], row.t,
                           dtype=torch.float32,
                           device=ctx.broker_capacity.device)
    return torch.full_like(upper, -inf), upper


def _minus_upper_plain(row, values, upper, ctx):
    """``values - upper``, one FMA where the bound is capacity x t."""
    from .utils.ordered import fma
    if row.form == 1:
        return fma(-ctx.broker_capacity[..., row.cap_col], row.t, values)
    return values - upper


def _violation_row_plain(row, aux, state, ctx):
    """(violation, scale) ``[*L]`` of one resolved row (``aux``: its bound
    array on the state's device, or None), step by step as KX."""
    from .analyzer.goals import _count_distinct, _jax_index, _per_broker
    from .utils.ordered import (topic_cell_sum, tree_sum_last,
                                vector_loop_sum)
    kind = ROW_KINDS[row.kind]
    zeros = torch.zeros(ctx.broker_alive.shape[:-1], dtype=torch.float32,
                        device=ctx.broker_alive.device)
    B = ctx.broker_capacity.shape[-2] - 1
    if kind in ("interval", "hard_cap"):
        values = _metric_plane(state, row.metric)
        lower, upper = _interval_bounds_plain(row, values, ctx)
        over = torch.clamp(_minus_upper_plain(row, values, upper, ctx),
                           min=0.0)
        under = 0.0 if row.upper_only else torch.clamp(lower - values,
                                                       min=0.0)
        pen = torch.where(ctx.broker_alive, over + under, 0.0)
        viol = (vector_loop_sum(pen, row.vf, row.ic, row.epi, row.tail)
                if row.vf else tree_sum_last(pen))
        if row.metric in _COUNT_METRICS:
            return viol, zeros
        return viol, tree_sum_last(torch.where(ctx.broker_valid,
                                               values.abs(), 0.0))
    rb = state.rb
    valid = rb < B
    R = rb.shape[-1]
    earlier = torch.tril(torch.ones((R, R), dtype=torch.bool,
                                    device=rb.device), diagonal=-1)
    if kind == "rack_aware":
        racks = _per_broker(ctx.broker_rack, rb)
        same = ((racks[..., :, None] == racks[..., None, :])
                & valid[..., :, None] & valid[..., None, :])
        dup = (same & earlier).any(dim=-1)
        return dup.sum(dim=(-2, -1)).to(torch.float32), zeros
    if kind == "rack_spread":
        racks = _per_broker(ctx.broker_rack, rb)
        alive_racks = torch.where(ctx.broker_alive, ctx.broker_rack.long(),
                                  -1)
        num_racks = torch.clamp(_count_distinct(alive_racks, B + 1), min=1)
        rf = valid.sum(dim=-1).to(torch.float32)
        limit = torch.ceil(rf / num_racks.to(torch.float32)[..., None]
                           ).to(torch.int64)
        same = ((racks[..., :, None] == racks[..., None, :])
                & valid[..., :, None] & valid[..., None, :])
        n = same.sum(dim=-1)
        first = valid & ~(same & earlier).any(dim=-1)
        excess = torch.clamp(n - limit[..., None], min=0)
        pen = torch.where(first, excess, 0).sum(dim=-1)
        return pen.sum(dim=-1).to(torch.float32), zeros
    if kind == "topic_replica":
        tc = state.topic_counts
        total = torch.where(ctx.broker_valid[..., None, :], tc, 0).sum(-1)
        n = torch.clamp(ctx.broker_alive.sum(-1), min=1)
        avg = total.to(torch.float32) / n.to(torch.float32)[..., None]
        gap = torch.clamp(avg * row.t, row.lower, row.hi)
        lower = torch.clamp(avg - gap, min=0.0)[..., None]
        upper = (avg + gap)[..., None]
        c = tc.to(torch.float32)
        pen = torch.clamp(c - upper, min=0.0) + torch.clamp(lower - c,
                                                            min=0.0)
        pen = torch.where(ctx.broker_alive[..., None, :], pen, 0.0)
        form = TOPIC_SUM_FORMS[row.sum]
        shape = ((row.vf, row.ic, row.epi, row.tail) if form == "rows"
                 else row.vf)
        return topic_cell_sum(pen, (form, shape)), zeros
    if kind == "topic_leaders":
        tlc = state.topic_leader_counts
        d = torch.clamp(row.param - tlc, min=0)
        d = torch.where(ctx.broker_alive[..., None, :], d, 0)
        d = torch.where(aux[:, None], d, 0)
        return d.sum(dim=(-2, -1)).to(torch.float32), zeros
    if kind == "broker_set":
        sets = aux
        want = sets[_jax_index(ctx.partition_topic, sets.shape[0])][..., None]
        have = _per_broker(ctx.broker_set, rb)
        mism = valid & (want >= 0) & (have >= 0) & (have != want)
        return mism.sum(dim=(-2, -1)).to(torch.float32), zeros
    if kind == "preferred_leader":
        wrong = ctx.partition_valid & (state.pos[..., 0] != 0)
        return wrong.sum(dim=-1).to(torch.float32), zeros
    return zeros, zeros


def _leading(state) -> tuple:
    """The state's scenario axes (() unbatched)."""
    return tuple(state.util.shape[:-2])


def _topics(state) -> int:
    """T of the state's topic tables, batched or not (0 without them)."""
    tc, tlc = state.topic_counts, state.topic_leader_counts
    t = tc if tc is not None else tlc
    return 0 if t is None else t.shape[-2]


def violation_rows_plain(table: ViolationTable, state, ctx, scales=False):
    """Twin of KX: each row's violation (and scale) composed in torch from
    the table's fields, step by step as the kernel computes it — never
    the goal's own methods, but for a goal with no row (``outside``),
    whose ``violation`` and ``violation_scale`` it calls."""
    B1 = state.util.shape[-2]
    T = _topics(state)
    batched = bool(_leading(state))
    rows = table.resolve(B1, T, batched)
    viol, scale = [], []
    dev = state.rb.device
    for k, (g, spec) in enumerate(zip(table.goals, table.specs)):
        if spec is None:
            v = g.violation(state, ctx)
            s = g.violation_scale(state, ctx) if scales else None
        else:
            aux = spec.get("aux")
            v, s = _violation_row_plain(
                rows[k], None if aux is None else aux.on(dev), state, ctx)
        viol.append(v)
        scale.append(s)
    if not viol:
        v = torch.zeros(_leading(state) + (0,), dtype=torch.float32,
                        device=dev)
        return (v, v.clone()) if scales else v
    v = torch.stack(viol, dim=-1)
    return (v, torch.stack(scale, dim=-1)) if scales else v


def _scenario_plane(t, inner: int, S: int):
    """(tensor, scenario step in elements) of a field with ``inner``
    trailing axes, read in place: a field without scenario axes (step 0),
    or one whose trailing axes are contiguous (an expanded field's step
    is 0); anything else is made contiguous."""
    if t is None:
        return None, 0
    if t.dim() == inner:
        return t.contiguous(), 0
    lead = t.dim() - inner
    if lead > 1:
        t = t.reshape((S,) + tuple(t.shape[lead:]))
    tail = t[0] if t.shape[0] else t
    if not tail.is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


#: the dtype of each field KX reads
_VIOL_DTYPES = dict(rb=torch.int64, pos=torch.int64, off=torch.bool,
                    util=torch.float32, cnt=torch.int32, lead=torch.int32,
                    pot=torch.float32, lni=torch.float32,
                    cap=torch.float32, bvalid=torch.bool,
                    balive=torch.bool, rack=torch.int32, bset=torch.int32,
                    pvalid=torch.bool, ptopic=torch.int32, tc=torch.int32,
                    tlc=torch.int32)


def violation_rows(table: ViolationTable, state, ctx, scales=False,
                   out=None, scale_out=None, flag=None, eps=0.0):
    """f32 ``[*L, G]`` every goal's violation of ``table`` (and with
    ``scales`` its violation scale, a second ``[*L, G]``) at ``state`` —
    see ``csrc/violation.cu`` (one launch, a block a row a scenario).
    ``out`` / ``scale_out``: contiguous ``[*L, G]`` buffers the caller
    keeps (a CUDA graph's fixed addresses); ``flag``: an int64 scalar set
    to whether the first row's violation exceeds ``eps`` (float32) or a
    replica is offline (a one-row table, unbatched), the goal pass's
    converged test."""
    lead = _leading(state)
    G = table.n
    if _on_cpu(state.rb, out, scale_out, flag):
        got = violation_rows_plain(table, state, ctx, scales)
        v, s = got if scales else (got, None)
        if flag is not None:
            flag.copy_((v[..., 0] > eps) | state.offline.any())
        if out is not None:
            v = out.copy_(v)
        if scale_out is not None:
            s = scale_out.copy_(s)
        return (v, s) if scales else v
    if flag is not None and (lead or G != 1 or flag.dtype != torch.int64
                             or flag.dim()):
        raise ValueError("violation_rows: flag is an int64 scalar of a "
                         "one-row table, unbatched")
    S = math.prod(lead)
    P, R = state.rb.shape[-2:]
    B1 = state.util.shape[-2]
    T = _topics(state)
    dev = state.rb.device
    need = {"topic_replica": state.topic_counts,
            "topic_leaders": state.topic_leader_counts}
    for k, spec in enumerate(table.specs):
        if spec is not None and spec["kind"] in need and need[
                spec["kind"]] is None:
            raise ValueError(f"violation_rows: {table.goals[k].name} reads "
                             f"a topic table the state does not hold")
    rows, resolved = table.rows_on(dev, B1, T, bool(lead))
    for name, buf in (("out", out), ("scale_out", scale_out)):
        if buf is not None and (buf.shape != lead + (G,)
                                or buf.dtype != torch.float32
                                or not buf.is_contiguous()):
            raise ValueError(f"violation_rows: {name} must be a contiguous "
                             f"float32 {list(lead + (G,))}")
    if out is None and flag is None:
        out = torch.empty(lead + (G,), dtype=torch.float32, device=dev)
    if scales and scale_out is None:
        scale_out = torch.empty(lead + (G,), dtype=torch.float32,
                                device=dev)
    fields = dict(
        rb=(state.rb, 2), pos=(state.pos, 2), off=(state.offline, 2),
        util=(state.util, 2), cnt=(state.replica_count, 1),
        lead=(state.leader_count, 1), pot=(state.potential_nw_out, 1),
        lni=(state.leader_nw_in, 1), cap=(ctx.broker_capacity, 2),
        bvalid=(ctx.broker_valid, 1), balive=(ctx.broker_alive, 1),
        rack=(ctx.broker_rack, 1), bset=(ctx.broker_set, 1),
        pvalid=(ctx.partition_valid, 1), ptopic=(ctx.partition_topic, 1),
        tc=(state.topic_counts, 2), tlc=(state.topic_leader_counts, 2))
    topic = ROW_KINDS.index("topic_replica")
    args = _ViolArgs(S=S, P=P, R=R, B1=B1, T=T, n_rows=G, eps=float(eps),
                     windows=int(any(resolved[k].kind == topic
                                     for k in range(G))))
    kept = []                      # the fields' tensors, alive over the launch
    for name, (t, inner) in fields.items():
        if t is not None and t.dtype != _VIOL_DTYPES[name]:
            raise TypeError(f"violation_rows: {name} must be "
                            f"{_VIOL_DTYPES[name]}, got {t.dtype}")
        t, step = _scenario_plane(t, inner, S)
        kept.append(t)
        setattr(args, name, _Plane(p=_ptr(t), s=step))
    _fill(args, rows=rows, viol=out, scale=scale_out if scales else None,
          flag=flag)
    if G:
        rc = _pass_library().cc_violation_rows(ctypes.byref(args),
                                               _stream())
        LAUNCHES["violation_rows"] += 1
        _check(rc, "violation_rows")
    return (out, scale_out) if scales else out


def interval_planes_plain(table: ViolationTable, state, ctx):
    """Twin of KY: (values, lo, up, excess, deficit) [B1] of the table's
    one interval row, from its fields (``IntervalGoal.plain_planes`` for
    a goal with no row)."""
    goal, spec = table.goals[0], table.specs[0]
    if spec is None:
        return goal.plain_planes(state, ctx)
    row = table.resolve(state.util.shape[-2], _topics(state), False)[0]
    values = _metric_plane(state, row.metric)
    lower, upper = _interval_bounds_plain(row, values, ctx)
    lo = torch.broadcast_to(lower, values.shape)
    up = torch.broadcast_to(upper, values.shape)
    alive = ctx.broker_alive
    excess = torch.where(alive, torch.clamp(
        _minus_upper_plain(row, values, up, ctx), min=0.0), values)
    deficit = (torch.zeros_like(values) if row.upper_only else
               torch.where(alive & torch.isfinite(lo),
                           torch.clamp(lo - values, min=0.0), 0.0))
    return values, lo, up, excess, deficit


def interval_planes(table: ViolationTable, state, ctx):
    """(values, lo, up, excess, deficit) f32[B1] of the one interval goal
    of ``table`` (the goal's own, ``IntervalGoal.planes_rows``: a graph
    that captures this launch reads its rows) — see ``csrc/violation.cu``
    (one launch, one block): views of one new ``[5, W]`` buffer (W = B1
    rounded up to 4: each row 16-byte aligned)."""
    if _on_cpu(state.rb):
        return interval_planes_plain(table, state, ctx)
    if _leading(state):
        raise ValueError("interval_planes takes an unbatched state")
    if table.n != 1 or table.specs[0] is None or table.specs[0][
            "kind"] not in ("interval", "hard_cap"):
        raise ValueError(f"KY has no interval row for "
                         f"{[g.name for g in table.goals]}")
    B1 = state.util.shape[0]
    dev = state.rb.device
    rows, _ = table.rows_on(dev, B1, _topics(state), False)
    out = torch.empty((5, -(-B1 // 4) * 4), dtype=torch.float32, device=dev)
    ins = _planes_inputs(state, ctx, "interval_planes")
    args = _fill(_PlanesArgs(B1=B1), **ins, rows=rows, out=out)
    rc = _pass_library().cc_interval_planes(ctypes.byref(args), _stream())
    LAUNCHES["interval_planes"] += 1
    _check(rc, "interval_planes")
    return tuple(out[k, :B1] for k in range(5))
