"""Read the population's weighted row from the reference's whole program,
one fusion at a time: the route for 23-32 goals.

The population program (``cruise_control_tpu/parallel/population.py:run``)
fuses the weighted objective ``(normalized_stacks * w).sum(-1)`` into
``multiply_reduce`` fusions. XLA's CPU backend emits each fusion as its
own kernel, and LLVM vectorizes one function at a time, so the fusion
compiled alone should get the loop the whole program gets — in seconds,
where the whole program takes 800-1,600 s to compile at 23-33 goals.

The program's form decides the fusions that hold the row:
- two or more plans, weights that differ (the probe chain: one hard goal
  in three): ``multiply_reduce`` fusions at the walk's end, after each
  polish round and at the end, the weights a buffer;
- a move weight: ``multiply_add`` fusions, the same reduce and then the
  move term added;
- one plan: one ``reduce_bitcast`` fusion, the final scores with the plan
  axis dropped (the boundaries' scores are dead code: one plan's
  permutation is fixed);
- every weight equal (an all-hard or all-soft chain): the weights a
  splat constant inside the fusion.

For each program (``--programs G[:K[:move weight[:chain]]],...``) the
script

1. runs the reference's population program (the chains and cluster of
   ``scripts/probe_population_goals.py``) in a child process with
   ``XLA_FLAGS=--xla_dump_to``, and stops the child once the optimized
   module (``*jit_run.cpu_after_optimizations.txt``) is written, before
   LLVM's code generation;
2. takes every fusion of the entry computation that holds the row (the
   1e-06 cutoff and a reduce), with its reducer, and makes each fusion's
   body the entry computation of a module of its own; the programs of one
   form at other goal counts must equal its first (the base) reshaped;
3. compiles each base fusion alone on the CPU backend at every goal count
   of ``--goals`` (its optimized IR dumped) and feeds it seeded stacks,
   scales, weights and moves — for a weight buffer one hard goal in three
   ("mixed"), no hard goal ("one") and every goal hard ("shared"), for a
   splat the fusion's own — and prints the orders of
   ``scripts/probe_sum_order.py``'s models that matched every trial;
   ``--save DIR`` writes each as ``DIR/weighted_row_<site>_<G><form>.hlo``
   (``_k1``, ``_mw``, ``_hard``, ``_soft``: :func:`_form`).

The route is trusted only if the lone fusions agree with what the whole
program was shown to compute (``probe_population_goals.py``): goal order
with FMAs at 23 goals with mixed weights, XLA's windowed tree of the
rounded products at 33.

    JAX_PLATFORMS=cpu python scripts/probe_row_fusion.py \\
        [--programs 23,28,32,33,23:1,23:4:0.1,23:4:0:hard] \\
        [--goals 23,...,33] [--plans 4] [--trials 8] [--save DIR] \\
        [--dumps DIR]

``--dumps DIR`` keeps each program's dump in ``DIR/<G><form>`` and reuses
one already there (by default a new directory under
``build/row_fusion/``, where each lone fusion's dump goes too). Each
program dump takes 10-18 minutes of CPU time and 15-20 GB of memory
(XLA's passes over a 500 MB module); the child processes run in parallel.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "jit_run.cpu_after_optimizations.txt"


# ---------------------------------------------------------------------------
# 1. The whole program's optimized module
# ---------------------------------------------------------------------------

def _child(G: int, K: int, move_weight: float, chain: str) -> None:
    """Compile the reference's population program of K plans at G goals
    of one of ``probe_population_goals.CHAINS`` with the given move weight
    (the dump flags come from the parent)."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                    os.path.join(ROOT, "scripts")]
    import jax
    import probe_population_goals as pp
    import cruise_control_tpu.analyzer as ja
    from torch_parity_util import build_both
    (jm, jmd), _ = build_both(12, 240, seed=3)
    jopt, _ = pp.optimizers(G, chain, K, move_weight)
    jcfg, jgoals, jchain, jctx, jstate, _ = jopt._prepare(
        jm, jmd, ja.OptimizationOptions(**pp.OPTS))
    jrun, _, _, _ = jopt._population_run_for(jcfg, jgoals, jchain)
    jrun.lower(jstate, jctx, jax.random.PRNGKey(pp.OPTS["seed"])).compile()


def start_dump(G: int, K: int, move_weight: float, chain: str, out: str):
    """A child compiling the program of K plans at G goals of the chain
    (and the move weight) into ``out``, or None if ``out`` already holds
    its optimized module."""
    if glob.glob(os.path.join(out, f"*{PROGRAM}")):
        return None
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_dump_to={out} --xla_dump_hlo_as_text "
        f"--xla_dump_hlo_module_re=jit_run"))
    return subprocess.Popen([sys.executable, __file__, "--child", str(G),
                             str(K), str(move_weight), chain],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def wait_dump(proc, out: str) -> str:
    """The optimized module's path, once written (the memory report is
    written after it); the child is stopped then."""
    done = os.path.join(out, f"*{PROGRAM[:-4]}-memory-usage-report.txt")
    while proc is not None and not glob.glob(done):
        if proc.poll() is not None:
            raise RuntimeError(f"the program's compile in {out} ended "
                               f"without an optimized module")
        time.sleep(5)
    if proc is not None:
        proc.kill()
        proc.wait()
    return glob.glob(os.path.join(out, f"*{PROGRAM}"))[0]


# ---------------------------------------------------------------------------
# 2. The weighted row's fusions as modules of their own
# ---------------------------------------------------------------------------

def _computations(path: str, names: set) -> dict:
    """name -> text of the named computations of an HLO module file."""
    found, cur, lines = {}, None, []
    head = re.compile(r"^%([\w.\-]+) \(")
    with open(path) as f:
        for line in f:
            if cur is None:
                m = head.match(line)
                if m and m.group(1) in names:
                    cur, lines = m.group(1), [line]
            else:
                lines.append(line)
                if line.startswith("}"):
                    found[cur] = "".join(lines)
                    cur = None
    return found


def weighted_fusions(path: str) -> list:
    """[(fusion name, module text)] for every fusion of the optimized
    module's entry computation that holds the weighted row: its body has
    the satisfied cutoff (a 1e-06 constant) and a reduce. At K >= 2 plans
    these are ``multiply_reduce`` fusions, or ``multiply_add`` ones with a
    move weight (the reduce, then the move term added); at K = 1 a
    ``reduce_bitcast`` fusion with the plan axis dropped. Each is returned
    as the fused computation made the entry computation, with its
    reducer."""
    calls = {}
    pat = re.compile(r"%([\w.\-]+) = f32\[\d+\]\{0\} fusion\(.*calls=%"
                     r"([\w.]+), metadata=\{op_name=\"jit\(run\)/\w+\"")
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                calls[m.group(2)] = m.group(1)
    bodies = {name: text for name, text in _computations(
        path, set(calls)).items()
        if "constant(1e-06)" in text and " reduce(" in text}
    regions = {re.search(r"to_apply=%([\w.]+)", text).group(1)
               for text in bodies.values()}
    regions = _computations(path, regions)
    out = []
    for comp, text in sorted(bodies.items()):
        region = re.search(r"to_apply=%([\w.]+)", text).group(1)
        entry = re.sub(r"^%[\w.\-]+ ", "ENTRY %main ", text, count=1)
        # the HLO importer takes a rank-changing bitcast as a reshape
        entry = entry.replace(" bitcast(", " reshape(")
        module = (f"HloModule weighted_row\n\n{regions[region]}\n{entry}")
        out.append((calls[comp], module))
    return out


# ---------------------------------------------------------------------------
# 3. Compile one fusion alone and feed it values
# ---------------------------------------------------------------------------

def compile_module(text: str, dump: str | None = None):
    """(run(*arrays) -> numpy, [parameter shapes]) of an HLO module text,
    compiled on the CPU backend (its IR dumped into ``dump``)."""
    import jax
    import numpy as np
    from jax._src import xla_bridge
    from jax._src.lib import xla_client as xc
    module = xc._xla.hlo_module_from_text(text)
    stablehlo = xc._xla.mlir.hlo_to_stablehlo(
        module.as_serialized_hlo_module_proto())
    backend = xla_bridge.get_backend("cpu")
    dev = backend.devices()[0]
    options = xc.CompileOptions()
    if dump:
        debug = options.executable_build_options.debug_options
        debug.xla_dump_to = dump
        debug.xla_dump_hlo_as_text = True
    exe = backend.compile_and_load(stablehlo, xc.DeviceList((dev,)),
                                   options)
    entry = text[text.index("ENTRY"):]
    params = re.findall(r"parameter\((\d+)\)", entry)
    shapes = {}
    for m in re.finditer(r"= \w+\[([\d,]*)\]\{[\d,]*\} parameter\((\d+)\)",
                         entry):
        dims = tuple(int(d) for d in m.group(1).split(",") if d)
        shapes[int(m.group(2))] = dims

    def run(*arrays):
        res = exe.execute_sharded([jax.device_put(a, dev) for a in arrays])
        return np.asarray(res.disassemble_into_single_device_arrays()[0][0])
    return run, [shapes[i] for i in range(len(params))]


def _roles(text: str) -> list:
    """Each entry parameter's role: 'bounds' (the walk's [K, G, G]
    boundaries, sliced at the last pass), 'moves' (the int32 [K, G]
    cumulative moves, whose last column is each plan's), 'stacks'
    (compared with the cutoff), 'norm' (the stacks already divided, the
    value the cutoff selects), 'scales' (scaled into the cutoff) or 'w'
    (the other [G] row, the weights)."""
    entry = text[text.index("ENTRY"):]
    roles = {}
    for name, dtype, dims, i in re.findall(
            r"%([\w.]+) = (\w+)\[([\d,]*)\]\{[\d,]*\} parameter\((\d+)\)",
            entry):
        esc = re.escape(name)
        if dtype == "s32":
            role = "moves"
        elif len(dims.split(",")) == 3:
            role = "bounds"
        elif re.search(rf"compare\(%{esc}\b", entry):
            role = "stacks"
        elif re.search(rf"select\(%[\w.]+, %[\w.]+, %{esc}\)", entry):
            role = "norm"
        elif re.search(rf"multiply\(%{esc}, %broadcast", entry):
            role = "scales"
        else:
            role = "w"
        roles[int(i)] = role
    return [roles[i] for i in range(len(roles))]


def _ir_shapes(dump: str, before: set) -> str:
    """Vector widths, FMAs and horizontal reductions in the lone fusion's
    optimized IR (the file this compile added to the dump)."""
    files = [f for f in glob.glob(os.path.join(dump, "*ir-with-opt.ll"))
             if f not in before]
    if not files:
        return "no IR dumped"
    text = open(max(files, key=os.path.getmtime)).read()
    widths = sorted({int(w) for w in re.findall(r"<(\d+) x float>", text)})
    fmas = len(re.findall(r"@llvm\.fma\.", text)) + len(
        re.findall(r"call .*@llvm\.fmuladd", text))
    red = len(re.findall(r"llvm\.vector\.reduce\.fadd", text))
    return f"vector widths {widths}, fma calls {fmas}, reduce.fadd {red}"


LOOPS = [(vf, ic, epi) for vf in (2, 4, 8) for ic in (1, 2, 4)
         for epi in (0, 2, 4) if epi < vf]


def fma_loop(x, w, vf: int, ic: int, epi: int):
    """LLVM's vectorized loop with every product contracted into its add:
    ``ic`` accumulators of ``vf`` lanes over the whole ``vf * ic`` chunks,
    re-associated into one chain in ``probe_sum_order._chain_order``'s
    chunk order (in order for one pass), folded by halves; an ``epi``-lane
    epilogue seeded with that total, likewise; then the scalar rest."""
    import numpy as np
    from probe_sum_order import _chain_order, _fma, _halves
    f32 = np.float32
    G = len(x)
    iters = G // (vf * ic)
    acc, pos = f32(0), iters * vf * ic
    if iters:
        lanes = [f32(0)] + [f32(-0.0)] * (vf - 1)
        for c in _chain_order(G, vf, ic):
            lanes = [_fma(x[c * vf + l], w[c * vf + l], lanes[l])
                     for l in range(vf)]
        acc = _halves(lanes)
    if epi and G - pos >= epi:
        lanes = [acc] + [f32(-0.0)] * (epi - 1)
        while G - pos >= epi:
            lanes = [_fma(x[pos + l], w[pos + l], lanes[l])
                     for l in range(epi)]
            pos += epi
        acc = _halves(lanes)
    for g in range(pos, G):
        acc = _fma(x[g], w[g], acc)
    return acc


def models_for(G: int) -> dict:
    """Candidate orders of the weighted row: name -> f(norm_row, w)."""
    import numpy as np
    import probe_violation_order as pvo
    from probe_sum_order import _fma, _tree
    f32 = np.float32
    pvo.f32 = f32

    def in_order(x, w, contract):
        acc = f32(0)
        for g in range(len(x)):
            acc = (_fma(x[g], w[g], acc) if contract
                   else f32(acc + f32(x[g] * w[g])))
        return acc
    models = {"in order": lambda x, w: in_order(x, w, True),
              "in order, rounded products": lambda x, w: in_order(x, w,
                                                                  False)}
    if G > 32:
        models["tree"] = lambda x, w: _tree((x * w).astype(f32))
        return models
    for shape in LOOPS:
        if G >= shape[0] * shape[1]:
            models[f"fma loop {shape}"] = (
                lambda x, w, shape=shape: fma_loop(x, w, *shape))
            models[f"rounded loop {shape}"] = (
                lambda x, w, shape=shape: pvo.loop_sum(
                    (x * w).astype(f32), *shape, 0, "halves"))
    return models


def site(roles) -> str:
    """Where the fusion sits in the program: the final scores (the
    stacks already divided), the walk's end (the walk's boundaries
    sliced) or a polish round's end."""
    return ("final" if "norm" in roles else
            "walk end" if "bounds" in roles else "polish")


def at_shape(text: str, G0: int, G: int, K0: int, K: int) -> str:
    """A fusion module read at G0 goals and K0 plans, at G goals and K
    plans (the program's fusions keep their form across goal counts:
    compare ``--dump`` programs)."""
    def dims(m):
        new = {str(G0): str(G), str(K0): str(K)}
        return "[" + ",".join(new.get(d, d) for d in m.group(1).split(","))\
            + "]"
    text = re.sub(r"(?<=f32|s32)\[([\d,]+)\]", dims, text)
    text = re.sub(r"(?<=pred)\[([\d,]+)\]", dims, text)
    text = text.replace(f"[{G0 - 1}:{G0}]", f"[{G - 1}:{G}]")
    text = text.replace(f"[0:{G0}]", f"[0:{G}]").replace(
        f"[0:{K0}]", f"[0:{K}]")
    return text


def _structure(text: str) -> str:
    """A module's text without metadata, its instructions renamed in the
    order they are defined (XLA's names differ between programs)."""
    text = re.sub(r", metadata=\{[^}]*\}", "", text)
    names = {}
    for m in re.finditer(r"%([\w.\-]+)", text):
        names.setdefault(m.group(1), f"%v{len(names)}")
    text = re.sub(r"%([\w.\-]+)", lambda m: names[m.group(1)], text)
    return re.sub(r"\b(param|reduce_sum)_?[\w.]*(?=:)", r"\1", text)


def _constant(text: str, name: str) -> float:
    """The value of the named instruction, a constant or a broadcast of
    one."""
    m = re.search(rf"%{re.escape(name)} = \w+\[[\d,]*\]\{{?[\d,]*\}}? "
                  rf"(constant\(\{{?([^{{}})]+)\}}?\)|broadcast\(%([\w.\-]+)\))",
                  text)
    return float(m.group(2)) if m.group(2) else _constant(text, m.group(3))


def read(module: str, G: int, trials: int, lone_dump: str) -> dict:
    """{weight kind: models matching every trial} of one lone fusion. A
    fusion with a move term (a ``moves`` parameter and its weight, a
    constant of the fusion) is read with the term added after the row,
    contracted (``+ fma move``) or rounded on its own (``+ move``)."""
    import numpy as np
    from probe_sum_order import _fma, _spread
    f32 = np.float32
    run, shapes = compile_module(module, lone_dump)
    roles = _roles(module)
    K = next((s[0] for s in shapes if len(s) >= 2), 1)
    mw = None
    if "moves" in roles:
        mw = f32(_constant(module, re.search(
            r"multiply\(%convert[\w.\-]*, %([\w.\-]+)\)", module).group(1)))
    kinds = ("mixed", "one", "shared")
    if "w" not in roles:
        # every weight equal, a constant of the fusion (1 multiplies
        # nothing: the row is a plain sum)
        m = re.search(r"multiply\(%select[\w.\-]*, %([\w.\-]+)\)", module)
        kinds = (("equal", _constant(module, m.group(1)) if m else 1.0),)
    hits = {}
    for kind in kinds:
        if isinstance(kind, tuple):
            kind, value = kind
            w = np.full(G, value, f32)
        else:
            hard = {"one": np.zeros(G, bool), "shared": np.ones(G, bool),
                    "mixed": np.arange(G) % 3 == 0}[kind]
            w = np.where(hard, f32(1000.0), f32(1.0)).astype(f32)
        rng = np.random.default_rng(G * 10 + len(kind))
        models = models_for(G)
        if mw is not None:
            models = {f"{name} + {how}": (
                lambda x, w, m, f=f, how=how: (
                    _fma(f32(m), mw, f(x, w)) if how == "fma move"
                    else f32(f(x, w) + f32(f32(m) * mw))))
                for name, f in models.items()
                for how in ("fma move", "move")}
        ok = dict.fromkeys(models, True)
        for t in range(trials):
            scales = (_spread(rng, (G,)) % 100 + 1).astype(f32)
            b = (_spread(rng, (K, G)) if t % 2 else
                 ((1 + rng.random((K, G))) * scales * 4).astype(f32))
            b[:, rng.random(G) < 0.2] = 0            # converged goals
            tol = _fma(f32(1e-6), scales, f32(1e-6))
            norm = np.where(b <= tol, f32(0),
                            b / np.maximum(scales, f32(1))).astype(f32)
            bounds = _spread(rng, (K, G, G))
            bounds[:, G - 1, :] = b
            moves = rng.integers(0, 200_000, (K, G)).astype(np.int32)
            feed = dict(norm=norm, stacks=b, w=w, scales=scales,
                        bounds=bounds, moves=moves)
            # a fusion of one plan takes its rows without the plan axis
            got = run(*[feed[r] if len(shape) == feed[r].ndim else feed[r][0]
                        for r, shape in zip(roles, shapes)])
            for name, f in models.items():
                if ok[name]:
                    want = np.array(
                        [f(norm[j], w) if mw is None
                         else f(norm[j], w, moves[j, -1])
                         for j in range(K)], f32)
                    ok[name] = np.array_equal(want, got.reshape(-1))
        hits[kind] = [m for m, v in ok.items() if v]
    return hits


def _form(K: int, mw: float, chain: str) -> str:
    """A program's form, the suffix of its saved fusions: '' for two or
    more plans of mixed weights, '_k1' for one plan, '_mw' with a move
    weight, '_hard' / '_soft' for a chain of equal weights."""
    return (("_k1" if K == 1 else "") + ("_mw" if mw else "")
            + ("" if chain == "mixed" else f"_{chain}"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--programs", default="23,33",
                    help="programs compiled whole, G[:K[:move weight"
                         "[:chain]]] each (K 4, no move weight, the mixed "
                         "chain by default); the first of each form is the "
                         "base the form is read from")
    ap.add_argument("--goals", default="23,24,25,26,27,28,29,30,31,32,33")
    ap.add_argument("--plans", default="4",
                    help="plan counts a form of several plans is read at")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--save", default=None)
    ap.add_argument("--dumps", default=None)
    ap.add_argument("--child", nargs="+", default=None,
                    help="G K move_weight [chain]: compile one program")
    args = ap.parse_args()
    if args.child is not None:
        G, K, mw, *chain = args.child
        _child(int(G), int(K), float(mw), chain[0] if chain else "mixed")
        return 0
    runs = []
    for spec in args.programs.split(","):
        G, K, mw, chain = (spec.split(":") + ["4", "0", "mixed"][
            spec.count(":"):])[:4]
        runs.append((int(G), int(K), float(mw), chain))
    build = os.path.join(ROOT, "build", "row_fusion")
    os.makedirs(build, exist_ok=True)
    root = args.dumps or tempfile.mkdtemp(prefix="row-fusion-", dir=build)

    def where(G, K, mw, chain):
        return os.path.join(root, f"{G}{_form(K, mw, chain).replace('_', '-')}")
    procs = {r: start_dump(*r, where(*r)) for r in runs}
    lone_dump = tempfile.mkdtemp(prefix="lone-row-", dir=build)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    fusions = {r: weighted_fusions(wait_dump(procs[r], where(*r)))
               for r in runs}
    # the base of each form: its first compiled program
    bases = {}
    for r in runs:
        bases.setdefault(_form(*r[1:]), (r, {site(_roles(t)): t
                                            for _n, t in fusions[r]}))
    agree = True
    for r in runs:
        (G0, K, *_), base = bases[_form(*r[1:])]
        G = r[0]
        if G == G0:
            continue
        if not fusions[r]:
            print(f"{r}: no weighted-row fusion: the program holds the row "
                  f"in fusions of another form (past 32 goals XLA's "
                  f"windowed reduce)", flush=True)
        for _n, t in fusions[r]:
            same = _structure(t) == _structure(at_shape(
                base[site(_roles(t))], G0, G, K, K))
            agree &= same
            print(f"{r} {site(_roles(t))}: the program's fusion "
                  f"{'equals' if same else 'DIFFERS FROM'} the base's at "
                  f"{G} goals", flush=True)
            if not same:
                print(t, flush=True)
    results = {}
    for form, ((G0, K0, *_), base) in bases.items():
        for K in ([1] if K0 == 1 else [int(k) for k in args.plans.split(",")]):
            for G in [int(g) for g in args.goals.split(",")]:
                for place, text in sorted(base.items()):
                    module = at_shape(text, G0, G, K0, K)
                    if args.save and K in (1, 4):
                        os.makedirs(args.save, exist_ok=True)
                        name = (f"weighted_row_{place.replace(' ', '_')}_"
                                f"{G}{form}.hlo")
                        with open(os.path.join(args.save, name), "w") as f:
                            f.write(module)
                    hits = read(module, G, args.trials, lone_dump)
                    results[form, G, K, place] = hits
                    common = [m for m in next(iter(hits.values()))
                              if all(m in v for v in hits.values())]
                    print(f"{form or 'mixed'} G={G:2d} K={K:2d} {place:<8} "
                          + " ".join(f"{k} {v[:1]}" for k, v in hits.items())
                          + f"; every kind: {common[:1]}", flush=True)
    checks = []
    if ("", 23, 4, "final") in results:
        checks.append("in order" in results["", 23, 4, "final"]["mixed"])
    if ("", 33, 4, "final") in results:
        checks.append(all("tree" in v for v in
                          results["", 33, 4, "final"].values()))
    holds = agree and all(checks) and bool(checks)
    print(f"route {'holds' if holds else 'fails'}: the programs' fusions "
          f"{'keep' if agree else 'do not keep'} their form across goal "
          f"counts; the lone final fusion gives goal order with FMAs at 23 "
          f"mixed goals and XLA's windowed tree at 33, as the whole program "
          f"does: {checks}", flush=True)
    return 0 if holds else 1


if __name__ == "__main__":
    sys.exit(main())
