"""Read, then probe, the float32 order in which XLA's CPU backend sums a
goal's violation row, which the PyTorch port reproduces
(``cruise_control_tpu_torch/utils/ordered.py:vector_loop_sum``).

A goal's violation is ``jnp.sum`` of a per-broker penalty row of B1 =
padded brokers + 1 elements, fused with the penalty's element-wise
producer. XLA's CPU backend emits that fusion as a loop, and LLVM's loop
vectorizer picks its order per program: a main loop of VF lanes by IC
interleaved accumulators, an optional vector epilogue, and a scalar
remainder. Which one depends on the width and on how the row is loaded (a
contiguous count plane, a strided column of ``util[B1, 4]``, two strided
columns for a capacity bound).

For each goal of the catalog and each width the script

1. dumps the jitted ``goal.violation`` (``XLA_FLAGS=--xla_dump_to``) and
   reads the fusion's optimized LLVM IR (``*reduce_fusion*.ir-with-opt.ll``)
   symbolically: every ``fadd reassoc`` and ``llvm.vector.reduce.fadd`` as a
   node over the row's elements. It prints the vector-loop shapes (VF, IC,
   epilogue lanes) whose order is that tree, or ``loop`` where the row is
   not unrolled (B1 > 32: XLA's windowed tree);
2. feeds penalty rows spread over 30 binades through the compiled program
   and through numpy models of the read shape, with each of three
   lowerings of the horizontal ``reduce.fadd`` (lanes folded by halves,
   pairwise, in order), and prints the lowerings that matched every trial;
3. with ``--batched S``, does both for ``jax.vmap(goal.violation)`` over S
   scenarios, the what-if scorer's row sums.

Runs on the CPU (JAX only; no accelerator):

    JAX_PLATFORMS=cpu python scripts/probe_violation_order.py \\
        [--widths 23,24,32] [--trials N] [--batched S] [--dump DIR]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import tempfile

f32 = None   # numpy.float32, bound in main()


# ---------------------------------------------------------------------------
# Symbolic reading of the optimized LLVM IR
# ---------------------------------------------------------------------------

_INST = re.compile(r"^\s*(%[\w.]+) = (.*)$")
_CASTS = ("sitofp", "uitofp", "trunc", "zext", "sext", "fpext", "fptrunc",
          "bitcast", "fptosi", "fptoui")


def _split_args(s):
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "(<[{"
        depth -= ch in ")>]}"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _type(t):
    """(bytes per element, lanes or None) of an LLVM type."""
    m = re.match(r"<(\d+) x (\w+)>", t.strip())
    base = m.group(2) if m else t.strip()
    return ({"i1": 1, "i8": 1, "i32": 4, "float": 4, "i64": 8,
             "double": 8, "ptr": 8}[base], int(m.group(1)) if m else None)


class _Reader:
    """Interprets one kernel: pointers are ``('ptr', buffer, byte offset)``
    (dynamic offsets, such as a scenario row's start, are dropped);
    vectors are lists of lane terms. A term is None (a constant), a
    frozenset of (buffer, element) leaves (element-wise in one element),
    ``('+', a, b)`` (an ``fadd reassoc``) or ``('h', lanes)`` (a
    horizontal ``llvm.vector.reduce.fadd``)."""

    def __init__(self):
        self.env = {"%0": ("ptr", "arg", 0)}
        self.stores = []
        self.loop = False

    def val(self, tok, width=None):
        m = re.match(r"^(<\d+ x \w+>|float|double|i\d+|ptr)\s+(.*)$",
                     tok.strip())
        if m:
            width = _type(m.group(1))[1] or width
            tok = m.group(2)
        tok = tok.strip()
        if tok.startswith("%"):
            return self.env[tok]
        return [None] * width if width else None

    @staticmethod
    def merge(terms):
        leaves, sums = set(), []
        for t in terms:
            if isinstance(t, frozenset):
                leaves |= t
            elif t is not None:
                sums.append(t)
        if len(sums) > 1:
            raise ValueError("an element-wise op over two partial sums")
        # a select of a partial sum against its lane mask keeps the sum
        return sums[0] if sums else (frozenset(leaves) or None)

    def lanewise(self, args):
        vecs = [a for a in args if isinstance(a, list)]
        if not vecs:
            return self.merge(args)
        return [self.merge([a[i] if isinstance(a, list) else a
                            for a in args]) for i in range(len(vecs[0]))]

    def ival(self, tok):
        """The constant part of a scalar integer (an index): dynamic parts,
        such as a scenario row's start, count as 0."""
        tok = tok.strip().split()[-1]
        if tok.startswith("%"):
            v = self.env.get(tok)
            return v[1] if isinstance(v, tuple) and v[0] == "int" else 0
        return int(tok) if re.fullmatch(r"-?\d+", tok) else 0

    def add(self, a, b):
        if isinstance(a, list):
            return [self.add(x, y) for x, y in zip(a, b)]
        return b if a is None else a if b is None else ("+", a, b)

    def run(self, text):
        for line in text.splitlines():
            m = _INST.match(line)
            if m:
                rhs = re.sub(r", align \d+|, !\S+ !\d+", "", m.group(2))
                self.env[m.group(1)] = self.inst(rhs)
            elif line.strip().startswith("store float"):
                self.stores.append(self.val(
                    _split_args(line.strip()[6:])[0]))
        return self.stores

    def inst(self, rhs):
        op = rhs.split()[0]
        if op == "phi":
            if re.match(r"phi (float|<)", rhs):
                self.loop = True          # a float accumulator in a loop
            return ("int", 0)
        m = re.match(r"(add|sub|mul|shl|or) ((nuw|nsw|disjoint) )*i(32|64) "
                     r"(.*)$", rhs)
        if m:
            a, b = (self.ival(x) for x in _split_args(m.group(5)))
            return ("int", {"add": a + b, "or": a + b, "sub": a - b,
                            "mul": a * b, "shl": a << b}[m.group(1)])
        if op == "getelementptr":
            args = _split_args(re.sub(r"^getelementptr (inbounds |nuw )*",
                                      "", rhs))
            base = self.val(args[1])
            off = sum(self.ival(a) for a in args[2:])
            scale = _type(args[0])[0] if len(args) == 3 else 1
            return ("ptr", base[1], base[2] + off * scale)
        if op == "load":
            t, p = _split_args(rhs[5:])[:2]
            p = self.val(p)
            if t == "ptr":
                return ("ptr", (p[1], p[2]), 0)
            nb, w = _type(t)
            first = p[2] // nb
            if w:
                return [frozenset([(p[1], first + k)]) for k in range(w)]
            return frozenset([(p[1], first)])
        if op == "shufflevector":
            a, b, mask = _split_args(rhs[14:])
            a, b = self.val(a), self.val(b)
            pool = (a if isinstance(a, list) else [a]) + \
                (b if isinstance(b, list) else [])
            w = _type(mask[:mask.index(">") + 1])[1]
            if "zeroinitializer" in mask:
                idx = [0] * w
            else:
                idx = [None if ("poison" in x or "undef" in x)
                       else int(x.split()[-1]) for x in
                       _split_args(mask[mask.index("<", 1) + 1:
                                        mask.rindex(">")])]
            return [None if i is None or i >= len(pool) else pool[i]
                    for i in idx]
        if op == "insertelement":
            v, x, i = _split_args(rhs[14:])
            t = v[:v.index(">") + 1]
            v = self.val(v)
            v = list(v) if isinstance(v, list) else [None] * _type(t)[1]
            v[int(i.split()[-1])] = self.val(x)
            return v
        if op == "extractelement":
            v, i = _split_args(rhs[15:])
            return self.val(v)[int(i.split()[-1])]
        if op == "fadd" and re.match(r"fadd (reassoc|fast)", rhs):
            body = re.sub(r"^fadd ((reassoc|fast|nnan|ninf|nsz|arcp|contract"
                          r"|afn) )+", "", rhs)
            t = body[:body.index(">") + 1] if body.startswith("<") else \
                body.split()[0]
            a, b = _split_args(body[len(t):])
            w = _type(t)[1]
            return self.add(self.val(a, w), self.val(b, w))
        m = re.match(r"(tail )?call (\w+ )*(\S+|<[^>]+>) @([\w.]+)\((.*)\)",
                     rhs)
        if m:
            args = _split_args(m.group(5))
            if m.group(4).startswith("llvm.vector.reduce.fadd"):
                if self.val(args[0]) is not None:
                    raise ValueError("a horizontal sum with a start value")
                return ("h", self.val(args[1]))
            return self.lanewise([self.val(a) for a in args])
        rest = re.sub(r"^((nuw|nsw|exact|disjoint|nneg|reassoc|nnan|ninf|nsz"
                      r"|arcp|contract|afn|fast|samesign)\s+)+", "",
                      rhs.split(" ", 1)[1])
        if op in ("fcmp", "icmp"):
            rest = rest.split(" ", 1)[1]
        if op in _CASTS:
            v = self.val(rest.split(" to ")[0])
            if isinstance(v, tuple) and v[0] == "int":
                return v
            return v
        if op == "fneg":
            return self.val(rest)
        if op == "select":
            return self.lanewise([self.val(a) for a in _split_args(rest)])
        t = rest[:rest.index(">") + 1] if rest.startswith("<") else \
            rest.split()[0]
        w = _type(t)[1]
        return self.lanewise([self.val(a, w)
                              for a in _split_args(rest[len(t):])])


def _first(t):
    if isinstance(t, int):
        return t
    return min(_first(x) for x in (t[1:] if t[0] == "+" else t[1]))


def _plus(a, b):
    if a is None or b is None:
        return b if a is None else a
    return ("+",) + tuple(sorted((a, b), key=_first))


def read_trees(text, n):
    """Each float store of a kernel as a canonical tree over the row's
    elements 0..n-1 (ints; '+' operands ordered, which IEEE addition
    allows); None where the row is summed in a loop."""
    r = _Reader()
    stores = r.run(text)
    if r.loop:
        return None
    seen = {}

    def scan(t):
        if isinstance(t, frozenset):
            for buf, i in t:
                seen.setdefault(buf, set()).add(i)
        elif isinstance(t, (list, tuple)):
            for x in t:
                scan(x)
    scan(stores)
    # a column of util[..., B1, 4] is read at one residue mod 4; a plane
    # [..., B1] at consecutive elements; a bound at one element
    width = {buf: 4 if len({i % 4 for i in idx}) == 1 else 1
             for buf, idx in seen.items()}

    def row(leaf):
        buf, i = leaf
        if len(seen[buf]) == 1:
            return None                   # a scalar operand (a bound)
        return i // width[buf] % n

    def canon(t):
        if t is None:
            return None
        if isinstance(t, frozenset):
            rows = {row(x) for x in t} - {None}
            if len(rows) > 1:
                raise ValueError(f"an element over rows {sorted(rows)}")
            return rows.pop() if rows else None
        if t[0] == "+":
            return _plus(canon(t[1]), canon(t[2]))
        return ("h", tuple(canon(x) for x in t[1]))
    return [canon(s) for s in stores]


def loop_tree(n, vf, ic, epi, scalar_tail):
    """The tree of LLVM's vectorized reduction loop over n elements: the
    main loop's ``ic`` accumulators of ``vf`` lanes (the init enters lane 0
    of the first), combined as ``((a0 + a1) + a2) + ...`` and reduced
    horizontally; an epilogue of ``epi`` lanes seeded with that total in
    lane 0 and reduced again; then the scalar remainder in order.
    ``scalar_tail``: a strided (gapped) load keeps at least one element
    for the scalar loop, so a loop whose count divides evenly runs one
    vector iteration fewer."""
    s, pos = None, 0
    if vf > 1 and ic:
        chunk = vf * ic
        iters = (n - scalar_tail) // chunk
        if iters:
            acc = [[None] * vf for _ in range(ic)]
            for it in range(iters):
                for k in range(ic):
                    for lane in range(vf):
                        acc[k][lane] = _plus(acc[k][lane],
                                             it * chunk + k * vf + lane)
            v = acc[0]
            for k in range(1, ic):
                v = [_plus(x, y) for x, y in zip(v, acc[k])]
            s, pos = ("h", tuple(v)), iters * chunk
    if epi and n - pos - scalar_tail >= epi:
        v = [s] + [None] * (epi - 1)
        while n - pos - scalar_tail >= epi:
            v = [_plus(x, pos + lane) for lane, x in enumerate(v)]
            pos += epi
        s = ("h", tuple(v))
    while pos < n:
        s = _plus(s, pos)
        pos += 1
    return s


SHAPES = [(1, 0, 0, 0)] + [(vf, ic, epi, tail) for vf in (4, 8, 16)
                           for ic in (1, 2, 4) for epi in (0, 4, 8)
                           for tail in (0, 1) if epi <= vf]


def shapes_of(tree, n):
    """The simplest (vf, ic, epi, scalar_tail) shapes whose order is
    ``tree``: in order first, then the fewest lanes."""
    return [s for s in SHAPES if loop_tree(n, *s) == tree]


# ---------------------------------------------------------------------------
# numpy models of the order, for the value probe
# ---------------------------------------------------------------------------

def _hsum(v, how):
    v = list(v)
    if how == "halves":
        while len(v) > 1:
            h = len(v) // 2
            v = [f32(v[k] + v[k + h]) for k in range(h)]
        return v[0]
    if how == "pairs":
        while len(v) > 1:
            v = [f32(v[k] + v[k + 1]) for k in range(0, len(v), 2)]
        return v[0]
    acc = v[0]
    for x in v[1:]:
        acc = f32(acc + x)
    return acc


def loop_sum(x, vf, ic, epi, scalar_tail, how):
    """float32 value of :func:`loop_tree`'s order, the horizontal sums
    lowered ``how``."""
    import numpy as np
    n = len(x)
    s, pos = f32(0), 0
    if vf > 1 and ic:
        iters = (n - scalar_tail) // (vf * ic)
        if iters:
            acc = np.zeros((ic, vf), np.float32)
            for it in range(iters):
                for k in range(ic):
                    base = (it * ic + k) * vf
                    acc[k] = acc[k] + x[base:base + vf]
            v = acc[0]
            for k in range(1, ic):
                v = v + acc[k]
            s, pos = _hsum(v, how), iters * vf * ic
    if epi and n - pos - scalar_tail >= epi:
        v = np.zeros(epi, np.float32)
        v[0] = s
        while n - pos - scalar_tail >= epi:
            v = v + x[pos:pos + epi]
            pos += epi
        s = _hsum(v, how)
    while pos < n:
        s = f32(s + x[pos])
        pos += 1
    return s


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------

GOALS = ("ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "NetworkInboundUsageDistributionGoal",
         "NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal",
         "ReplicaCapacityGoal", "DiskCapacityGoal",
         "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
         "CpuCapacityGoal")
#: capacity thresholds that leave many brokers over their bound
THRESHOLDS = dict(capacity_threshold=(0.3, 0.3, 0.3, 0.3),
                  max_replicas_per_broker=40)


def _shapes(G, S, constraint):
    """IntervalGoal shapes over the other planes the catalog reads: leader
    counts (both bounds), the leaders' NW_IN (upper bound only) and the
    potential NW_OUT against a per-broker capacity bound."""
    class LeaderCount(G.IntervalGoal):
        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1, integer=True)

    class LeaderNwIn(G.IntervalGoal):
        upper_only = True

        def bounds(self, state, ctx):
            return self._avg_bounds(state, ctx, 1.1, upper_only=True)

    class PotentialNwOut(G.IntervalGoal):
        upper_only = True

        def bounds(self, state, ctx):
            upper = ctx.broker_capacity[:, 2] * 0.03
            return upper * float("-inf"), upper
    return [LeaderCount("LeaderCount", S.METRIC_LEADER_COUNT, hard=False,
                        constraint=constraint),
            LeaderNwIn("LeaderNwIn", S.METRIC_LEADER_NW_IN, hard=False,
                       constraint=constraint),
            PotentialNwOut("PotentialNwOut", S.METRIC_POTENTIAL_NW_OUT,
                           hard=False, constraint=constraint)]


def _model(n_brokers, seed):
    """A skewed cluster of n_brokers (pad multiple 1: B1 = n_brokers + 1)."""
    import numpy as np
    from cruise_control_tpu.model import spec
    rng = np.random.default_rng(seed)
    brokers = [spec.BrokerSpec(broker_id=i, rack=f"r{i % 4}",
                               capacity=(100.0, 1e5, 1e5, 1e6))
               for i in range(n_brokers)]
    parts = []
    for p in range(40 * n_brokers):
        pool = max(n_brokers // 5, 2) if p % 2 == 0 else n_brokers
        reps = rng.choice(pool, size=2, replace=False).tolist()
        parts.append(spec.PartitionSpec(
            topic=f"t{p % 8}", partition=p, replicas=reps,
            leader_load=(0.02 + 0.02 * rng.random(), 5 + 10 * rng.random(),
                         8 + 15 * rng.random(), 50 + 100 * rng.random())))
    model, _ = spec.flatten_spec(spec.ClusterSpec(brokers=brokers,
                                                  partitions=parts),
                                 broker_pad_multiple=1)
    return model


def _spread_state(state, rng):
    """The state with every plane the goals read replaced by values spread
    over 30 binades (counts over 24 bits), so that any two summation
    orders give other bits."""
    import jax.numpy as jnp
    import numpy as np
    B1 = state.util.shape[-2]
    lead = state.util.shape[:-2]

    def spread(shape):
        return (rng.random(shape) * 2.0 ** rng.integers(-8, 22, shape)
                ).astype(np.float32)
    counts = (rng.random(lead + (B1,)) * 2.0 ** rng.integers(0, 24, lead + (
        B1,))).astype(np.int32)
    return state.replace(util=jnp.asarray(spread(lead + (B1, 4))),
                         replica_count=jnp.asarray(counts),
                         leader_count=jnp.asarray(counts[..., ::-1].copy()),
                         potential_nw_out=jnp.asarray(spread(lead + (B1,))),
                         leader_nw_in=jnp.asarray(spread(lead + (B1,))))


def probe(widths, trials, batched, dump_dir):
    import jax
    import numpy as np
    from cruise_control_tpu.analyzer import goals as G
    from cruise_control_tpu.analyzer import state as S
    from cruise_control_tpu.analyzer.constraint import BalancingConstraint
    constraint = BalancingConstraint(**THRESHOLDS)
    goals = G.goals_by_name(list(GOALS), constraint) + _shapes(G, S,
                                                                constraint)
    print(f"{'B1':>3} {'goal':<38} {'read from the IR (vf, ic, epi, tail)':<44}"
          f" matched lowerings")
    for n in widths:
        model = _model(n - 1, n)
        state, ctx = S.init_state(model), S.build_context(model)
        if batched:
            stack = lambda t: jax.tree_util.tree_map(
                lambda a: np.broadcast_to(a, (batched,) + a.shape).copy(), t)
            state, ctx = stack(state), stack(ctx)
        rng = np.random.default_rng(n)
        for goal in goals:
            tag = f"probe_{goal.name}_{n}_{batched}"

            def violation(st, cx, goal=goal):
                if batched:
                    return jax.vmap(goal.violation)(st, cx)
                return goal.violation(st, cx)
            violation.__name__ = tag
            run = jax.jit(violation)
            run(state, ctx).block_until_ready()
            files = sorted(glob.glob(os.path.join(
                dump_dir, f"*jit_{tag}.*reduce*ir-with-opt.ll")))
            read = "no reduce fusion"
            shapes = []
            if files:
                trees = read_trees(open(files[-1]).read(), n)
                if trees is None:
                    read = "loop"
                else:
                    shapes = [shapes_of(t, n) for t in trees]
                    read = " | ".join(
                        str(s[0]) if s else "?" for s in shapes)
            # the value probe: the penalty row of the same spread state
            # (computed in one program with its bounds, as the violation's
            # fusion computes it), summed by each lowering of the read shape
            def penalty(st, cx, goal=goal):
                lo, up = goal.bounds(st, cx)
                return goal._penalty(S.metric_values(st, goal.metric), lo,
                                     up, cx.broker_alive)
            pen_fn = jax.jit(jax.vmap(penalty) if batched else penalty)
            matched = {h: True for h in ("halves", "pairs", "in order")}
            for _ in range(trials):
                st = _spread_state(state, rng)
                want = np.asarray(run(st, ctx), np.float32).reshape(-1)
                pen = np.asarray(pen_fn(st, ctx), np.float32).reshape(-1, n)
                shape = (shapes[0][0] if shapes and shapes[0]
                         else (1, 0, 0, 0))
                for h in matched:
                    got = np.array([loop_sum(r, *shape, h) for r in pen],
                                   np.float32)
                    matched[h] &= np.array_equal(got, want)
            print(f"{n:>3} {goal.name:<38} {read:<44} "
                  f"{[h for h, ok in matched.items() if ok] or 'none'}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="23,24,25,32",
                    help="comma-separated B1 row widths (2..32 unroll)")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--batched", type=int, default=0,
                    help="probe jax.vmap(goal.violation) over S scenarios")
    ap.add_argument("--dump", default=None,
                    help="keep XLA's dump in this directory")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="xla_dump_") as scratch:
        dump = args.dump or scratch
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={dump}").strip()
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import jax
        import numpy as np
        global f32
        f32 = np.float32
        print("jax", jax.__version__, "dump", dump)
        probe([int(w) for w in args.widths.split(",")], args.trials,
              args.batched, dump)


if __name__ == "__main__":
    main()
