"""Search-hyperparameter auto-tuning: learned, scenario-aware schedules
per shape bucket.

Port of ``cruise_control_tpu/analyzer/tuning.py`` (host code only):

- :class:`SuccessiveHalvingTuner`: seeded random sampling over the tunable
  ``SearchConfig`` fields plus successive halving — evaluate the whole
  candidate pool at a small budget, keep the faster feasible half,
  re-evaluate the survivors at a larger budget, repeat. The incumbent (the
  base config) is always in the pool and never eliminated, and a
  quality/move-count constraint relative to it keeps a "fast because it
  gave up" config infeasible;
- :class:`TunedConfigStore`: tuned field overrides persisted per *shape
  bucket* (power-of-two broker x partition buckets), versioned by
  ``TUNED_CONFIG_VERSION``. ``TorchGoalOptimizer._prepare`` applies the
  store before the tiny-model clamp, so every model in a bucket resolves
  to one scaled config.

The store's default file lies in the checkout's git-ignored ``build/``
directory. The tuner is driven by benchmark runs, not the serving path.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .constraint import SearchConfig

LOG = logging.getLogger(__name__)

#: where tuned configs persist by default: inside the checkout, git-ignored
DEFAULT_STORE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "tuned")

#: Version of the persisted tuned-config format AND of the SearchConfig
#: field semantics the stored overrides assume. Bump when a tuned field
#: changes meaning — old files are then ignored (logged), so a signature
#: change retires stale entries predictably instead of mixing them with
#: fresh ones.
TUNED_CONFIG_VERSION = 1

#: The tunable SearchConfig fields and their sampling ranges: the
#: schedule knobs — swap-batch size, walk length
#: (iteration cap), polish budget, candidate pool sizes, drain batch.
#: Everything else in SearchConfig is semantics (epsilon, fused mode),
#: not schedule, and stays fixed.
TUNABLE_FIELDS: dict[str, tuple[int, int]] = {
    "num_replica_candidates": (64, 4096),
    "num_dest_candidates": (4, 64),
    "num_swap_candidates": (32, 2048),
    "apply_per_iter": (64, 4096),
    "drain_batch": (1024, 65536),
    "max_iters_per_goal": (32, 1024),
    "polish_passes": (0, 3),
}


def plan_quality(result, hard_weight: float = 1000.0) -> float:
    """Scalar plan-quality score of an ``OptimizerResult`` (lower is
    better): the weighted joint objective over the final violation
    stacks — THE scoring convention shared by the tuner's feasibility
    test, the multiobj bench gates, and the population A/B tests. One
    definition so they can never silently score on different
    objectives."""
    from .engine import weighted_objective
    stacks = np.asarray([[g.violation_after for g in result.goal_results]],
                        np.float32)
    scales = np.asarray([g.scale for g in result.goal_results], np.float32)
    hard = np.asarray([g.hard for g in result.goal_results])
    return float(weighted_objective(stacks, scales, hard,
                                    hard_weight=hard_weight)[0])


def shape_bucket(num_partitions: int, num_brokers: int,
                 regime: str | None = None) -> str:
    """Power-of-two shape bucket key, e.g. ``b128p32768`` — the
    granularity tuned configs persist at (shared with the population
    K-bucket rule via ``parallel.batching.pow2_bucket``). A traffic
    ``regime`` (workload/regime.py's vocabulary) qualifies the key —
    ``b128p32768@flash_crowd`` — so the continuous tuning loop persists
    one schedule per (shape, regime) pair; lookups fall back to the
    un-regimed bucket when the pair is untuned."""
    from ..parallel.batching import pow2_bucket
    base = f"b{pow2_bucket(num_brokers)}p{pow2_bucket(num_partitions)}"
    return f"{base}@{regime}" if regime else base


class TunedConfigStore:
    """Per-shape-bucket tuned ``SearchConfig`` overrides + trial history,
    persisted as one JSON file.

    Thread-safe, best-effort on IO: an unreadable/unwritable store file
    degrades to the base config (the optimizer must come up regardless —
    same contract as ``enable_compilation_cache``)."""

    def __init__(self, path: str | None = None):
        self.path = path or self.default_path()
        self._lock = threading.Lock()
        self._buckets: dict[str, dict] = {}
        self._load()

    @staticmethod
    def default_path() -> str:
        return os.path.join(DEFAULT_STORE_DIR, f"v{TUNED_CONFIG_VERSION}",
                            "search_configs.json")

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if data.get("version") != TUNED_CONFIG_VERSION:
            LOG.warning(
                "ignoring tuned search configs at %s: version %s != %d "
                "(stale format — re-tune to regenerate)",
                self.path, data.get("version"), TUNED_CONFIG_VERSION)
            return
        buckets = data.get("buckets")
        if isinstance(buckets, dict):
            self._buckets = buckets
            LOG.info("loaded tuned search configs for %d shape "
                     "bucket(s) from %s", len(buckets), self.path)

    def save(self) -> str | None:
        """Persist (best-effort). Returns the path written, or None."""
        with self._lock:
            # Snapshot INSIDE the lock: json.dump below iterates outside
            # it, and a concurrent record() replacing entries would blow
            # up mid-serialization (entry payloads are replaced
            # wholesale, never mutated in place, so a per-entry shallow
            # copy is a consistent snapshot).
            payload = {"version": TUNED_CONFIG_VERSION,
                       "buckets": {k: dict(v)
                                   for k, v in self._buckets.items()}}
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            return self.path
        except OSError as exc:
            LOG.warning("could not persist tuned search configs to %s: "
                        "%s", self.path, exc)
            return None

    def lookup(self, num_partitions: int, num_brokers: int, *,
               regime: str | None = None,
               fallback: bool = True) -> dict | None:
        """Tuned field overrides for this shape's bucket, or None.
        With a ``regime``, the regime-qualified entry wins; an untuned
        pair falls back to the un-regimed bucket (``fallback=False``
        disables that — the tuning loop's "has this pair been tuned"
        probe). Values are validated, not just keys: a corrupted or
        hand-edited store (string/negative/bool values) must DEGRADE to
        the base config with a warning — the class contract — not crash
        the first optimize at trace time."""
        bucket = shape_bucket(num_partitions, num_brokers, regime=regime)
        with self._lock:
            entry = self._buckets.get(bucket)
            if entry is None and regime and fallback:
                bucket = shape_bucket(num_partitions, num_brokers)
                entry = self._buckets.get(bucket)
        if not entry or not isinstance(entry.get("fields"), dict):
            return None
        fields, bad = {}, []
        for k, v in entry["fields"].items():
            if k not in TUNABLE_FIELDS:
                continue
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                bad.append(f"{k}={v!r}")
                continue
            fields[k] = v
        if bad:
            LOG.warning(
                "tuned search config %s[%s]: dropping invalid field "
                "value(s) %s (expected non-negative ints — re-tune to "
                "regenerate)", self.path, bucket, ", ".join(bad))
        return fields

    def apply(self, cfg: SearchConfig, num_partitions: int,
              num_brokers: int, *,
              regime: str | None = None) -> SearchConfig:
        """``cfg`` with this bucket's tuned overrides folded in (identity
        when the bucket is untuned; with a ``regime``, the qualified
        entry wins over the plain bucket). Callers apply this BEFORE
        ``scaled_for`` so the tiny-model clamp still bounds whatever the
        tuner picked."""
        fields = self.lookup(num_partitions, num_brokers, regime=regime)
        if not fields:
            return cfg
        return replace(cfg, **fields)

    def record(self, num_partitions: int, num_brokers: int,
               fields: dict, history: list | None = None,
               save: bool = True, regime: str | None = None) -> str:
        """Store tuned ``fields`` (a TUNABLE_FIELDS subset) for the
        shape's bucket — regime-qualified when ``regime`` is given —
        with the tuner's trial history; returns the bucket key."""
        unknown = set(fields) - set(TUNABLE_FIELDS)
        if unknown:
            raise ValueError(f"not tunable SearchConfig fields: "
                             f"{sorted(unknown)}")
        bucket = shape_bucket(num_partitions, num_brokers, regime=regime)
        with self._lock:
            self._buckets[bucket] = {
                "fields": dict(fields),
                "tunedAtMs": int(time.time() * 1000),
                "shapes": {"numPartitions": num_partitions,
                           "numBrokers": num_brokers},
                "regime": regime,
                "history": list(history or []),
            }
        if save:
            self.save()
        return bucket

    def to_json(self) -> dict:
        """The /devicestats ``tuning`` payload: per-bucket tuned fields
        and trial history."""
        with self._lock:
            return {"version": TUNED_CONFIG_VERSION, "path": self.path,
                    "buckets": {k: dict(v)
                                for k, v in self._buckets.items()}}

    def __len__(self) -> int:
        with self._lock:
            return len(self._buckets)


@dataclass
class Trial:
    """One tuner evaluation: candidate fields + measured outcome."""

    fields: dict
    rung: int
    wall_s: float
    quality: float
    moves: int
    feasible: bool
    incumbent: bool = False

    def to_json(self) -> dict:
        return {"fields": dict(self.fields), "rung": self.rung,
                "wallClockS": round(self.wall_s, 4),
                "quality": round(self.quality, 6), "moves": self.moves,
                "feasible": self.feasible, "incumbent": self.incumbent}


@dataclass
class SuccessiveHalvingTuner:
    """Random search + successive halving over ``TUNABLE_FIELDS``.

    ``evaluate(fields, rung, repeats) -> {"wall_s", "quality", "moves"}``
    is injected: it must build/run the candidate schedule and report the
    warm wall-clock (best of ``repeats``), a scalar plan-quality score
    (lower is better — the weighted joint objective over final violation
    stacks), and the move count. Rung r re-evaluates the surviving pool
    with ``r + 1`` repeats, so noise shrinks exactly where decisions
    tighten (the multi-fidelity trick of arxiv 1612.00383's
    budget-constrained loop, without a GP surrogate).

    Feasibility vs the incumbent: a candidate whose quality exceeds
    ``incumbent_quality * quality_tolerance + 1e-9`` or whose move count
    exceeds ``incumbent_moves * move_tolerance`` is ranked behind every
    feasible candidate regardless of speed — "fast because it gave up"
    never wins. The incumbent itself always survives, so ``tune``
    returns ``{}`` (keep the base schedule) when nothing beats it.
    """

    evaluate: object
    trials: int = 8
    rungs: int = 2
    seed: int = 0
    quality_tolerance: float = 1.02
    move_tolerance: float = 1.5
    history: list = field(default_factory=list)

    def sample(self, rng) -> dict:
        """One candidate: log-uniform draws over each tunable range
        (schedule knobs are scale-ish quantities), snapped to the power
        of two at or below the draw so candidate configs land on a small
        lattice — repeat tuning runs re-visit comparable points."""
        fields = {}
        for name, (lo, hi) in TUNABLE_FIELDS.items():
            if name == "polish_passes":
                fields[name] = int(rng.integers(lo, hi + 1))
                continue
            draw = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            snapped = 1 << int(np.log2(max(draw, 1)))
            fields[name] = int(min(max(snapped, lo), hi))
        return fields

    def tune(self) -> tuple[dict, list]:
        """Run the halving loop; returns ``(best_fields, history)`` where
        ``best_fields`` is ``{}`` when the incumbent (the evaluator's
        base schedule) won."""
        rng = np.random.default_rng(self.seed)
        pool: list[dict] = [{}]            # {} = the incumbent schedule
        seen = {()}
        while len(pool) < max(self.trials, 1):
            cand = self.sample(rng)
            sig = tuple(sorted(cand.items()))
            if sig in seen:
                continue
            seen.add(sig)
            pool.append(cand)
        self.history = []
        for rung in range(max(self.rungs, 1)):
            results = []
            incumbent_metrics = None
            for cand in pool:
                out = self.evaluate(cand, rung, rung + 1)
                results.append((cand, out))
                if not cand:
                    incumbent_metrics = out
            assert incumbent_metrics is not None   # pool[0] is always {}
            q_ref = incumbent_metrics["quality"]
            m_ref = max(int(incumbent_metrics["moves"]), 1)
            ranked = []
            for i, (cand, out) in enumerate(results):
                feasible = (
                    out["quality"] <= q_ref * self.quality_tolerance + 1e-9
                    and out["moves"] <= m_ref * self.move_tolerance)
                trial = Trial(fields=cand, rung=rung,
                              wall_s=float(out["wall_s"]),
                              quality=float(out["quality"]),
                              moves=int(out["moves"]),
                              feasible=feasible, incumbent=not cand)
                self.history.append(trial)
                ranked.append((not (feasible or not cand),
                               float(out["wall_s"]), i, cand))
            ranked.sort(key=lambda t: t[:3])
            keep = max(len(pool) // 2, 1)
            pool = [cand for _, _, _, cand in ranked[:keep]]
            if not any(not c for c in pool):
                pool.append({})             # the incumbent never dies
        best = pool[0]                      # rank winner of the last rung
        return best, [t.to_json() for t in self.history]


def make_optimizer_evaluator(model, metadata, *, base: SearchConfig
                             | None = None, goals=None,
                             constraint=None, options=None):
    """The benchmark evaluator: builds a fresh ``TorchGoalOptimizer`` on the
    model's device per candidate schedule, runs one warm-up pass and
    ``repeats`` timed runs, and scores plan quality with the weighted joint
    objective the population search selects on (:func:`plan_quality`)."""
    from .optimizer import TorchGoalOptimizer
    from .options import OptimizationOptions

    base = base or SearchConfig()
    options = options or OptimizationOptions(skip_hard_goal_check=True)

    def evaluate(fields: dict, rung: int, repeats: int) -> dict:
        cfg = replace(base, **fields) if fields else base
        opt = TorchGoalOptimizer(goals=goals, constraint=constraint,
                                 config=cfg, device=model.device)
        opt.optimize(model, metadata, options)         # warm-up
        best_s, last = float("inf"), None
        for r in range(max(repeats, 1)):
            _sync(model.device)
            t0 = time.monotonic()
            last = opt.optimize(model, metadata, replace(
                options, seed=options.seed + 1 + r))
            _sync(model.device)
            best_s = min(best_s, time.monotonic() - t0)
        return {"wall_s": best_s, "quality": plan_quality(last),
                "moves": last.num_moves}

    return evaluate


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune(model, metadata, *, base: SearchConfig | None = None,
             store: TunedConfigStore | None = None, trials: int = 8,
             rungs: int = 2, seed: int = 0, goals=None, constraint=None,
             options=None, save: bool = True,
             regime: str | None = None):
    """End-to-end tuning for one bench scenario: successive-halving over
    the schedule space, winner recorded into the store under the
    scenario's shape bucket (regime-qualified when the continuous loop
    passes the active ``regime``). Returns ``(fields, history,
    bucket)`` — ``fields`` empty when the base schedule won."""
    base = base or SearchConfig()
    tuner = SuccessiveHalvingTuner(
        evaluate=make_optimizer_evaluator(model, metadata, base=base,
                                          goals=goals,
                                          constraint=constraint,
                                          options=options),
        trials=trials, rungs=rungs, seed=seed)
    fields, history = tuner.tune()
    bucket = shape_bucket(metadata.num_partitions, metadata.num_brokers,
                          regime=regime)
    if store is not None:
        bucket = store.record(metadata.num_partitions,
                              metadata.num_brokers, fields,
                              history=history, save=save, regime=regime)
    return fields, history, bucket
