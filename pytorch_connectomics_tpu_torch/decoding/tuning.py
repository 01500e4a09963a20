"""Decode-parameter tuning, the port's copy of
``pytorch_connectomics_tpu/decoding/tuning.py`` (numpy, host side): search
spaces over decoder parameters (float/int/categorical, log scale), random,
grid, CMA-ES-style and TPE samplers, median and Hyperband pruning, single-
and multi-objective scoring (adapted_rand, voi, jaccard, instance f1,
nerl), a per-trial timeout in a forked process, and the best-params YAML.
One seed gives the JAX package's trial sequence.

TPE is the two-density formulation (good/bad split by objective quantile,
candidates scored by l(x)/g(x)). ``nerl`` skeletonises the ground truth on
every trial, as the JAX package does.

The timeout's child process is forked from a parent that may have
initialised CUDA: an objective works on host arrays and the native ops
only, and never touches a CUDA tensor.
"""

from __future__ import annotations

import copy
import logging
import math
import multiprocessing as mp
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config.schema import TuningConfig, TuningParamConfig
from ..metrics import adapted_rand, compute_nerl, instance_matching, voi
from ..metrics.binary import jaccard_index

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------


@dataclass
class Trial:
    number: int
    params: Dict[str, Any]
    value: Optional[float] = None
    values: Optional[List[float]] = None  # multi-objective
    state: str = "running"  # complete | failed | pruned
    duration: float = 0.0
    user_attrs: Dict[str, Any] = field(default_factory=dict)


# sign convention: +1 = minimize (smaller better), -1 = maximize
_DEFAULT_DIRECTION = {
    "adapted_rand": "minimize",
    "voi": "minimize",
    "voi_split": "minimize",
    "voi_merge": "minimize",
    "nerl": "maximize",
    "instance_f1": "maximize",
    "f1": "maximize",
    "jaccard": "maximize",
}


def _signs(metrics: Sequence[str], directions: Optional[Sequence[str]]) -> List[float]:
    if directions:
        return [1.0 if d != "maximize" else -1.0 for d in directions]
    return [
        1.0 if _DEFAULT_DIRECTION.get(m, "minimize") != "maximize" else -1.0
        for m in metrics
    ]


def pareto_rank(values: np.ndarray) -> np.ndarray:
    """Non-dominated sorting rank (0 = Pareto front) of an (N, M) matrix
    where smaller is better on every column."""
    n = len(values)
    ranks = np.full(n, -1, dtype=int)
    remaining = list(range(n))
    rank = 0
    while remaining:
        front = []
        for i in remaining:
            dominated = False
            for j in remaining:
                if i == j:
                    continue
                if (values[j] <= values[i]).all() and (values[j] < values[i]).any():
                    dominated = True
                    break
            if not dominated:
                front.append(i)
        for i in front:
            ranks[i] = rank
        remaining = [i for i in remaining if i not in front]
        rank += 1
    return ranks


class SearchSpace:
    def __init__(self, params: Sequence[TuningParamConfig]):
        self.params = list(params)

    def sample_random(self, rng: np.random.Generator) -> Dict[str, Any]:
        out = {}
        for p in self.params:
            if p.type == "categorical":
                out[p.name] = p.choices[int(rng.integers(0, len(p.choices)))]
            elif p.type == "int":
                out[p.name] = int(rng.integers(int(p.low), int(p.high) + 1))
            else:
                if p.log:
                    out[p.name] = float(
                        math.exp(rng.uniform(math.log(p.low), math.log(p.high)))
                    )
                else:
                    out[p.name] = float(rng.uniform(p.low, p.high))
                if p.step:
                    out[p.name] = round(out[p.name] / p.step) * p.step
        return out

    def grid(self, points_per_dim: int = 5) -> List[Dict[str, Any]]:
        axes = []
        for p in self.params:
            if p.type == "categorical":
                axes.append([(p.name, c) for c in p.choices])
            elif p.type == "int":
                vals = np.unique(np.linspace(p.low, p.high, points_per_dim).astype(int))
                axes.append([(p.name, int(v)) for v in vals])
            else:
                if p.log:
                    vals = np.exp(np.linspace(math.log(p.low), math.log(p.high), points_per_dim))
                else:
                    vals = np.linspace(p.low, p.high, points_per_dim)
                axes.append([(p.name, float(v)) for v in vals])
        import itertools

        return [dict(combo) for combo in itertools.product(*axes)]


class TrialPruned(Exception):
    """Raised inside an objective by the pruning callback."""


class MedianPruner:
    """Median pruning over intermediate reports (reference MedianPruner via
    ``optuna_tuner.py:1033``): a trial whose running value is worse than the
    median of previous trials' values at the same report step is cut."""

    def __init__(self, n_warmup_trials: int = 4, n_warmup_steps: int = 0):
        self.n_warmup_trials = n_warmup_trials
        self.n_warmup_steps = n_warmup_steps
        self._history: Dict[int, List[float]] = {}  # step -> signed values

    def record(self, step: int, signed_value: float):
        self._history.setdefault(step, []).append(signed_value)

    def should_prune(self, step: int, signed_value: float) -> bool:
        past = self._history.get(step, [])
        if step < self.n_warmup_steps or len(past) < self.n_warmup_trials:
            return False
        return signed_value > float(np.median(past))  # signed: smaller better


class HyperbandPruner:
    """Successive-halving pruning over intermediate reports (reference
    HyperbandPruner via ``optuna_tuner.py:1044``). Rungs sit at resource
    budgets ``min_resource * reduction_factor**k`` (resource = number of
    reports, i.e. volumes evaluated); at each rung a trial survives only if
    its running value is in the best ``1/reduction_factor`` fraction of
    values previously seen at that rung. Optuna's Hyperband runs several
    such brackets; with the handful of per-trial reports decode tuning
    produces, the single aggressive bracket is the part that matters."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3,
                 n_warmup_trials: int = 4):
        self.min_resource = min_resource
        self.eta = reduction_factor
        self.n_warmup_trials = n_warmup_trials
        self._rungs: Dict[int, List[float]] = {}  # budget -> signed values

    def _is_rung(self, budget: int) -> bool:
        b = self.min_resource
        while b < budget:
            b *= self.eta
        return b == budget

    def record(self, step: int, signed_value: float):
        budget = step + 1
        if self._is_rung(budget):
            self._rungs.setdefault(budget, []).append(signed_value)

    def should_prune(self, step: int, signed_value: float) -> bool:
        budget = step + 1
        if not self._is_rung(budget):
            return False
        past = self._rungs.get(budget, [])
        if len(past) < self.n_warmup_trials:
            return False
        # signed: smaller is better; survive only in the top 1/eta fraction
        return signed_value > float(np.quantile(past, 1.0 / self.eta))


class CmaEsSampler:
    """Diagonal evolution-strategy sampler of the CMA family (sequential
    (mu, lambda)-ES with per-dimension step sizes; the full-covariance
    Optuna CmaEs is overkill for <=4 decode params)."""

    def __init__(self, space: SearchSpace, seed: int = 0, population: int = 8, mu: int = 3):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.population = population
        self.mu = mu
        self._float_params = [p for p in space.params if p.type in ("float", "int")]
        self.mean = {p.name: (p.low + p.high) / 2.0 for p in self._float_params}
        self.sigma = {p.name: (p.high - p.low) / 4.0 for p in self._float_params}

    def suggest(self, history: List["Trial"], minimize: bool = True) -> Dict[str, Any]:
        done = [t for t in history if t.state == "complete" and t.value is not None]
        gen = len(done) // self.population
        if gen > 0 and len(done) % self.population == 0:
            # update from the last generation's elite
            last = done[-self.population:]
            key = (lambda t: t.value) if minimize else (lambda t: -t.value)
            elite = sorted(last, key=key)[: self.mu]
            for p in self._float_params:
                vals = np.array([float(t.params[p.name]) for t in elite])
                new_mean = vals.mean()
                spread = max(vals.std(), 1e-12)
                self.sigma[p.name] = 0.5 * self.sigma[p.name] + 0.5 * max(
                    spread, (p.high - p.low) * 0.01
                )
                self.mean[p.name] = new_mean
        out = self.space.sample_random(self.rng)  # categoricals + fallback
        for p in self._float_params:
            v = self.rng.normal(self.mean[p.name], self.sigma[p.name])
            v = float(min(max(v, p.low), p.high))
            if p.step:
                v = round(v / p.step) * p.step
            out[p.name] = int(round(v)) if p.type == "int" else v
        return out


class TPESampler:
    """Tree-structured Parzen estimator (two-density l/g ratio)."""

    def __init__(self, space: SearchSpace, seed: int = 0, gamma: float = 0.25, n_candidates: int = 24):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates

    def suggest(self, history: List[Trial], minimize: bool = True) -> Dict[str, Any]:
        done = [t for t in history if t.state == "complete" and t.value is not None]
        if len(done) < max(5, 2 * len(self.space.params)):
            return self.space.sample_random(self.rng)
        values = np.array([t.value for t in done])
        order = np.argsort(values if minimize else -values)
        n_good = max(1, int(self.gamma * len(done)))
        good = [done[i] for i in order[:n_good]]
        bad = [done[i] for i in order[n_good:]]
        candidates = [self.space.sample_random(self.rng) for _ in range(self.n_candidates)]
        # mutate around good points too
        for g in good[: self.n_candidates // 2]:
            cand = dict(g.params)
            for p in self.space.params:
                if p.type in ("float", "int") and self.rng.random() < 0.7:
                    width = (p.high - p.low) * 0.15
                    v = float(cand[p.name]) + self.rng.normal(0, width)
                    v = min(max(v, p.low), p.high)
                    cand[p.name] = int(round(v)) if p.type == "int" else float(v)
            candidates.append(cand)

        def density(trials, cand):
            logp = 0.0
            for p in self.space.params:
                if p.type == "categorical":
                    counts = sum(1 for t in trials if t.params.get(p.name) == cand[p.name])
                    logp += math.log((counts + 1) / (len(trials) + len(p.choices)))
                else:
                    xs = np.array([float(t.params[p.name]) for t in trials])
                    bw = max((p.high - p.low) * 0.1, 1e-9)
                    k = np.exp(-0.5 * ((cand[p.name] - xs) / bw) ** 2)
                    logp += math.log(max(k.mean(), 1e-12))
            return logp

        scores = [density(good, c) - density(bad, c) for c in candidates]
        return candidates[int(np.argmax(scores))]


# ---------------------------------------------------------------------------
# objective metrics
# ---------------------------------------------------------------------------


def compute_segmentation_metric(
    metric: str, seg: np.ndarray, gt: np.ndarray
) -> float:
    """One tuning metric of ``seg`` against ``gt`` (reference
    ``_compute_segmentation_metric``, ``optuna_tuner.py:185``)."""
    if metric == "adapted_rand":
        return float(adapted_rand(seg, gt))
    if metric == "voi":
        vs, vm = voi(seg, gt)
        return float(vs + vm)
    if metric == "voi_split":
        return float(voi(seg, gt)[0])
    if metric == "voi_merge":
        return float(voi(seg, gt)[1])
    if metric == "nerl":
        return float(compute_nerl(seg, gt)["nerl"])
    if metric in ("instance_f1", "f1"):
        return float(instance_matching(seg, gt)["f1"])
    if metric == "jaccard":
        return float(jaccard_index(seg > 0, gt > 0, from_logits=False))
    raise ValueError(f"unknown tuning metric '{metric}'")


# ---------------------------------------------------------------------------
# tuner
# ---------------------------------------------------------------------------


def _trial_worker(queue, objective, params):
    try:
        queue.put(("ok", objective(params)))
    except Exception as e:  # pragma: no cover
        queue.put(("err", repr(e)))


class DecodingTuner:
    """Search decode params minimizing/maximizing a metric.

    ``decode_fn(params_dict) -> labels`` is built by the caller from the
    decoding config (dotted param names patch ``decoding.*`` paths, e.g.
    ``steps.0.kwargs.threshold``).
    """

    def __init__(self, cfg: TuningConfig, objective: Callable[[Dict[str, Any]], Any]):
        self.cfg = cfg
        self.objective = objective
        self.space = SearchSpace(cfg.params)
        self.metrics: List[str] = list(cfg.metrics) if cfg.metrics else [cfg.metric]
        self.multi = bool(cfg.metrics) and len(self.metrics) > 1
        self.signs = _signs(self.metrics, cfg.directions if cfg.metrics else [cfg.direction])
        self.minimize = self.signs[0] > 0
        self.trials: List[Trial] = []
        self._sampler = None
        if cfg.sampler == "tpe":
            self._sampler = TPESampler(self.space, seed=cfg.seed)
        elif cfg.sampler == "cmaes":
            self._sampler = CmaEsSampler(self.space, seed=cfg.seed)
        self._grid: Optional[List[Dict[str, Any]]] = (
            self.space.grid() if cfg.sampler == "grid" else None
        )
        pruner_name = (cfg.pruner or "").lower()
        self._pruner = (
            MedianPruner() if pruner_name == "median"
            else HyperbandPruner() if pruner_name == "hyperband"
            else None
        )
        self._rng = np.random.default_rng(cfg.seed)

    def _suggest(self, i: int) -> Optional[Dict[str, Any]]:
        if self._grid is not None:
            return self._grid[i] if i < len(self._grid) else None
        if self._sampler is not None:
            if self.multi:
                # TPE over the Pareto rank: non-dominated trials are "good"
                done = [t for t in self.trials if t.state == "complete" and t.values]
                if done:
                    vals = np.array([np.asarray(t.values) * self.signs for t in done])
                    ranks = pareto_rank(vals)
                    surrogate = [
                        Trial(t.number, t.params, value=float(r), state="complete")
                        for t, r in zip(done, ranks)
                    ]
                else:
                    surrogate = []
                return self._sampler.suggest(surrogate, minimize=True)
            return self._sampler.suggest(self.trials, self.minimize)
        return self.space.sample_random(self._rng)

    def _run_objective(self, params: Dict[str, Any]):
        timeout = self.cfg.timeout_per_trial
        if not timeout:
            return self.objective(params)
        # per-trial process timeout (reference ``optuna_tuner.py:436-508``);
        # fork, since the objective is a closure over the host arrays. The
        # result is read before the join: a child blocks on a full pipe
        # until its result is read.
        ctx = mp.get_context("fork")
        q = ctx.Queue()
        proc = ctx.Process(target=_trial_worker, args=(q, self.objective, params))
        proc.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    status, payload = q.get(timeout=max(0.0, min(0.05, deadline - time.monotonic())))
                    break
                except queue.Empty:
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"trial exceeded {timeout}s") from None
                    if not proc.is_alive() and q.empty():
                        raise RuntimeError(f"trial process exited with code {proc.exitcode} and no result")
        finally:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        if status == "err":
            raise RuntimeError(payload)
        return payload

    def _record(self, trial: Trial, result: Any):
        """Normalize objective results: float | sequence of floats (multi-
        objective) | (either, attrs dict)."""
        if isinstance(result, tuple) and len(result) == 2 and isinstance(result[1], dict):
            result, attrs = result
            trial.user_attrs.update(attrs)
        if isinstance(result, (list, tuple, np.ndarray)):
            trial.values = [float(v) for v in result]
            trial.value = trial.values[0]
        else:
            trial.value = float(result)
            if self.multi:
                raise ValueError(
                    f"multi-objective study (metrics={self.metrics}) needs a "
                    "values sequence from the objective, got a scalar"
                )

    def optimize(self, n_trials: Optional[int] = None) -> Trial:
        n = n_trials or self.cfg.n_trials
        if self._grid is not None:
            n = min(n, len(self._grid))
        import inspect

        takes_report = (
            not self.cfg.timeout_per_trial
            and "report" in inspect.signature(self.objective).parameters
        )
        for i in range(n):
            params = self._suggest(i)
            if params is None:
                break
            trial = Trial(number=i, params=params)
            t0 = time.time()

            def report(step: int, value: float):
                """Intermediate-value hook: feeds the pruner (reference
                trial.report + MedianPruner)."""
                if self._pruner is None:
                    return
                signed = self.signs[0] * float(value)
                if self._pruner.should_prune(step, signed):
                    raise TrialPruned(f"step {step}: {value} worse than median")
                self._pruner.record(step, signed)

            try:
                if takes_report:
                    self._record(trial, self.objective(params, report=report))
                else:
                    self._record(trial, self._run_objective(params))
                trial.state = "complete"
            except TrialPruned as e:
                trial.state = "pruned"
                logger.info("trial %d pruned: %s", i, e)
            except Exception as e:
                trial.state = "failed"
                bad = [math.inf if s > 0 else -math.inf for s in self.signs]
                trial.value = bad[0]
                if self.multi:
                    trial.values = bad
                logger.warning("trial %d failed: %s", i, e)
            trial.duration = time.time() - t0
            self.trials.append(trial)
            logger.info(
                "trial %d/%d %s -> %s (%.1fs)",
                i + 1, n, params, trial.values if self.multi else trial.value,
                trial.duration,
            )
        return self.best_trial

    @property
    def best_trials(self) -> List[Trial]:
        """Pareto front (all completed trials in single-objective mode
        collapse to the best one)."""
        done = [t for t in self.trials if t.state == "complete"]
        if not done:
            raise RuntimeError("no completed trials")
        if not self.multi:
            return [self.best_trial]
        vals = np.array([np.asarray(t.values) * self.signs for t in done])
        ranks = pareto_rank(vals)
        return [t for t, r in zip(done, ranks) if r == 0]

    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.state == "complete"]
        if not done:
            raise RuntimeError("no completed trials")
        if self.multi:
            # representative point: best primary metric on the Pareto front
            front = self.best_trials
            return min(front, key=lambda t: self.signs[0] * t.values[0])
        key = (lambda t: t.value) if self.minimize else (lambda t: -t.value)
        return min(done, key=key)

    def save_study(self, path: str | Path):
        """Persist trials + best params (reference best-params YAML,
        ``output_naming.py:626-663``)."""
        import yaml

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        best = self.best_trial
        payload = {
            "best_params": best.params,
            "best_value": best.value,
            "metric": self.metrics[0] if self.multi else self.cfg.metric,
            "direction": self.cfg.direction,
            "n_trials": len(self.trials),
            "trials": [
                {
                    "number": t.number, "params": t.params, "value": t.value,
                    "state": t.state,
                    **({"values": t.values} if t.values else {}),
                    **({"user_attrs": t.user_attrs} if t.user_attrs else {}),
                }
                for t in self.trials
            ],
        }
        if self.multi:
            payload["metrics"] = self.metrics
            payload["directions"] = [
                "minimize" if s > 0 else "maximize" for s in self.signs
            ]
            payload["best_values"] = best.values
            payload["pareto_front"] = [
                {"number": t.number, "params": t.params, "values": t.values}
                for t in self.best_trials
            ]
        if best.user_attrs:
            payload["best_user_attrs"] = best.user_attrs
        path.write_text(yaml.safe_dump(payload))
        return path


def load_best_params(path: str | Path) -> Dict[str, Any]:
    """The ``best_params`` of a study YAML."""
    import yaml

    return yaml.safe_load(Path(path).read_text())["best_params"]


def make_decode_objective(
    prediction: np.ndarray,
    gt: np.ndarray,
    decoding_cfg_dict: Dict[str, Any],
    metric: "str | Sequence[str]" = "adapted_rand",
) -> Callable[[Dict[str, Any]], Any]:
    """Builds the objective: patch decoding config with trial params (dotted
    paths relative to ``decoding``), decode, score against GT. A list of
    metrics makes the objective return a values vector (multi-objective)."""
    from ..config.schema import DecodingConfig, build_dataclass
    from .stage import run_decoding_stage

    metrics = [metric] if isinstance(metric, str) else list(metric)

    def objective(params: Dict[str, Any]):
        d = copy.deepcopy(decoding_cfg_dict)
        for k, v in params.items():
            _set_dotted_with_list_indices(d, k, v)
        cfg = build_dataclass(DecodingConfig, d)
        seg = run_decoding_stage(prediction, cfg)
        vals = [compute_segmentation_metric(m, seg, gt) for m in metrics]
        return vals[0] if len(vals) == 1 else vals

    return objective


def make_multi_volume_objective(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    decoding_cfg_dict: Dict[str, Any],
    metric: "str | Sequence[str]" = "adapted_rand",
) -> Callable[..., Any]:
    """Average the metric over (prediction, gt) volume pairs — each volume
    decoded independently to avoid instance-id collisions (reference
    ``optuna_tuner.py`` per-volume evaluation). Reports the running mean
    after each volume so a Median pruner can cut hopeless trials early."""
    metrics = [metric] if isinstance(metric, str) else list(metric)
    single = [
        make_decode_objective(p, g, decoding_cfg_dict, metrics) for p, g in pairs
    ]

    def objective(params: Dict[str, Any], report: Optional[Callable] = None):
        acc = np.zeros(len(metrics), np.float64)
        for k, obj in enumerate(single):
            vals = obj(params)
            acc += np.atleast_1d(np.asarray(vals, np.float64))
            if report is not None and len(single) > 1:
                report(k, float(acc[0] / (k + 1)))
        mean = acc / len(single)
        return float(mean[0]) if len(metrics) == 1 else [float(v) for v in mean]

    return objective


def find_waterz_step(decoding_cfg_dict: Dict[str, Any]) -> Optional[int]:
    """Index of the waterz step in the decoding config, or None."""
    for i, step in enumerate(decoding_cfg_dict.get("steps") or []):
        if step.get("name") == "waterz":
            return i
    return None


def make_waterz_batch_objective(
    prediction: np.ndarray,
    gt: np.ndarray,
    decoding_cfg_dict: Dict[str, Any],
    metric: str,
    batch_thresholds: Sequence[float],
    minimize: bool = True,
) -> Callable[[Dict[str, Any]], Tuple[float, Dict[str, Any]]]:
    """Waterz batch objective (reference ``optuna_tuner.py:1155``): each
    trial runs ONE watershed + RAG and sweeps every merge threshold via
    incremental agglomeration, scoring each; returns the best metric with
    per-threshold scores and the winning threshold as trial attrs.

    The trial's other params (fragment_threshold, min_size, ...) are applied
    normally; any sampled ``threshold`` param is ignored in favor of the
    sweep. The thresholds are post-processed and scored on a thread pool
    (the native ops and the numpy passes release the GIL).
    """
    from ..config.schema import DecodingPostprocessConfig, DecodingStepConfig, build_dataclass
    from .decoders import decode_waterz
    from .postprocess import apply_postprocessing

    step_idx = find_waterz_step(decoding_cfg_dict)
    if step_idx is None:
        raise ValueError("waterz batch tuning needs a 'waterz' decoding step")
    # accept a single volume or lists (multi-volume: metric averaged per
    # threshold across volumes, reference per-volume evaluation)
    preds = prediction if isinstance(prediction, (list, tuple)) else [prediction]
    gts = gt if isinstance(gt, (list, tuple)) else [gt]

    def objective(params: Dict[str, Any]) -> Tuple[float, Dict[str, Any]]:
        d = copy.deepcopy(decoding_cfg_dict)
        for k, v in params.items():
            _set_dotted_with_list_indices(d, k, v)
        step = build_dataclass(DecodingStepConfig, d["steps"][step_idx])
        kwargs = dict(step.kwargs or {})
        kwargs.pop("threshold", None)
        post = build_dataclass(DecodingPostprocessConfig, d.get("postprocessing") or {})
        per_thr: Dict[float, float] = {float(t): 0.0 for t in batch_thresholds}
        for pred_v, gt_v in zip(preds, gts):
            pred = np.asarray(pred_v, dtype=np.float32)
            by_thr = decode_waterz(
                pred, thresholds=list(batch_thresholds),
                return_all_thresholds=True, **kwargs,
            )

            def score(labels):
                return compute_segmentation_metric(metric, apply_postprocessing(labels, post), gt_v)

            with ThreadPoolExecutor(min(8, os.cpu_count() or 1, len(by_thr))) as pool:
                for thr, value in zip(by_thr, pool.map(score, by_thr.values())):
                    per_thr[float(thr)] += value
        per_thr = {t: v / len(preds) for t, v in per_thr.items()}
        best_thr = (min if minimize else max)(per_thr, key=per_thr.get)
        attrs = {
            "best_threshold": float(best_thr),
            "per_threshold_metric": {f"{t:g}": float(v) for t, v in per_thr.items()},
        }
        return per_thr[best_thr], attrs

    return objective


def _set_dotted_with_list_indices(d: Any, dotted: str, value: Any):
    """set_path variant supporting numeric list indices (steps.0.kwargs.x)."""
    parts = dotted.split(".")
    node = d
    for i, part in enumerate(parts[:-1]):
        is_last = i == len(parts) - 2
        if part.isdigit():
            node = node[int(part)]
        else:
            if part not in node or node[part] is None:
                node[part] = {}
            node = node[part]
    last = parts[-1]
    if last.isdigit():
        node[int(last)] = value
    else:
        node[last] = value
