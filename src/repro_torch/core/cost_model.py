"""Learned cost model over the plan-cache corpus: predict backend winners
(PyTorch port: a numpy copy of ``repro.core.cost_model``; models are keyed
by the port's device key, ``core.cache.device_key``).

The autotuner (``core/autotune.py``) decides everything structure-derivable
once per pattern — but it decides by *measuring* every backend candidate,
and at production cardinality (millions of distinct routing/serving
structures) that cold-start staging cost is the bottleneck.  This module
closes the loop the ROADMAP asks for: every measured ``TuningPlan`` already
persisted by :class:`~.cache.PlanCache` is a labeled training example
(structure features x device -> per-backend runtime), so a process that has
tuned enough structures can *predict* the winner for a new one and skip the
micro-benchmarks entirely.

Design (pure numpy, no new dependencies):

* **Features** (:func:`meta_features`) come from the plan's ``meta`` dict —
  rows/cols, stored nnz, block count, block-size moments, density, and the
  dense-operand column count — log-scaled so ridge regression over
  log-runtime sees roughly linear structure (runtime of every backend here
  is polynomial in the size quantities).
* **Model** (:class:`CostModel`): one closed-form ridge regressor per
  candidate *label* (``grouped``, ``bucketed``, ``cuda[32x32]``, ...)
  over z-scored features, fit per ``(device, kind)`` — a card's model never
  answers for the CPU.  The z-scored training set is retained for a
  nearest-neighbor distance, which is the out-of-distribution gate.
* **Calibrated refusal**: prediction is only trusted when (a) every
  candidate label was seen in training, (b) the nearest corpus structure is
  within :data:`DEFAULT_MAX_DISTANCE` in z-space, and (c) the predicted
  gap between the top two candidates exceeds :data:`DEFAULT_MARGIN`.
  Anything else falls back to measurement — the measurement path stays the
  ground-truth oracle, and what it measures is recorded back into the
  corpus, so the model improves online and every prediction stays testable
  against a measurable truth.
* **Persistence**: fitted models are stored in the same cache under
  ``models/cost-<kind>-<device>-v<version>.json`` and refit automatically
  once the corpus grows past :data:`REFIT_GROWTH` x the size it was
  trained on (:func:`load_or_fit`).

``autotune(mode="predict")`` is the consumer in the port so far; in the
reference ``sparse.linear.choose_matmul_strategy(mode="predict")`` and the
serving scheduler's cold-structure scoring (``staging_cost``) use it too.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np

from .cache import PlanCache, TuningPlan

__all__ = [
    "COST_MODEL_VERSION",
    "CostModel",
    "corpus",
    "cost_model_stats",
    "fit",
    "load_or_fit",
    "meta_features",
    "model_key",
    "pattern_features",
    "reset_cost_model_stats",
    "vbr_features",
    "FEATURE_NAMES",
]

# v2: structure-class features (bandwidth_frac / diag_occupancy /
# reblock_fill) joined FEATURE_NAMES — the bump orphans v1 models by key
# so they refit instead of replaying weights over a different feature set
COST_MODEL_VERSION = 2

# calibration knobs (overridable per call)
MIN_CORPUS = 8          # plans needed before a model is fit at all
MIN_LABEL_SAMPLES = 3   # timings needed before a label's regressor answers
RIDGE_LAMBDA = 1e-3
DEFAULT_MARGIN = 0.15        # required relative gap between top-2 predictions
DEFAULT_MAX_DISTANCE = 2.0   # required z-space RMS distance to nearest neighbor
REFIT_GROWTH = 1.5           # refit when corpus grows past this factor
MAX_TRAIN_ROWS = 1024        # cap on retained z-scored rows (OOD gate)

FEATURE_NAMES = (
    "log_rows",
    "log_cols",
    "log_nnz",
    "log_blocks",
    "log_block_mean",
    "log_block_max",
    "block_cv",
    "density",
    "log_n_cols",
    # structure-class features (core/inspect.py / core/reblock.py): these
    # separate the patterns where dia_hybrid / reblocked candidates win
    "bandwidth_frac",   # scalar bandwidth / max dim (1.0 when unrecorded)
    "diag_occupancy",   # nnz fraction on dense diagonals (0.0 default)
    "reblock_fill",     # fill ratio of the primary reblocking proposal
)

_STATS = {
    "model_fits": 0,
    "model_loads": 0,
    "plans_predicted": 0,
    "predict_fallbacks": 0,
}


def cost_model_stats() -> dict:
    return dict(_STATS)


def reset_cost_model_stats() -> None:
    _STATS.update({k: 0 for k in _STATS})


# ---------------------------------------------------------------------- #
# feature extraction
# ---------------------------------------------------------------------- #
def meta_features(kind: str, meta: dict, n_cols=None) -> np.ndarray:
    """Fixed-length feature vector from a plan's ``meta`` dict.

    Handles both the VBR autotuner's meta (``autotune._structure_meta``)
    and the ``linear`` kind's BlockPattern meta.  Old plans written before
    the block-moment fields existed degrade gracefully (moments derived
    from nnz / block count).
    """
    if kind == "linear":
        rows = float(meta["d_in"])
        cols = float(meta["d_out"])
        nb = float(meta["n_tiles"])
        bsize = float(meta["tm"]) * float(meta["tk"])
        nnz = nb * bsize
        bmean = bmax = bsize
        bcv = 0.0
        density = float(meta.get("density", 1.0))
    else:
        rows, cols = (float(s) for s in meta["shape"])
        nnz = float(meta["stored_nnz"])
        nb = float(meta["num_blocks"])
        bmean = float(meta.get("block_size_mean", nnz / max(nb, 1.0)))
        bmax = float(meta.get("block_size_max", bmean))
        bcv = float(meta.get("block_size_cv", 0.0))
        density = float(meta.get("density", 1.0))
    nc = 1.0 if n_cols is None else float(n_cols)
    # structure-class features degrade gracefully on pre-v2 metas: a full
    # band (1.0), no dense diagonals (0.0), no reblocking fill (1.0)
    band_frac = float(meta.get("bandwidth_frac", 1.0))
    diag_occ = float(meta.get("diag_occupancy", 0.0))
    reblock_fill = float(meta.get("reblock_fill_ratio", 1.0))
    return np.array(
        [
            math.log1p(rows),
            math.log1p(cols),
            math.log1p(nnz),
            math.log1p(nb),
            math.log1p(bmean),
            math.log1p(bmax),
            bcv,
            density,
            math.log1p(nc),
            band_frac,
            diag_occ,
            reblock_fill,
        ],
        dtype=np.float64,
    )


def plan_features(plan: TuningPlan) -> np.ndarray:
    return meta_features(plan.kind, plan.meta, plan.n_cols)


def vbr_features(vbr, kind: str = "spmv", n_cols=None) -> np.ndarray:
    """Features for a VBR structure not yet in the corpus."""
    from .autotune import _structure_meta

    return meta_features(kind, _structure_meta(vbr), n_cols)


def pattern_features(pattern) -> np.ndarray:
    """Features for a ``sparse.linear.BlockPattern`` (kind ``linear``)."""
    return meta_features(
        "linear",
        {
            "d_in": pattern.d_in,
            "d_out": pattern.d_out,
            "tm": pattern.tm,
            "tk": pattern.tk,
            "n_tiles": pattern.n_tiles,
            "density": pattern.density,
        },
    )


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
class CostModel:
    """Per-(device, kind) runtime predictor: one ridge regressor per
    candidate label over z-scored features, log-runtime target, plus the
    retained training rows for the nearest-neighbor OOD gate."""

    def __init__(
        self,
        device: str,
        kind: str,
        mu: np.ndarray,
        sigma: np.ndarray,
        weights: dict,       # label -> (F+1,) ridge weights (bias first)
        label_counts: dict,  # label -> training-sample count
        train_x: np.ndarray,  # (N, F) z-scored corpus features
        n_train: int,
        version: int = COST_MODEL_VERSION,
    ):
        self.device = device
        self.kind = kind
        self.mu = np.asarray(mu, np.float64)
        self.sigma = np.asarray(sigma, np.float64)
        self.weights = {k: np.asarray(v, np.float64) for k, v in weights.items()}
        self.label_counts = dict(label_counts)
        self.train_x = np.asarray(train_x, np.float64).reshape(-1, len(mu))
        self.n_train = int(n_train)
        self.version = int(version)

    # ------------------------------------------------------------------ #
    def _z(self, feats: np.ndarray) -> np.ndarray:
        return (np.asarray(feats, np.float64) - self.mu) / self.sigma

    def knows(self, label: str) -> bool:
        return self.label_counts.get(label, 0) >= MIN_LABEL_SAMPLES

    def predict(self, feats: np.ndarray, labels: Iterable[str]) -> dict:
        """Predicted runtime (seconds) per label; unknown labels omitted."""
        z = self._z(feats)
        zb = np.concatenate([[1.0], z])
        out = {}
        for label in labels:
            if self.knows(label):
                out[label] = float(np.exp(zb @ self.weights[label]))
        return out

    def rank(self, feats: np.ndarray, labels: Iterable[str]) -> list:
        preds = self.predict(feats, labels)
        return sorted(preds.items(), key=lambda kv: kv[1])

    def margin(self, feats: np.ndarray, labels: Iterable[str]) -> float:
        """Relative gap between the top-2 predicted candidates (inf when
        only one candidate is rankable)."""
        ranked = self.rank(feats, labels)
        if len(ranked) < 2:
            return float("inf")
        (_, t1), (_, t2) = ranked[0], ranked[1]
        return (t2 - t1) / max(t1, 1e-12)

    def nn_distance(self, feats: np.ndarray) -> float:
        """RMS z-space distance to the nearest training structure."""
        if not len(self.train_x):
            return float("inf")
        d = self.train_x - self._z(feats)[None, :]
        return float(np.sqrt((d * d).mean(axis=1)).min())

    def staging_cost(self, feats: np.ndarray, labels=None) -> float:
        """Predicted cost of *measuring* this structure: the sum of every
        known candidate's predicted runtime (the tuner stages and times
        them all).  Used by the scheduler to order cold structures."""
        preds = self.predict(
            feats, labels if labels is not None else self.weights
        )
        return float(sum(preds.values())) if preds else float("inf")

    def confident(
        self,
        feats: np.ndarray,
        labels: Iterable[str],
        margin: float = DEFAULT_MARGIN,
        max_distance: float = DEFAULT_MAX_DISTANCE,
    ) -> tuple:
        """(ok, reason) — ok only when prediction is trustworthy enough to
        skip measurement.  Never-guess contract: any unknown candidate
        label, an out-of-corpus feature vector, or a too-close call
        returns ``(False, reason)`` and the caller measures."""
        labels = list(labels)
        unknown = [lbl for lbl in labels if not self.knows(lbl)]
        if unknown:
            return False, f"unknown candidates {unknown}"
        d = self.nn_distance(feats)
        if d > max_distance:
            return False, f"out of corpus (nn distance {d:.2f} > {max_distance})"
        m = self.margin(feats, labels)
        if m < margin:
            return False, f"margin {m:.3f} < {margin}"
        return True, f"margin {m:.3f}, nn distance {d:.2f}"

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "device": self.device,
            "kind": self.kind,
            "feature_names": list(FEATURE_NAMES),
            "mu": self.mu.tolist(),
            "sigma": self.sigma.tolist(),
            "weights": {k: v.tolist() for k, v in self.weights.items()},
            "label_counts": dict(self.label_counts),
            "train_x": self.train_x.tolist(),
            "n_train": self.n_train,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        if d.get("version") != COST_MODEL_VERSION:
            raise ValueError(f"unsupported cost-model version {d.get('version')}")
        if tuple(d.get("feature_names", ())) != FEATURE_NAMES:
            raise ValueError("cost-model feature set drifted; refit")
        return cls(
            device=d["device"],
            kind=d["kind"],
            mu=np.asarray(d["mu"]),
            sigma=np.asarray(d["sigma"]),
            weights=d["weights"],
            label_counts=d["label_counts"],
            train_x=np.asarray(d["train_x"]),
            n_train=d["n_train"],
            version=d["version"],
        )


# ---------------------------------------------------------------------- #
# fitting
# ---------------------------------------------------------------------- #
def corpus(
    cache: PlanCache, device: str, kind: str
) -> list:
    """Every *measured* plan for (device, kind) in the cache — predicted
    and heuristic plans are excluded so the model never trains on its own
    output (no feedback loop).

    Reblocked plans are additionally excluded UNLESS their structure meta
    carries the reblock features (``reblock_fill_ratio``): a reblocked
    plan's timings were measured over a different (reblocked) layout, so
    training on it against features that don't describe that reblocking
    would be the same no-feedback-loop violation — the features and the
    label would silently disagree.  Plans written by this version always
    carry the feature; the guard protects against plans written by
    foreign/older writers.
    """
    return [
        p
        for p in cache.iter_plans(device=device, kind=kind)
        if p.source == "measured"
        and p.timings
        and not (p.reblock is not None and "reblock_fill_ratio" not in p.meta)
    ]


def fit(plans: list, device: str, kind: str) -> Optional[CostModel]:
    """Closed-form ridge fit over the corpus; None if it is too small."""
    plans = [p for p in plans if p.timings]
    if len(plans) < MIN_CORPUS:
        return None
    X = np.stack([plan_features(p) for p in plans])  # (N, F)
    mu = X.mean(axis=0)
    sigma = X.std(axis=0)
    sigma[sigma < 1e-9] = 1.0
    Z = (X - mu) / sigma

    weights: dict = {}
    counts: dict = {}
    labels = sorted({lbl for p in plans for lbl in p.timings})
    for label in labels:
        idx = [i for i, p in enumerate(plans) if label in p.timings]
        counts[label] = len(idx)
        if len(idx) < MIN_LABEL_SAMPLES:
            continue
        Zi = Z[idx]
        y = np.log(
            np.maximum([plans[i].timings[label] for i in idx], 1e-12)
        )
        A = np.concatenate([np.ones((len(idx), 1)), Zi], axis=1)  # bias col
        lam = RIDGE_LAMBDA * np.eye(A.shape[1])
        lam[0, 0] = 0.0  # never shrink the bias
        weights[label] = np.linalg.solve(A.T @ A + lam, A.T @ y)
    if not weights:
        return None
    train_x = Z
    if len(train_x) > MAX_TRAIN_ROWS:  # deterministic subsample for OOD gate
        step = len(train_x) / MAX_TRAIN_ROWS
        train_x = train_x[(np.arange(MAX_TRAIN_ROWS) * step).astype(int)]
    _STATS["model_fits"] += 1
    return CostModel(
        device=device,
        kind=kind,
        mu=mu,
        sigma=sigma,
        weights=weights,
        label_counts=counts,
        train_x=train_x,
        n_train=len(plans),
    )


def model_key(kind: str, device: str) -> str:
    """Cache key for a persisted model — per device and model version, so
    a feature/format bump refits instead of replaying stale weights."""
    return f"cost-{kind}-{device}-v{COST_MODEL_VERSION}"


def load_or_fit(
    cache: Optional[PlanCache],
    device: str,
    kind: str,
    min_corpus: int = MIN_CORPUS,
) -> Optional[CostModel]:
    """The entry point consumers use: load the persisted model when it is
    still representative of the corpus, refit (and persist) when the
    corpus grew past ``REFIT_GROWTH`` x its training size or shrank, and
    return ``None`` when the corpus is too small to trust at all (the
    caller must then measure)."""
    from .cache import default_cache

    cache = cache if cache is not None else default_cache()
    plans = corpus(cache, device, kind)
    if len(plans) < min_corpus:
        return None
    stored = cache.load_model(model_key(kind, device))
    if stored is not None:
        try:
            model = CostModel.from_dict(stored)
        except (ValueError, KeyError):
            model = None
        if (
            model is not None
            and model.n_train <= len(plans) <= model.n_train * REFIT_GROWTH
        ):
            _STATS["model_loads"] += 1
            return model
    model = fit(plans, device, kind)
    if model is not None:
        cache.store_model(model_key(kind, device), model.to_dict())
    return model
