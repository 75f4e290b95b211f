"""Offline trainer for the learned scoring head (docs/LEARNED_SCORING.md).

Deterministic by construction: full-batch gradient descent on a
logistic loss in float64, zeros init, fixed iteration count — the same
dataset and config reproduce bit-identical weights (and therefore the
same artifact content hash) on every retrain, which is what the CI
``modelgate`` pins.  No new dependencies: plain numpy (the matmul is
small — the golden corpus is thousands of rows by ~2k rules).

Decision semantics mirror serving (models/pipeline.py finalize): a
request can only flag when at least one rule CONFIRMED, so rows with an
empty activation bitmap carry no decision signal and are excluded from
the gradient (recorded in provenance).  The calibration step then picks
the operating threshold under a **zero-new-FN constraint** against the
fixed-weight baseline: the largest threshold that keeps every
baseline-detected attack detected — maximizing benign-block reduction
without giving back any recall the fixed weights already had.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import numpy as np

from ingress_plus_tpu_torch.learn.features import FeatureDataset
from ingress_plus_tpu_torch.learn.head import ScoringHead


@dataclass
class TrainConfig:
    """Trainer knobs.  ``seed`` is recorded in provenance; the
    full-batch closed-form iteration is deterministic regardless, the
    seed exists so a future stochastic trainer stays reproducible."""

    seed: int = 20260804
    iters: int = 300
    lr: float = 0.5
    #: L2 on the weights (not the bias) — keeps rules the corpus never
    #: activates at exactly zero and bounds weight growth on tiny data
    l2: float = 1e-3
    #: threshold safety margin subtracted after calibration (float
    #: slack so a serving-side float32 round never flips a calibrated
    #: attack to a miss)
    margin: float = 1e-4


def train_head(x: np.ndarray, y: np.ndarray,
               config: Optional[TrainConfig] = None
               ) -> tuple[np.ndarray, float]:
    """Logistic regression on activation bitmaps → ``(weights, bias)``.

    Full-batch GD, float64, zeros init: deterministic.  Rows with no
    active feature are dropped (they cannot flag at serve time)."""
    cfg = config or TrainConfig()
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    live = x.any(axis=1)
    x, y = x[live], y[live]
    n, f = x.shape
    if n == 0:
        raise ValueError("no rows with active features to train on")
    w = np.zeros((f,), dtype=np.float64)
    b = 0.0
    for _ in range(cfg.iters):
        z = x @ w + b
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30.0, 30.0)))
        g = p - y
        gw = x.T @ g / n + cfg.l2 * w
        gb = float(g.mean())
        w -= cfg.lr * gw
        b -= cfg.lr * gb
    return w.astype(np.float32), float(b)


def fixed_flags(ds: FeatureDataset) -> np.ndarray:
    """The fixed-weight baseline decision per row: CRS anomaly sum over
    confirmed rules >= the pack's threshold (and at least one hit) —
    exactly finalize's ``attack`` with no learned head installed."""
    score = ds.x.astype(np.int64) @ ds.rule_score.astype(np.int64)
    return (score >= int(ds.anomaly_threshold)) & ds.x.any(axis=1)


def calibrate_threshold(margins: np.ndarray, y: np.ndarray,
                        baseline: np.ndarray, anyhit: np.ndarray,
                        safety_margin: float = 1e-4) -> float:
    """Zero-new-FN threshold: the largest t such that every attack the
    fixed baseline detects has learned margin >= t.  With no
    baseline-detected attacks at all (degenerate corpus) the threshold
    falls back to the benign maximum + margin (flag nothing benign)."""
    protected = (y.astype(bool)) & baseline & anyhit
    if protected.any():
        return float(margins[protected].min()) - safety_margin
    benign_live = (~y.astype(bool)) & anyhit
    if benign_live.any():
        return float(margins[benign_live].max()) + safety_margin
    return 0.0


def compare_scorers(ds: FeatureDataset, head: ScoringHead,
                    curve_points: int = 9) -> Dict:
    """Fixed weights vs learned head on one dataset — the MODELGATE /
    bench-quality comparison block: flags, FPs at equal (or better)
    recall, new-FN count (must be zero), and a calibration curve of
    (threshold, fp, fn) around the operating point."""
    aligned, coverage = _aligned_weights(ds, head)
    anyhit = ds.x.any(axis=1)
    margins = ds.x.astype(np.float64) @ aligned + head.bias
    learned = (margins >= head.threshold) & anyhit
    fixed = fixed_flags(ds)
    y = ds.y.astype(bool)
    new_fn = int((fixed & ~learned & y).sum())
    curve: List[Dict] = []
    lo = float(margins[anyhit].min()) if anyhit.any() else 0.0
    hi = float(margins[anyhit].max()) if anyhit.any() else 1.0
    for t in np.linspace(lo, hi, curve_points):
        flag = (margins >= t) & anyhit
        curve.append({"threshold": round(float(t), 4),
                      "fp": int((flag & ~y).sum()),
                      "fn": int((~flag & y).sum())})
    return {
        "requests": ds.n,
        "attacks": int(y.sum()),
        "benign": int((~y).sum()),
        "coverage": round(coverage, 4),
        "threshold": round(float(head.threshold), 6),
        "fixed": {"flagged": int(fixed.sum()),
                  "fp": int((fixed & ~y).sum()),
                  "fn": int((~fixed & y).sum())},
        "learned": {"flagged": int(learned.sum()),
                    "fp": int((learned & ~y).sum()),
                    "fn": int((~learned & y).sum())},
        "new_fn_vs_fixed": new_fn,
        "fp_reduction": int((fixed & ~y).sum()) - int((learned & ~y).sum()),
        "calibration_curve": curve,
    }


def _aligned_weights(ds: FeatureDataset,
                     head: ScoringHead) -> tuple[np.ndarray, float]:
    from ingress_plus_tpu_torch.learn.features import remap_columns

    if len(head.rule_ids) == len(ds.rule_ids) and \
            (head.rule_ids == ds.rule_ids).all():
        return head.weights.astype(np.float64), 1.0
    w, cov = remap_columns(head.weights.reshape(1, -1), head.rule_ids,
                           ds.rule_ids)
    return w[0].astype(np.float64), cov


def train_from_dataset(ds: FeatureDataset,
                       config: Optional[TrainConfig] = None
                       ) -> ScoringHead:
    """Dataset → trained + calibrated + provenance-stamped head (the
    one-call path the CLI, the CI modelgate, and tests share)."""
    cfg = config or TrainConfig()
    w, b = train_head(ds.x, ds.y, cfg)
    anyhit = ds.x.any(axis=1)
    margins = ds.x.astype(np.float64) @ w.astype(np.float64) + b
    thr = calibrate_threshold(margins, ds.y, fixed_flags(ds), anyhit,
                              safety_margin=cfg.margin)
    head = ScoringHead(
        rule_ids=ds.rule_ids.copy(), weights=w, bias=b, threshold=thr,
        provenance={
            "dataset": ds.fingerprint(),
            "dataset_meta": dict(ds.meta),
            "train_config": asdict(cfg),
            "trained_rows": int(anyhit.sum()),
            "calibration": "zero-new-fn vs fixed weights "
                           "(threshold=%d)" % ds.anomaly_threshold,
        })
    head.provenance["baseline"] = compare_scorers(ds, head,
                                                  curve_points=5)
    # provenance mutation above does not move the content hash (hash
    # covers weights/map/bias/threshold only) — version stays stable
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ingress_plus_tpu_torch.learn.train",
        description="Train + calibrate a scoring head from a feature "
                    "dataset (utils/export_corpus.py --features) or "
                    "straight from the golden corpus.")
    ap.add_argument("--dataset", default=None,
                    help="feature dataset prefix (the .npz/.json pair "
                         "export_corpus --features wrote); omitted = "
                         "build from the golden corpus in-process")
    ap.add_argument("--out", required=True,
                    help="artifact path prefix (writes .npz + .json)")
    ap.add_argument("--n", type=int, default=2048,
                    help="golden-corpus size when --dataset is omitted")
    ap.add_argument("--corpus-seed", type=int, default=20260729)
    ap.add_argument("--seed", type=int, default=20260804)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--l2", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the golden corpus runs when --dataset is "
                         "omitted (the trainer itself is host numpy)")
    args = ap.parse_args(argv)

    if args.dataset:
        ds = FeatureDataset.load(args.dataset)
    else:
        from ingress_plus_tpu_torch.utils.export_corpus import (
            build_feature_dataset)
        ds = build_feature_dataset(n=args.n, seed=args.corpus_seed,
                                   device=args.device)
    cfg = TrainConfig(seed=args.seed, iters=args.iters, lr=args.lr,
                      l2=args.l2)
    head = train_from_dataset(ds, cfg)
    out = head.save(args.out)
    base = head.provenance.get("baseline", {})
    print(json.dumps({
        "artifact": str(out),
        "version": head.version,
        "threshold": head.threshold,
        "rules": int(len(head.rule_ids)),
        "fixed_fp": base.get("fixed", {}).get("fp"),
        "learned_fp": base.get("learned", {}).get("fp"),
        "new_fn_vs_fixed": base.get("new_fn_vs_fixed"),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
