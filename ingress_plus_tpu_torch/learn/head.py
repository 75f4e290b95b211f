"""ScoringHead artifact + LearnedScorer serving binding.

The artifact is the unit that rolls out (docs/LEARNED_SCORING.md):
weights + rule-id map + calibrated threshold + provenance, persisted as
``<path>.npz`` + ``<path>.json`` with a content hash the loader
verifies — a truncated or hand-edited artifact is rejected at load, the
first admission stage.

Serving: ``LearnedScorer`` binds a head onto one compiled pack's rule
axis by CRS rule id (pack swaps re-bind — the rule-id remap is what
lets a trained head survive a ruleset rollout).  The score is one tiny
matmul over the request's confirmed-hit bitmap; ``score_confirmed`` is
the sparse row-dot the CPU finalize loop runs per request and
``score_batch`` is the dense batched form — parity-pinned in
tests/test_learned_scoring.py, so the two are interchangeable and the
batched form is what a device-resident finalize dispatches.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ingress_plus_tpu_torch.learn.features import remap_columns

#: bump when the on-disk artifact layout changes incompatibly
HEAD_SCHEMA = 1

#: scorer last-known-good pointer file name (lives next to the pack LKG
#: pointer in --lkg-dir; separate pointer — pack and scorer roll out
#: and roll back independently)
SCORER_LKG_POINTER = "LKG_SCORER"


@dataclass
class ScoringHead:
    """Versioned learned-scorer artifact (weights + rule-id map +
    threshold + provenance)."""

    #: (F,) CRS rule id per weight — the portability key
    rule_ids: np.ndarray
    #: (F,) float32 per-rule weight
    weights: np.ndarray
    bias: float
    #: calibrated operating threshold (zero-new-FN calibration,
    #: learn/train.py) — a request flags when its confirmed-hit margin
    #: reaches this
    threshold: float
    version: str = ""
    #: training provenance: dataset fingerprint, seed, config, baseline
    #: comparison at calibration time
    provenance: Dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.rule_ids = np.asarray(self.rule_ids, dtype=np.int64)
        self.weights = np.asarray(self.weights, dtype=np.float32)
        if not self.version:
            self.version = self.fingerprint()

    def fingerprint(self) -> str:
        """Content hash over everything that affects a verdict (weights,
        rule-id map, bias, threshold) — the artifact-hash-stability
        anchor the CI modelgate pins (same data + same seed must
        reproduce this exactly)."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.rule_ids).tobytes())
        h.update(np.ascontiguousarray(self.weights).tobytes())
        h.update(np.float64(self.bias).tobytes())
        h.update(np.float64(self.threshold).tobytes())
        return "lh-" + h.hexdigest()[:16]

    def validate(self) -> None:
        """Schema gate (first admission stage): shapes line up, values
        finite, threshold present.  Raises ValueError."""
        if self.rule_ids.ndim != 1 or self.weights.ndim != 1:
            raise ValueError("rule_ids and weights must be 1-d")
        if len(self.rule_ids) != len(self.weights):
            raise ValueError(
                "rule-id map (%d) and weights (%d) length mismatch"
                % (len(self.rule_ids), len(self.weights)))
        if len(self.rule_ids) == 0:
            raise ValueError("empty scoring head")
        if not np.isfinite(self.weights).all():
            raise ValueError("non-finite weight(s)")
        for name, v in (("bias", self.bias), ("threshold", self.threshold)):
            if not np.isfinite(float(v)):
                raise ValueError("non-finite %s" % name)

    # ------------------------------------------------------ persistence

    def save(self, path: str | Path) -> Path:
        p = Path(path)
        self.validate()
        np.savez_compressed(p.with_suffix(".npz"),
                            rule_ids=self.rule_ids,
                            weights=self.weights)
        p.with_suffix(".json").write_text(json.dumps({
            "schema": HEAD_SCHEMA,
            "kind": "scoring_head",
            "version": self.version,
            "bias": float(self.bias),
            "threshold": float(self.threshold),
            "n_rules": int(len(self.rule_ids)),
            "content_sha": self.fingerprint(),
            "provenance": self.provenance,
        }, indent=1))
        return p.with_suffix(".npz")

    @classmethod
    def load(cls, path: str | Path) -> "ScoringHead":
        """Load + verify: schema version, shape validation, and the
        content hash recorded at save time — a corrupt/tampered
        artifact raises here, before any gate sees it."""
        p = Path(path)
        meta = json.loads(p.with_suffix(".json").read_text())
        if meta.get("kind") != "scoring_head":
            raise ValueError("not a scoring-head artifact: kind=%r"
                             % meta.get("kind"))
        if meta.get("schema") != HEAD_SCHEMA:
            raise ValueError("unsupported scoring-head schema %r"
                             % meta.get("schema"))
        with np.load(p.with_suffix(".npz")) as z:
            head = cls(rule_ids=z["rule_ids"], weights=z["weights"],
                       bias=float(meta["bias"]),
                       threshold=float(meta["threshold"]),
                       version=str(meta.get("version", "")),
                       provenance=dict(meta.get("provenance", {})))
        head.validate()
        if meta.get("content_sha") and \
                meta["content_sha"] != head.fingerprint():
            raise ValueError(
                "scoring-head content hash mismatch (corrupt or "
                "tampered): %s != %s"
                % (head.fingerprint(), meta["content_sha"]))
        return head


class LearnedScorer:
    """A ScoringHead bound to one compiled pack's rule axis.

    Binding resolves the head's rule-id-keyed weights onto the pack's
    sigpack-row order once per install (``DetectionPipeline._install``)
    — the per-request hot path is then a plain dot with no id lookups.
    ``coverage`` is the fraction of head rules found in the pack (the
    admission gate's rule-id-map coverage check); weight mass carried by
    missing rules simply contributes nothing, which only LOWERS learned
    scores — fail-toward-the-fixed-baseline, never toward over-blocking
    relative to the head's calibration.
    """

    def __init__(self, head: ScoringHead, ruleset) -> None:
        head.validate()
        self.head = head
        self.ruleset_version: str = ruleset.version
        pack_ids = np.asarray(ruleset.rule_ids, dtype=np.int64)
        if len(head.rule_ids) == len(pack_ids) and \
                (head.rule_ids == pack_ids).all():
            # identical axis (the head was trained on THIS pack):
            # positional bind, bit-exact with calibration even when a
            # multi-row rule repeats one CRS id with distinct per-row
            # weights (remap pairs duplicates positionally too, but the
            # short circuit makes the common case trivially exact)
            w, cov = head.weights.reshape(1, -1), 1.0
        else:
            w, cov = remap_columns(
                head.weights.reshape(1, -1), head.rule_ids, pack_ids)
        #: (R,) float32 weights on the pack's rule axis
        self.w: np.ndarray = np.ascontiguousarray(
            w[0], dtype=np.float32)
        self.bias: float = float(head.bias)
        self.threshold: float = float(head.threshold)
        #: fraction of head rule ids present in this pack
        self.coverage: float = float(cov)

    @property
    def version(self) -> str:
        return self.head.version

    def score_confirmed(self, confirmed: Sequence[int]) -> float:
        """Sparse dot over a request's confirmed rule indices — the
        finalize-loop form (identical result to ``score_batch`` on the
        equivalent bitmap row; parity-pinned)."""
        if not len(confirmed):
            return self.bias
        return float(
            self.w[np.asarray(confirmed, dtype=np.int64)].sum()
            + self.bias)

    def score_batch(self, bitmap: np.ndarray) -> np.ndarray:
        """(Q, R) activation bitmap → (Q,) learned margins: the one tiny
        matmul.  Device-friendly: dense, no gather, shape-stable in R."""
        return bitmap.astype(np.float32) @ self.w + np.float32(self.bias)

    def snapshot(self) -> dict:
        """/scoring endpoint body fragment."""
        order = np.argsort(-np.abs(self.head.weights), kind="stable")[:16]
        return {
            "version": self.head.version,
            "threshold": round(self.threshold, 6),
            "bias": round(self.bias, 6),
            "rules_in_head": int(len(self.head.rule_ids)),
            "coverage": round(self.coverage, 4),
            "bound_ruleset": self.ruleset_version,
            "provenance": self.head.provenance,
            "top_weights": [
                {"rule_id": int(self.head.rule_ids[i]),
                 "weight": round(float(self.head.weights[i]), 4)}
                for i in order],
        }


# ----------------------------------------------------------- LKG store
# Same write-then-rename discipline as the pack LKG (control/rollout.py
# persist_lkg), separate pointer: the scorer is an independent rollout
# axis — rolling a pack back must not silently drop a good model, and
# vice versa.


def persist_lkg_scorer(head: ScoringHead, lkg_dir: str | Path,
                       keep: int = 2) -> Path:
    """Atomically persist ``head`` as the last-known-good scorer."""
    d = Path(lkg_dir)
    d.mkdir(parents=True, exist_ok=True)
    base = d / ("scorer-%s" % head.version)
    tmp = d / (".tmp-scorer-%s" % head.version)
    head.save(tmp)
    os.replace(tmp.with_suffix(".npz"), base.with_suffix(".npz"))
    os.replace(tmp.with_suffix(".json"), base.with_suffix(".json"))
    ptr_tmp = d / (SCORER_LKG_POINTER + ".tmp")
    ptr_tmp.write_text(json.dumps({"artifact": base.name,
                                   "version": head.version}))
    os.replace(ptr_tmp, d / SCORER_LKG_POINTER)
    olds: List[Path] = sorted(
        (p for p in d.glob("scorer-*.json") if p.stem != base.stem),
        key=lambda p: p.stat().st_mtime)
    for p in olds[:max(0, len(olds) - (keep - 1))]:
        p.unlink(missing_ok=True)
        p.with_suffix(".npz").unlink(missing_ok=True)
    return base


def load_lkg_scorer(lkg_dir: str | Path) -> Optional[ScoringHead]:
    """Load the last-known-good scoring head, or None when absent or
    unreadable — startup must serve (fixed weights) either way."""
    d = Path(lkg_dir)
    ptr = d / SCORER_LKG_POINTER
    if not ptr.is_file():
        return None
    try:
        meta = json.loads(ptr.read_text())
        return ScoringHead.load(d / meta["artifact"])
    except Exception:
        return None
