"""Feature extraction for the learned scoring lane (docs/LEARNED_SCORING.md).

The feature representation is the per-request **rule-activation bitmap**
over one compiled pack's rule axis — exactly what ``RuleStats`` folds
per finalize batch and what ModSec-Learn trains on.  Two lanes:

- ``confirmed`` — rules whose confirm regex matched (the exact lane the
  verdict is scored from; the serving feature).
- ``candidates`` — prefilter candidate rules (sound over-approximation;
  kept as an ablation axis — a head trained on candidates could score
  during brownout rung 1, where the confirm lane is skipped).

Features are KEYED BY CRS RULE ID, not by sigpack row: a pack swap
reorders/adds/removes rows, so every artifact carries its rule-id map
and ``remap_columns`` aligns a matrix (or a weight vector) onto another
pack's axis by id.  Rules absent from the target axis drop (their
weight contributes nothing — the coverage fraction is the admission
gate's signal); rules new to the target axis get a zero column.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: bump when the on-disk dataset layout changes incompatibly
DATASET_SCHEMA = 1


def remap_columns(x: np.ndarray, from_ids: Sequence[int],
                  to_ids: Sequence[int]) -> Tuple[np.ndarray, float]:
    """Align columns of ``x`` (..., len(from_ids)) keyed by ``from_ids``
    onto the ``to_ids`` axis.  Returns ``(aligned, coverage)`` where
    ``coverage`` is the fraction of distinct source ids present in the
    target axis — the admission gate's rule-id-map coverage check.

    Duplicate ids (a multi-row compile of one CRS rule — each row is a
    distinct feature column) pair up POSITIONALLY: the k-th target
    occurrence of an id takes the k-th source occurrence's column, so a
    head trained on a pack binds back onto that same pack (or any pack
    preserving the duplicate structure) bit-exactly.  Target
    occurrences beyond the source's count fall back to the first
    source occurrence."""
    from_arr = np.asarray(from_ids, dtype=np.int64)
    to_arr = np.asarray(to_ids, dtype=np.int64)
    src_occ: Dict[int, List[int]] = {}
    for i, rid in enumerate(from_arr):
        src_occ.setdefault(int(rid), []).append(i)
    out = np.zeros(x.shape[:-1] + (len(to_arr),), dtype=x.dtype)
    found = 0
    hit_src: set = set()
    taken: Dict[int, int] = {}
    for j, rid in enumerate(to_arr):
        rid = int(rid)
        occ = src_occ.get(rid)
        if occ is None:
            continue
        k = taken.get(rid, 0)
        taken[rid] = k + 1
        out[..., j] = x[..., occ[k] if k < len(occ) else occ[0]]
        if rid not in hit_src:
            hit_src.add(rid)
            found += 1
    coverage = found / max(len(src_occ), 1)
    return out, coverage


@dataclass
class FeatureDataset:
    """Labeled per-request activation dataset — the shared input of the
    trainer, the CI ``modelgate``, and the tests (one export, three
    consumers; utils/export_corpus.py builds it)."""

    #: (N, R) confirmed-hit bitmaps (uint8 0/1) — the serving features
    x: np.ndarray
    #: (N,) labels: 1 = attack, 0 = benign
    y: np.ndarray
    #: (R,) CRS rule id per feature column — the portability key
    rule_ids: np.ndarray
    #: (R,) fixed CRS anomaly weight per column (the baseline scorer)
    rule_score: np.ndarray
    #: fixed-weight operating threshold the pack was compiled with
    anomaly_threshold: int
    #: (N, R) prefilter-candidate bitmaps (ablation lane), optional
    x_candidates: Optional[np.ndarray] = None
    #: per-request ids (corpus provenance; len N)
    request_ids: List[str] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.x.shape[1])

    def fingerprint(self) -> str:
        """Content hash — provenance for artifacts trained on this
        dataset (ties a head to its exact training data)."""
        h = hashlib.sha256()
        for a in (self.x, self.y, self.rule_ids, self.rule_score):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(self.anomaly_threshold).encode())
        return "ds-" + h.hexdigest()[:16]

    def remap(self, to_rule_ids: Sequence[int],
              to_rule_score: Optional[np.ndarray] = None,
              anomaly_threshold: Optional[int] = None
              ) -> "FeatureDataset":
        """The dataset re-keyed onto another pack's rule axis (pack-swap
        survival for recorded features)."""
        x2, cov = remap_columns(self.x, self.rule_ids, to_rule_ids)
        xc2 = None
        if self.x_candidates is not None:
            xc2, _ = remap_columns(self.x_candidates, self.rule_ids,
                                   to_rule_ids)
        rs = (np.asarray(to_rule_score, dtype=np.int64)
              if to_rule_score is not None
              else np.zeros((len(to_rule_ids),), dtype=np.int64))
        return FeatureDataset(
            x=x2, y=self.y.copy(),
            rule_ids=np.asarray(to_rule_ids, dtype=np.int64),
            rule_score=rs,
            anomaly_threshold=(self.anomaly_threshold
                               if anomaly_threshold is None
                               else anomaly_threshold),
            x_candidates=xc2, request_ids=list(self.request_ids),
            meta={**self.meta, "remapped_coverage": round(cov, 4)})

    # ------------------------------------------------------ persistence

    def save(self, path: str | Path) -> Path:
        """``<path>.npz`` (arrays) + ``<path>.json`` (schema + meta) —
        the CompiledRuleset.save convention."""
        p = Path(path)
        arrays = {
            "x": self.x.astype(np.uint8),
            "y": self.y.astype(np.uint8),
            "rule_ids": self.rule_ids.astype(np.int64),
            "rule_score": self.rule_score.astype(np.int64),
        }
        if self.x_candidates is not None:
            arrays["x_candidates"] = self.x_candidates.astype(np.uint8)
        np.savez_compressed(p.with_suffix(".npz"), **arrays)
        p.with_suffix(".json").write_text(json.dumps({
            "schema": DATASET_SCHEMA,
            "n": self.n,
            "n_features": self.n_features,
            "anomaly_threshold": int(self.anomaly_threshold),
            "fingerprint": self.fingerprint(),
            "request_ids": self.request_ids,
            "meta": self.meta,
        }, indent=1))
        return p.with_suffix(".npz")

    @classmethod
    def load(cls, path: str | Path) -> "FeatureDataset":
        p = Path(path)
        meta = json.loads(p.with_suffix(".json").read_text())
        if meta.get("schema") != DATASET_SCHEMA:
            raise ValueError("unsupported dataset schema %r"
                             % meta.get("schema"))
        with np.load(p.with_suffix(".npz")) as z:
            ds = cls(
                x=z["x"], y=z["y"], rule_ids=z["rule_ids"],
                rule_score=z["rule_score"],
                anomaly_threshold=int(meta["anomaly_threshold"]),
                x_candidates=(z["x_candidates"]
                              if "x_candidates" in z.files else None),
                request_ids=list(meta.get("request_ids", [])),
                meta=dict(meta.get("meta", {})))
        if meta.get("fingerprint") and \
                meta["fingerprint"] != ds.fingerprint():
            raise ValueError("dataset content hash mismatch (corrupt or "
                             "tampered): %s != %s"
                             % (ds.fingerprint(), meta["fingerprint"]))
        return ds
