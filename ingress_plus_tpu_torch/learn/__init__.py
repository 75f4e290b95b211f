"""Learned scoring lane (docs/LEARNED_SCORING.md).

The ModSec-Learn result (arXiv:2406.13547, PAPERS.md): CRS's fixed
per-rule anomaly weights and global threshold are a hand-tuned linear
model over the rule-activation vector — training that linear model on
labeled traffic cuts false positives at equal recall.  The
``RuleStats`` already observes exactly that representation per request;
this package closes the loop:

- ``features``  — per-request rule-activation bitmaps keyed by CRS rule
  id (so features survive pack swaps via rule-id remapping), plus the
  labeled ``FeatureDataset`` container the trainer/CI gate share.
- ``head``      — the versioned ``ScoringHead`` artifact (weights +
  rule-id map + calibrated threshold + provenance hash) and the
  ``LearnedScorer`` that binds it to one compiled pack's rule axis for
  serving (one tiny matmul over the confirmed-hit bitmap inside
  finalize; the fixed-weight score is still computed and exported so
  live divergence is observable).
- ``train``     — deterministic seeded logistic trainer + the
  zero-new-FN threshold calibration against the fixed-weight baseline,
  and ``compare_scorers`` (the MODELGATE / bench quality block).

Rollout safety: scoring-head swaps ride the ``RolloutController``
stages (``admit_scoring``) — admission (schema + coverage + golden
replay vs the incumbent scorer), shadow, canary with the verdict-diff
trigger, auto-rollback, and scorer LKG persistence — so a bad model can
never block traffic the fixed weights wouldn't.
"""

from ingress_plus_tpu_torch.learn.features import FeatureDataset, remap_columns
from ingress_plus_tpu_torch.learn.head import (
    LearnedScorer,
    ScoringHead,
    load_lkg_scorer,
    persist_lkg_scorer,
)

# learn.train is NOT imported eagerly: it doubles as the trainer CLI
# (`python -m ingress_plus_tpu_torch.learn.train`), and a package __init__
# that pre-imports it trips runpy's re-execution warning for every CLI
# user.  Import trainer symbols from ingress_plus_tpu_torch.learn.train.

__all__ = [
    "FeatureDataset",
    "LearnedScorer",
    "ScoringHead",
    "load_lkg_scorer",
    "persist_lkg_scorer",
    "remap_columns",
]
