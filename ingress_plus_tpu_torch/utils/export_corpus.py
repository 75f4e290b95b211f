"""Export the labeled corpus — request frames for loadgen, feature
datasets for the learned scoring lane.

Frame export (the original mode; native/sidecar/loadgen.cc replays
these over the serve-loop UDS — the wrk2-corpus-replay analog of
BASELINE config #1):

    python -m ingress_plus_tpu_torch.utils.export_corpus out.bin [n] [seed]

Feature export (docs/LEARNED_SCORING.md): the golden corpus
(utils/corpus attacks + benign + utils/benign_fixtures) through the
pipeline (on the CUDA card unless ``--device cpu``) with the RuleStats
capture ring on, written as a labeled
``FeatureDataset`` (per-request confirmed-hit + candidate bitmaps,
attack/benign label, rule-id map) — the ONE shared input of the
offline trainer, the CI ``modelgate``, and the tests:

    python -m ingress_plus_tpu_torch.utils.export_corpus --features out \
        [--n 2048] [--seed 20260729] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ingress_plus_tpu_torch.serve.protocol import encode_request
from ingress_plus_tpu_torch.utils.corpus import generate_corpus


def export(path: str, n: int = 10_000, seed: int = 20260729,
           attack_fraction: float = 0.2, tenants: int = 1,
           mode: int = 2) -> int:
    """``mode=0`` exports wallarm_mode-off frames: the serve loop returns
    an instant clean verdict without touching the pipeline, so a loadgen
    replay of such a corpus measures the pure boundary chain
    (loadgen→sidecar→serve framing), bench.py's chain-overhead leg."""
    corpus = generate_corpus(n=n, attack_fraction=attack_fraction,
                             seed=seed, tenants=tenants)
    with open(path, "wb") as f:
        for i, lr in enumerate(corpus):
            f.write(encode_request(lr.request, req_id=i + 1, mode=mode))
    return len(corpus)


def build_feature_dataset(n: int = 2048, seed: int = 20260729,
                          attack_fraction: float = 0.3,
                          include_fixtures: bool = True,
                          ruleset=None, batch: int = 128,
                          capture_mb: int = 32, device=None):
    """Golden corpus → labeled ``FeatureDataset`` (learn/features.py).

    Runs the FULL pipeline in monitoring mode on ``device`` (None = the
    CUDA card; ``"cpu"`` = the plain scan) and records each
    request's activation bitmaps through the RuleStats capture ring —
    the same code path shadow-time collection uses, so exported
    features match serving features exactly.  ``include_fixtures``
    appends the hand-authored benign fixtures: they carry the known
    fixed-weight false positives (SQL-in-prose tickets, code-snippet
    pastes — reports/QUALITY.json ``benign_fixture``), which is
    precisely the head's FP-reduction training signal."""
    from ingress_plus_tpu_torch.learn.features import FeatureDataset
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.utils.benign_fixtures import fixture_corpus

    if ruleset is None:
        from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
        from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules

        ruleset = compile_ruleset(load_bundled_rules())
    pipeline = DetectionPipeline(ruleset, mode="monitoring", device=device)
    labeled = generate_corpus(n=n, seed=seed,
                              attack_fraction=attack_fraction)
    if include_fixtures:
        labeled = labeled + fixture_corpus()
    row_bytes = 2 * ((ruleset.n_rules + 7) // 8)
    pipeline.rule_stats.enable_capture(
        cap_bytes=max(capture_mb << 20, (len(labeled) + 1) * row_bytes))
    for i in range(0, len(labeled), batch):
        pipeline.detect([lr.request for lr in labeled[i:i + batch]])
    cand, conf = pipeline.rule_stats.capture_snapshot()
    if conf.shape[0] != len(labeled):
        raise RuntimeError(
            "capture ring recorded %d requests for a %d-request corpus "
            "(ring undersized or a batch failed open)"
            % (conf.shape[0], len(labeled)))
    return FeatureDataset(
        x=conf.astype(np.uint8),
        y=np.asarray([1 if lr.is_attack else 0 for lr in labeled],
                     dtype=np.uint8),
        rule_ids=np.asarray(ruleset.rule_ids, dtype=np.int64).copy(),
        rule_score=np.asarray(ruleset.rule_score, dtype=np.int64).copy(),
        anomaly_threshold=int(pipeline.anomaly_threshold),
        x_candidates=cand.astype(np.uint8),
        request_ids=[lr.request.request_id for lr in labeled],
        meta={
            "corpus_n": n, "corpus_seed": seed,
            "attack_fraction": attack_fraction,
            "fixtures": include_fixtures,
            "ruleset": ruleset.version,
            "mode": "monitoring (full pipeline, CPU confirm lane)",
        })


def _features_main(argv) -> int:
    out: Optional[str] = None
    n, seed, device = 2048, 20260729, "cuda"
    it = iter(argv)
    for a in it:
        if a == "--features":
            out = next(it)
        elif a == "--n":
            n = int(next(it))
        elif a == "--seed":
            seed = int(next(it))
        elif a == "--device":
            device = next(it)
        else:
            print("unknown argument %r" % a, file=sys.stderr)
            return 2
    assert out is not None
    ds = build_feature_dataset(n=n, seed=seed, device=device)
    path = ds.save(out)
    print("wrote %d labeled feature rows (%d rules, %d attacks) to %s"
          % (ds.n, ds.n_features, int(ds.y.sum()), path))
    return 0


if __name__ == "__main__":
    if "--features" in sys.argv[1:]:
        sys.exit(_features_main(sys.argv[1:]))
    out = sys.argv[1] if len(sys.argv) > 1 else "corpus.bin"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 20260729
    count = export(out, n=n, seed=seed)
    print("wrote %d request frames to %s" % (count, out))
