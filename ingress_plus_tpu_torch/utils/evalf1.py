"""Detection-quality eval: the F1 gate.

The port of ``ingress_plus_tpu/utils/evalf1.py``.  A labeled corpus
(``utils/corpus.py``: attack payloads planted from per-class templates)
is replayed through the port's ``DetectionPipeline`` in monitoring mode,
and its verdicts are scored against the labels: tp, fp, fn, tn,
precision, recall, F1, per-class recall and per-family precision.  It
also measures the pipeline's requests/s on the chosen device
(``F1Report.platform``: ``cuda`` or ``cpu``).  With a scoring head, the
fixed-weights vs learned-head comparison runs on the same corpus.

CLI:
    python -m ingress_plus_tpu_torch.utils.evalf1 --n 2048 [--platform cpu]
prints one JSON report to stdout (``--platform`` defaults to ``cuda``,
which raises where there is no card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ingress_plus_tpu_torch.utils.device import DeviceLike


@dataclass
class F1Report:
    n: int
    tp: int
    fp: int
    fn: int
    tn: int
    blocked: int
    precision: float
    recall: float
    f1: float
    per_class_recall: Dict[str, float]
    false_positives: List[str]   # uris of misfired benign requests (≤20)
    false_negatives: List[str]   # "class: uri" of missed attacks (≤20)
    req_s: float
    platform: str
    mode: str
    n_rules: int
    #: per-CRS-family precision (the quality leg): of the requests
    #: each rule family confirmed on, what fraction were labeled
    #: attacks — the family-resolution FP attribution the aggregate
    #: precision averages away (recall stays per attack CLASS above:
    #: ground truth labels classes, verdicts name rule families)
    per_family: Dict[str, dict] = field(default_factory=dict)
    #: fixed-weights vs learned-head comparison (present when a scoring
    #: head was passed): FPs at equal-or-better recall, threshold,
    #: calibration curve — the ModSec-Learn claim, measured
    scorer_comparison: Optional[dict] = None

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def evaluate(n: int = 2048, mode: str = "monitoring",
             batch: int = 256, seed: int = 20260729,
             pipeline=None, attack_fraction: float = 0.3,
             warm: bool = True, scoring_head=None,
             device: DeviceLike = None) -> F1Report:
    """Score ``pipeline`` (default: a new one on the bundled rules, on
    ``device``, None = the card) on ``n`` labeled requests."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    if pipeline is None:
        pipeline = DetectionPipeline(
            compile_ruleset(load_bundled_rules()), mode=mode, device=device)
    corpus = generate_corpus(n=n, seed=seed,
                             attack_fraction=attack_fraction)

    if warm and corpus:
        pipeline.detect([lr.request for lr in corpus[:batch]])  # compile

    verdicts = []
    t0 = time.perf_counter()
    for i in range(0, len(corpus), batch):
        verdicts.extend(pipeline.detect(
            [lr.request for lr in corpus[i : i + batch]]))
    dt = time.perf_counter() - t0

    tp = fp = fn = tn = 0
    class_total: Dict[str, int] = {}
    class_hit: Dict[str, int] = {}
    fps: List[str] = []
    fns: List[str] = []
    from ingress_plus_tpu_torch.models.rule_stats import family_of

    fam_stats: Dict[str, List[int]] = {}  # family → [flagged, attacks]
    for lr, v in zip(corpus, verdicts):
        for fam in {family_of(rid) for rid in v.rule_ids}:
            t = fam_stats.setdefault(fam, [0, 0])
            t[0] += 1
            t[1] += 1 if lr.is_attack else 0
        if lr.is_attack:
            cls = lr.attack_class or "?"
            class_total[cls] = class_total.get(cls, 0) + 1
            if v.attack:
                tp += 1
                class_hit[cls] = class_hit.get(cls, 0) + 1
            else:
                fn += 1
                if len(fns) < 20:
                    fns.append("%s: %s" % (cls, lr.request.uri[:120]))
        else:
            if v.attack:
                fp += 1
                if len(fps) < 20:
                    fps.append(lr.request.uri[:120])
            else:
                tn += 1

    from ingress_plus_tpu_torch.utils.corpus import f1_score

    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0

    # fixed-vs-learned comparison leg: the SAME corpus through
    # the same pack with the head installed; verdict-level, end to end
    scorer_cmp = None
    if scoring_head is not None:
        scorer_cmp = _scorer_comparison(pipeline, scoring_head, corpus,
                                        verdicts, batch)
    return F1Report(
        n=len(corpus), tp=tp, fp=fp, fn=fn, tn=tn,
        blocked=sum(v.blocked for v in verdicts),
        precision=round(precision, 4), recall=round(recall, 4),
        f1=round(f1_score(tp, fp, fn), 4),
        per_class_recall={
            c: round(class_hit.get(c, 0) / t, 4)
            for c, t in sorted(class_total.items())},
        false_positives=fps, false_negatives=fns,
        req_s=round(len(corpus) / dt, 1),
        platform=pipeline.engine.device.type, mode=pipeline.mode,
        n_rules=pipeline.ruleset.n_rules,
        per_family={
            fam: {"flagged": t[0], "attacks": t[1],
                  "benign_fps": t[0] - t[1],
                  "precision": round(t[1] / t[0], 4)}
            for fam, t in sorted(fam_stats.items())},
        scorer_comparison=scorer_cmp)


def _scorer_comparison(fixed_pipeline, scoring_head, corpus,
                       fixed_verdicts, batch: int) -> dict:
    """Verdict-level fixed-vs-learned comparison on one labeled corpus
    (the quality-leg twin of learn.train.compare_scorers, which works
    on exported feature matrices — this one exercises the full serve
    finalize path)."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline

    learned = DetectionPipeline(
        fixed_pipeline.ruleset, mode=fixed_pipeline.mode,
        anomaly_threshold=fixed_pipeline.anomaly_threshold,
        engine=fixed_pipeline.engine, scoring_head=scoring_head)
    lv = []
    for i in range(0, len(corpus), batch):
        lv.extend(learned.detect(
            [lr.request for lr in corpus[i:i + batch]]))
    out = {"threshold": round(float(scoring_head.threshold), 6),
           "head_version": scoring_head.version,
           "fixed": {"fp": 0, "fn": 0, "flagged": 0},
           "learned": {"fp": 0, "fn": 0, "flagged": 0},
           "new_fn_vs_fixed": 0, "new_flag_vs_fixed": 0}
    for lr, fv, nv in zip(corpus, fixed_verdicts, lv):
        for key, v in (("fixed", fv), ("learned", nv)):
            if v.attack:
                out[key]["flagged"] += 1
                if not lr.is_attack:
                    out[key]["fp"] += 1
            elif lr.is_attack:
                out[key]["fn"] += 1
        if lr.is_attack and fv.attack and not nv.attack:
            out["new_fn_vs_fixed"] += 1
        if nv.attack and not fv.attack:
            out["new_flag_vs_fixed"] += 1
    out["fp_reduction"] = out["fixed"]["fp"] - out["learned"]["fp"]
    return out


def main(argv=None) -> int:
    from ingress_plus_tpu_torch.utils.platform import ensure_live_backend

    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.utils.evalf1")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mode", default="monitoring")
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--attack-fraction", type=float, default=0.3)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the device (default: the card; no fallback)")
    ap.add_argument("--scoring-head", default=None,
                    help="learned scoring-head artifact: adds the "
                         "fixed-vs-learned scorer_comparison block")
    args = ap.parse_args(argv)
    dev = ensure_live_backend(args.platform)
    head = None
    if args.scoring_head:
        from ingress_plus_tpu_torch.learn.head import ScoringHead

        head = ScoringHead.load(args.scoring_head)
    rep = evaluate(n=args.n, mode=args.mode, batch=args.batch,
                   seed=args.seed, attack_fraction=args.attack_fraction,
                   scoring_head=head, device=dev)
    print(json.dumps(rep.to_dict()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
