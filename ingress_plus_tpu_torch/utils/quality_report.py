"""The non-self-referential quality eval, as one JSON report.

Three legs, all through the full pipeline on the chosen device (the card
by default: its prefilter is the raw-byte pair kernel, ``pallas3``):

* **Evasion detection**: every classic public payload, plain and under
  each WAF-bypass transform (``utils/evasion.py``), through the FULL
  pipeline (prefilter + confirm + anomaly scoring).  Reported per
  transform so a weak decoder is visible, not averaged away.
* **False-positive rate**: ≥10k realistic benign requests through the
  same pipeline; any ``attack=True`` verdict is an FP.
* **Benign fixtures**: the hand-authored, generator-independent traffic
  of ``utils/benign_fixtures.py``, a second FP figure.

Usage:  python -m ingress_plus_tpu_torch.utils.quality_report \
            [--n-benign N] [--platform cpu] [--out PATH]
(``--out`` defaults to ``chiprun_out/QUALITY.json`` under the working
directory.)
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Dict, List

from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device


def build_report(n_benign: int = 10_000, batch: int = 256,
                 device: DeviceLike = None) -> dict:
    """The report, on a monitoring pipeline of the bundled pack built on
    ``device`` (None = the card; no card raises)."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.utils.evasion import generate_benign, generate_evasion

    device = resolve_device(device)      # no card raises before the compile
    cr = compile_ruleset(load_bundled_rules())
    pipeline = DetectionPipeline(cr, mode="monitoring", device=device)

    # ---- evasion leg
    samples = generate_evasion()
    per_transform: Dict[str, List[int]] = collections.defaultdict(
        lambda: [0, 0])  # [detected, total]
    per_class: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    misses: List[dict] = []
    for i in range(0, len(samples), batch):
        chunk = samples[i:i + batch]
        verdicts = pipeline.detect([s.labeled.request for s in chunk])
        for s, v in zip(chunk, verdicts):
            key = "+".join(s.transforms) if s.transforms else "plain"
            per_transform[key][1] += 1
            per_class[s.labeled.attack_class][1] += 1
            if v.attack:
                per_transform[key][0] += 1
                per_class[s.labeled.attack_class][0] += 1
            else:
                misses.append({"id": s.labeled.request.request_id,
                               "base": s.base_name,
                               "transforms": list(s.transforms)})
    ev_det = sum(v[0] for v in per_transform.values())
    ev_tot = sum(v[1] for v in per_transform.values())

    # ---- benign / FP leg
    benign = generate_benign(n=n_benign)
    fp_ids: List[str] = []
    fp_rules: Dict[int, int] = collections.defaultdict(int)
    for i in range(0, len(benign), batch):
        chunk = benign[i:i + batch]
        verdicts = pipeline.detect([b.request for b in chunk])
        for b, v in zip(chunk, verdicts):
            if v.attack:
                fp_ids.append(b.request.request_id)
                for rid in v.rule_ids:
                    fp_rules[rid] += 1

    # ---- hand-authored fixture leg: the second, generator-independent
    # benign FP figure.  Flagging fixtures are
    # reported with their rule ids — the known residue is the
    # CRS-parity class (verbatim SQL statements in support-ticket
    # prose, markdown code snippets with event handlers), which a stock
    # ModSecurity+CRS deployment also flags and operators handle with
    # exclusions.
    from ingress_plus_tpu_torch.utils.benign_fixtures import fixture_corpus

    fixtures = fixture_corpus()
    fx_fps: List[dict] = []
    verdicts = pipeline.detect([f.request for f in fixtures])
    for f, v in zip(fixtures, verdicts):
        if v.attack:
            fx_fps.append({"id": f.request.request_id,
                           "uri": f.request.uri,
                           "rules": [int(r) for r in v.rule_ids]})

    report = {
        "evasion": {
            "total": ev_tot,
            "detected": ev_det,
            "detection_rate": round(ev_det / max(ev_tot, 1), 4),
            "per_transform": {
                k: {"detected": v[0], "total": v[1],
                    "rate": round(v[0] / max(v[1], 1), 4)}
                for k, v in sorted(per_transform.items())},
            "per_class": {
                k: {"detected": v[0], "total": v[1],
                    "rate": round(v[0] / max(v[1], 1), 4)}
                for k, v in sorted(per_class.items())},
            "misses": misses,
        },
        "benign": {
            "total": len(benign),
            "false_positives": len(fp_ids),
            "fp_rate": round(len(fp_ids) / max(len(benign), 1), 5),
            "fp_ids": fp_ids[:50],
            "fp_rule_counts": {str(k): v for k, v in
                               sorted(fp_rules.items(),
                                      key=lambda kv: -kv[1])[:20]},
        },
        "benign_fixture": {
            "total": len(fixtures),
            "false_positives": len(fx_fps),
            "fp_rate": round(len(fx_fps) / max(len(fixtures), 1), 4),
            "fps": fx_fps,
            "note": ("hand-authored, generator-independent traffic "
                     "(utils/benign_fixtures.py): GraphQL, OAuth/OIDC, "
                     "nested JSON configs, SQL-in-prose tickets, code "
                     "snippets, webhooks, uploads.  Residual FPs are "
                     "the CRS-parity class — verbatim SQL statements "
                     "in prose and markdown code with event handlers, "
                     "which stock ModSecurity+CRS also flags"),
        },
        "ruleset": {"n_rules": int(cr.n_rules)},
        "platform": pipeline.engine.device.type,
        "scan_impl": pipeline.engine.scan_impl,
        "method": ("full pipeline (prefilter+confirm+anomaly, monitoring "
                   "mode); evasion corpus = utils/evasion.py CLASSIC x "
                   "transforms (public payloads, independent of rule "
                   "templates); benign corpus = utils/evasion.py "
                   "generate_benign (form/JSON/cookie-blob traffic)"),
    }
    return report


def main(argv=None) -> int:
    from ingress_plus_tpu_torch.utils.platform import ensure_live_backend

    ap = argparse.ArgumentParser(
        prog="ingress_plus_tpu_torch.utils.quality_report")
    ap.add_argument("--n-benign", type=int, default=10_000)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the device (default: the card; no fallback)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "QUALITY.json"),
                    help="where the JSON report goes")
    args = ap.parse_args(argv)
    rep = build_report(n_benign=args.n_benign,
                       device=ensure_live_backend(args.platform))
    out = args.out
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f, indent=1)
    ev, bn = rep["evasion"], rep["benign"]
    print("evasion: %d/%d detected (%.1f%%); benign FP: %d/%d (%.3f%%)"
          % (ev["detected"], ev["total"], 100 * ev["detection_rate"],
             bn["false_positives"], bn["total"], 100 * bn["fp_rate"]))
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
