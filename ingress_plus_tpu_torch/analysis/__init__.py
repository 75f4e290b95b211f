"""rulecheck — static analyzer for compiled rulesets.

Runs five check classes over the parsed SecLang tree, the regex ASTs
and the compiled sigpack (see docs/ANALYSIS.md for the full catalog):

  1. prefilter-soundness audit   (analysis/prefilter_audit.py)
  2. control-flow reachability   (analysis/reach.py)
  3. TX / setvar dataflow        (analysis/txflow.py)
  4. regex hazards / ReDoS       (analysis/redos.py)
  5. transform-lane consistency  (analysis/lanecheck.py)

Entry points: ``run_rulecheck()`` (library), ``python -m
ingress_plus_tpu_torch.analysis`` (CLI, text/JSON/SARIF) and ``dbg
rulecheck`` (control/dbg.py).  The guarded rollout's admission gate
(control/rollout.py ``_static_gate``) runs the three checks that need
no SecLang source (1, 4, 5) on a compiled pack.

The package also hosts ``concheck`` — the concurrency static analyzer
over this package's serve-plane SOURCES (analysis/concheck.py +
threadmap.py, docs/ANALYSIS.md "Concurrency analysis"):
``run_concheck()``, ``python -m ingress_plus_tpu_torch.analysis
--conc``, ``dbg concheck`` — and ``evadecheck``, the evasion-closure
analyzer (analysis/evadecheck.py, docs/ANALYSIS.md "Evasion
analysis"): ``run_evadecheck()``, ``python -m
ingress_plus_tpu_torch.analysis --evade``, ``dbg evadecheck``, with the
utils/evasion.py mutation harness as its runtime twin.  None of them
imports a kernel or touches a device: they read sources and packs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ingress_plus_tpu_torch.analysis.findings import (  # noqa: F401 (public API)
    Baseline,
    BaselineError,
    Finding,
    Report,
    SEVERITIES,
)
from ingress_plus_tpu_torch.analysis.concheck import (  # noqa: F401 (public API)
    run_concheck,
)
from ingress_plus_tpu_torch.analysis.evadecheck import (  # noqa: F401 (public API)
    run_evadecheck,
)
from ingress_plus_tpu_torch.analysis.lanecheck import check_lanes
from ingress_plus_tpu_torch.analysis.prefilter_audit import audit_prefilter
from ingress_plus_tpu_torch.analysis.reach import check_reachability
from ingress_plus_tpu_torch.analysis.redos import check_regex_hazards
from ingress_plus_tpu_torch.analysis.scan import rule_positions, scan_tree
from ingress_plus_tpu_torch.analysis.txflow import check_tx_dataflow

#: the bundled CRS-shaped tree — the default audit subject; its
#: accepted-findings baseline ships next to it as rulecheck-baseline.json
#: (resolved by run_rulecheck's "auto" mode)
BUNDLED_RULES = Path(__file__).resolve().parent.parent / "rules" / "crs"


def run_rulecheck(rules_path: Optional[str | Path] = None,
                  baseline_path: Optional[str | Path] = "auto",
                  compiled=None) -> Report:
    """Run every analyzer over a rules tree.

    ``baseline_path="auto"`` picks ``<rules>/rulecheck-baseline.json``
    when present; ``None`` disables suppression.  ``compiled`` may pass
    a pre-built CompiledRuleset to skip recompilation (dbg paths)."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir

    rules_path = Path(rules_path) if rules_path is not None else \
        BUNDLED_RULES
    if not rules_path.exists():
        raise OSError("rules tree %s does not exist — an empty audit "
                      "would report a misleading clean pass" % rules_path)
    if compiled is None:
        compiled = compile_ruleset(load_seclang_dir(rules_path))

    scans = scan_tree(rules_path)
    findings = []
    findings += audit_prefilter(compiled.rules, compiled.tables)
    findings += check_reachability(scans)
    def _has_anomaly_setvars() -> bool:
        for m in compiled.rules:
            link = m.rule
            while link is not None:
                if any("anomaly_score" in sv.partition("=")[0].lower()
                       for sv in link.setvars):
                    return True
                link = link.chain
        return False

    findings += check_tx_dataflow(
        scans,
        anomaly_threshold=compiled.anomaly_threshold,
        max_anomaly_sum=int(np.sum(compiled.rule_score)),
        explicit_anomaly=_has_anomaly_setvars())
    findings += check_regex_hazards(compiled.rules)
    findings += check_lanes(compiled.rules)

    # attach source positions to findings that only know their rule id,
    # then relativize paths: reports and SARIF must not embed
    # machine-specific absolute paths (code scanning cannot map
    # absolute URIs, and checked-in reports would differ per checkout
    # location)
    pos = rule_positions(scans)
    rel_bases = [Path.cwd(),
                 rules_path if rules_path.is_dir() else rules_path.parent]

    def _rel(p: str) -> str:
        for base in rel_bases:
            try:
                return str(Path(p).resolve().relative_to(base.resolve()))
            except ValueError:
                continue
        return p

    for f in findings:
        if not f.file and f.rule_id in pos:
            f.file, f.line = pos[f.rule_id]
        if f.file:
            f.file = _rel(f.file)

    resolved_baseline = ""
    if baseline_path == "auto":
        # an entry-config FILE keeps its baseline next to it
        # (<file>/rulecheck-baseline.json is never a file, so accepted
        # findings would silently re-gate)
        base_dir = rules_path.parent if rules_path.is_file() else rules_path
        cand = base_dir / "rulecheck-baseline.json"
        baseline_path = cand if cand.is_file() else None
    if baseline_path is not None:
        bl = Baseline.load(baseline_path)
        bl.apply(findings)
        resolved_baseline = bl.path

    return Report(
        findings=findings,
        rules_path=_rel(str(rules_path)),
        baseline_path=_rel(resolved_baseline) if resolved_baseline else "",
        n_rules=compiled.n_rules,
        pack_version=compiled.version,
        reduction=getattr(compiled, "reduction", None),
    )
