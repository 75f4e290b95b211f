"""Finding model, suppression baseline, and output renderers for rulecheck.

A *finding* is one machine-checked statement about the compiled ruleset
(see docs/ANALYSIS.md for the check catalog).  Severities gate CI:

    error    — a soundness/correctness hole (prefilter can lose a match,
               control flow drops rules ModSecurity would run, a blocking
               threshold that can never fire).  CI fails on unsuppressed
               errors.
    warning  — likely authoring bug or silent degradation worth a human
               look (read-before-write TX, coverage gap).
    notice   — measurable-but-accepted weakness (weak factor, polynomial
               backtracking shape).
    info     — by-design behavior surfaced for visibility (confirm-only
               rules, heuristic trigger groups).

The suppression baseline is a checked-in JSON list of accepted findings
("this limitation is known, here is why"); a suppressed finding still
appears in reports (``suppressed: true``) but never gates.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

SEVERITIES = ("error", "warning", "notice", "info")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

#: SARIF has no "notice"/"info" split at the level granularity we use
_SARIF_LEVEL = {"error": "error", "warning": "warning",
                "notice": "note", "info": "note"}


@dataclass
class Finding:
    """One rulecheck result.

    ``check`` is the stable dotted id (e.g. ``flow.dangling-marker``);
    ``subject`` is the non-rule anchor (marker name, TX variable,
    transform name) used for suppression matching when ``rule_id`` alone
    is ambiguous or absent.
    """

    check: str
    severity: str
    message: str
    rule_id: int = 0
    subject: str = ""
    file: str = ""
    line: int = 0
    suppressed: bool = False
    suppress_reason: str = ""

    def sort_key(self):
        return (_SEV_RANK.get(self.severity, len(SEVERITIES)),
                self.check, self.rule_id, self.subject)

    def to_dict(self) -> Dict:
        d = {"check": self.check, "severity": self.severity,
             "message": self.message}
        if self.rule_id:
            d["rule_id"] = self.rule_id
        if self.subject:
            d["subject"] = self.subject
        if self.file:
            d["file"] = self.file
        if self.line:
            d["line"] = self.line
        if self.suppressed:
            d["suppressed"] = True
            d["suppress_reason"] = self.suppress_reason
        return d


class BaselineError(Exception):
    pass


@dataclass
class Baseline:
    """Accepted-findings list.  An entry matches a finding when the
    ``check`` ids are equal AND every anchor the entry names (rule_id,
    subject, class, file) matches — an entry with only ``check`` set
    accepts the whole class, which is deliberate for by-design info
    classes.  ``class`` matches the owner part of a dotted subject
    (``ConfirmResult.confirmed`` → ``ConfirmResult``) — concheck's
    class-level suppression for single-owner handoff objects."""

    entries: List[Dict] = field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str | Path) -> "Baseline":
        p = Path(path)
        try:
            data = json.loads(p.read_text())
        except (OSError, ValueError) as e:
            raise BaselineError("cannot read baseline %s: %s" % (p, e))
        entries = data.get("suppressions", data) if isinstance(data, dict) \
            else data
        if not isinstance(entries, list):
            raise BaselineError("baseline %s: expected a list" % p)
        for e in entries:
            if not isinstance(e, dict) or "check" not in e or \
                    not e.get("reason"):
                raise BaselineError(
                    "baseline %s: every entry needs 'check' and a "
                    "one-line 'reason': %r" % (p, e))
        return cls(entries=entries, path=str(p))

    def match(self, f: Finding) -> Optional[Dict]:
        for e in self.entries:
            if e["check"] != f.check:
                continue
            if "rule_id" in e and int(e["rule_id"]) != f.rule_id:
                continue
            if "subject" in e and e["subject"] != f.subject:
                continue
            if "class" in e and \
                    e["class"] != f.subject.partition(".")[0]:
                continue
            if "file" in e and e["file"] != Path(f.file).name:
                continue
            return e
        return None

    def apply(self, findings: List[Finding]) -> None:
        for f in findings:
            e = self.match(f)
            if e is not None:
                f.suppressed = True
                f.suppress_reason = e["reason"]


@dataclass
class Report:
    """The full analyzer run: findings + provenance."""

    findings: List[Finding]
    rules_path: str = ""
    baseline_path: str = ""
    n_rules: int = 0
    pack_version: str = ""
    #: which analyzer produced this report ("rulecheck" | "concheck" |
    #: "evadecheck") — renderers brand their headers/driver from it
    tool: str = "rulecheck"
    #: tool-specific provenance (concheck: analyzed files, the thread
    #: -root registry, the lock-order edge list)
    meta: Optional[Dict] = None
    #: approximate-merge provenance of the audited pack (compiler
    #: ReductionReport dict; None = exact compile).  The prefilter audit
    #: certifies soundness THROUGH the reduction (widened/truncated
    #: factors still cover every derivation), but an operator reading
    #: the report must be able to see what was merged and at what
    #: estimated candidate cost.
    reduction: Optional[Dict] = None

    def counts(self, suppressed: bool = False) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            if f.suppressed == suppressed:
                out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def gating(self, fail_on: str = "error") -> List[Finding]:
        """Unsuppressed findings at or above ``fail_on`` severity."""
        rank = _SEV_RANK[fail_on]
        return [f for f in self.findings
                if not f.suppressed and _SEV_RANK[f.severity] <= rank]

    # ------------------------------------------------------------ renderers

    def to_json(self) -> str:
        out = {
            "tool": self.tool,
            "rules_path": self.rules_path,
            "baseline": self.baseline_path,
            "n_rules": self.n_rules,
            "pack_version": self.pack_version,
            "reduction": self.reduction,
            "counts": self.counts(),
            "suppressed_counts": self.counts(suppressed=True),
            "findings": [f.to_dict()
                         for f in sorted(self.findings,
                                         key=Finding.sort_key)],
        }
        if self.meta is not None:
            out["meta"] = self.meta
        return json.dumps(out, indent=2, sort_keys=False) + "\n"

    def to_text(self) -> str:
        if self.tool == "concheck":
            m = self.meta or {}
            lines = ["concheck: %d functions over %d files, "
                     "%d thread roots"
                     % (m.get("functions", 0), len(m.get("files", ())),
                        len(m.get("thread_roots", ())))]
        elif self.tool == "evadecheck":
            m = self.meta or {}
            lines = ["evadecheck: %d rules, pack %s, "
                     "%d corroborated by runtime escapes"
                     % (self.n_rules, self.pack_version or "?",
                        m.get("corroborated", 0))]
        else:
            lines = ["rulecheck: %d rules, pack %s" %
                     (self.n_rules, self.pack_version or "?")]
        active = [f for f in self.findings if not f.suppressed]
        for f in sorted(active, key=Finding.sort_key):
            loc = Path(f.file).name if f.file else "-"
            if f.line:
                loc += ":%d" % f.line
            anchor = str(f.rule_id) if f.rule_id else (f.subject or "-")
            lines.append("%-8s %-28s %-22s %-10s %s"
                         % (f.severity, f.check, loc, anchor, f.message))
        c = self.counts()
        sup = sum(self.counts(suppressed=True).values())
        lines.append("%d error, %d warning, %d notice, %d info"
                     " (%d suppressed by baseline)"
                     % (c["error"], c["warning"], c["notice"], c["info"],
                        sup))
        return "\n".join(lines) + "\n"

    def to_sarif(self) -> str:
        """SARIF 2.1.0, one run, one rule descriptor per check id —
        minimal but valid for GitHub code-scanning upload."""
        by_check: Dict[str, str] = {}
        results = []
        for f in sorted(self.findings, key=Finding.sort_key):
            by_check.setdefault(f.check, f.severity)
            res: Dict = {
                "ruleId": f.check,
                "level": _SARIF_LEVEL[f.severity],
                "message": {"text": f.message},
            }
            if f.file:
                loc: Dict = {"artifactLocation": {"uri": f.file}}
                if f.line:
                    loc["region"] = {"startLine": f.line}
                res["locations"] = [{"physicalLocation": loc}]
            if f.suppressed:
                res["suppressions"] = [{
                    "kind": "external",
                    "justification": f.suppress_reason,
                }]
            results.append(res)
        sarif = {
            "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                        "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": self.tool,
                    "informationUri": "docs/ANALYSIS.md",
                    "version": "1.0.0",
                    "rules": [{"id": cid,
                               "defaultConfiguration":
                                   {"level": _SARIF_LEVEL[sev]}}
                              for cid, sev in sorted(by_check.items())],
                }},
                "results": results,
            }],
        }
        return json.dumps(sarif, indent=2) + "\n"
