"""TX / setvar dataflow checks (check class 3).

Collects every TX write (``setvar:tx.NAME=...``), read (``TX:NAME``
target, ``%{tx.NAME}`` macro) and engine-consumed name across the tree
in load order, then reports:

  tx.read-before-write   (warning) a TX variable is read but never
                                   written anywhere (or only written
                                   later in load order) — stale-name
                                   reads abstain at best, compare
                                   against garbage at worst
  tx.dead-write          (notice)  a setvar target nothing ever reads
  tx.threshold-unreachable (error) the compiled blocking threshold
                                   exceeds the sum of every rule's
                                   possible anomaly contribution — the
                                   949-style blocking rule can never fire
  tx.anomaly-never-evaluated (warning) rules contribute anomaly score
                                   but no threshold rule consumes it
  tx.conditional-setvar-skip (warning) a skipAfter condition reads a TX
                                   variable that a *conditional* SecRule
                                   writes: the parser abstains (keeps
                                   rules active) because the write is
                                   request-dependent — make it a
                                   SecAction if it is really static
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from ingress_plus_tpu_torch.analysis.findings import Finding
from ingress_plus_tpu_torch.analysis.scan import (
    FileScan,
    iter_load_order,
    static_tx_env,
)

#: names the COMPILER itself consumes from the static TX env
_ENGINE_READ = {
    "inbound_anomaly_score_threshold", "outbound_anomaly_score_threshold",
    "detection_paranoia_level", "paranoia_level",
    "blocking_paranoia_level", "executing_paranoia_level",
    "critical_anomaly_score", "error_anomaly_score",
    "warning_anomaly_score", "notice_anomaly_score",
}
#: names with compiler-provided defaults (readable without any write)
_DEFAULTED = {
    "critical_anomaly_score", "error_anomaly_score",
    "warning_anomaly_score", "notice_anomaly_score",
}
#: the anomaly accumulator family is consumed by the compiled score
#: matmul + threshold resolution even when no directive reads it back
_ANOMALY = re.compile(r"(^|_)anomaly_score(_pl\d)?$")

_MACRO = re.compile(r"%\{tx\.([a-zA-Z0-9_.]+)\}", re.IGNORECASE)


def _tx_reads(d) -> List[Tuple[str, bool]]:
    """``(name_or_pattern, is_regex)`` TX reads of this directive:
    TX: targets (incl. the CRS ``TX:/^prefix_/`` regex-selector shape —
    treating those as literal names would produce false
    read-before-write AND dead-write findings) + %{tx.*} macros in the
    operator argument and every action value."""
    reads: List[Tuple[str, bool]] = []
    if d.kind == "SecRule":
        for t in d.targets_txt.split("|"):
            t = t.strip().lstrip("&!")
            if t.upper().startswith("TX:"):
                sel = t.split(":", 1)[1].strip()
                if sel.startswith("/"):
                    reads.append((sel.strip("/").lower(), True))
                else:
                    reads.append((sel.lower(), False))
        _, _, arg = d.operator()
        reads.extend((m.lower(), False) for m in _MACRO.findall(arg))
    for vals in d.actions.values():
        for v in vals:
            reads.extend((m.lower(), False)
                         for m in _MACRO.findall(v or ""))
    return reads


def _tx_writes(d) -> List[str]:
    """TX names this directive writes (delete form included — a delete
    is a write for dataflow purposes), via the parser's shared setvar
    normalization."""
    from ingress_plus_tpu_torch.compiler.seclang import _classify_setvar
    out = []
    for sv in d.setvars:
        key, kind, _value = _classify_setvar(sv)
        if kind is not None:
            out.append(key)
    return out


def check_tx_dataflow(scans: List[FileScan], anomaly_threshold=None,
                      max_anomaly_sum: int = 0,
                      explicit_anomaly: bool = False) -> List[Finding]:
    findings: List[Finding] = []

    writes: Dict[str, Tuple[int, str, int]] = {}  # first write wins
    reads: List[Tuple[str, int, object]] = []
    skip_cond_reads: List[Tuple[str, int, object]] = []
    order_of: Dict[int, int] = {}     # id(directive) → load order
    any_capture = False
    order = 0
    # the include-following iterator, NOT a flat per-file walk: load
    # order interleaves at the Include point (a flat order would
    # invert read/write positions across Includes)
    for _fs, d in iter_load_order(scans):
        if d.kind not in ("SecRule", "SecAction"):
            continue
        order += 1
        order_of[id(d)] = order
        if "capture" in d.actions:
            any_capture = True
        for name in _tx_writes(d):
            if name not in writes:
                writes[name] = (order, d.file, d.line)
        for name, is_regex in _tx_reads(d):
            reads.append((name, is_regex, order, d))
        if d.skip_marker is not None and d.kind == "SecRule":
            for t in d.targets_txt.split("|"):
                t = t.strip().lstrip("&!")
                if t.upper().startswith("TX:"):
                    skip_cond_reads.append(
                        (t.split(":", 1)[1].strip().lower(), order, d))

    # request-dependent writes only: a SecRule whose condition resolves
    # statically true FOLDS like a SecAction (the parser's semantics —
    # flagging those would produce a factually wrong "rules stay
    # active" warning on trees the parser statically skips)
    _, conditional_writes = static_tx_env(scans)

    reported: set = set()
    for name, is_regex, order_r, d in reads:
        if name in reported:
            continue
        if is_regex:
            # regex selector: satisfied by ANY matching write; no
            # positional check (the selector deliberately ranges over
            # names written all over the tree)
            try:
                pat = re.compile(name)
            except re.error:
                continue
            if not any(pat.search(w) for w in writes):
                reported.add(name)
                findings.append(Finding(
                    check="tx.read-before-write", severity="warning",
                    rule_id=d.rule_id, subject="tx:/%s/" % name,
                    file=d.file, line=d.line,
                    message="TX selector /%s/ matches no variable ever "
                            "written in the tree (stale or typo'd "
                            "pattern?)" % name))
            continue
        if name.isdigit():
            if not any_capture:
                reported.add(name)
                findings.append(Finding(
                    check="tx.read-before-write", severity="warning",
                    rule_id=d.rule_id, subject="tx.%s" % name,
                    file=d.file, line=d.line,
                    message="capture variable tx.%s is read but no rule "
                            "in the tree uses the capture action" % name))
            continue
        if name in _DEFAULTED:
            continue
        w = writes.get(name)
        if w is None:
            reported.add(name)
            findings.append(Finding(
                check="tx.read-before-write", severity="warning",
                rule_id=d.rule_id, subject="tx.%s" % name,
                file=d.file, line=d.line,
                message="tx.%s is read but never written anywhere in "
                        "the tree (stale or typo'd name?)" % name))
        elif w[0] > order_r:
            reported.add(name)
            findings.append(Finding(
                check="tx.read-before-write", severity="warning",
                rule_id=d.rule_id, subject="tx.%s" % name,
                file=d.file, line=d.line,
                message="tx.%s is read before its first write (%s:%d "
                        "in load order)" % (name, w[1], w[2])))

    read_names = {name for name, is_regex, _, _ in reads if not is_regex}
    read_patterns = []
    for name, is_regex, _, _ in reads:
        if is_regex:
            try:
                read_patterns.append(re.compile(name))
            except re.error:
                pass
    for name, (order_w, file, line) in sorted(writes.items()):
        if name in read_names or name in _ENGINE_READ or \
                _ANOMALY.search(name) or \
                any(p.search(name) for p in read_patterns):
            continue
        findings.append(Finding(
            check="tx.dead-write", severity="notice",
            subject="tx.%s" % name, file=file, line=line,
            message="tx.%s is written but nothing (directive or engine) "
                    "ever reads it" % name))

    for name, order_r, d in skip_cond_reads:
        w = conditional_writes.get(name)
        # only a conditional write the parser has already seen at the
        # read point makes the condition abstain; a later write leaves
        # the static resolution intact (flagging those would
        # claim "rules stay active" for tiers the parser skips)
        if w is not None and order_of.get(id(w), order_r + 1) < order_r:
            findings.append(Finding(
                check="tx.conditional-setvar-skip", severity="warning",
                rule_id=d.rule_id, subject="tx.%s" % name,
                file=d.file, line=d.line,
                message="skipAfter condition reads tx.%s, which the "
                        "conditional SecRule %s writes: the write is "
                        "request-dependent, so the jump never resolves "
                        "statically (rules stay active); use SecAction "
                        "for static configuration" % (name,
                                                      w.rule_id or "?")))

    scored = max_anomaly_sum
    if anomaly_threshold is not None and scored and \
            anomaly_threshold > scored:
        findings.append(Finding(
            check="tx.threshold-unreachable", severity="error",
            subject="anomaly_threshold",
            message="blocking threshold %d exceeds the sum of every "
                    "rule's possible anomaly contribution (%d): anomaly "
                    "blocking can never fire"
                    % (anomaly_threshold, scored)))
    # only trees that OPT INTO anomaly mode (explicit setvar
    # increments) are expected to carry a 949-style threshold rule —
    # severity-fallback scores exist on every rule and the engine has a
    # default threshold, so warning on their absence alone was a false
    # positive on every plain block-action tree
    if anomaly_threshold is None and explicit_anomaly:
        findings.append(Finding(
            check="tx.anomaly-never-evaluated", severity="warning",
            subject="anomaly_threshold",
            message="rules carry explicit anomaly-score setvar "
                    "increments but the tree has no 949-style "
                    "threshold rule: the engine falls back to its "
                    "default threshold instead of the CRS-configured "
                    "one"))
    return findings
