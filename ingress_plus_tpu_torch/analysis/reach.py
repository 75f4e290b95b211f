"""Control-flow reachability checks (check class 2).

Re-derives the parser's skipAfter/SecMarker semantics over the raw
directive stream and reports what the parser survives silently:

  flow.dangling-marker   (error)   skipAfter names a marker that never
                                   appears later in the same file — the
                                   region silently extends to EOF and
                                   drops every same-phase rule after it
  flow.marker-splits-chain (error) a SecMarker lands between a chain
                                   leader and its continuation links —
                                   a jump to it would tear the chain
  flow.unreachable-paranoia (warning) a rule is inside a skip region
                                   whose condition holds at EVERY
                                   paranoia level 1–4: no deployment
                                   setting can ever activate it
  flow.bad-paranoia-tag  (warning) paranoia-level/N tag outside 1–4
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ingress_plus_tpu_torch.analysis.findings import Finding
from ingress_plus_tpu_torch.analysis.scan import FileScan, root_scans
from ingress_plus_tpu_torch.compiler.seclang import (
    _fold_tx_assignments,
    _invalidate_tx_names,
    _static_skip_condition,
)

#: TX names the CRS family uses to carry the deployment paranoia level —
#: reachability is evaluated with each of these forced to PL 1..4
_PARANOIA_VARS = ("detection_paranoia_level", "paranoia_level",
                  "blocking_paranoia_level", "executing_paranoia_level")

_PL_TAG = re.compile(r"paranoia-level/(\d+)")


def _simulate_skipped(scans: List[FileScan], pl: int,
                      base_tx: Optional[Dict[str, str]]) -> Dict[int, object]:
    """Walk the whole tree IN LOAD ORDER under trial paranoia level
    ``pl``, mirroring the parser's skip semantics: conditions evaluate
    against the env at their load point (an end-state
    env would both miss real skips and invent false ones), setvars
    fold/invalidate as they execute, and skip regions follow the
    Include topology — a region survives INTO an included file (whose
    markers can close it) and is cleared after each included file, like
    the parser's `_skip_state["skips"] = []` at Include boundaries.
    Returns skipped Directives keyed by id()."""
    env: Dict[str, str] = dict(base_tx or {})
    tainted: set = set()   # paranoia vars invalidated (request-dependent)

    def force() -> None:
        # the trial PL is the deployment knob being swept: it overrides
        # whatever the tree's own SecActions assign — unless a
        # request-dependent write made the variable unknowable
        for name in _PARANOIA_VARS:
            if name in tainted:
                env.pop(name, None)
            else:
                env[name] = str(pl)

    def invalidate(setvars) -> None:
        for name in _invalidate_tx_names(env, setvars):
            if name in _PARANOIA_VARS:
                tainted.add(name)

    force()
    skipped: Dict[int, object] = {}

    def walk(fs: FileScan, active: List[Tuple[str, str]]) -> None:
        in_chain = False
        skip_chain = False
        for idx, d in enumerate(fs.directives):
            if d.kind == "Include":
                for child in fs.includes.get(idx, []):
                    walk(child, active)
                    del active[:]   # parser clears after each include
                continue
            if d.kind == "SecMarker":
                name = d.tokens[1].strip().strip("'\"") \
                    if len(d.tokens) > 1 else ""
                active[:] = [r for r in active if r[0] != name]
                continue
            if d.kind not in ("SecRule", "SecAction"):
                continue
            is_link = False
            if d.kind == "SecRule":
                is_link = in_chain
                in_chain = d.is_chain_link_opener
            if is_link:
                if skip_chain:
                    skipped[id(d)] = d
                    if not d.is_chain_link_opener:
                        skip_chain = False
                else:
                    invalidate(d.setvars)   # conjunction-conditioned
                    force()
                continue
            if any(ph == d.phase for _m, ph in active):
                skipped[id(d)] = d
                if d.kind == "SecRule" and d.is_chain_link_opener:
                    skip_chain = True
                continue
            if d.kind == "SecAction":
                # actions execute, then an unconditional jump (if any)
                _fold_tx_assignments(env, d.setvars)
                force()
                if d.skip_marker is not None:
                    active.append((d.skip_marker, d.phase))
                continue
            if d.is_chain_link_opener:
                invalidate(d.setvars)       # chain leader: never static
                force()
                continue
            negate, op, arg = d.operator()
            verdict = _static_skip_condition(d.targets_txt, negate, op,
                                             arg, env)
            if d.skip_marker is not None and verdict is True:
                _fold_tx_assignments(env, d.setvars)  # before the jump
                force()
                active.append((d.skip_marker, d.phase))
                continue
            if d.skip_marker is not None and verdict is False:
                continue                    # inert control rule
            if verdict is True:
                _fold_tx_assignments(env, d.setvars)
            elif verdict is None:
                invalidate(d.setvars)
            force()

    for fs in root_scans(scans):
        walk(fs, [])    # fresh regions per entry file (parser behavior)
    return skipped


def _marker_reachable(fs: FileScan, i: int, marker: str) -> bool:
    """Can a region opened at directive ``i`` of ``fs`` meet its marker
    before the parser clears it?  Forward in the same file; across an
    Include, only the FIRST included file's prefix counts — the parser
    clears skip regions after each included file (so a
    marker in the Include'd file is NOT dangling)."""
    for j in range(i + 1, len(fs.directives)):
        d = fs.directives[j]
        if d.kind == "SecMarker" and len(d.tokens) > 1 and \
                d.tokens[1].strip().strip("'\"") == marker:
            return True
        if d.kind == "Include":
            children = fs.includes.get(j, [])
            if children:
                return _marker_reachable(children[0], -1, marker)
    return False


def _chain_spans(fs: FileScan) -> List[Tuple[int, int]]:
    """(leader_idx, last_link_idx) spans of SecRule chains."""
    spans = []
    i, n = 0, len(fs.directives)
    while i < n:
        d = fs.directives[i]
        if d.kind == "SecRule" and d.is_chain_link_opener:
            j = i + 1
            while j < n:
                dj = fs.directives[j]
                if dj.kind != "SecRule":
                    j += 1
                    continue
                if not dj.is_chain_link_opener:
                    break
                j += 1
            spans.append((i, min(j, n - 1)))
            i = j + 1
        else:
            i += 1
    return spans


def check_reachability(scans: List[FileScan],
                       base_tx: Optional[Dict[str, str]] = None
                       ) -> List[Finding]:
    findings: List[Finding] = []

    # the paranoia sweep: a rule skipped under EVERY trial PL is
    # unreachable by any deployment setting
    skipped_at: Dict[int, list] = {}
    for pl in (1, 2, 3, 4):
        for key, dj in _simulate_skipped(scans, pl, base_tx).items():
            skipped_at.setdefault(key, [dj, set()])[1].add(pl)
    for dj, pls in skipped_at.values():
        if len(pls) != 4:
            continue
        if dj.kind == "SecRule" and dj.skip_marker is None:
            findings.append(Finding(
                check="flow.unreachable-paranoia",
                severity="warning", rule_id=dj.rule_id,
                file=dj.file, line=dj.line,
                message="rule is skipped at every paranoia level 1-4: "
                        "no deployment setting ever activates it"))

    for fs in scans:
        markers_at = [i for i, d in enumerate(fs.directives)
                      if d.kind == "SecMarker"]
        marker_names = {
            i: fs.directives[i].tokens[1].strip().strip("'\"")
            for i in markers_at if len(fs.directives[i].tokens) > 1}

        for i, d in enumerate(fs.directives):
            marker = d.skip_marker
            if marker is not None and d.kind in ("SecRule", "SecAction"):
                if not _marker_reachable(fs, i, marker):
                    findings.append(Finding(
                        check="flow.dangling-marker", severity="error",
                        rule_id=d.rule_id, subject=marker,
                        file=d.file, line=d.line,
                        message="skipAfter:%s meets no SecMarker before "
                                "the region is cleared: a taken jump "
                                "silently skips same-phase rules to the "
                                "end of the file (or first Include)"
                                % marker))
            if d.kind == "SecRule":
                for t in d.actions.get("tag", []):
                    m = _PL_TAG.search(t)
                    if m and not (1 <= int(m.group(1)) <= 4):
                        findings.append(Finding(
                            check="flow.bad-paranoia-tag",
                            severity="warning", rule_id=d.rule_id,
                            subject=t.strip("'\""),
                            file=d.file, line=d.line,
                            message="paranoia-level/%s is outside 1-4: "
                                    "the paranoia mask can never enable "
                                    "this rule" % m.group(1)))

        for leader, last in _chain_spans(fs):
            split = [j for j in markers_at if leader < j <= last]
            if split:
                d = fs.directives[leader]
                findings.append(Finding(
                    check="flow.marker-splits-chain", severity="error",
                    rule_id=d.rule_id,
                    subject=marker_names.get(split[0], "?"),
                    file=d.file, line=fs.directives[split[0]].line,
                    message="SecMarker '%s' lands inside the chain of "
                            "rule %s: a jump to it would run a partial "
                            "chain" % (marker_names.get(split[0], "?"),
                                       d.rule_id or "?")))

    return findings
