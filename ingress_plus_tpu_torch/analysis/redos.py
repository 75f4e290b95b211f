"""Regex hazard checks (check class 4): static ReDoS lint + degraded
constructs, over the CONFIRM-lane patterns.

The confirm stage evaluates the original PCRE with Python ``re`` — a
backtracking engine — on attacker-controlled bytes, so catastrophic
backtracking is a real availability hazard there (the device scan lane is
linear-time by construction and immune).  Checks, on the parsed AST:

  regex.redos-nested-quantifier   (error)   an unbounded repeat whose
      body contains another unbounded repeat AND whose iterations can
      abut ambiguously (first/last byte classes of the body overlap):
      the (a+)+ shape — exponential backtracking on a miss
  regex.redos-overlapping-alternation (warning) an unbounded repeat over
      an alternation with intersecting option languages ((a|a)*,
      (a|ab)*): exponential path multiplicity
  regex.redos-adjacent-quantifiers (notice) two adjacent unbounded
      repeats with overlapping byte classes (\\s*\\s*, .*.*): O(n²)
      backtracking — tolerated, surfaced
  regex.degraded-construct        (notice)  pattern uses constructs the
      factor compiler cannot model (lookaround, backreferences, ...):
      the rule silently runs confirm-only on every applicable request
  regex.confirm-unparsable        (error)   the pattern does not compile
      in the confirm engine (Python ``re``) either: ConfirmRule holds
      rx=None and abstains forever — the rule is silently DEAD (the
      941300 shlex-halved-backslash shape this check first caught)
"""

from __future__ import annotations

import re as _re

from typing import Iterable, List, Set, Tuple

from ingress_plus_tpu_torch.analysis.findings import Finding
from ingress_plus_tpu_torch.compiler.regex_ast import (
    Alt,
    Anchor,
    Concat,
    Lit,
    Repeat,
    RegexUnsupported,
    parse_regex,
)

#: a bounded repeat this large backtracks like an unbounded one
_LARGE = 16


def _unbounded(r: Repeat) -> bool:
    return r.max is None or r.max >= _LARGE


def _first_classes(node) -> Tuple[Set[int], bool]:
    """(possible first bytes, nullable)."""
    if isinstance(node, Lit):
        return set(node.chars), False
    if isinstance(node, Anchor):
        return set(), True
    if isinstance(node, Repeat):
        first, nullable = _first_classes(node.node)
        return first, nullable or node.min == 0
    if isinstance(node, Alt):
        first: Set[int] = set()
        nullable = False
        for o in node.options:
            f, n = _first_classes(o)
            first |= f
            nullable = nullable or n
        return first, nullable
    if isinstance(node, Concat):
        first = set()
        for p in node.parts:
            f, n = _first_classes(p)
            first |= f
            if not n:
                return first, False
        return first, True
    return set(), True


def _last_classes(node) -> Tuple[Set[int], bool]:
    if isinstance(node, Concat):
        last: Set[int] = set()
        for p in reversed(node.parts):
            f, n = _last_classes(p)
            last |= f
            if not n:
                return last, False
        return last, True
    if isinstance(node, Alt):
        last = set()
        nullable = False
        for o in node.options:
            f, n = _last_classes(o)
            last |= f
            nullable = nullable or n
        return last, nullable
    if isinstance(node, Repeat):
        last, nullable = _last_classes(node.node)
        return last, nullable or node.min == 0
    if isinstance(node, Lit):
        return set(node.chars), False
    return set(), True


def _walk(node) -> Iterable:
    yield node
    if isinstance(node, Concat):
        for p in node.parts:
            yield from _walk(p)
    elif isinstance(node, Alt):
        for o in node.options:
            yield from _walk(o)
    elif isinstance(node, Repeat):
        yield from _walk(node.node)


def _alphabet(node) -> Set[int]:
    out: Set[int] = set()
    for n in _walk(node):
        if isinstance(n, Lit):
            out |= n.chars
    return out


def _ambiguous_inner_repeat(body) -> bool:
    """Is there an unbounded repeat inside ``body`` whose alphabet
    overlaps what can ADJOIN it — the bytes following/preceding it
    within an iteration, or (wrapping past nullable tails) the body's
    own first bytes from the next outer iteration?  That overlap lets
    the repeat absorb bytes the decomposition also needs elsewhere, so
    one string splits into exponentially many iteration decompositions
    ((a+)+ yes; (?:[^,]{0,64},)+ no — the separator disambiguates).
    Only the FOLLOW side creates this: a fixed predecessor is matched
    before the repeat ever starts (variable predecessors are the
    adjacent-quantifiers check's domain)."""
    first_b, _ = _first_classes(body)

    def rec(node, follow: Set[int]) -> bool:
        if isinstance(node, Repeat):
            if _unbounded(node) and _alphabet(node.node) & follow:
                return True
            return rec(node.node, follow)
        if isinstance(node, Alt):
            return any(rec(o, follow) for o in node.options)
        if isinstance(node, Concat):
            parts = node.parts
            for k, p in enumerate(parts):
                f: Set[int] = set()
                i = k + 1
                while i < len(parts):
                    fc, nullable = _first_classes(parts[i])
                    f |= fc
                    if not nullable:
                        break
                    i += 1
                else:
                    f |= follow      # everything after is nullable: wrap
                if rec(p, f):
                    return True
            return False
        return False

    # the wrap-around context: after the body ends, the next outer
    # iteration begins with the body's own first bytes
    return rec(body, first_b)


def _langs_overlap(a, b, cap: int = 32) -> bool:
    """Can options a and b match a common string (bounded check)?
    Classwise: same length + positionwise intersection, or one a
    classwise-intersecting prefix of the other."""
    from ingress_plus_tpu_torch.analysis.prefilter_audit import enum_language
    la = enum_language(a, cap)
    lb = enum_language(b, cap)
    if la is None or lb is None:
        return False  # conservative: no finding on unenumerable options
    for sa in la:
        for sb in lb:
            short, long_ = (sa, sb) if len(sa) <= len(sb) else (sb, sa)
            if all(short[i] & long_[i] for i in range(len(short))):
                return True
    return False


def hazards_for_pattern(ast) -> List[Tuple[str, str]]:
    """(check, detail) hazard list for one parsed pattern."""
    out: List[Tuple[str, str]] = []
    for node in _walk(ast):
        if not isinstance(node, Repeat) or not _unbounded(node):
            continue
        body = node.node
        if _ambiguous_inner_repeat(body):
            out.append((
                "regex.redos-nested-quantifier",
                "unbounded repeat of a body with an inner unbounded "
                "repeat whose alphabet overlaps its iteration "
                "boundary ((a+)+ shape)"))
            continue
        alts = [body] if isinstance(body, Alt) else \
            [n for n in _walk(body) if isinstance(n, Alt)]
        flagged = False
        for alt in alts:
            opts = alt.options
            for i in range(len(opts)):
                for j in range(i + 1, len(opts)):
                    if _langs_overlap(opts[i], opts[j]):
                        out.append((
                            "regex.redos-overlapping-alternation",
                            "alternation options under an unbounded "
                            "repeat can match the same string"))
                        flagged = True
                        break
                if flagged:
                    break
            if flagged:
                break

    for node in _walk(ast):
        if not isinstance(node, Concat):
            continue
        parts = [p for p in node.parts if not isinstance(p, Anchor)]
        for a, b in zip(parts, parts[1:]):
            if isinstance(a, Repeat) and isinstance(b, Repeat) and \
                    _unbounded(a) and _unbounded(b):
                last, _ = _last_classes(a)
                first, _ = _first_classes(b)
                if last & first:
                    out.append((
                        "regex.redos-adjacent-quantifiers",
                        "adjacent unbounded repeats over overlapping "
                        "byte classes (O(n²) backtracking)"))
    return out


def _iter_rx_confirms(metas):
    """Yield (rule_id, confirm_dict, where) for every rx evaluation the
    confirm stage performs — leaders and chain links."""
    for meta in metas:
        yield meta.rule.rule_id, meta.confirm, "rule"
        for k, link in enumerate(meta.confirm.get("chain", [])):
            yield meta.rule.rule_id, link, "chain link %d" % (k + 1)


def check_regex_hazards(metas) -> List[Finding]:
    findings: List[Finding] = []
    seen: set = set()
    for rid, confirm, where in _iter_rx_confirms(metas):
        if confirm.get("op") != "rx":
            continue
        arg = confirm.get("arg", "")
        key = (rid, where, arg)
        if key in seen:
            continue
        seen.add(key)
        try:
            # the confirm stage compiles the byte form of the pattern
            # (models/confirm.py ConfirmRule); a failure there means the
            # rule abstains on every request — dead, not degraded
            _re.compile(arg.encode("utf-8", "surrogateescape"))
        except _re.error as e:
            findings.append(Finding(
                check="regex.confirm-unparsable", severity="error",
                rule_id=rid, subject=where,
                message="pattern does not compile in the confirm "
                        "engine (%s): %s abstains on every request — "
                        "the rule is silently dead" % (e, where)))
            continue
        if "regex_unsupported" in confirm:
            findings.append(Finding(
                check="regex.degraded-construct", severity="notice",
                rule_id=rid, subject=where,
                message="pattern uses a construct the factor compiler "
                        "cannot model (%s): %s runs confirm-only on "
                        "every applicable request"
                        % (confirm["regex_unsupported"], where)))
            # hazards are still analyzable only if the AST parses; it
            # does not for unsupported constructs — Python re evaluates
            # them, so note the blind spot and move on
            continue
        try:
            ast = parse_regex(arg, ignorecase=bool(confirm.get("fold")))
        except RegexUnsupported as e:
            findings.append(Finding(
                check="regex.degraded-construct", severity="notice",
                rule_id=rid, subject=where,
                message="pattern unparsable at audit time (%s); ReDoS "
                        "lint blind for %s" % (e, where)))
            continue
        for check, detail in dict.fromkeys(hazards_for_pattern(ast)):
            sev = {"regex.redos-nested-quantifier": "error",
                   "regex.redos-overlapping-alternation": "warning",
                   "regex.redos-adjacent-quantifiers": "notice"}[check]
            findings.append(Finding(
                check=check, severity=sev, rule_id=rid, subject=where,
                message="%s — confirm-lane backtracking hazard in %s"
                        % (detail, where)))
    return findings
