"""Prefilter-soundness audit: static per-rule proof of the gate property.

A measurement gate can show *on a corpus* that the device bitap
prefilter never loses a confirm-stage match.  This module proves it
*statically, per rule*: it decodes the packed bitap tables back into
byte-class sequences (independent de-packing — a packing bug shows up
here, not just a derivation bug) and certifies, against a fresh
derivation from the rule's regex AST, that every string the rule can
match contains a substring matching one of the rule's packed factor
alternatives.  Certification logic:

    covered(d, G)   — class sequence d contains a window classwise
                      inside some alternative g of G (so every string
                      matching d contains a string matching g)
    certify(node,G) — exact when the node's language enumerates within
                      a bound; otherwise decomposes: any concat part (or
                      contiguous enumerable run of parts) certifying G
                      certifies the concat; an alternation certifies iff
                      every option does; Repeat(min>=1) via its body.

Squash/path scan lanes re-derive the compiler's factor-rewrite contract
independently: derived sequences are fragmented at ambiguous positions
(classes partially inside SQUASH_BYTES / path separators) with fully
deletable positions removed, and a factor must cover a window of some
fragment of EVERY alternative.

Rules without factors are classified (negated, non-scan operator,
degraded regex, unscannable target, destructive transform) so the
"silently falls to confirm-only" set is explicit; an rx rule with no
structural reason whose AST yields a certifiable factor group is a
coverage gap (the compiler left prefilter power on the table).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ingress_plus_tpu_torch.analysis.findings import Finding
from ingress_plus_tpu_torch.compiler.bitap import BitapTables
from ingress_plus_tpu_torch.compiler.regex_ast import (
    Alt,
    Anchor,
    Concat,
    Lit,
    Repeat,
    RegexUnsupported,
    parse_regex,
)

ClassSeq = Tuple[frozenset, ...]

#: enumeration bound — deliberately wider than the compiler's
#: MAX_ALTERNATIVES=64 so every group the compiler derived from an
#: enumerable (sub)language is re-derivable here
ENUM_CAP = 256
MAX_REPEAT_ENUM = 8
#: mirrors compiler MIN_GROUP_BITS: below this a derivable group is too
#: weak to call its absence a coverage gap
GAP_MIN_BITS = 6.0
WEAK_BITS = 6.0

# independent copies of the compiler's lane byte sets (ruleset.py);
# divergence between these and the compiler's is itself a bug the
# cross-check would surface as uncertified factors
_SQUASH = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B,
                     0x5C, 0x27, 0x22, 0x5E])
_PATH_SEP = frozenset([0x2F, 0x5C])

_FACTOR_OPS = {"rx", "pm", "pmf", "pmFromFile", "contains", "containsWord",
               "streq", "beginsWith", "endsWith"}
_HEURISTIC_OPS = {"detectSQLi", "detectXSS"}


def seq_bits(seq: ClassSeq) -> float:
    return sum(math.log2(256.0 / max(1, len(c))) for c in seq)


# ------------------------------------------------------------- de-packing


def decode_factors(tables: BitapTables) -> List[ClassSeq]:
    """Reconstruct every packed factor's byte-class sequence from the
    device tables (byte_table bit columns), independently of the
    compiler's packing bookkeeping."""
    out: List[ClassSeq] = []
    bt = tables.byte_table
    for f in range(tables.n_factors):
        w = int(tables.factor_word[f])
        fin = int(tables.factor_bit[f])
        length = int(tables.factor_len[f])
        start = fin - length + 1
        col = bt[:, w]
        seq = []
        for j in range(start, fin + 1):
            members = np.nonzero((col >> np.uint32(j)) & np.uint32(1))[0]
            seq.append(frozenset(int(b) for b in members))
        out.append(tuple(seq))
    return out


def rule_factor_groups(tables: BitapTables) -> Dict[int, List[int]]:
    """rule index → packed factor indices (CSR inversion)."""
    out: Dict[int, List[int]] = {}
    indptr = tables.factor_rule_indptr
    for f in range(tables.n_factors):
        for r in tables.factor_rule_ids[indptr[f]:indptr[f + 1]]:
            out.setdefault(int(r), []).append(f)
    return out


def table_consistency(tables: BitapTables) -> List[str]:
    """Structural invariants of the packed tables (start bit in INIT,
    final bit in FINAL, factor ranges inside their word)."""
    problems = []
    for f in range(tables.n_factors):
        w = int(tables.factor_word[f])
        fin = int(tables.factor_bit[f])
        length = int(tables.factor_len[f])
        start = fin - length + 1
        if not (0 <= start <= fin < 32):
            problems.append("factor %d: bit range [%d,%d] outside word"
                            % (f, start, fin))
            continue
        if not (int(tables.init_mask[w]) >> start) & 1:
            problems.append("factor %d: start bit %d missing from "
                            "init_mask[%d]" % (f, start, w))
        if not (int(tables.final_mask[w]) >> fin) & 1:
            problems.append("factor %d: final bit %d missing from "
                            "final_mask[%d]" % (f, fin, w))
    return problems


# ----------------------------------------------------- language machinery


def enum_language(node, cap: int = ENUM_CAP) -> Optional[List[ClassSeq]]:
    """Bounded exact enumeration of the class sequences ``node``
    matches; None when unbounded or past ``cap``."""
    if isinstance(node, Lit):
        return [(node.chars,)]
    if isinstance(node, Anchor):
        return [()]
    if isinstance(node, Alt):
        out: List[ClassSeq] = []
        for opt in node.options:
            sub = enum_language(opt, cap)
            if sub is None:
                return None
            out.extend(sub)
            if len(out) > cap:
                return None
        return list(dict.fromkeys(out))
    if isinstance(node, Concat):
        acc: List[ClassSeq] = [()]
        for part in node.parts:
            sub = enum_language(part, cap)
            if sub is None:
                return None
            acc = [a + b for a in acc for b in sub]
            if len(acc) > cap:
                return None
        return acc
    if isinstance(node, Repeat):
        if node.max is None or node.max > MAX_REPEAT_ENUM:
            return None
        base = enum_language(node.node, cap)
        if base is None:
            return None
        out = []
        piece: List[ClassSeq] = [()]
        for k in range(node.max + 1):
            if k >= node.min:
                out.extend(piece)
                if len(out) > cap:
                    return None
            if k < node.max:
                piece = [a + b for a in piece for b in base]
                if len(piece) > cap:
                    return None
        return list(dict.fromkeys(out))
    raise TypeError("unknown AST node %r" % (node,))


def lane_fragments(seq: ClassSeq, squash: bool,
                   path_split: bool) -> List[ClassSeq]:
    """A derived sequence's surviving contiguous fragments in the rule's
    scan lane.  Fully deletable positions vanish (neighbors adjacent in
    the squashed stream); ambiguously deletable / path-separator-capable
    positions are barriers a factor window cannot span."""
    if not squash and not path_split:
        return [seq]
    frags: List[List[frozenset]] = [[]]
    for cls in seq:
        if squash and cls <= _SQUASH:
            continue
        barrier = (squash and bool(cls & _SQUASH)) or \
                  (path_split and bool(cls & _PATH_SEP))
        if barrier:
            frags.append([])
        else:
            frags[-1].append(cls)
    return [tuple(f) for f in frags]


def covered(d: ClassSeq, group: Sequence[ClassSeq]) -> bool:
    """Does some window of ``d`` sit classwise inside some alternative
    of ``group`` (⇒ every string matching d contains a group match)?"""
    for g in group:
        L = len(g)
        if L == 0 or L > len(d):
            continue
        for off in range(len(d) - L + 1):
            if all(d[off + i] <= g[i] for i in range(L)):
                return True
    return False


def _enum_certifies(seqs: List[ClassSeq], group: Sequence[ClassSeq],
                    squash: bool, path_split: bool) -> bool:
    for d in seqs:
        if not any(covered(f, group)
                   for f in lane_fragments(d, squash, path_split)):
            return False
    return True


def certify(node, group: Sequence[ClassSeq], squash: bool = False,
            path_split: bool = False) -> bool:
    """True iff every match of ``node`` provably contains (in the rule's
    scan lane) a substring matching ``group``.  False = NOT certified
    (may still be sound — but the static proof failed, which for
    compiler-produced groups means a compiler bug)."""
    seqs = enum_language(node)
    if seqs is not None:
        return _enum_certifies(seqs, group, squash, path_split)
    if isinstance(node, Repeat):
        return node.min >= 1 and certify(node.node, group, squash,
                                         path_split)
    if isinstance(node, Alt):
        return all(certify(opt, group, squash, path_split)
                   for opt in node.options)
    if isinstance(node, Concat):
        # contiguous runs of enumerable parts form exactly-known
        # sub-languages that appear contiguously in every match
        run: List[ClassSeq] = [()]
        for part in node.parts:
            sub = enum_language(part)
            if sub is not None and len(sub) * len(run) <= ENUM_CAP:
                run = [a + b for a in run for b in sub]
                continue
            if run != [()] and _enum_certifies(run, group, squash,
                                               path_split):
                return True
            if sub is not None:
                # product overflowed the cap: the part still starts a
                # fresh run of its own (dropping it
                # produced false uncertified errors on sound groups)
                run = sub
            else:
                run = [()]
                if certify(part, group, squash, path_split):
                    return True
        return run != [()] and _enum_certifies(run, group, squash,
                                               path_split)
    return False


def derive_group(node, squash: bool = False,
                 path_split: bool = False) -> Optional[List[ClassSeq]]:
    """Independently derive a usable mandatory factor group, used to
    distinguish 'no factor exists' from 'compiler missed one'.
    Deliberately simpler than the compiler's extractor — a None here is
    conservative (no coverage-gap warning), never wrong."""
    seqs = enum_language(node)
    if seqs is not None:
        group: List[ClassSeq] = []
        for d in seqs:
            frags = [f for f in lane_fragments(d, squash, path_split) if f]
            if not frags:
                return None
            best = max(frags, key=seq_bits)
            # trim uninformative edges, clamp to a bitap word
            lo, hi = 0, len(best)
            while lo < hi and len(best[lo]) == 256:
                lo += 1
            while hi > lo and len(best[hi - 1]) == 256:
                hi -= 1
            best = best[lo:hi][:32]
            if not best:
                return None
            group.append(best)
        group = list(dict.fromkeys(group))
        if 0 < len(group) <= 64 and \
                min(seq_bits(g) for g in group) >= GAP_MIN_BITS:
            return group
        return None
    if isinstance(node, Repeat):
        if node.min >= 1:
            return derive_group(node.node, squash, path_split)
        return None
    if isinstance(node, Concat):
        for part in node.parts:
            g = derive_group(part, squash, path_split)
            if g is not None:
                return g
        return None
    if isinstance(node, Alt):
        combined: List[ClassSeq] = []
        for opt in node.options:
            g = derive_group(opt, squash, path_split)
            if g is None:
                return None
            combined.extend(g)
        combined = list(dict.fromkeys(combined))
        return combined if len(combined) <= 64 else None
    return None


def _lit_seq(text: str, fold: bool) -> ClassSeq:
    seq = []
    for b in text.encode("utf-8", "surrogateescape"):
        s = {b}
        if fold:
            if 0x41 <= b <= 0x5A:
                s.add(b + 0x20)
            elif 0x61 <= b <= 0x7A:
                s.add(b - 0x20)
        seq.append(frozenset(s))
    return tuple(seq)


# ------------------------------------------------------------- the audit


def _confirm_only_reason(meta) -> Optional[str]:
    """Structural reason a rule compiles with no prefilter, or None."""
    c = meta.confirm
    if c.get("negate"):
        return "negated operator (absence has no factors)"
    if c["op"] in _HEURISTIC_OPS:
        return None
    if c["op"] not in _FACTOR_OPS:
        return "non-scan operator @%s" % c["op"]
    if "regex_unsupported" in c:
        return "regex outside the NFA subset (%s)" % c["regex_unsupported"]
    # imported, not copied: these sets ARE the compiler policy being
    # classified — a copy would mis-report a future always-confirm
    # transform as a coverage gap
    from ingress_plus_tpu_torch.compiler.ruleset import (
        _COMMENT_TRANSFORMS,
        _UNMODELED_DECODE_TRANSFORMS,
    )
    transforms = set(c.get("transforms", []))
    if transforms & _COMMENT_TRANSFORMS:
        return "comment transforms rewrite text no scan variant models"
    if transforms & _UNMODELED_DECODE_TRANSFORMS:
        return "decode transform no scan variant models"
    from ingress_plus_tpu_torch.compiler.seclang import NON_SCANNED_SCALAR_BASES
    bases = {t.strip().lstrip("&!").split(":", 1)[0].upper()
             for t in c.get("raw_targets", []) if t.strip()}
    if bases & NON_SCANNED_SCALAR_BASES:
        return "target text never appears in a scanned stream"
    if not meta.rule.targets:
        return "no scannable target (rule abstains)"
    return None


def audit_prefilter(metas, tables: BitapTables) -> List[Finding]:
    """The check-class-1 entry point: cross-check every rule's packed
    factors against an independent derivation from its operator AST.

    ``metas`` is CompiledRuleset.rules (RuleMeta sequence) and
    ``tables`` the matching BitapTables."""
    findings: List[Finding] = []
    for problem in table_consistency(tables):
        findings.append(Finding(
            check="prefilter.table-corrupt", severity="error",
            message="packed table invariant violated: %s" % problem,
            subject=problem.split(":")[0]))

    decoded = decode_factors(tables)
    by_rule = rule_factor_groups(tables)

    for meta in metas:
        rid = meta.rule.rule_id
        c = meta.confirm
        op = c["op"]
        group = [decoded[f] for f in by_rule.get(meta.index, [])]
        squash = meta.variant in (3, 4, 5)
        path_split = bool(set(c.get("transforms", []))
                          & {"normalizePath", "normalisePath",
                             "normalizePathWin"})

        if group:
            if op in _HEURISTIC_OPS:
                findings.append(Finding(
                    check="prefilter.heuristic-trigger", severity="info",
                    rule_id=rid, subject=op,
                    message="@%s gate uses heuristic trigger factors; "
                            "soundness vs the strict-grammar detector is "
                            "pinned by tests, not statically provable"
                            % op))
                continue
            ok, detail = _certify_rule(c, group, squash, path_split)
            if not ok:
                findings.append(Finding(
                    check="prefilter.uncertified", severity="error",
                    rule_id=rid, subject=op,
                    message="packed factor group could not be certified "
                            "mandatory for the rule's pattern%s — the "
                            "prefilter may lose confirm-stage matches"
                            % (" (%s)" % detail if detail else "")))
            else:
                bits = min(seq_bits(g) for g in group)
                if bits < WEAK_BITS:
                    findings.append(Finding(
                        check="prefilter.weak-factor", severity="notice",
                        rule_id=rid,
                        message="weakest factor alternative carries only "
                                "%.1f bits (<%.0f): the prefilter fires "
                                "on most traffic for this rule"
                                % (bits, WEAK_BITS)))
            continue

        # ---- no packed factors: classify the confirm-only fall-through
        reason = _confirm_only_reason(meta)
        if reason is not None:
            findings.append(Finding(
                check="prefilter.confirm-only", severity="info",
                rule_id=rid,
                message="no prefilter, evaluated exactly on CPU for "
                        "every applicable request: %s" % reason))
            continue
        if op == "rx":
            try:
                ast = parse_regex(c.get("arg", ""),
                                  ignorecase=bool(c.get("fold")))
            except RegexUnsupported:
                continue  # compiler stores regex_unsupported; handled above
            g = derive_group(ast, squash, path_split)
            if g is not None and certify(ast, g, squash, path_split):
                findings.append(Finding(
                    check="prefilter.coverage-gap", severity="warning",
                    rule_id=rid,
                    message="compiled always-confirm although a "
                            "certifiable mandatory factor group exists "
                            "(%d alternatives, >=%.1f bits) — compiler "
                            "left prefilter power unused"
                            % (len(g), min(seq_bits(s) for s in g))))
            else:
                findings.append(Finding(
                    check="prefilter.confirm-only", severity="info",
                    rule_id=rid,
                    message="no prefilter: no mandatory factor is "
                            "derivable from the pattern"))
        else:
            findings.append(Finding(
                check="prefilter.confirm-only", severity="info",
                rule_id=rid,
                message="no prefilter factors for @%s" % op))
    return findings


def _certify_rule(confirm: Dict, group: List[ClassSeq], squash: bool,
                  path_split: bool) -> Tuple[bool, str]:
    """Certify one rule's packed group against its operator semantics."""
    op = confirm["op"]
    fold = bool(confirm.get("fold"))
    if op == "rx":
        try:
            ast = parse_regex(confirm.get("arg", ""), ignorecase=fold)
        except RegexUnsupported as e:
            return False, "pattern unparsable at audit time: %s" % e
        if certify(ast, group, squash, path_split):
            return True, ""
        return False, "regex language not covered"
    if op in ("pm", "pmf", "pmFromFile"):
        arg = confirm.get("arg", "")
        words = confirm.get("words") or \
            (arg.split("\n") if "\n" in arg else arg.split())
        for w in words:
            if not w.strip():
                continue
            d = _lit_seq(w.strip(), fold=True)
            if not any(covered(f, group)
                       for f in lane_fragments(d, squash, path_split)):
                return False, "phrase %r not covered" % w.strip()
        return True, ""
    if op in ("contains", "containsWord", "streq", "beginsWith",
              "endsWith"):
        d = _lit_seq(confirm.get("arg", ""), fold)
        if any(covered(f, group)
               for f in lane_fragments(d, squash, path_split)):
            return True, ""
        return False, "literal argument not covered"
    if op == "within":
        # @within inverts containment: the VARIABLE must occur inside
        # the argument, so arbitrarily short variable values match and
        # no factor is mandatory — any packed factor is unsound
        return False, "@within has no mandatory factor (variable ⊆ " \
                      "argument; short values escape any factor)"
    return False, "no certification procedure for @%s" % op
