"""evadecheck — static evasion-closure analyzer (docs/ANALYSIS.md).

The third analyzer next to rulecheck/concheck.  rulecheck certifies the
prefilter never loses a match OF THE BYTES IT SCANS; evadecheck asks the
question that leaves open: are those bytes the ones an
attacker must send?  For each compiled rule it statically decides
whether detection is CLOSED under the modeled evasion families — the
re-encodings a payload survives on its way to the backend sink — by
diffing three artifacts the compiler already produces: the rule's
SecLang transform chain, the serve-path normalizer's decode set
(serve/normalize.py scan variants; ARGS is pre-decoded exactly once),
and the regex AST / mandatory-literal factors.

Check classes (stable dotted ids):

  evade.transform-closure   a rule scans a RAW byte stream (REQUEST_URI,
                            REQUEST_HEADERS) with no decode transform in
                            its chain: a %XX-encoded payload never folds
                            back to the pattern's bytes on any scanned
                            variant (the 944130 escape).  Also flags
                            html-entity blindness for XSS-tagged markup
                            literals.
  evade.literal-fragility   every mandatory quick-reject literal
                            (models/confirm.py derive_quick_reject)
                            contains a severable gap: a space an inline
                            comment (/**/, SQL sinks) or an alternate
                            whitespace byte can occupy while the chain
                            neutralizes neither.  Long factors near the
                            pack window are surfaced (info) as chunk-
                            boundary seams for a windowed scan.
  evade.case-hole           a letter-keyword pattern matched case-
                            sensitively (no t:lowercase, no inline
                            (?i)): mixed-case spelling evades while the
                            sink stays case-insensitive.
  evade.anchor-hazard       every path through the pattern starts at ^ —
                            on scanned streams the attacker owns the
                            prefix, so padding defeats the anchor.

Runtime twin: utils/evasion.py ``mutation_harness`` replays the golden
corpus re-encoded per mutation family through ``detect_cpu_only`` and
reports per-family retention + per-escape rule attribution.  Pass its
escapes to ``run_evadecheck(escapes=...)`` and any static finding whose
rule appears in a runtime escape of the matching family is CORROBORATED:
severity escalates to error and the finding message names the escaping
request.  Statically-found weaknesses that no mutation reaches stay at
their static severity and live in the reasoned baseline
(analysis/evadecheck-baseline.json).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

from ingress_plus_tpu_torch.analysis.findings import Baseline, Finding, Report

#: mutation family → the static check class its escapes corroborate
FAMILY_CHECK = {
    "url": "evade.transform-closure",
    "html": "evade.transform-closure",
    "unicode": "evade.transform-closure",
    "comment": "evade.literal-fragility",
    "whitespace": "evade.literal-fragility",
    "case": "evade.case-hole",
    "split": "evade.anchor-hazard",
}

#: text-matching operators whose argument describes payload bytes an
#: attacker can re-encode (heuristic detectors model their own decoding)
_TEXT_OPS = {"rx", "pm", "pmf", "pmFromFile", "contains", "containsWord",
             "streq", "beginsWith", "endsWith"}

#: factors at/over this length will straddle a chunk boundary once item
#: 3's windowed scanning lands (MAX_FACTOR_LEN is 32; seams open well
#: before that)
_CHUNK_SEAM_LEN = 24


#: protocol wire tokens: the engine maps them into the uri scan stream,
#: but no backend ever decodes them — the method/protocol field IS the
#: raw token, so encoding it breaks the request, not the detection
_WIRE_TOKEN_BASES = {"REQUEST_METHOD", "REQUEST_PROTOCOL"}


def _raw_bases(rule) -> Set[str]:
    return {t.strip().lstrip("&!").split(":", 1)[0].upper()
            for t in (rule.raw_targets or ()) if t.strip()}


def _wire_token_only(rule) -> bool:
    bases = _raw_bases(rule)
    return bool(bases) and bases <= _WIRE_TOKEN_BASES


def _rule_chain_transforms(rule) -> Set[str]:
    """Union of transforms over the rule and its chained links — a decode
    anywhere in the chain covers the shared MATCHED_VAR re-tests."""
    t: Set[str] = set()
    link = rule
    while link is not None:
        t |= set(link.transforms)
        link = getattr(link, "chain", None)
    return t


def _letter_runs(text: str, n: int = 3) -> bool:
    """True when ``text`` contains a run of >= n letters — a keyword an
    attacker can respell in mixed case (two-letter hex fragments like
    ``%df`` don't count)."""
    streak = 0
    for c in text:
        streak = streak + 1 if c.isalpha() else 0
        if streak >= n:
            return True
    return False


def _all_paths_start_anchored(node) -> bool:
    """True iff every string matched by the pattern must begin at ``^``.

    Conservative: unknown node shapes return False (no finding)."""
    from ingress_plus_tpu_torch.compiler import regex_ast as R

    if isinstance(node, R.Anchor):
        return node.kind in ("^", "A")
    if isinstance(node, R.Concat):
        for part in node.parts:
            if isinstance(part, R.Anchor) and part.kind in ("^", "A"):
                return True
            if isinstance(part, R.Repeat) and part.min == 0:
                continue  # skippable prefix — look further
            return _all_paths_start_anchored(part)
        return False
    if isinstance(node, R.Alt):
        return all(_all_paths_start_anchored(b) for b in node.options)
    return False


def _check_transform_closure(meta) -> List[Finding]:
    rule = meta.rule
    if rule.operator not in _TEXT_OPS or getattr(rule, "negate", False):
        return []
    t = _rule_chain_transforms(rule)
    out: List[Finding] = []

    # raw-stream decode gap: URI bytes arrive percent-encoded, the
    # backend's router decodes them, and NOTHING decodes them before
    # this rule's variant (ARGS alone is pre-decoded once by the serve
    # path).  Headers are deliberately out of scope — no backend
    # url-decodes header bytes, so an encoded header is a broken attack,
    # not an evasion (the same carrier model as utils/evasion.py).
    # Patterns that themselves match encoded forms ('%' in the
    # argument) are exempt — encoding detectors by design; so are
    # wire-token rules (REQUEST_METHOD et al. are never decoded).
    from ingress_plus_tpu_torch.compiler.ruleset import _DECODE_TRANSFORMS
    if "uri" in rule.targets and not (t & _DECODE_TRANSFORMS) \
            and "%" not in rule.argument and not _wire_token_only(rule):
        out.append(Finding(
            check="evade.transform-closure", severity="warning",
            rule_id=rule.rule_id, subject="missing-url-decode",
            message="scans the raw uri with no urlDecode-family "
                    "transform: a %XX-encoded path never matches on "
                    "any scanned variant while the backend router "
                    "decodes it"))

    # html-entity blindness: an XSS markup literal ('<'-shaped) without
    # htmlEntityDecode anywhere — &#x3c;script decodes at the browser
    # sink but never on the scanned rows.
    from ingress_plus_tpu_torch.compiler.ruleset import _HTML_TRANSFORMS
    if "attack-xss" in rule.tags and "<" in rule.argument \
            and rule.operator in ("rx", "contains", "pm", "pmf",
                                  "pmFromFile") \
            and not (t & _HTML_TRANSFORMS):
        out.append(Finding(
            check="evade.transform-closure", severity="notice",
            rule_id=rule.rule_id, subject="missing-html-decode",
            message="XSS markup literal without htmlEntityDecode: "
                    "entity-encoded markup (&#x3c;script) decodes at the "
                    "browser but not on the scanned rows"))
    return out


def _check_literal_fragility(meta) -> List[Finding]:
    from ingress_plus_tpu_torch.compiler.ruleset import (
        _COMMENT_TRANSFORMS,
        _WS_COLLAPSE,
    )
    from ingress_plus_tpu_torch.models.confirm import derive_quick_reject

    rule = meta.rule
    out: List[Finding] = []
    t = _rule_chain_transforms(rule)

    gapped: List[bytes] = []
    if rule.operator == "rx":
        qr = derive_quick_reject(rule.argument,
                                 bool(meta.confirm.get("fold")))
        if qr and all(b" " in lit for lit in qr):
            gapped = list(qr)
    elif rule.operator in ("pm", "pmf", "pmFromFile"):
        words = meta.confirm.get("words") or []
        enc = [w.encode("utf-8", "surrogateescape") for w in words]
        if enc and all(b" " in w for w in enc):
            gapped = enc

    if gapped:
        sample = gapped[0].decode("utf-8", "replace")
        if "attack-sqli" in rule.tags and not (t & _COMMENT_TRANSFORMS):
            out.append(Finding(
                check="evade.literal-fragility", severity="warning",
                rule_id=rule.rule_id, subject="comment-severable",
                message="every mandatory literal spans a space (e.g. "
                        "%r) and no comment transform folds /**/ back "
                        "to whitespace: an inline comment severs the "
                        "match in a SQL sink" % sample))
        if not (t & _WS_COLLAPSE):
            out.append(Finding(
                check="evade.literal-fragility", severity="notice",
                rule_id=rule.rule_id, subject="whitespace-severable",
                message="every mandatory literal spans a literal space "
                        "(e.g. %r) with no whitespace-collapse "
                        "transform: tab/newline separators sever the "
                        "match" % sample))

    # chunk-boundary seam: a mandatory factor this long WILL straddle a
    # window edge under a chunked, windowed scan
    if meta.has_prefilter and rule.operator == "rx":
        qr = derive_quick_reject(rule.argument,
                                 bool(meta.confirm.get("fold")))
        longest = max((len(lit) for lit in qr or ()), default=0)
        if longest >= _CHUNK_SEAM_LEN:
            out.append(Finding(
                check="evade.literal-fragility", severity="info",
                rule_id=rule.rule_id, subject="chunk-window",
                message="mandatory literal of %d bytes will straddle "
                        "chunk boundaries under windowed scanning "
                        "unless windows overlap by at least that "
                        "length" % longest))
    return out


def _check_case_hole(meta) -> List[Finding]:
    rule = meta.rule
    if rule.operator not in ("rx", "contains", "containsWord", "streq",
                             "beginsWith", "endsWith"):
        return []  # pm-family ops fold unconditionally at compile
    if meta.confirm.get("fold") or _wire_token_only(rule):
        return []  # HTTP methods/protocol are case-sensitive tokens
    if rule.operator == "rx" and "(?i" in rule.argument:
        return []
    if not _letter_runs(rule.argument):
        return []
    return [Finding(
        check="evade.case-hole", severity="notice",
        rule_id=rule.rule_id, subject="case-sensitive-keyword",
        message="letter keyword matched case-sensitively (no "
                "t:lowercase, no inline (?i)): mixed-case spelling "
                "evades while most sinks stay case-insensitive")]


def _check_anchor_hazard(meta) -> List[Finding]:
    from ingress_plus_tpu_torch.compiler.regex_ast import (
        RegexUnsupported,
        parse_regex,
    )

    rule = meta.rule
    if rule.operator not in ("rx", "beginsWith"):
        return []
    # only where the attacker owns the matched value's prefix: args and
    # body values.  uri rows start at the request line's fixed framing,
    # header rows at the header NAME, and scalar rules (REQUEST_METHOD)
    # anchor a value the attacker must produce whole — padding is
    # impossible or self-defeating in all three.
    scanned = set(rule.targets) & {"args", "body"}
    if not scanned or _wire_token_only(rule):
        return []
    if rule.operator == "beginsWith":
        anchored = True
    else:
        try:
            ast = parse_regex(rule.argument,
                              ignorecase=bool(meta.confirm.get("fold")))
        except (RegexUnsupported, RecursionError):
            return []
        anchored = _all_paths_start_anchored(ast)
    if not anchored:
        return []
    return [Finding(
        check="evade.anchor-hazard", severity="notice",
        rule_id=rule.rule_id, subject="start-anchored",
        message="every match path starts at ^ but the attacker owns "
                "the %s prefix: benign padding defeats the anchor"
                % "/".join(sorted(scanned)))]


def _corroborate(findings: List[Finding],
                 escapes: Sequence[Dict]) -> int:
    """Escalate static findings confirmed by runtime escapes.

    An escape corroborates a finding when the finding's rule was among
    the rules that detected the BASE request and the escape's mutation
    family maps to the finding's check class — the mutation removed
    exactly the signal the static check called fragile."""
    by_key: Dict = {}
    for e in escapes:
        check = FAMILY_CHECK.get(e.get("family", ""))
        for rid in e.get("base_rule_ids", ()):
            by_key.setdefault((check, int(rid)), []).append(e)
    n = 0
    for f in findings:
        hits = by_key.get((f.check, f.rule_id))
        if not hits:
            continue
        e = hits[0]
        f.severity = "error"
        f.message += (" [CORROBORATED: %s-family mutation of %s escaped "
                      "detection]" % (e.get("family"),
                                      e.get("request_id", "?")))
        n += 1
    return n


#: default suppression baseline, next to this module (concheck layout)
BASELINE = Path(__file__).resolve().parent / "evadecheck-baseline.json"


def run_evadecheck(rules_path: Optional[str | Path] = None,
                   baseline_path: Optional[str | Path] = "auto",
                   compiled=None,
                   escapes: Optional[Sequence[Dict]] = None) -> Report:
    """Run the evasion-closure checks over a rules tree.

    ``escapes`` takes ``mutation_harness`` escape records (any families,
    flattened, each dict carrying ``family``) for corroboration.
    ``compiled`` skips recompilation (dbg / gate paths)."""
    from ingress_plus_tpu_torch.analysis import BUNDLED_RULES
    from ingress_plus_tpu_torch.analysis.scan import rule_positions, scan_tree
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir

    rules_path = Path(rules_path) if rules_path is not None else \
        BUNDLED_RULES
    if not rules_path.exists():
        raise OSError("rules tree %s does not exist — an empty audit "
                      "would report a misleading clean pass" % rules_path)
    if compiled is None:
        compiled = compile_ruleset(load_seclang_dir(rules_path))

    findings: List[Finding] = []
    for meta in compiled.rules:
        findings += _check_transform_closure(meta)
        findings += _check_literal_fragility(meta)
        findings += _check_case_hole(meta)
        findings += _check_anchor_hazard(meta)

    corroborated = _corroborate(findings, escapes or ())

    # source positions + path relativization (rulecheck convention:
    # reports must not embed machine-specific absolute paths)
    scans = scan_tree(rules_path)
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
        baseline_path = BASELINE if BASELINE.is_file() else None
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
        tool="evadecheck",
        meta={"corroborated": corroborated,
              "escapes_seen": len(escapes or ())},
    )
