"""Transform-lane consistency checks (check class 5).

Every rule is scanned on ONE normalization variant of each stream; the
confirm stage applies the rule's exact transform chain.  The contract
(compiler/ruleset.py module docstring) is that the scan lane's
normalization never deletes bytes the rule's own chain keeps — a
`t:urlDecodeUni` double decode is one instance of this class, a 942170
htmlEntityDecode factor loss another.  This module
lints the whole class statically:

  lane.variant-mismatch  (error)  the compiled scan variant differs
      from the variant the rule's transform chain implies (independent
      re-derivation) — the rule scans text its transforms don't produce
  lane.unmodeled-decode  (error)  a rule KEEPS prefilter factors while
      its chain has a decode transform no scan variant applies
      (base64Decode/hexDecode/jsDecode/cssDecode): encoded payloads
      never contain the factor bytes, so the prefilter loses matches
  lane.comment-transform (error)  same, for comment-rewrite transforms
  lane.unknown-transform (warning) transform name the confirm stage
      does not implement — apply_transforms silently skips it, so the
      rule matches UN-transformed text (typo lint)
  lane.noop-transform    (notice)  documented no-op approximations
      (utf8toUnicode)
"""

from __future__ import annotations

from typing import List

from ingress_plus_tpu_torch.analysis.findings import Finding

#: independent copy of the variant-assignment contract; divergence from
#: compiler/ruleset.py _rule_variant IS the finding
_WS_COLLAPSE = {"compressWhitespace", "removeWhitespace", "cmdLine"}
_HTML = {"htmlEntityDecode"}
_DECODE = {"urlDecode", "urlDecodeUni", "jsDecode", "cssDecode",
           "hexDecode", "base64Decode"}
_UNMODELED_DECODE = {"base64Decode", "hexDecode", "jsDecode", "cssDecode"}
_COMMENT = {"replaceComments", "removeCommentsChar"}
_NOOP = {"utf8toUnicode"}


def expected_variant(transforms) -> int:
    t = set(transforms)
    if t & _WS_COLLAPSE:
        if t & _HTML:
            return 4
        if t & _DECODE:
            return 5
        return 3
    if t & _HTML:
        return 2
    if t & _DECODE:
        return 1
    return 0


def check_lanes(metas) -> List[Finding]:
    findings: List[Finding] = []
    known = _known_transforms()
    for meta in metas:
        rid = meta.rule.rule_id
        transforms = list(meta.confirm.get("transforms", []))
        exp = expected_variant(transforms)
        got = int(meta.confirm.get("variant", meta.variant))
        if exp != got:
            findings.append(Finding(
                check="lane.variant-mismatch", severity="error",
                rule_id=rid, subject="variant %d != expected %d"
                                     % (got, exp),
                message="rule compiled onto scan variant %d but its "
                        "transform chain %r implies variant %d: the "
                        "prefilter scans text the confirm semantics "
                        "never see" % (got, transforms, exp)))
        if meta.has_prefilter:
            bad = set(transforms) & _UNMODELED_DECODE
            if bad:
                findings.append(Finding(
                    check="lane.unmodeled-decode", severity="error",
                    rule_id=rid, subject=",".join(sorted(bad)),
                    message="rule keeps prefilter factors while its "
                            "chain decodes with %s, which no scan "
                            "variant models: encoded payloads bypass "
                            "the prefilter" % ", ".join(sorted(bad))))
            bad = set(transforms) & _COMMENT
            if bad:
                findings.append(Finding(
                    check="lane.comment-transform", severity="error",
                    rule_id=rid, subject=",".join(sorted(bad)),
                    message="rule keeps prefilter factors while its "
                            "chain rewrites comments (%s), which no "
                            "scan variant models"
                            % ", ".join(sorted(bad))))
        # transform-name lint covers chain links too (they confirm with
        # their own chains)
        chains = [transforms] + [
            list(link.get("transforms", []))
            for link in meta.confirm.get("chain", [])]
        seen: set = set()
        for tlist in chains:
            for name in tlist:
                if name in seen:
                    continue
                seen.add(name)
                if name in _NOOP:
                    findings.append(Finding(
                        check="lane.noop-transform", severity="notice",
                        rule_id=rid, subject=name,
                        message="t:%s is a documented no-op "
                                "approximation here (docs/SECLANG.md)"
                                % name))
                elif name not in known:
                    findings.append(Finding(
                        check="lane.unknown-transform", severity="warning",
                        rule_id=rid, subject=name,
                        message="t:%s is not implemented by the confirm "
                                "stage and is silently skipped — the "
                                "rule matches un-transformed text "
                                "(typo?)" % name))
    return findings


def _known_transforms() -> set:
    from ingress_plus_tpu_torch.models.confirm import TRANSFORMS
    return set(TRANSFORMS) | {"none"}
