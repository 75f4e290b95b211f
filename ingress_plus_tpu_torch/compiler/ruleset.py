"""Rule → compiled-artifact pipeline.

The port of ``ingress_plus_tpu/compiler/ruleset.py``: the same compiler,
array for array, and the same checkpoint format (``<path>.npz`` +
``<path>.json``), so a pack compiled by either package serves in both.

``compile_ruleset`` turns format-neutral ``Rule`` objects (from seclang.py /
sigpack.py) into a ``CompiledRuleset``: packed bitap tables + per-rule
metadata arrays + confirm descriptors.  The artifact serializes to disk
(npz + json) — this is the framework's checkpoint analog (SURVEY.md §5
"Checkpoint/resume": versioned compiled-NFA tables, atomically hot-swapped
on device like the reference's proton.db sync-node flow).

Scan-variant model: each stream (uri/args/headers/body/resp_*) is scanned
in up to six normalization variants:

    0 raw           — bytes as received
    1 urldec        — urlDecodeUni + removeNulls
    2 urldec_html   — urldec + htmlEntityDecode
    3 squash_raw    — raw with all SQUASH_BYTES deleted (whitespace \\ ' " ^)
    4 squash_dec    — urldec_html with all SQUASH_BYTES deleted
    5 squash_urldec — urldec with all SQUASH_BYTES deleted (no html decode
                      — that decode can DELETE factor bytes of rules whose
                      chain doesn't include it)

A rule is assigned the variant matching its transform chain, so factor
matching stays *sound* (never misses) while the CPU confirm stage applies
the rule's exact transforms.  Soundness of the squash variants: deletion
transforms (compressWhitespace / removeWhitespace / cmdLine) let attackers
interleave deletable bytes inside a payload (``w"get`` → ``wget``); both
the scanned stream AND the rule's factors have the same SQUASH_BYTES
deleted, so the factor fires iff the post-transform text contains it.
Factor positions whose class is a subset of SQUASH_BYTES are dropped
(neighbors become adjacent, exactly as in the stream); positions whose
class only partially overlaps are split points (survival is ambiguous).

``normalizePath`` rules get factors split at path separators: nginx-style
path normalization only deletes chunks that contain a '/', so any
slash-free factor fragment present in the normalized text is literally
present in the raw stream.
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler import factors as F
from ingress_plus_tpu_torch.compiler.bitap import BitapTables, pack_factors
from ingress_plus_tpu_torch.compiler.reduce import (
    ReductionConfig,
    coarsen_byte_classes,
    reduce_rule_groups,
)
from ingress_plus_tpu_torch.compiler.regex_ast import (
    RegexUnsupported,
    parse_regex,
)
from ingress_plus_tpu_torch.compiler.seclang import (
    CLASSES,
    CLASS_INDEX,
    NON_SCANNED_SCALAR_BASES as F_NON_SCANNED,
    Rule,
    STREAMS,
    STREAM_INDEX,
    _classify_setvar,
    _id_matcher,
    _invalidate_tx_names,
    _static_skip_condition,
)

#: scan-row normalization variants (serve/normalize.py variant_chain).
#: "squash_urldec" (5) exists because htmlEntityDecode can DELETE factor
#: bytes ("&#x61;" → "a" removes '#'): a ws-collapse+urlDecode rule whose
#: own chain has NO html transform must be scanned on squash(urldec), not
#: squash(html(urldec)) — rule 942170 would lose its '#' factor to the
#: html decode of the scanned row.
VARIANTS = ("raw", "urldec", "urldec_html", "squash_raw", "squash_dec",
            "squash_urldec")
N_SV = len(STREAMS) * len(VARIANTS)  # stream-variant row space

#: the word-tier split (docs/SCAN_KERNEL.md): streams every request row
#: can carry vs the body/response streams only some requests produce.
#: Factors owned exclusively by tail-stream rules pack after
#: BitapTables.n_head_words so bodyless dispatches scan a word prefix.
HEAD_STREAMS = ("uri", "args", "headers")
N_HEAD_SV = len(HEAD_STREAMS) * len(VARIANTS)

#: default approximate-reduction config (compiler/reduce.py): modest
#: candidate-inflation budget, 16-byte factor windows, exact prefix
#: merging and word tiering on.  Pass ``reduction=ReductionConfig.off()``
#: for bit-identical legacy tables (the frozen bench fixture does).
DEFAULT_REDUCTION = ReductionConfig()

_DECODE_TRANSFORMS = {
    "urlDecode", "urlDecodeUni", "jsDecode", "cssDecode", "hexDecode",
    "base64Decode",
}
_HTML_TRANSFORMS = {"htmlEntityDecode"}
_WS_COLLAPSE = {"compressWhitespace", "removeWhitespace", "cmdLine"}
_PATH_TRANSFORMS = {"normalizePath", "normalisePath", "normalizePathWin"}
#: comment transforms rewrite text in ways no scan variant models
#: ("un/**/ion" → "un ion" resp. "union"): any factor extracted from the
#: post-transform pattern could miss the pre-transform bytes, so rules
#: carrying them compile always-confirm (sound; exact CPU evaluation)
_COMMENT_TRANSFORMS = {"replaceComments", "removeCommentsChar"}
#: decode transforms with NO scan-variant twin (the lanes only model
#: urlDecode(Uni) + htmlEntityDecode): the pattern matches DECODED text
#: but the scanned rows hold the encoded form — base64("expression(")
#: contains no "expression" — so factors from these rules can miss
#: every true match.  Always-confirm instead (rulecheck PR: the
#: lane.unmodeled-decode analyzer class pins this invariant).
_UNMODELED_DECODE_TRANSFORMS = {"base64Decode", "hexDecode", "jsDecode",
                                "cssDecode"}
_WS_BYTES = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B])
# Bytes deleted by the squash variants (stream side AND factor side).
# Superset of what cmdLine deletes; whitespace covers compress/remove.
SQUASH_BYTES = _WS_BYTES | frozenset([0x5C, 0x27, 0x22, 0x5E])  # \ ' " ^
_PATH_SEP_BYTES = frozenset([0x2F, 0x5C])  # / and \\

SEVERITY_SCORE = {
    "CRITICAL": 5, "ERROR": 4, "WARNING": 3, "NOTICE": 2, "INFO": 1, "DEBUG": 1,
}

# ------------------------------------------------------- CRS anomaly mode
# Real CRS v3 blocks via tx.anomaly_score accumulation: crs-setup.conf's
# SecAction initializes the weights (tx.critical_anomaly_score=5, ...),
# each rule does setvar:'tx.anomaly_score_pl1=+%{tx.critical_anomaly_
# score}', and a 949-family rule blocks when TX:ANOMALY_SCORE >= the
# threshold.  We resolve that WHOLE protocol AT COMPILE TIME: setvar
# increments become the rule_score vector (anomaly accumulation is the
# engine's score matmul — nothing per-request), and the 949 rule becomes
# the pipeline's anomaly_threshold.  SURVEY.md §2.2 libmodsecurity row.

#: CRS-standard weights, used when no SecAction overrides them — a bare
#: CRS rules file without crs-setup.conf still scores canonically
_TX_DEFAULTS = {
    "critical_anomaly_score": "5",
    "error_anomaly_score": "4",
    "warning_anomaly_score": "3",
    "notice_anomaly_score": "2",
}

_MACRO_RE = re.compile(r"%\{([^}]+)\}")


def resolve_macros(text: str, env: Dict[str, str],
                   max_depth: int = 5) -> Optional[str]:
    """Expand %{tx.NAME} macros from the static TX env.  Returns None if
    any macro stays unresolved (caller abstains / keeps the raw text)."""
    for _ in range(max_depth):
        if "%{" not in text:
            return text

        unresolved = False

        def sub(m: "re.Match[str]") -> str:
            nonlocal unresolved
            name = m.group(1).strip().lower()
            if name.startswith("tx."):
                val = env.get(name[3:])
                if val is not None:
                    return val
            unresolved = True
            return m.group(0)

        new = _MACRO_RE.sub(sub, text)
        if unresolved:
            return None
        text = new
    return None  # cyclic definitions


def _apply_setvars(env: Dict[str, str], setvars: List[str]) -> None:
    """Fold setvar actions into the static env.  Form normalization is
    shared with the parse-time env (seclang._classify_setvar) so the
    two layers can never diverge; the compile env differs only in
    resolving full multi-hop %{tx.*} macros.  Deletes, increments and
    unresolvable macros INVALIDATE the entry — a stale literal would
    expand into confirm arguments ModSecurity evaluates differently."""
    for sv in setvars:
        key, kind, val = _classify_setvar(sv)
        if kind is None:
            continue
        if kind in ("delete", "increment"):
            env.pop(key, None)
            continue
        resolved = resolve_macros(val, env)
        if resolved is not None:
            env[key] = resolved
        else:
            env.pop(key, None)


def _anomaly_increment(rule: Rule, env: Dict[str, str]) -> Optional[int]:
    """The rule's anomaly-score contribution from its setvar actions
    ('tx.<x>anomaly_score<y>=+%{...}'), resolved statically; None when
    the rule doesn't participate in anomaly scoring."""
    for sv in rule.setvars:
        name, sep, val = sv.partition("=")
        if not sep or "anomaly_score" not in name.lower():
            continue
        val = val.strip()
        if not val.startswith("+"):
            continue
        resolved = resolve_macros(val[1:].strip(), env)
        if resolved is None:
            continue
        m = re.match(r"\s*(\d+)", resolved)
        if m:
            return int(m.group(1))
    return None


#: TX selectors that ARE the inbound request-blocking score.  Outbound
#: (959-style response evaluation) and per-PL sub-score rules
#: (TX:ANOMALY_SCORE_PL1) must NOT set the pipeline's request threshold —
#: on real CRS the outbound threshold (4) sorts after 949110's inbound
#: (5) and a last-wins match would silently lower the blocking bar.
_INBOUND_SCORE_SELECTORS = {
    "ANOMALY_SCORE", "INBOUND_ANOMALY_SCORE",
    "BLOCKING_INBOUND_ANOMALY_SCORE",
}


def _threshold_from_rule(rule: Rule, env: Dict[str, str]) -> Optional[int]:
    """Detect the 949-style blocking rule: TX:ANOMALY_SCORE '@ge N'
    (N possibly a %{tx.*} macro).  Returns the resolved threshold."""
    if rule.operator not in ("ge", "gt"):
        return None
    def _is_inbound(t: str) -> bool:
        base, _, sel = t.partition(":")
        return (base.strip().upper() == "TX"
                and sel.strip().upper() in _INBOUND_SCORE_SELECTORS)
    if not any(_is_inbound(t) for t in rule.raw_targets):
        return None
    resolved = resolve_macros(rule.argument.strip(), env)
    if resolved is None:
        return None
    m = re.match(r"\s*(\d+)", resolved)
    if not m:
        return None
    n = int(m.group(1))
    return n + 1 if rule.operator == "gt" else n

# NOTE on operator coverage: the per-operator branches in
# _factor_group_for decide which operators contribute prefilter factors
# (rx/pm/contains/... families).  Rules with any OTHER operator (@eq,
# @validateByteRange, ... — the CRS 920 protocol family) and negated
# operators are NOT dropped: they compile with an empty factor group, so
# the rule_nfactors==0 always-confirm path evaluates them exactly on CPU
# (models/confirm.py) for every applicable request.

# Heuristic trigger factors for the strict-grammar detectors (libdetection
# analog).  These gate the CPU confirm stage; soundness vs our own
# models/libdetect implementation is asserted by tests/test_libdetect.py.
_SQLI_TRIGGERS = [
    "'", '"', "`", "--", "/*", "#", ";", "=", "union", "select", "sleep(",
    "benchmark(", "0x", "||", "char(",
]
_XSS_TRIGGERS = ["<", ">", "javascript:", "on", "&#", "src=", "%3c", "%3e"]


def _lit_seq(text: str, fold: bool) -> F.ClassSeq:
    seq = []
    for ch in text.encode("utf-8", "surrogateescape"):
        s = frozenset([ch])
        if fold:
            if 0x41 <= ch <= 0x5A:
                s = frozenset([ch, ch + 0x20])
            elif 0x61 <= ch <= 0x7A:
                s = frozenset([ch, ch - 0x20])
        seq.append(s)
    return tuple(seq)


def _squash_group(group: F.Group) -> F.Group:
    """Rewrite factors for the squash variants: positions whose class is
    entirely deletable vanish (neighbors join, as in the squashed stream);
    ambiguous positions (class partially deletable) split the factor; per
    alternative the best fragment is kept (still mandatory)."""
    out: F.Group = []
    for seq in group:
        frags: List[List[frozenset]] = [[]]
        for cls in seq:
            if cls <= SQUASH_BYTES:
                continue  # deleted on both sides — neighbors become adjacent
            if cls & SQUASH_BYTES:
                frags.append([])  # ambiguous survival → split
            else:
                frags[-1].append(cls)
        best = max(frags, key=lambda f: F.seq_bits(tuple(f)))
        if not best:
            return []  # an alternative squashes away entirely → unusable
        out.append(tuple(best))
    return out


def _split_at(group: F.Group, split_bytes: frozenset) -> F.Group:
    """Split factors at positions that may contain ``split_bytes`` and keep
    the best fragment per alternative (used for normalizePath rules, whose
    deletions always contain a path separator)."""
    out: F.Group = []
    for seq in group:
        frags: List[List[frozenset]] = [[]]
        for cls in seq:
            if cls & split_bytes:
                frags.append([])
            else:
                frags[-1].append(cls)
        best = max(frags, key=lambda f: F.seq_bits(tuple(f)))
        if not best:
            return []
        out.append(tuple(best))
    return out


@dataclass
class RuleMeta:
    """Per-rule compile result (everything the runtime needs off-device)."""

    rule: Rule
    index: int
    variant: int
    has_prefilter: bool
    confirm: Dict  # JSON-serializable confirm descriptor


@dataclass
class CompiledRuleset:
    """Device tables + metadata; the deployable/hot-swappable artifact."""

    tables: BitapTables
    rules: List[RuleMeta]
    # (n_rules, N_SV) bool — which stream-variant rows count for each rule
    rule_sv_mask: np.ndarray
    rule_class: np.ndarray      # (n_rules,) int32 → CLASSES
    rule_score: np.ndarray      # (n_rules,) int32 anomaly score
    rule_action: np.ndarray     # (n_rules,) int32 0=pass 1=block 2=deny
    rule_paranoia: np.ndarray   # (n_rules,) int32
    rule_ids: np.ndarray        # (n_rules,) int64 CRS ids
    version: str = ""
    #: CRS anomaly-mode config resolved at compile time from SecAction
    #: setvars + the 949-style threshold rule (None = pack doesn't use
    #: anomaly mode; the pipeline then keeps its default threshold)
    anomaly_threshold: Optional[int] = None
    paranoia_hint: Optional[int] = None
    #: runtime ctl exclusions (the CRS exclusion-package shape), resolved
    #: to concrete rule ids at compile time: carrying rule INDEX →
    #: {"remove_ids": [id, ...],              # ctl:ruleRemoveById/ByTag
    #:  "target_excl": {str(id): [tok, ...]}, # ctl:ruleRemoveTargetById
    #:  "engine_off": bool}                   # ctl:ruleEngine=Off
    #: Applied per request by the confirm stage when the carrying rule
    #: matches (models/pipeline.py finalize).
    ctl_specs: Dict[int, Dict] = field(default_factory=dict)
    #: approximate-reduction provenance (compiler/reduce.py
    #: ReductionReport.to_dict(), None = exact compile) — serialized
    #: with the artifact and surfaced by rulecheck's JSON report
    reduction: Optional[Dict] = None

    @property
    def n_rules(self) -> int:
        return len(self.rules)

    @property
    def classes(self) -> Tuple[str, ...]:
        return tuple(CLASSES)

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for a in (self.tables.byte_table, self.tables.init_mask,
                  self.tables.final_mask, self.rule_sv_mask):
            h.update(np.ascontiguousarray(a).tobytes())
        # confirm descriptors and ctl exclusions change detection
        # behavior WITHOUT touching any scan table (SecRuleUpdateTargetById
        # edits, ctl:ruleRemoveById swaps...) — a fingerprint blind to
        # them would make a ruleset watcher skip hot-swapping
        # exclusion-only changes
        h.update(json.dumps(
            [m.confirm for m in self.rules], sort_keys=True).encode())
        h.update(json.dumps(
            {str(k): v for k, v in self.ctl_specs.items()},
            sort_keys=True).encode())
        return h.hexdigest()[:16]

    # ---------------------------------------------------------- serialize

    def save(self, path: str | Path) -> None:
        """Write the checkpoint artifact: <path>.npz + <path>.json."""
        path = Path(path)
        t = self.tables
        np.savez_compressed(
            path.with_suffix(".npz"),
            byte_table=t.byte_table, init_mask=t.init_mask,
            final_mask=t.final_mask, factor_word=t.factor_word,
            factor_bit=t.factor_bit, factor_rule_indptr=t.factor_rule_indptr,
            factor_rule_ids=t.factor_rule_ids, rule_nfactors=t.rule_nfactors,
            factor_len=t.factor_len, rule_sv_mask=self.rule_sv_mask,
            rule_class=self.rule_class, rule_score=self.rule_score,
            rule_action=self.rule_action, rule_paranoia=self.rule_paranoia,
            rule_ids=self.rule_ids,
            n_head_words=np.asarray(t.n_head_words, np.int32),
            n_prefix_shared=np.asarray(t.n_prefix_shared, np.int32),
        )
        meta = {
            "version": self.version or self.fingerprint(),
            "n_rules": self.n_rules,
            "classes": CLASSES,
            "streams": STREAMS,
            "variants": VARIANTS,
            "confirm": [m.confirm for m in self.rules],
            # tags drive tenant (EP) rule-subset masks — must survive the
            # checkpoint roundtrip (control/tenants.py)
            "tags": [list(m.rule.tags) for m in self.rules],
            "anomaly_threshold": self.anomaly_threshold,
            "paranoia_hint": self.paranoia_hint,
            "ctl_specs": {str(k): v for k, v in self.ctl_specs.items()},
            "reduction": self.reduction,
        }
        path.with_suffix(".json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path) -> "CompiledRuleset":
        """Read a checkpoint artifact: ``<path>.npz`` + ``<path>.json``."""
        path = Path(path)
        with np.load(path.with_suffix(".npz")) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(path.with_suffix(".json").read_text())
        tables = BitapTables(
            byte_table=arrays["byte_table"],
            init_mask=arrays["init_mask"],
            final_mask=arrays["final_mask"],
            factor_word=arrays["factor_word"],
            factor_bit=arrays["factor_bit"],
            factor_rule_indptr=arrays["factor_rule_indptr"],
            factor_rule_ids=arrays["factor_rule_ids"],
            rule_nfactors=arrays["rule_nfactors"],
            factor_len=arrays["factor_len"],
            # checkpoints without a tier boundary keep the full width
            n_head_words=(int(arrays["n_head_words"])
                          if "n_head_words" in arrays else -1),
            n_prefix_shared=(int(arrays["n_prefix_shared"])
                             if "n_prefix_shared" in arrays else 0),
        )
        rules = []
        action_names = {0: "pass", 1: "block", 2: "deny"}
        all_tags = meta.get("tags", [[]] * len(meta["confirm"]))
        for i, confirm in enumerate(meta["confirm"]):
            rule = Rule(
                rule_id=int(arrays["rule_ids"][i]),
                operator=confirm["op"],
                argument=confirm.get("arg", ""),
                targets=list(confirm.get("targets", ["args"])),
                raw_targets=list(confirm.get("raw_targets", [])),
                transforms=confirm.get("transforms", []),
                action=action_names[int(arrays["rule_action"][i])],
                tags=list(all_tags[i]),
            )
            rules.append(RuleMeta(rule=rule, index=i,
                                  variant=confirm.get("variant", 0),
                                  has_prefilter=bool(tables.rule_nfactors[i]),
                                  confirm=confirm))
        return cls(
            tables=tables, rules=rules,
            rule_sv_mask=arrays["rule_sv_mask"],
            rule_class=arrays["rule_class"],
            rule_score=arrays["rule_score"],
            rule_action=arrays["rule_action"],
            rule_paranoia=arrays["rule_paranoia"],
            rule_ids=arrays["rule_ids"], version=meta["version"],
            anomaly_threshold=meta.get("anomaly_threshold"),
            paranoia_hint=meta.get("paranoia_hint"),
            ctl_specs={int(k): v
                       for k, v in meta.get("ctl_specs", {}).items()},
            reduction=meta.get("reduction"),
        )


def _rule_variant(rule: Rule) -> int:
    t = set(rule.transforms)
    if t & _WS_COLLAPSE:
        if t & _HTML_TRANSFORMS:
            return 4          # squash(html(urldec))
        if t & _DECODE_TRANSFORMS:
            return 5          # squash(urldec) — html decode would be
                              # UNSOUND here (can delete factor bytes
                              # the rule's own chain keeps)
        return 3              # squash(raw)
    if t & _HTML_TRANSFORMS:
        return 2
    if t & _DECODE_TRANSFORMS:
        return 1
    return 0


def _factor_group_for(rule: Rule) -> Tuple[F.Group, Dict]:
    """Extract the rule's factor group + confirm descriptor."""
    fold = "lowercase" in rule.transforms or rule.operator in ("pm", "pmFromFile", "pmf")
    op = rule.operator
    confirm: Dict = {
        "op": op, "arg": rule.argument, "transforms": rule.transforms,
        "fold": fold, "variant": _rule_variant(rule),
    }
    if op == "rx":
        try:
            ast = parse_regex(rule.argument, ignorecase=fold)
            group = F.best_factor_group(ast) or []
        except RegexUnsupported as e:
            confirm["regex_unsupported"] = str(e)
            group = []
    elif op in ("pm", "pmf", "pmFromFile"):
        # phrases (one per line, from @pmFromFile) or whitespace words
        words = (rule.argument.split("\n") if "\n" in rule.argument
                 else rule.argument.split())
        words = [w for w in (w.strip() for w in words) if w]
        confirm["words"] = words
        group = [F.best_window(_lit_seq(w, fold=True)) for w in words]
    elif op in ("contains", "containsWord", "streq", "beginsWith",
                "endsWith"):
        group = [F.best_window(_lit_seq(rule.argument, fold))]
    # @within is NOT in the literal family: it inverts containment (the
    # VARIABLE must occur inside the argument), so a short variable
    # value matches without the stream ever containing the full
    # argument — a factor over the argument text would silently kill
    # the rule (rulecheck PR: found statically by the prefilter audit's
    # certification pass).  Confirm-only.
    elif op == "detectSQLi":
        group = [F.best_window(_lit_seq(w, True)) for w in _SQLI_TRIGGERS]
    elif op == "detectXSS":
        group = [F.best_window(_lit_seq(w, True)) for w in _XSS_TRIGGERS]
    else:
        group = []

    if rule.negate:
        # inverted match: absence of a pattern has no scannable factors —
        # always-confirm, evaluated exactly (and inverted) on CPU.  The
        # op-specific confirm fields (words etc.) above are still needed:
        # the confirm stage evaluates the op, THEN inverts.
        confirm["negate"] = True
        return [], confirm

    # Targets whose text never appears in a scanned stream (the HTTP
    # status/protocol/method scalars): a prefilter factor could never
    # fire there, silently killing the rule — always-confirm instead
    # (RESPONSE_STATUS "@rx ^5\d\d$" would compile a dead prefilter
    # against resp_headers bytes).
    if rule.raw_targets:
        bases = {t.strip().lstrip("&!").split(":", 1)[0].upper()
                 for t in rule.raw_targets if t.strip()}
        # ANY non-scanned target makes the rule always-confirm, not just
        # all-non-scanned: a mixed REQUEST_URI|
        # REMOTE_ADDR rule with a scanned-side prefilter would silently
        # drop the REMOTE_ADDR leg whenever the uri bytes miss — a
        # prefilter may only gate targets whose text it can actually see
        if bases and bases & F_NON_SCANNED:
            return [], confirm

    # Soundness fix-ups for destructive transforms (see module docstring).
    t = set(rule.transforms)
    if t & _COMMENT_TRANSFORMS:
        return [], confirm
    if t & _UNMODELED_DECODE_TRANSFORMS:
        return [], confirm
    if t & _PATH_TRANSFORMS and group:
        group = _split_at(group, _PATH_SEP_BYTES)
    if t & _WS_COLLAPSE and group:
        group = _squash_group(group)

    # Discard degenerate groups: an empty alternative fires everywhere, and
    # a group whose weakest alternative carries <2 bits of information
    # (e.g. a single near-full byte class) fires on ~all traffic — worse
    # than honestly marking the rule always-confirm.
    group = [s for s in group if len(s) > 0]
    if group and min(F.seq_bits(s) for s in group) < 2.0:
        group = []
    return group, confirm


def compile_ruleset(
    rules: Sequence[Rule],
    base_path: Optional[str | Path] = None,
    include_chains: bool = True,
    reduction: Optional[ReductionConfig] = None,
) -> CompiledRuleset:
    """Compile rules → CompiledRuleset.

    ``reduction`` configures the pack-size-invariance passes
    (compiler/reduce.py + bitap prefix merging; docs/SCAN_KERNEL.md):
    None = DEFAULT_REDUCTION (budgeted approximate reduction ON — the
    prefilter may over-trigger within the candidate-inflation budget,
    verdicts are unchanged because the exact confirm lane decides);
    ``ReductionConfig.off()`` = bit-identical legacy tables.

    Chained rules contribute the FIRST scannable link's factors (a chain hit
    requires every link; prefiltering on one link is sound); the confirm
    descriptor carries all links for exact AND evaluation.

    ``base_path`` is accepted for compatibility but unused: @pmFromFile is
    resolved at SecLang parse time (seclang.parse_seclang).

    EVERY rule compiles — non-scan operators (@eq, @validateByteRange,
    ...) and negated operators get an empty factor group and ride the
    always-confirm path; nothing is silently dropped (a dropped CRS 920
    rule would be a silent protocol-check hole).

    CRS anomaly mode resolves statically (see the "CRS anomaly mode"
    block above): SecAction config rules fold into a TX env and are
    dropped from the pack; per-rule setvar increments become
    rule_score; the 949-style rule becomes ``anomaly_threshold``;
    resolvable %{tx.*} macros in operator arguments are expanded so the
    confirm stage sees literal values.
    """
    # ---- pass 0: static TX environment + config-rule partition.
    # Mirrors the parser's conditional-setvar semantics (seclang.py):
    # a SecRule whose condition resolves statically TRUE folds like a
    # SecAction, FALSE never fires, and a request-dependent condition
    # INVALIDATES its written names — folding only SecActions would
    # leave this env disagreeing with the parse-time env on
    # the same tree (unresolved thresholds, stale macro expansions).
    env: Dict[str, str] = dict(_TX_DEFAULTS)
    scannable = []
    anomaly_threshold: Optional[int] = None
    for rule in rules:
        if (rule.operator == "unconditionalMatch" and not rule.raw_targets
                and rule.setvars):
            _apply_setvars(env, rule.setvars)   # SecAction config rule
            continue
        scannable.append(rule)
        sv_chain = list(rule.setvars)
        if rule.chain is not None:
            verdict = None          # conjunction: never static here
            link: Optional[Rule] = rule.chain
            while link is not None:
                sv_chain.extend(link.setvars)
                link = link.chain
        elif sv_chain:
            verdict = _static_skip_condition(
                "|".join(rule.raw_targets), rule.negate, rule.operator,
                rule.argument, env)
        if sv_chain:
            if verdict is True:
                _apply_setvars(env, sv_chain)
            elif verdict is None:
                _invalidate_tx_names(env, sv_chain)
            # statically FALSE: the rule never fires — env untouched
    if "detection_paranoia_level" in env or "paranoia_level" in env:
        try:
            paranoia_hint: Optional[int] = int(
                env.get("detection_paranoia_level",
                        env.get("paranoia_level", "1")))
        except ValueError:
            paranoia_hint = None
    else:
        paranoia_hint = None
    thr = env.get("inbound_anomaly_score_threshold")
    if thr is not None and re.match(r"\s*\d+", thr):
        anomaly_threshold = int(re.match(r"\s*(\d+)", thr).group(1))
    for rule in scannable:
        t = _threshold_from_rule(rule, env)
        if t is not None:
            anomaly_threshold = t
        links = rule.chain
        while links is not None:
            t = _threshold_from_rule(links, env)
            if t is not None:
                anomaly_threshold = t
            links = links.chain
        # expand resolvable %{tx.*} macros in operator arguments so the
        # confirm stage evaluates literals instead of abstaining
        link: Optional[Rule] = rule
        while link is not None:
            if "%{" in link.argument:
                resolved = resolve_macros(link.argument, env)
                if resolved is not None:
                    link.argument = resolved
            link = link.chain

    metas: List[RuleMeta] = []
    groups: List[F.Group] = []
    sv_mask = np.zeros((len(scannable), N_SV), dtype=bool)
    rule_class = np.zeros((len(scannable),), dtype=np.int32)
    rule_score = np.zeros((len(scannable),), dtype=np.int32)
    rule_action = np.zeros((len(scannable),), dtype=np.int32)
    rule_paranoia = np.ones((len(scannable),), dtype=np.int32)
    rule_ids = np.zeros((len(scannable),), dtype=np.int64)

    for i, rule in enumerate(scannable):
        group, confirm = _factor_group_for(rule)
        if include_chains and rule.chain is not None:
            links = []
            link: Optional[Rule] = rule.chain
            while link is not None:
                _, link_confirm = _factor_group_for(link)
                link_confirm["targets"] = link.targets
                link_confirm["raw_targets"] = link.raw_targets
                links.append(link_confirm)
                link = link.chain
            confirm["chain"] = links
        confirm["targets"] = rule.targets
        confirm["raw_targets"] = rule.raw_targets
        variant = confirm["variant"]

        groups.append(group)
        metas.append(RuleMeta(rule=rule, index=i, variant=variant,
                              has_prefilter=bool(group), confirm=confirm))
        for stream in rule.targets:
            sv = STREAM_INDEX[stream] * len(VARIANTS) + variant
            sv_mask[i, sv] = True
        rule_class[i] = CLASS_INDEX[rule.attack_class]
        inc = _anomaly_increment(rule, env)
        if inc is None and rule.chain is not None:
            # CRS puts the setvar on the LAST chain link sometimes
            link = rule.chain
            while link is not None and inc is None:
                inc = _anomaly_increment(link, env)
                link = link.chain
        rule_score[i] = (inc if inc is not None
                         else SEVERITY_SCORE.get(rule.severity.upper(), 3))
        rule_action[i] = {"pass": 0, "block": 1, "deny": 2}[rule.action]
        rule_paranoia[i] = rule.paranoia
        rule_ids[i] = rule.rule_id

    cfg = DEFAULT_REDUCTION if reduction is None else reduction
    report = None
    # profile-priced compile (docs/RETUNE.md): measured traffic
    # re-weights the budget math and pins hot rules' factors; everything
    # stays strictly over-approximating — the profile is pricing only
    prof = cfg.profile if cfg.approximate else None
    rule_w = hot_mask = None
    if prof is not None:
        rule_w = prof.rule_weights(rule_ids)
        hot_ids = prof.hot_rule_ids(cfg.hot_frac)
        hot_mask = np.asarray([int(r) in hot_ids for r in rule_ids],
                              dtype=bool)
    if cfg.approximate:
        groups, rep = reduce_rule_groups(groups, cfg, rule_weights=rule_w,
                                         hot_rules=hot_mask)
        report = rep
        if prof is not None:
            report.profile_hash = prof.content_hash()
    if prof is not None and cfg.qr_relax_top > 0:
        # rules the profile ranks most expensive to confirm get relaxed
        # quick-reject literal derivation (models/confirm.py qr_relax:
        # shorter mandatory literals are still sound — absence of a
        # mandatory literal disproves a match at any length).  The flag
        # rides the confirm descriptor, so it is fingerprint-covered.
        relax_ids = set(prof.top_expensive_confirms(cfg.qr_relax_top))
        n_relaxed = 0
        for i, m in enumerate(metas):
            if int(rule_ids[i]) in relax_ids:
                m.confirm["qr_relax"] = 1
                n_relaxed += 1
        if report is not None:
            report.qr_relaxed = n_relaxed
    rule_tier = None
    if cfg.word_tiering:
        # tail tier: rules whose every scanned stream is body/response —
        # their factors pack after n_head_words so a dispatch carrying
        # only uri/args/headers rows can slice the word axis
        tail_streams = set(STREAMS) - set(HEAD_STREAMS)
        rule_tier = np.asarray(
            [1 if (r.targets and set(r.targets) <= tail_streams) else 0
             for r in scannable], dtype=np.int32)
    tables = pack_factors(groups, n_rules=len(scannable),
                          prefix_merge=cfg.prefix_merge,
                          rule_tier=rule_tier)
    if cfg.approximate and cfg.class_merge and report is not None:
        owners = np.diff(tables.factor_rule_indptr).astype(np.int64)
        bt, n_merges, k_in, k_out, cspent = coarsen_byte_classes(
            tables.byte_table, tables.factor_word, tables.factor_bit,
            tables.factor_len, owners,
            budget_frac=max(0.0, cfg.budget - report.spent),
            merge_cap=cfg.class_merge_cap,
            mu=prof.byte_mu() if prof is not None else None)
        tables.byte_table = bt
        report.class_merges = n_merges
        report.classes_in = k_in
        report.classes_out = k_out
        report.spent += cspent
    if report is not None:
        report.prefix_shared = tables.n_prefix_shared
        report.spent = round(report.spent, 5)
    ctl_specs = _resolve_ctls(scannable, rule_ids)
    cr = CompiledRuleset(
        tables=tables, rules=metas, rule_sv_mask=sv_mask,
        rule_class=rule_class, rule_score=rule_score,
        rule_action=rule_action, rule_paranoia=rule_paranoia,
        rule_ids=rule_ids, anomaly_threshold=anomaly_threshold,
        paranoia_hint=paranoia_hint, ctl_specs=ctl_specs,
        reduction=report.to_dict() if report is not None else None,
    )
    cr.version = cr.fingerprint()
    return cr


def _resolve_ctls(scannable: List[Rule],
                  rule_ids: np.ndarray) -> Dict[int, Dict]:
    """Resolve each rule's ctl actions against the finished pack.

    Id specs (single ids, "lo-hi" ranges) become the concrete rule ids
    present in THIS pack, so the runtime applies plain masks with zero
    parsing; tag/msg-based variants resolve their regex the same way.
    Handled: ruleRemoveById/ByTag/ByMsg, ruleRemoveTargetById/ByTag/
    ByMsg, ruleEngine=Off|DetectionOnly.  Other ctl keys (auditEngine,
    requestBodyProcessor, ...) control ModSecurity plumbing we don't
    model and are ignored — but EVERY ctl-carrying rule still gets a
    spec entry (possibly empty), so the pipeline always knows it is
    config machinery and never reports it as a detection hit."""
    specs: Dict[int, Dict] = {}
    all_ids = [int(r) for r in rule_ids]

    def _ids_for_pattern(val: str, field: str):
        try:
            pat = re.compile(val)
        except re.error:
            return []
        out = []
        for j, r in enumerate(scannable):
            hay = r.tags if field == "tags" else [r.msg]
            if any(pat.search(t) for t in hay):
                out.append(all_ids[j])
        return out

    for i, rule in enumerate(scannable):
        remove: set = set()
        target_excl: Dict[str, List[str]] = {}
        engine = None            # None | "off" | "detection_only"
        ctls = list(rule.ctls)
        link = rule.chain
        while link is not None:           # ctl may sit on a chain link
            ctls.extend(link.ctls)
            link = link.chain

        def _add_target_excl(rids, target: str) -> None:
            for rid in rids:
                target_excl.setdefault(str(rid), [])
                if target not in target_excl[str(rid)]:
                    target_excl[str(rid)].append(target)

        for c in ctls:
            key, _, val = c.partition("=")
            key, val = key.strip(), val.strip()
            if key == "ruleEngine":
                if val.lower() == "off":
                    engine = "off"
                elif val.lower() == "detectiononly" and engine != "off":
                    # monitoring for this request: detect + log, never
                    # block (ModSecurity's DetectionOnly transaction
                    # semantics: silently ignoring it would over-block
                    # where ModSecurity passes)
                    engine = "detection_only"
            elif key == "ruleRemoveById":
                match = _id_matcher([val])
                remove.update(rid for rid in all_ids if match(rid))
            elif key == "ruleRemoveByTag":
                remove.update(_ids_for_pattern(val, "tags"))
            elif key == "ruleRemoveByMsg":
                remove.update(_ids_for_pattern(val, "msg"))
            elif key in ("ruleRemoveTargetById", "ruleRemoveTargetByTag",
                         "ruleRemoveTargetByMsg"):
                spec_txt, _, target = val.partition(";")
                target = target.strip()
                if not target:
                    continue
                if key == "ruleRemoveTargetById":
                    match = _id_matcher([spec_txt])
                    rids = [rid for rid in all_ids if match(rid)]
                else:
                    rids = _ids_for_pattern(
                        spec_txt.strip(),
                        "tags" if key.endswith("ByTag") else "msg")
                _add_target_excl(rids, target)
        if ctls:
            specs[i] = {"remove_ids": sorted(remove),
                        "target_excl": target_excl,
                        "engine": engine,
                        # legacy key, kept for checkpoints written by
                        # earlier builds that read/wrote a bool
                        "engine_off": engine == "off"}
    return specs
