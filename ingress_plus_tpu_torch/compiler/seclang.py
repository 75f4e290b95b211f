"""SecLang (ModSecurity rule language) parser.

The reference data plane consumes two rule formats: OWASP CRS v3 SecLang
rules via libmodsecurity, and Wallarm's proprietary proton.db signature packs
(closed source; SURVEY.md §2.2).  This module parses the SecLang subset CRS
uses — `SecRule VARIABLES "OPERATOR" "ACTIONS"` with chains, transformations
and the common operators — into neutral ``Rule`` objects that
ruleset.py compiles for the scan engine.  Signature packs are handled by
sigpack.py with the same Rule output type.
"""

from __future__ import annotations

import glob as _glob
import re
import shlex
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

# CRS-style rule-id range → attack class (verdict head).
CLASS_RANGES = [
    (911000, 911999, "protocol"),
    (913000, 913999, "scanner"),
    (920000, 920999, "protocol"),
    (921000, 921999, "protocol"),
    (922000, 922999, "protocol"),
    (930000, 930999, "lfi"),
    (931000, 931999, "rfi"),
    (932000, 932999, "rce"),
    (933000, 933999, "php"),
    (934000, 934999, "nodejs"),
    (941000, 941999, "xss"),
    (942000, 942999, "sqli"),
    (943000, 943999, "session"),
    (944000, 944999, "java"),
    # response-side data-leakage families (CRS RESPONSE-95x): fired by
    # the response scan path (serve-side PTPI frames), phase 4
    (950000, 954999, "leak"),
]

# "leak"/"acl" are appended LAST: class ids ride the wire as u8 indexes
# (protocol.py / protocol.hpp) — existing ids must stay stable.  "acl"
# is the enforcement pseudo-class for wallarm-acl deny verdicts
# (models/pipeline.py finalize), not a detection family.
CLASSES = [
    "protocol", "scanner", "lfi", "rfi", "rce", "php", "nodejs",
    "xss", "sqli", "session", "java", "generic", "leak", "acl",
]
CLASS_INDEX = {c: i for i, c in enumerate(CLASSES)}

# Request targets we know how to feed to the scanner.  Each maps to one of
# the normalized streams the serve loop extracts from a request
# (serve/request.py).
KNOWN_TARGETS = {
    "REQUEST_URI": "uri",
    "REQUEST_URI_RAW": "uri",
    "REQUEST_BASENAME": "uri",
    "REQUEST_FILENAME": "uri",
    "QUERY_STRING": "args",
    # ModSecurity's ARGS is ARGS_GET ∪ ARGS_POST: both the query-args
    # stream AND the body stream apply (a numeric/negated ARGS rule on a
    # query-less POST must still reach confirm via a body row)
    "ARGS": ("args", "body"),
    "ARGS_GET": "args",
    "ARGS_POST": "body",
    "ARGS_NAMES": ("args", "body"),
    "ARGS_GET_NAMES": "args",
    "ARGS_POST_NAMES": "body",
    "REQUEST_BODY": "body",
    "XML": "body",
    "JSON": "body",
    "FILES": "body",
    "FILES_NAMES": "body",
    "REQUEST_HEADERS": "headers",
    "REQUEST_HEADERS_NAMES": "headers",
    "REQUEST_COOKIES": "headers",
    "REQUEST_COOKIES_NAMES": "headers",
    "REQUEST_LINE": "uri",
    "REQUEST_METHOD": "uri",
    # scalar resolved in confirm (@ipMatch); binds to uri so the rule
    # APPLIES to every request (every request has a uri row) — the
    # factor group is empty (NON_SCANNED_SCALAR_BASES), so this never
    # compiles a dead prefilter against uri bytes
    "REMOTE_ADDR": "uri",
    "REQUEST_PROTOCOL": "uri",
    # ---- response side (phase 3/4 rules; wallarm_parse_response /
    # wallarm-unpack-response analog — scanned from PTPI frames)
    "RESPONSE_BODY": "resp_body",
    "RESPONSE_HEADERS": "resp_headers",
    "RESPONSE_HEADERS_NAMES": "resp_headers",
    "RESPONSE_STATUS": "resp_headers",   # scalar resolved in confirm
    "RESPONSE_PROTOCOL": "resp_headers",
}

STREAMS = ("uri", "args", "headers", "body", "resp_headers", "resp_body")

#: variable bases the engine recognizes but cannot scan (no byte stream):
#: collections/scalars that exist only at confirm time (TX anomaly vars)
#: or that we don't model (IP/SESSION persistence, env).  A rule whose
#: every target is unscannable must ABSTAIN (empty targets), not rebind
#: to args text.
UNSCANNABLE_BASES = {
    "TX", "IP", "GLOBAL", "SESSION", "USER", "ENV", "GEO", "TIME",
    "DURATION", "REMOTE_HOST", "REMOTE_PORT", "AUTH_TYPE",
    "MATCHED_VAR", "MATCHED_VARS", "MATCHED_VAR_NAME", "MATCHED_VARS_NAMES",
    "UNIQUE_ID", "WEBSERVER_ERROR_LOG",
}

#: scalar bases whose text is NOT present in any scanned stream: their
#: rules must compile with an empty factor group (always-confirm) — a
#: prefilter factor could never fire, silently killing the rule
#: (RESPONSE_STATUS "^5\\d\\d$" factors can't match header bytes)
NON_SCANNED_SCALAR_BASES = {
    "RESPONSE_STATUS", "RESPONSE_PROTOCOL", "REQUEST_METHOD",
    "REQUEST_PROTOCOL", "REMOTE_ADDR",
}
STREAM_INDEX = {s: i for i, s in enumerate(STREAMS)}


@dataclass
class Rule:
    """One detection rule, format-neutral."""

    rule_id: int
    operator: str                     # rx | pm | contains | streq | beginsWith |
                                      # endsWith | within | detectSQLi |
                                      # detectXSS | eq/ge/gt/le/lt |
                                      # validateByteRange | ... (non-scan
                                      # operators compile confirm-only)
    argument: str                     # regex text / word list / literal
    targets: List[str] = field(default_factory=lambda: ["args"])  # stream names
    #: original pipe-split variable tokens ("REQUEST_HEADERS:Content-Length",
    #: "&ARGS", "!ARGS:z", ...) — the confirm stage resolves subfield
    #: selectors / counts / exclusions from these EXACTLY, instead of
    #: evaluating against the whole coarse stream (a negated op on a
    #: discarded selector would fire on every request)
    raw_targets: List[str] = field(default_factory=list)
    transforms: List[str] = field(default_factory=list)
    action: str = "block"             # block | deny | pass (monitoring)
    severity: str = "WARNING"
    msg: str = ""
    tags: List[str] = field(default_factory=list)
    chain: Optional["Rule"] = None    # AND-linked next rule
    paranoia: int = 1
    phase: int = 2
    negate: bool = False              # "!@op": match inverted (confirm-only
                                      # by construction — absence cannot be
                                      # prefiltered by factors)
    #: raw setvar action values ("tx.anomaly_score_pl1=+%{tx.critical_
    #: anomaly_score}") — the compiler resolves the CRS anomaly-scoring
    #: pattern from these statically (compile-time macro resolution keeps
    #: the runtime fully batched: anomaly accumulation IS the engine's
    #: score matmul)
    setvars: List[str] = field(default_factory=list)
    #: raw ctl action values ("ruleRemoveById=942100",
    #: "ruleRemoveTargetById=942100;ARGS:password") — runtime rule
    #: exclusions conditioned on THIS rule matching (the CRS exclusion-
    #: package shape: SecRule REQUEST_URI "@beginsWith /api" "...,pass,
    #: nolog,ctl:...").  Resolved to static masks at compile time
    #: (compiler/ruleset.py) and applied per request in the confirm
    #: stage (models/pipeline.py).
    ctls: List[str] = field(default_factory=list)

    @property
    def attack_class(self) -> str:
        for lo, hi, name in CLASS_RANGES:
            if lo <= self.rule_id <= hi:
                return name
        for t in self.tags:
            m = re.search(r"attack-(\w+)", t)
            if m and m.group(1) in CLASS_INDEX:
                return m.group(1)
        return "generic"


class SecLangError(Exception):
    pass


def _logical_lines_numbered(text: str) -> List[tuple]:
    """(first_line_no, joined_line) pairs: backslash-continued lines
    joined, comments/blank lines stripped.  The single implementation of
    the line-joining rules — the rulecheck analyzer's position-aware
    directive scanner (analysis/scan.py) shares it so reported line
    numbers can never drift from what the parser loads."""
    out: List[tuple] = []
    cur, cur_start = "", 0
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not cur and (not line.strip() or line.lstrip().startswith("#")):
            continue
        if not cur:
            cur_start = i
        if line.endswith("\\"):
            cur += line[:-1] + " "
            continue
        cur += line
        out.append((cur_start, cur.strip()))
        cur = ""
    if cur.strip():
        out.append((cur_start, cur.strip()))
    return out


def _logical_lines(text: str) -> List[str]:
    return [line for _, line in _logical_lines_numbered(text)]


def _split_directive(line: str) -> List[str]:
    """Split a SecLang line into directive tokens, honoring quotes."""
    lex = shlex.shlex(line, posix=True)
    lex.whitespace_split = True
    lex.commenters = ""
    return list(lex)


def _parse_actions(text: str) -> Dict[str, List[str]]:
    """Parse the comma-separated action list (quoted values allowed)."""
    out: Dict[str, List[str]] = {}
    buf, depth, quote = [], 0, None
    items: List[str] = []
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
            else:
                buf.append(ch)
            continue
        if ch in "'\"":
            quote = ch
            continue
        if ch == "," and depth == 0:
            items.append("".join(buf).strip())
            buf = []
            continue
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        buf.append(ch)
    if buf:
        items.append("".join(buf).strip())
    for item in items:
        if not item:
            continue
        if ":" in item:
            k, v = item.split(":", 1)
        else:
            k, v = item, ""
        out.setdefault(k.strip(), []).append(v.strip())
    return out


def _phase_key(actions: Dict[str, List[str]]) -> str:
    """The ONE normalized phase string (symbolic names mapped to their
    numbers) — used for both SecDefaultAction storage and rule lookup,
    so mixed numeric/symbolic notation can't break inheritance."""
    txt = (actions.get("phase", ["2"])[0] or "2").strip("'\"")
    return {"request": "2", "response": "4", "logging": "5"}.get(txt, txt)


def _parse_targets(text: str) -> List[str]:
    """Target expression → stream names (prefilter sv-mask granularity).

    Counting-form targets (&ARGS — the variable's COUNT, not its text)
    map to their base stream so the rule reaches the confirm stage,
    which evaluates the count EXACTLY from the raw target token
    (models/confirm.py _values_for).  Before round 3 they were dropped
    entirely; the confirm stage could only abstain.  Note the remaining
    gap, documented there: a count rule fires only for requests with at
    least one row of the base stream (an absent-stream "@eq 0" abstains).
    """
    streams: List[str] = []
    saw_any = False
    for t in text.split("|"):
        t = t.strip()
        if not t or t.startswith("!"):
            continue  # exclusions narrow the target set; superset is sound
        if t.startswith("&"):
            t = t[1:].strip()   # counting form: same base stream
        base = t.split(":", 1)[0].upper()
        if base in UNSCANNABLE_BASES:
            saw_any = True      # recognized, but no stream to bind
            continue
        mapped = KNOWN_TARGETS.get(base)
        for stream in ((mapped,) if isinstance(mapped, str)
                       else (mapped or ())):
            if stream not in streams:
                streams.append(stream)
        saw_any = saw_any or mapped is not None
    if streams:
        return streams
    # nothing usable: only fall back to args when the expression named
    # NO target we recognize at all (legacy lenient behavior); an
    # all-TX/-IP rule must abstain, not rebind to args text
    return [] if saw_any else ["args"]


def _id_matcher(specs: Sequence[str]):
    """SecRuleRemoveById/UpdateTargetById id expressions → predicate.
    Accepts space-separated ids and "lo-hi" ranges (quotes already
    stripped by the directive tokenizer)."""
    ids: set = set()
    ranges: List[tuple] = []
    for spec in specs:
        for part in spec.split():
            part = part.strip()
            if not part:
                continue
            if "-" in part[1:]:
                lo, _, hi = part.partition("-")
                try:
                    ranges.append((int(lo), int(hi)))
                except ValueError:
                    raise SecLangError("bad rule-id range %r" % part)
            else:
                try:
                    ids.add(int(part))
                except ValueError:
                    raise SecLangError("bad rule id %r" % part)

    def match(rid: int) -> bool:
        return rid in ids or any(lo <= rid <= hi for lo, hi in ranges)

    return match


def _static_skip_condition(targets_txt: str, negate: bool, operator: str,
                           argument: str, tx: Dict[str, str]):
    """Statically evaluate a skipAfter rule's condition against the
    parse-time TX environment (VERDICT r04 item #7).

    The CRS paranoia-gating shape — ``SecRule TX:DETECTION_PARANOIA_LEVEL
    "@lt 2" "...,skipAfter:END-...-PL2"`` — compares a SecAction-set TX
    variable against a literal (or another TX variable), so the whole
    control flow resolves at compile time.  Returns True/False when
    decidable, None otherwise (unknown variable, non-TX target, macro
    that doesn't resolve, unsupported operator) — the caller then keeps
    the skipped-over rules ACTIVE, the sound fallback."""
    toks = [t.strip().strip("'\"") for t in targets_txt.split("|")
            if t.strip()]
    if len(toks) != 1:
        return None
    tok = toks[0]
    count_form = tok.startswith("&")
    if count_form:
        tok = tok[1:].strip()
    if not tok.upper().startswith("TX:"):
        return None
    var = tok.split(":", 1)[1].strip().lower()
    val = tx.get(var)
    if val is None:
        return None
    if count_form:
        # &TX:var — the variable's COUNT: statically-set means exactly
        # one.  Without this, the canonical CRS-901 defaulting idiom
        # (SecRule &TX:x "@eq 0" "...,setvar:tx.x=1") was undecidable
        # and its invalidation killed static paranoia gating on real
        # trees.  An env MISS already returned None
        # above: the runtime count could be 0 or 1, so we abstain.
        val = "1"
    arg = argument.strip().strip("'\"")
    # CRS writes macros in canonical caps — %{TX.blocking_paranoia_level}
    # — so the match must be case-insensitive or static skipAfter
    # resolution silently no-ops on real CRS trees (ADVICE r05)
    m = re.match(r"%\{tx\.([a-zA-Z0-9_]+)\}\Z", arg, re.IGNORECASE)
    if m:
        arg = tx.get(m.group(1).lower())
        if arg is None:
            return None
    if operator in ("eq", "ge", "gt", "le", "lt"):
        ma = re.match(r"\s*([+-]?\d+)", str(val))
        mb = re.match(r"\s*([+-]?\d+)", str(arg))
        if not ma or not mb:
            return None
        a, b = int(ma.group(1)), int(mb.group(1))
        res = {"eq": a == b, "ge": a >= b, "gt": a > b,
               "le": a <= b, "lt": a < b}[operator]
    elif operator == "streq":
        res = str(val) == str(arg)
    else:
        return None
    return (not res) if negate else res


def _inert_config_rule(actions: Dict[str, List[str]],
                       setvars: List[str]) -> Rule:
    """Setvar assignments as an inert config rule (unconditionalMatch,
    no targets, pass): the compile-time partition (ruleset.py pass 0)
    folds these into its static TX env and drops them from the pack.
    Shared by the SecAction path and the statically-true skipAfter
    control-rule path."""
    try:
        rid = int(actions.get("id", ["0"])[0] or 0)
    except ValueError:
        rid = 0
    return Rule(rule_id=rid, operator="unconditionalMatch", argument="",
                targets=[], raw_targets=[], action="pass",
                setvars=setvars)


def _classify_setvar(sv: str):
    """One setvar action → ``(key, kind, value)`` with kind one of
    ``"delete"`` (``!tx.name``), ``"set"`` (literal or value-less "set
    to 1"), ``"increment"`` (``=+``/``=-``), or ``None`` for non-TX
    targets.  The SINGLE normalization shared by the parse-time env
    (_fold_tx_assignments), the compile-time env (ruleset._apply_
    setvars) and the analyzer mirrors: hand-copies of these rules would
    diverge on the delete and value-less forms."""
    name, sep, value = sv.partition("=")
    name = name.strip().lower()
    if name.startswith("!"):
        bare = name[1:].strip()
        if bare.startswith("tx."):
            return bare[3:], "delete", ""
        return None, None, ""
    if not name.startswith("tx."):
        return None, None, ""
    key = name[3:]
    if not sep:
        return key, "set", "1"     # value-less form: ModSec "set to 1"
    value = value.strip()
    if value[:1] in ("+", "-"):
        return key, "increment", value
    return key, "set", value


def _invalidate_tx_names(tx: Dict[str, str], setvars: List[str]) -> List[str]:
    """Drop every TX name these setvars write from the parse-time env
    (request-dependent writes: later static conditions on them must
    abstain).  Returns the popped-or-missing names.  Shared with the
    rulecheck analyzer's TX-env mirror (analysis/scan.static_tx_env) so
    the parser and its auditor can never disagree on the normalization."""
    names = []
    for sv in setvars:
        key, kind, _value = _classify_setvar(sv)
        if kind is not None:
            tx.pop(key, None)
            names.append(key)
    return names


def _fold_tx_assignments(tx: Dict[str, str], setvars: List[str]) -> None:
    """Record literal ``tx.name=value`` assignments (and one-hop
    ``%{tx.other}`` copies) in the parse-time TX env.  An increment
    (``=+``/``=-``) or an unresolvable macro INVALIDATES the entry
    rather than leaving the stale literal behind (a stale value would
    make a later skipAfter condition confidently wrong and drop rules
    ModSecurity would run) — an undecidable variable
    makes conditions on it abstain, which keeps rules active."""
    for sv in setvars:
        key, kind, value = _classify_setvar(sv)
        if kind is None:
            continue
        if kind in ("delete", "increment"):
            # delete: the variable is unset (a stale literal would make
            # later skipAfter conditions confidently wrong); increment:
            # the value is request-dependent — both invalidate
            tx.pop(key, None)
            continue
        # one-hop copies also arrive as %{TX.other} on canonical trees
        m = re.match(r"%\{tx\.([a-zA-Z0-9_]+)\}\Z", value, re.IGNORECASE)
        if m:
            resolved = tx.get(m.group(1).lower())
            if resolved is None:
                tx.pop(key, None)
                continue
            value = resolved
        elif "%{" in value:
            tx.pop(key, None)
            continue
        tx[key] = value


def parse_seclang(
    text: str,
    source: str = "<string>",
    base_dir: Optional[Path] = None,
    rules: Optional[List[Rule]] = None,
    _seen_includes: Optional[set] = None,
    _phase_defaults: Optional[dict] = None,
    _skip_state: Optional[dict] = None,
) -> List[Rule]:
    """Parse SecLang text → list of top-level Rules (chains attached).

    ``@pmFromFile`` is resolved HERE, against ``base_dir`` (the directory of
    the .conf file): the operator is rewritten to ``pm`` with the file's
    phrases joined by newlines.  A missing file or missing base_dir is a
    hard SecLangError — a silently-empty word list would compile to a dead
    rule whose misses the F1 gate would blame on the kernel.

    ``rules`` (optional accumulator): config-time exclusion directives
    (SecRuleRemoveById/ByTag/ByMsg, SecRuleUpdateTargetById) apply to the
    rules loaded SO FAR, in directive order — ModSecurity semantics, and
    the CRS convention of exclusion files sorting after rule includes.
    load_seclang_dir passes one shared list so exclusions in a later
    .conf reach rules from earlier files."""
    if rules is None:
        rules = []
    if _seen_includes is None:
        _seen_includes = set()
    if _phase_defaults is None:
        _phase_defaults = {}   # phase → (default action, default t: list)
    if _skip_state is None:
        # "tx": parse-time TX env (SecAction literal assignments);
        # "skips": active skipAfter regions as (marker, phase) pairs —
        # SecRule/SecAction directives OF THE SAME PHASE are
        # runtime-skipped until the marker, because a ModSecurity jump
        # only applies within the control rule's own phase (rules of
        # other phases in the interval still run;
        # CRS emits paired per-phase control rules for exactly this
        # reason).  Config directives (Include/SecRuleRemove...) always
        # apply: skipAfter is runtime flow, config is config.
        # "chain_drop": a skipped chain leader's continuation lines.
        _skip_state = {"tx": {}, "skips": [], "chain_drop": False}
    pending_chain: Optional[Rule] = None

    for line in _logical_lines(text):
        try:
            tokens = _split_directive(line)
        except ValueError as e:
            raise SecLangError("%s: tokenize error: %s in %r" % (source, e, line))
        if not tokens:
            continue
        directive = tokens[0]
        if directive == "Include":
            # ModSecurity's config-tree loader: every real deployment
            # pulls CRS in via `Include .../rules/*.conf`, so a user
            # migrating an existing tree points us at it unchanged.
            # Paths resolve against the including file's directory;
            # globs expand sorted (CRS file-order convention); a file
            # is loaded at most once per parse (cycle-proof).
            if len(tokens) < 2 or not tokens[1]:
                raise SecLangError("%s: Include needs a path" % source)
            if base_dir is None:
                raise SecLangError(
                    "%s: Include %r needs base_dir" % (source, tokens[1]))
            pat = tokens[1]   # quotes already stripped by the tokenizer
            root = Path(pat) if Path(pat).is_absolute() else base_dir / pat
            # glob the FULL pattern — Apache/ModSecurity expand
            # wildcards in directory segments too (conf.d/*/rules.conf)
            matches = ([Path(m) for m in sorted(_glob.glob(str(root)))]
                       if any(c in pat for c in "*?[") else [root])
            if not matches or not any(m.is_file() for m in matches):
                raise SecLangError(
                    "%s: Include %r matched no files (resolved %s)"
                    % (source, pat, root))
            for conf in matches:
                if not conf.is_file():
                    continue
                key = str(conf.resolve())
                if key in _seen_includes:
                    continue
                _seen_includes.add(key)
                parse_seclang(conf.read_text(), source=str(conf),
                              base_dir=conf.parent, rules=rules,
                              _seen_includes=_seen_includes,
                              _phase_defaults=_phase_defaults,
                              _skip_state=_skip_state)
                # an unmatched marker must not leak past the included
                # file (a typo'd marker would silently
                # swallow every subsequent Include — mass
                # under-detection).  A parent region spanning the
                # Include still skipped the file's rules above; clearing
                # here can only over-detect, never under-detect.
                _skip_state["skips"] = []
                _skip_state["chain_drop"] = False
            continue
        if directive == "SecAction":
            # config-plane rule (CRS crs-setup.conf shape): no scan
            # content, but its setvar actions initialize the TX
            # environment (anomaly score weights, thresholds, paranoia
            # level).  Emitted as an inert config Rule the compiler
            # folds into the static TX env and drops from the pack.
            actions = _parse_actions(tokens[1] if len(tokens) > 1 else "")
            if any(p == _phase_key(actions)
                   for _m, p in _skip_state["skips"]):
                continue   # inside a statically-skipped region (same phase)
            sv = [v.strip("'\"") for v in actions.get("setvar", []) if v]
            _fold_tx_assignments(_skip_state["tx"], sv)
            if sv:
                rules.append(_inert_config_rule(actions, sv))
            if actions.get("skipAfter"):
                # unconditional SecAction skip: setvars above still
                # applied (they execute before the jump in ModSecurity)
                _skip_state["skips"].append(
                    (actions["skipAfter"][0].strip().strip("'\""),
                     _phase_key(actions)))
            continue
        if directive == "SecDefaultAction":
            # per-phase defaults subsequent SecRules inherit: the
            # disruptive action (when a rule names none) and the
            # transform chain (prepended unless the rule leads with
            # t:none) — ModSecurity's inheritance model
            acts = _parse_actions(tokens[1] if len(tokens) > 1 else "")
            ph = _phase_key(acts)
            d_action = next((a for a in ("deny", "block", "pass")
                             if a in acts), None)
            d_t = [v for v in acts.get("t", []) if v]
            _phase_defaults[ph] = (d_action, d_t)
            continue
        if directive == "SecMarker":
            # a marker ends every active skip region targeting it
            name = tokens[1].strip().strip("'\"") if len(tokens) > 1 else ""
            _skip_state["skips"] = [
                s for s in _skip_state["skips"] if s[0] != name]
            continue
        if directive in ("SecComponentSignature",
                         "SecRuleEngine", "SecRequestBodyAccess",
                         "SecCollectionTimeout"):
            continue  # engine-control directives: no scan content
        if directive == "SecRuleRemoveById":
            # config-time removal (the FP-tuning workhorse of every real
            # CRS deployment): drop already-loaded rules by id/range
            match = _id_matcher(tokens[1:])
            rules[:] = [r for r in rules if not match(r.rule_id)]
            continue
        if directive in ("SecRuleRemoveByTag", "SecRuleRemoveByMsg"):
            if len(tokens) < 2:
                raise SecLangError("%s: %s needs a pattern"
                                   % (source, directive))
            try:
                pat = re.compile(tokens[1])
            except re.error as e:
                raise SecLangError("%s: bad %s pattern: %s"
                                   % (source, directive, e))
            if directive == "SecRuleRemoveByTag":
                rules[:] = [r for r in rules
                            if not any(pat.search(t) for t in r.tags)]
            else:
                rules[:] = [r for r in rules if not pat.search(r.msg)]
            continue
        if directive in ("SecRuleUpdateTargetById",
                         "SecRuleUpdateTargetByTag",
                         "SecRuleUpdateTargetByMsg"):
            # append targets (typically "!ARGS:password" exclusions) to
            # already-loaded rules; the per-variable confirm honors the
            # exclusion exactly, and the scan keeps its superset streams
            # (sound: the confirm stage is what decides).  The 4-arg
            # REPLACED_TARGETS form is not supported — replacing targets
            # could only narrow the scan, and silently accepting it
            # would widen detection instead of narrowing it.
            if len(tokens) < 3:
                raise SecLangError(
                    "%s: %s needs selector + targets" % (source, directive))
            if len(tokens) > 3:
                raise SecLangError(
                    "%s: %s REPLACED_TARGETS form is not supported"
                    % (source, directive))
            if directive.endswith("ById"):
                match = _id_matcher([tokens[1]])

                def selected(r: Rule) -> bool:
                    return match(r.rule_id)
            else:
                try:
                    pat = re.compile(tokens[1])
                except re.error as e:
                    raise SecLangError("%s: bad %s pattern: %s"
                                       % (source, directive, e))
                by_tag = directive.endswith("ByTag")

                def selected(r: Rule) -> bool:
                    hay = r.tags if by_tag else [r.msg]
                    return any(pat.search(t) for t in hay)
            new_toks = [t.strip() for t in tokens[2].split("|")
                        if t.strip()]
            positive = [t for t in new_toks if not t.startswith("!")]
            for r in rules:
                if not selected(r):
                    continue
                r.raw_targets.extend(
                    t for t in new_toks if t not in r.raw_targets)
                if positive:
                    for s in _parse_targets("|".join(positive)):
                        if s not in r.targets:
                            r.targets.append(s)
            continue
        if directive != "SecRule":
            continue  # unknown directives are ignored (forward compat)
        if len(tokens) < 3:
            raise SecLangError("%s: short SecRule: %r" % (source, line))
        targets_txt, op_txt = tokens[1], tokens[2]
        actions_txt = tokens[3] if len(tokens) > 3 else ""
        if _skip_state["chain_drop"]:
            # continuation links of a skipped chain leader: drop until
            # the chain ends (a link without its own "chain" action)
            if "chain" not in _parse_actions(actions_txt):
                _skip_state["chain_drop"] = False
            continue

        negate = False
        if op_txt.startswith("!@"):
            # "!@eq 1"-style inverted operators (CRS uses them heavily in
            # the 920 protocol family and chain links): compile with the
            # match inverted — confirm-only, since absence has no factors
            negate = True
            op_txt = op_txt[1:]
        if op_txt.startswith("@"):
            parts = op_txt.split(None, 1)
            operator = parts[0][1:]
            argument = parts[1] if len(parts) > 1 else ""
        elif op_txt.startswith("!"):
            negate = True
            operator, argument = "rx", op_txt[1:]
        else:
            operator, argument = "rx", op_txt

        if operator in ("pmFromFile", "pmf"):
            if base_dir is None:
                raise SecLangError(
                    "%s: @pmFromFile %r needs base_dir" % (source, argument))
            fp = (base_dir / argument).resolve()
            if not fp.exists():
                raise SecLangError(
                    "%s: @pmFromFile %r not found (resolved %s)"
                    % (source, argument, fp))
            phrases = [w.strip() for w in fp.read_text().splitlines()
                       if w.strip() and not w.startswith("#")]
            if not phrases:
                raise SecLangError("%s: @pmFromFile %r is empty" % (source, argument))
            operator, argument = "pm", "\n".join(phrases)

        if operator == "ipMatchFromFile":
            # resolved HERE like @pmFromFile: the operator rewrites to
            # @ipMatch over the file's entries (one IP/CIDR per line,
            # '#' comments) — CRS DoS/allowlist data-file shape
            if base_dir is None:
                raise SecLangError(
                    "%s: @ipMatchFromFile %r needs base_dir"
                    % (source, argument))
            fp = (base_dir / argument).resolve()
            if not fp.exists():
                raise SecLangError(
                    "%s: @ipMatchFromFile %r not found (resolved %s)"
                    % (source, argument, fp))
            entries = [w.strip() for w in fp.read_text().splitlines()
                       if w.strip() and not w.startswith("#")]
            if not entries:
                raise SecLangError(
                    "%s: @ipMatchFromFile %r is empty" % (source, argument))
            operator, argument = "ipMatch", ",".join(entries)

        actions = _parse_actions(actions_txt)
        if pending_chain is None and any(
                p == _phase_key(actions) for _m, p in _skip_state["skips"]):
            # this rule's phase is inside an active skip region: it is
            # runtime-skipped; a chain leader takes its links with it
            if "chain" in actions:
                _skip_state["chain_drop"] = True
            continue
        if actions.get("skipAfter") and pending_chain is None \
                and "chain" not in actions:
            # skipAfter control flow (VERDICT r04 item #7).  The CRS
            # shape compares a SecAction-set TX variable, so the jump
            # resolves STATICALLY: condition true → the rules between
            # here and the SecMarker are skipped (and this control rule
            # never detects anything itself); condition false → the
            # jump can never fire, the control rule is inert.  A
            # non-static condition keeps everything active — the sound
            # fallback (the skipped-over rules were authored to run at
            # stricter settings; running them can only over-detect,
            # never under-detect).
            marker = actions["skipAfter"][0].strip().strip("'\"")
            verdict = _static_skip_condition(
                targets_txt, negate, operator, argument,
                _skip_state["tx"])
            if verdict is True:
                # the rule fires: its setvars execute BEFORE the jump
                # (ModSecurity action order — same as the SecAction
                # path above: skipping the fold would leave a
                # stale literal that mis-skips a later tier)
                sv = [v.strip("'\"") for v in actions.get("setvar", [])
                      if v]
                _fold_tx_assignments(_skip_state["tx"], sv)
                if sv:
                    # keep the assignments as an inert config rule so
                    # the COMPILE-time env folds them too (dropping
                    # the control rule entirely would leave stale
                    # values in %{tx.*} confirm expansions)
                    rules.append(_inert_config_rule(actions, sv))
                # the jump is scoped to THIS control rule's phase
                _skip_state["skips"].append(
                    (marker, _phase_key(actions)))
                continue
            if verdict is False:
                continue
        try:
            rid = int(actions.get("id", ["0"])[0] or 0)
        except ValueError:
            raise SecLangError("%s: non-numeric rule id in %r" % (source, line))
        raw_t = [v for v in actions.get("t", []) if v]
        phase_txt = _phase_key(actions)
        dflt = _phase_defaults.get(phase_txt)
        # ModSecurity transform inheritance: t:none RESETS the chain —
        # everything before the last t:none (inherited defaults
        # included) is discarded; without any t:none the rule's list
        # appends to the phase's SecDefaultAction transforms (the
        # reason every CRS rule leads with t:none)
        if "none" in raw_t:
            raw_t = raw_t[len(raw_t) - raw_t[::-1].index("none"):]
        elif dflt and dflt[1]:
            raw_t = dflt[1] + raw_t
        transforms = [v for v in raw_t if v != "none"]
        if "deny" in actions:
            action = "deny"
        elif "block" in actions:
            action = "block"
        elif "pass" in actions:
            action = "pass"
        elif dflt and dflt[0]:
            action = dflt[0]   # phase default (SecDefaultAction)
        else:
            action = "block"
        severity = (actions.get("severity", ["WARNING"])[0] or "WARNING").strip("'\"")
        msg = (actions.get("msg", [""])[0]).strip("'\"")
        tags = [v.strip("'\"") for v in actions.get("tag", [])]
        paranoia = 1
        for t in tags:
            m = re.search(r"paranoia-level/(\d)", t)
            if m:
                paranoia = int(m.group(1))
        try:
            phase = int(phase_txt)
        except ValueError:
            raise SecLangError("%s: bad phase %r in rule %s"
                               % (source, actions.get("phase"), rid))

        rule = Rule(
            rule_id=rid,
            operator=operator,
            argument=argument,
            targets=_parse_targets(targets_txt),
            raw_targets=[t.strip() for t in targets_txt.split("|")
                         if t.strip()],
            transforms=transforms,
            action=action,
            severity=severity,
            msg=msg,
            tags=tags,
            paranoia=paranoia,
            phase=phase,
            negate=negate,
            setvars=[v.strip("'\"") for v in actions.get("setvar", [])
                     if v],
            ctls=[v.strip("'\"") for v in actions.get("ctl", []) if v],
        )

        # SecRule-carried setvars vs the parse-time TX env (the SECLANG.md
        # "remaining limitation", now handled): a conditional rule whose
        # condition itself resolves STATICALLY TRUE folds its assignments
        # like a SecAction; a request-dependent condition INVALIDATES the
        # written names instead, so a later skipAfter condition on them
        # abstains (keeps rules active — sound) rather than trusting the
        # stale SecAction literal it would otherwise still see (silent
        # mis-skip).  Chain rules are conjunctions across links — never
        # statically decidable here — so they always invalidate.
        if rule.setvars:
            if pending_chain is not None or "chain" in actions:
                sv_verdict = None
            else:
                sv_verdict = _static_skip_condition(
                    targets_txt, negate, operator, argument,
                    _skip_state["tx"])
            if sv_verdict is True:
                _fold_tx_assignments(_skip_state["tx"], rule.setvars)
            elif sv_verdict is None:
                _invalidate_tx_names(_skip_state["tx"], rule.setvars)
            # statically FALSE: the rule can never fire — env untouched

        if pending_chain is not None:
            # attach to deepest chain link
            tail = pending_chain
            while tail.chain is not None:
                tail = tail.chain
            tail.chain = rule
            if "chain" not in actions:
                rules.append(pending_chain)
                pending_chain = None
        elif "chain" in actions:
            pending_chain = rule
        else:
            rules.append(rule)

    if pending_chain is not None:
        rules.append(pending_chain)  # tolerate dangling chain
    return rules


def load_seclang_dir(path: str | Path) -> List[Rule]:
    """Parse a rules tree: a DIRECTORY loads every ``*.conf`` (sorted,
    CRS-style file order); a FILE is treated as the deployment's entry
    config (modsecurity.conf shape) whose ``Include`` directives pull in
    the rest.  One shared rules accumulator rides through all files so
    exclusion directives in later files (the REQUEST-900/999-style
    before/after convention) apply to rules from earlier ones."""
    p = Path(path)
    rules: List[Rule] = []
    seen: set = set()
    defaults: dict = {}   # SecDefaultAction state crosses files
    # TX assignments (crs-setup.conf paranoia levels) must be visible to
    # skipAfter conditions in LATER files; an active skip region does
    # NOT cross file boundaries (CRS markers are always within-file,
    # and letting a typo'd marker swallow every subsequent file would
    # fail much too quietly)
    skip_state: dict = {"tx": {}, "skips": [], "chain_drop": False}
    if p.is_file():
        seen.add(str(p.resolve()))
        return parse_seclang(p.read_text(), source=str(p),
                             base_dir=p.parent, rules=rules,
                             _seen_includes=seen,
                             _phase_defaults=defaults,
                             _skip_state=skip_state)
    for conf in sorted(p.glob("*.conf")):
        key = str(conf.resolve())
        if key in seen:
            continue   # already pulled in by an earlier file's Include
        seen.add(key)
        parse_seclang(conf.read_text(), source=str(conf),
                      base_dir=conf.parent, rules=rules,
                      _seen_includes=seen, _phase_defaults=defaults,
                      _skip_state=skip_state)
        skip_state["skips"] = []
        skip_state["chain_drop"] = False
    return rules
