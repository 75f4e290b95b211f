"""Exact CPU confirm stage.

Prefilter hits from the TPU engine are re-checked here with full rule
semantics: the rule's exact transform chain applied to the raw stream, the
original PCRE evaluated by Python ``re`` (which supports lookaround,
backreferences and possessive quantifiers — everything our NFA subset
cannot express), chains AND-ed across links.  This is the hybrid design of
SURVEY.md §7 (hard part #1): the TPU answers "could this rule match?", the
confirm answers "does it?" — so detection F1 equals the confirm stage's
semantics by construction.

Transform implementations mirror ModSecurity behavior for the subset the
corpus uses; deviations are approximations documented inline.
"""

from __future__ import annotations

import base64
import binascii
import re
from typing import Callable, Dict, List, Optional, Tuple

from ingress_plus_tpu_torch.serve.bodyparse import flatten_json, parse_multipart
from ingress_plus_tpu_torch.serve.normalize import (
    html_entity_decode,
    url_decode_uni,
)
from ingress_plus_tpu_torch.serve.unpack import SEP as _UNPACK_SEP

_WS = b" \t\n\r\f\v"

# ------------------------------------------------- quick-reject literals
# (docs/CONFIRM_PLANE.md).  The compiler's mandatory-factor machinery
# (compiler/factors.py) proves that every match of a regex contains a
# substring from some alternative group; when every alternative of such
# a group collapses to a fixed byte literal (singleton classes up to
# ASCII case), the confirm stage can pre-check `literal in value` —
# C-level memmem — before paying ``re.search``.  The check runs on the
# EXACT text the regex would search (post-transform), so it is sound by
# construction: no literal present ⇒ the regex cannot match ⇒ the
# operator outcome is exactly False (negation then applies as usual).
# Case handling: literals are derived LOWERCASED and the haystack is
# lowercased unless no literal carries an ASCII letter — sound for
# case-sensitive patterns too (``"SELECT" in v`` ⇒ ``"select" in
# v.lower()``, so a lowercase miss proves the case-exact miss).

#: weakest usable literal: below this ``lit in value`` fires on nearly
#: everything and the pre-check is pure overhead
QR_MIN_LEN = 3
#: alternative cap: a wide group costs one memmem per alternative per
#: value — past this the regex is usually cheaper
QR_MAX_ALTS = 8


def _group_literals(group) -> Optional[List[bytes]]:
    """One mandatory group → lowercased literal alternatives, or None
    when any alternative has a position that is not a single byte up to
    ASCII case (or is non-ASCII: the str-level regex AST and the
    byte-level ``re`` pattern diverge outside ASCII — abstain)."""
    lits: List[bytes] = []
    for seq in group:
        lit = bytearray()
        for cls in seq:
            folded = {(b + 0x20 if 0x41 <= b <= 0x5A else b) for b in cls}
            if len(folded) != 1:
                return None
            b = folded.pop()
            if b > 0x7F:
                return None
            lit.append(b)
        lits.append(bytes(lit))
    return lits or None


def derive_quick_reject(pattern: str, fold: bool,
                        min_len: int = QR_MIN_LEN,
                        ) -> Optional[Tuple[bytes, ...]]:
    """Case-folded mandatory literals for an ``@rx`` pattern: a tuple of
    lowercased byte literals such that any match of the pattern contains
    at least one of them (case-insensitively), or None when no usable
    literal group exists.  Picks the group whose WEAKEST alternative is
    longest — the group is only as selective as its weakest literal.

    ``min_len`` gates which literals are worth a memmem; lowering it
    (the profile-driven qr_relax path) is purely a cost trade — absence
    of a mandatory literal disproves a match at ANY literal length, so
    soundness never depends on the gate."""
    from ingress_plus_tpu_torch.compiler.factors import mandatory_groups
    from ingress_plus_tpu_torch.compiler.regex_ast import (
        RegexUnsupported,
        parse_regex,
    )

    try:
        ast = parse_regex(pattern, ignorecase=fold)
    except (RegexUnsupported, RecursionError):
        return None
    best: Optional[Tuple[int, List[bytes]]] = None
    try:
        groups = mandatory_groups(ast)
    except RecursionError:
        return None
    for group in groups:
        if not group or len(group) > QR_MAX_ALTS:
            continue
        lits = _group_literals(group)
        if lits is None:
            continue
        weakest = min(len(lit) for lit in lits)
        if weakest < min_len:
            continue
        if best is None or weakest > best[0]:
            best = (weakest, lits)
    if best is None:
        return None
    # dedup, longest-first (a long literal missing is the common case;
    # order does not affect soundness, only which memmem runs first)
    return tuple(sorted(dict.fromkeys(best[1]), key=len, reverse=True))


def t_lowercase(d: bytes) -> bytes:
    return d.lower()


def t_urldecode(d: bytes) -> bytes:
    return url_decode_uni(d)


def t_htmlentitydecode(d: bytes) -> bytes:
    return html_entity_decode(d)


def t_removenulls(d: bytes) -> bytes:
    return d.replace(b"\x00", b"")


def t_replacenulls(d: bytes) -> bytes:
    return d.replace(b"\x00", b" ")


def t_compresswhitespace(d: bytes) -> bytes:
    return re.sub(rb"[\s\x0b]+", b" ", d)


def t_removewhitespace(d: bytes) -> bytes:
    return re.sub(rb"[\s\x0b]+", b"", d)


def t_trim(d: bytes) -> bytes:
    return d.strip(_WS)


def t_replacecomments(d: bytes) -> bytes:
    """ModSecurity replaceComments: each complete /*...*/ becomes one
    space; an unterminated /* swallows the rest of the input."""
    d = re.sub(rb"/\*.*?\*/", b" ", d, flags=re.S)
    return re.sub(rb"/\*.*\Z", b" ", d, flags=re.S)


def t_removecommentschar(d: bytes) -> bytes:
    """ModSecurity removeCommentsChar: delete comment DELIMITERS
    (/* */ -- #), keeping the commented text."""
    return re.sub(rb"/\*|\*/|--|#", b"", d)


def t_normalizepath(d: bytes) -> bytes:
    """Collapse //, remove /./, resolve seg/../ (keeps leading slash)."""
    prev = None
    while prev != d:
        prev = d
        d = d.replace(b"//", b"/")
    d = d.replace(b"/./", b"/")
    out: List[bytes] = []
    for seg in d.split(b"/"):
        if seg == b"..":
            if out and out[-1] not in (b"", b".."):
                out.pop()
            else:
                out.append(seg)
        else:
            out.append(seg)
    return b"/".join(out)


def t_cmdline(d: bytes) -> bytes:
    """ModSecurity cmdLine (approximation): delete \\ ' " ^ ; lowercase;
    collapse whitespace; drop spaces around / and (."""
    d = re.sub(rb"[\\'\"^]", b"", d).lower()
    d = re.sub(rb"[\s\x0b]+", b" ", d)
    d = re.sub(rb"\s*([/(])\s*", rb"\1", d)
    return d.strip(_WS)


def t_base64decode(d: bytes) -> bytes:
    try:
        return base64.b64decode(d + b"=" * (-len(d) % 4), validate=False)
    except (binascii.Error, ValueError):
        return d


def t_hexdecode(d: bytes) -> bytes:
    try:
        return binascii.unhexlify(d)
    except (binascii.Error, ValueError):
        return d


def t_jsdecode(d: bytes) -> bytes:
    """\\xHH, \\uHHHH, \\n etc. (approximation)."""
    def repl(m: "re.Match[bytes]") -> bytes:
        g = m.group(0)
        try:
            if g[1:2] in (b"x", b"u"):
                return bytes([int(g[2:], 16) & 0xFF])
            return {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"0": b"\x00"}.get(
                g[1:2], g[1:2])
        except ValueError:
            return g
    return re.sub(rb"\\(?:x[0-9a-fA-F]{2}|u[0-9a-fA-F]{4}|.)", repl, d)


def t_cssdecode(d: bytes) -> bytes:
    def repl(m: "re.Match[bytes]") -> bytes:
        try:
            return bytes([int(m.group(1), 16) & 0xFF])
        except ValueError:
            return m.group(0)
    return re.sub(rb"\\([0-9a-fA-F]{1,6})\s?", repl, d)


TRANSFORMS: Dict[str, Callable[[bytes], bytes]] = {
    "lowercase": t_lowercase,
    "urlDecode": t_urldecode,
    "urlDecodeUni": t_urldecode,
    "htmlEntityDecode": t_htmlentitydecode,
    "removeNulls": t_removenulls,
    "replaceNulls": t_replacenulls,
    "compressWhitespace": t_compresswhitespace,
    "removeWhitespace": t_removewhitespace,
    "normalizePath": t_normalizepath,
    "normalisePath": t_normalizepath,
    "normalizePathWin": t_normalizepath,
    "cmdLine": t_cmdline,
    "base64Decode": t_base64decode,
    "hexDecode": t_hexdecode,
    "jsDecode": t_jsdecode,
    "cssDecode": t_cssdecode,
    "trim": t_trim,
    "replaceComments": t_replacecomments,
    "removeCommentsChar": t_removecommentschar,
    "utf8toUnicode": lambda d: d,  # no-op approximation
    "none": lambda d: d,
}


def apply_transforms(data: bytes, transforms: List[str]) -> bytes:
    for name in transforms:
        fn = TRANSFORMS.get(name)
        if fn is not None:
            data = fn(data)
    return data


# ------------------------------------------- cross-request transform memo
# Transforms are pure functions, and short confirm values repeat heavily
# across requests (header values, content types, common parameters) —
# the per-request cache re-pays urlDecode/htmlEntityDecode for the same
# "Mozilla/5.0 ..." on every request.  This process-level memo keys on
# (transform chain, text) for SHORT texts only (long bodies rarely
# repeat and would dominate the memory bound); at capacity it clears and
# rebuilds — self-healing under high-cardinality traffic, and the steady
# serve-plane working set (stable header vocabulary) re-fills in one
# cycle.  Concurrent confirm workers may duplicate a compute; dict ops
# are GIL-atomic and the value is identical, so races are harmless.

_TF_MEMO: Dict[tuple, bytes] = {}
_TF_MEMO_CAP = 1 << 15
_TF_MEMO_MAXLEN = 512


def transform_cached(tkey: tuple, transforms: List[str],
                     text: bytes) -> bytes:
    if len(text) > _TF_MEMO_MAXLEN:
        return apply_transforms(text, transforms)
    key = (tkey, text)
    v = _TF_MEMO.get(key)
    if v is None:
        v = apply_transforms(text, transforms)
        if len(_TF_MEMO) >= _TF_MEMO_CAP:
            _TF_MEMO.clear()
        _TF_MEMO[key] = v
    return v


def _atoi(text: bytes) -> int:
    """C atoi semantics (what ModSecurity's numeric operators use):
    optional sign + leading digits, anything else → 0."""
    m = re.match(rb"\s*([+-]?\d+)", text)
    return int(m.group(1)) if m else 0


def _parse_byte_ranges(arg: bytes) -> List[tuple]:
    """@validateByteRange argument: "32-126,9,10,13" → [(lo, hi), ...]."""
    ranges: List[tuple] = []
    for part in arg.split(b","):
        part = part.strip()
        if not part:
            continue
        try:
            if b"-" in part:
                lo, hi = part.split(b"-", 1)
                ranges.append((int(lo), int(hi)))
            else:
                v = int(part)
                ranges.append((v, v))
        except ValueError:
            continue
    return ranges


#: operators that compare a number (atoi both sides) — these and negated
#: operators may only consume EXACT per-variable values, never a whole
#: coarse stream blob (atoi of a headers
#: blob is 0, and "!@rx" on a blob fires on every request)
NUMERIC_OPS = frozenset(("eq", "ge", "gt", "le", "lt"))

#: scalar pseudo-streams the confirm stage can consume beyond the 4 scan
#: streams (Request.confirm_streams supplies them; absent keys degrade
#: per _values_for rules)
_SCALAR_BASES = {
    "REQUEST_URI": "uri",
    "REQUEST_URI_RAW": "uri",
    "REQUEST_BODY": "body",
    "REQUEST_METHOD": "method",
    "REQUEST_PROTOCOL": "protocol",
    "REQUEST_FILENAME": "filename",
    "REQUEST_BASENAME": "basename",
    "QUERY_STRING": "query",
    "RESPONSE_BODY": "resp_body",
    "RESPONSE_STATUS": "status",
    "REMOTE_ADDR": "remote_addr",
}

#: bases that only approximate to a coarse blob (REQUEST_LINE has no
#: method/protocol in the uri stream; XML:/JSON: selectors address
#: nodes we don't model): positive pattern ops get the blob superset,
#: negated/numeric ops abstain (marking these exact
#: made '!@rx ^(GET|POST)' on REQUEST_LINE fire on every request)
_BLOB_BASES = {
    "REQUEST_LINE": "uri",
    "XML": "body",
    "JSON": "body",
}

#: collection bases → (parser kind, which part of the k/v pair)
_COLLECTION_BASES = {
    "REQUEST_HEADERS": ("headers", "values"),
    "REQUEST_HEADERS_NAMES": ("headers", "names"),
    "REQUEST_COOKIES": ("cookies", "values"),
    "REQUEST_COOKIES_NAMES": ("cookies", "names"),
    "ARGS": ("args", "values"),          # ARGS_GET ∪ ARGS_POST
    "ARGS_NAMES": ("args", "names"),
    "ARGS_GET": ("queryargs", "values"),
    "ARGS_GET_NAMES": ("queryargs", "names"),
    "ARGS_POST": ("bodyargs", "values"),
    "ARGS_POST_NAMES": ("bodyargs", "names"),
    # FILES shares the parsed-body collection but NOT the exclusion
    # namespace: an "!ARGS:x" exclusion must never suppress an upload
    # rule's match on a field of the same name (
    # ModSecurity's ARGS exclusions don't touch FILES)
    "FILES": ("files", "values"),
    "FILES_NAMES": ("files", "names"),
    "RESPONSE_HEADERS": ("resp_headers", "values"),
    "RESPONSE_HEADERS_NAMES": ("resp_headers", "names"),
}


def parse_exclusion_token(tok: str):
    """"ARGS:password" → ("args", b"password") in the internal exclusion
    form (ctl:ruleRemoveTargetById plumbing — compiler/ruleset.py stores
    the raw token, the pipeline resolves it here once per install).
    Returns None for tokens that aren't collection subfields — a
    non-collection exclusion can't narrow per-variable iteration, so the
    confirm keeps its (sound, wider) evaluation."""
    tok = tok.strip().lstrip("!")
    base, sep, sel = tok.partition(":")
    cb = _COLLECTION_BASES.get(base.strip().upper())
    if cb and sep and sel.strip():
        # ARGS is the GET∪POST union: excluding ARGS:x must also reach
        # rules that iterate the GET/POST-specific collections
        kinds = (("args", "queryargs", "bodyargs") if cb[0] == "args"
                 else (cb[0],))
        return kinds, sel.strip().lower().encode()
    return None


def _looks_like_form(body: bytes) -> bool:
    """Heuristic for ARGS_POST when no content-type is available: a
    form-urlencoded body is k=v pairs with no raw control bytes.  A
    JSON/XML/binary body must NOT be k/v-split (mis-parsed pairs would
    feed wrong values to negated ops)."""
    if len(body) > 1 << 16 or b"=" not in body:
        return False
    head = body[:256]
    if head[:1] in (b"{", b"[", b"<") or head[:2] == b"--":
        return False
    return not any(c < 9 or (13 < c < 32) for c in head)


def _body_content_type(streams: Dict[str, bytes],
                       cache: Optional[Dict],
                       raw: bool = False) -> bytes:
    """Content-Type header value (b"" when absent).  ``raw=True`` keeps
    the original case — the multipart boundary token is case-sensitive,
    so the delimiter must come from the unlowered value."""
    for lo, _n, v in (_parse_collection("headers", streams, cache) or ()):
        if lo == b"content-type":
            return v if raw else v.lower()
    return b""


def _parse_body_form(streams: Dict[str, bytes], cache: Optional[Dict]):
    """Memoized multipart parse of the body stream (fields AND files
    come from the one walk); None = present-but-unparseable (abstain)."""
    ck = ("#mpform",)
    if cache is not None and ck in cache:
        return cache[ck]
    form = parse_multipart(streams.get("body", b""),
                           _body_content_type(streams, cache, raw=True))
    if cache is not None:
        cache[ck] = form
    return form


def _split_form(raw: bytes, decode: bool) -> List[tuple]:
    """Split k=v&k2=v2 into (name_lower, name, value).  Pair splitting
    happens on the RAW bytes FIRST, decoding each component after
    (ModSecurity order) — splitting an already-decoded blob would let a
    percent-encoded '&'/'=' inside a value fabricate variables that the
    evaluator then trusts as exact.  A valueless
    parameter ('?flag') is (flag, b'') like ModSecurity, not dropped."""
    out: List[tuple] = []
    for part in raw.split(b"&"):
        if not part:
            continue
        k, _sep, v = part.partition(b"=")
        if decode:
            k, v = url_decode_uni(k), url_decode_uni(v)
        k = k.strip()
        if k:
            out.append((k.lower(), k, v))
    return out


def _parse_collection(kind: str, streams: Dict[str, bytes],
                      cache: Optional[Dict]) -> Optional[List[tuple]]:
    """(name_lower, name, value) triples for one collection kind.

    Returns [] when the backing stream is ABSENT/EMPTY (a faithful empty
    collection — counts are exactly 0) and None when a PRESENT stream
    cannot be faithfully parsed (counts/negation must abstain, not
    report a fabricated 0).  Header units are
    "name: value" joined by \\x1f (serve/normalize.py streams())."""
    ck = ("#coll", kind)
    if cache is not None and ck in cache:
        return cache[ck]
    out: Optional[List[tuple]]
    if kind in ("headers", "resp_headers"):
        blob = streams.get(kind)
        out = []
        for unit in (blob.split(b"\x1f") if blob else ()):
            name, sep, val = unit.partition(b":")
            if not sep:
                continue
            name = name.strip()
            out.append((name.lower(), name, val.strip()))
    elif kind == "cookies":
        hdrs = _parse_collection("headers", streams, cache) or []
        out = []
        for lo, _name, val in hdrs:
            if lo != b"cookie":
                continue
            for part in val.split(b";"):
                k, _sep, v = part.partition(b"=")
                k = k.strip()
                if k:
                    out.append((k.lower(), k, v.strip()))
    elif kind == "queryargs":
        # prefer the RAW query (confirm_streams provides it); the
        # decoded args blob is a legacy fallback where encoded '&'/'='
        # can't be distinguished — still split-then-nothing, since the
        # blob is already decoded
        raw = streams.get("query")
        if raw is not None:
            out = _split_form(raw, decode=True)
        else:
            blob = streams.get("args")
            out = _split_form(blob, decode=False) if blob else []
    elif kind == "bodyargs":
        blob = streams.get("body")
        ct = _body_content_type(streams, cache)
        if not blob:
            out = []
        elif b"multipart/form-data" in ct:
            # RFC 7578 part parsing (serve/bodyparse.py): non-file
            # parts are ModSecurity's ARGS_POST; a malformed body
            # abstains rather than fabricate pairs
            form = _parse_body_form(streams, cache)
            out = None if form is None else [
                (n.lower(), n, v) for n, v in form.fields]
        elif b"json" in ct:
            # JSON processor (ModSecurity analog): dotted json.path
            # names feed ARGS_POST → the ARGS union.  The body stream
            # may carry unpack's extra \x1f-joined segments — the JSON
            # document is the base segment (valid JSON cannot contain
            # a raw 0x1f byte, so the split is exact).  Honors the
            # wallarm-parser-disable json bit like the unpack stage.
            if b"json" in streams.get("parsers_off", b""):
                out = []
            else:
                ent = flatten_json(blob.split(_UNPACK_SEP, 1)[0])
                out = None if ent is None else [
                    (n.lower(), n, v) for n, v in ent]
        elif (b"application/x-www-form-urlencoded" in ct
              or (not ct and _looks_like_form(blob))):
            # the body stream may carry unpack's decoded extra segment
            # (\x1f-joined, for double-encoding prefilter coverage) —
            # the FORM TEXT is the base segment; splitting the joined
            # blob would pollute the last pair's value with the decoded
            # copy, corrupting exact values for negated/numeric ops
            out = _split_form(blob.split(_UNPACK_SEP, 1)[0], decode=True)
        else:
            # non-form body: ModSecurity's ARGS_POST is empty here
            # (the XML processor feeds a different collection)
            out = []
    elif kind == "files":
        # multipart file parts only (ModSecurity: FILES values are the
        # client filenames, FILES_NAMES the field names); separate kind
        # from bodyargs so ARGS-family exclusions can't reach it (see
        # _COLLECTION_BASES note).  Non-multipart bodies faithfully
        # have an empty FILES collection.
        blob = streams.get("body")
        ct = _body_content_type(streams, cache)
        if blob and b"multipart/form-data" in ct:
            form = _parse_body_form(streams, cache)
            out = None if form is None else [
                (n.lower(), n, fn) for n, fn in form.files]
        else:
            out = []
    elif kind == "args":
        # ModSecurity's ARGS is ARGS_GET ∪ ARGS_POST (:
        # query-only counts fabricated '&ARGS @eq 0' hits on POSTs);
        # an abstaining body parse makes the whole union abstain
        q = _parse_collection("queryargs", streams, cache)
        b = _parse_collection("bodyargs", streams, cache)
        out = None if (q is None or b is None) else q + b
    else:
        out = None
    if cache is not None:
        cache[ck] = out
    return out


class ConfirmRule:
    """Compiled exact-evaluation closure for one rule (+ chain links).

    Non-scan operators (@eq family, @validateByteRange, ... — the CRS 920
    protocol-check shapes) are evaluated here exactly; such rules reach
    confirm on every applicable request via the rule_nfactors==0 path
    (compiler/ruleset.py), so nothing about them is approximate.

    Evaluation is PER VARIABLE:
    ``raw_targets`` carries the original SecLang variable tokens
    ("REQUEST_HEADERS:Content-Length", "&ARGS", "!ARGS:passwd"), and
    ``_values_for`` resolves each to the exact value list ModSecurity
    would build — subfield selection, counting form, exclusions.
    Negated and numeric operators only ever consume exact per-variable
    values; positive pattern operators may additionally fall back to the
    whole coarse stream (a sound superset — the same bytes the TPU
    scanner saw)."""

    def __init__(self, confirm: Dict):
        self.desc = confirm
        self.op: str = confirm["op"]
        self.transforms: List[str] = confirm.get("transforms", [])
        self.targets: List[str] = confirm.get("targets", ["args"])
        self.raw_targets: List[str] = confirm.get("raw_targets", [])
        self.fold: bool = confirm.get("fold", False)
        self.negate: bool = confirm.get("negate", False)
        self.rx: Optional["re.Pattern[bytes]"] = None
        self.words: List[bytes] = [
            w.encode() for w in confirm.get("words", [])]
        self.arg: bytes = confirm.get("arg", "").encode(
            "utf-8", "surrogateescape")
        self.compile_error: Optional[str] = None
        # quick-reject (docs/CONFIRM_PLANE.md): lowercased mandatory
        # literals derived from the pattern once per install; the
        # counters are telemetry-grade plain ints (concurrent confirm
        # workers may lose the odd increment — bounded noise in
        # observability, never in verdicts)
        self.qr_literals: Optional[Tuple[bytes, ...]] = None
        self.qr_caseless = False
        self.qr_skips = 0
        self.qr_evals = 0
        if self.op == "rx":
            flags = re.IGNORECASE if self.fold else 0
            try:
                self.rx = re.compile(self.arg, flags)
            except re.error as e:
                self.compile_error = str(e)
            if self.rx is not None:
                self.qr_literals = derive_quick_reject(
                    confirm.get("arg", ""), self.fold)
                if self.qr_literals is None and confirm.get("qr_relax"):
                    # profile-flagged expensive confirm (compile-time
                    # qr_relax, docs/RETUNE.md): retry with the literal
                    # length gate lowered — 2-byte mandatory literals
                    # are weak filters in general, but cheaper than the
                    # measured regex cost on these specific rules
                    self.qr_literals = derive_quick_reject(
                        confirm.get("arg", ""), self.fold, min_len=2)
                if self.qr_literals is not None:
                    # letter-free literals need no case fold of the
                    # haystack — the common "../", "<!--" shapes skip
                    # the per-value lower() entirely
                    self.qr_caseless = not any(
                        0x61 <= b <= 0x7A for lit in self.qr_literals
                        for b in lit)
        self.allowed_bytes: Optional[frozenset] = None
        self._vbr_delete: bytes = b""
        if self.op == "validateByteRange":
            allowed = set()
            for lo, hi in _parse_byte_ranges(self.arg):
                allowed.update(range(lo, hi + 1))
            self.allowed_bytes = frozenset(allowed) if allowed else None
            if self.allowed_bytes is not None:
                # delete-table for the C-level translate fast path in
                # _op_match (the set(text) form built a Python set per
                # value on an always-confirm op — measured hot)
                self._vbr_delete = bytes(sorted(
                    b for b in self.allowed_bytes if 0 <= b <= 255))
        self.chain = [ConfirmRule(c) for c in confirm.get("chain", [])]
        self._plan, self._exclusions = self._compile_targets()
        self._matched_spec = self._parse_matched_spec()
        # hot-path precomputation: the transform-chain key was rebuilt
        # as tuple(self.transforms) on EVERY _self_match call (measured
        # in the confirm-plane profile), and the rule-level quick-reject
        # keys its per-request haystack on (plan, chain) — rules sharing
        # a CRS target list + transform chain share one haystack build
        self._tkey = tuple(self.transforms)
        self._plan_sig = tuple(
            (count, base, sel) for count, base, sel in self._plan)
        # rule-level quick-reject eligibility (docs/CONFIRM_PLANE.md):
        # positive @rx with mandatory literals, no compiled target
        # exclusions (they narrow the value set per rule — the shared
        # haystack would over-include, which is sound for REJECT but
        # the bail keeps the logic obvious), and no count entries
        # (counts yield numbers, not scannable text)
        self._qr_rule_ok = (
            self.op == "rx" and self.rx is not None and not self.negate
            and self.qr_literals is not None and not self._exclusions
            and bool(self._plan)
            and all(not count for count, _b, _s in self._plan))

    def walk_chain(self):
        """This rule then every chain link, depth-first.  Chain links
        run ``_op_match`` (and so the quick-reject pre-check) too — the
        confirm-plane telemetry and the microbench toggle must cover
        them, not just the top-level rule."""
        yield self
        for link in self.chain:
            yield from link.walk_chain()

    def dead_reason(self) -> Optional[str]:
        """Why this rule can never fire at runtime, or None.

        The runtime twin of rulecheck's ``regex.confirm-unparsable``: a
        pattern Python ``re`` rejects makes ``_op_match`` abstain on
        every value, and a chain with such a link can never satisfy the
        all-links conjunction (a negated broken link abstains too — an
        abstain never counts as a hit).  Surfaced per candidate by the
        RuleStats confirm-error counter so a dead rule is visible
        within minutes of deploy, not at the next static audit."""
        if self.compile_error is not None:
            return "regex-unparsable: %s" % self.compile_error
        for link in self.chain:
            r = link.dead_reason()
            if r is not None:
                return "chain-link %s" % r
        return None

    def _compile_targets(self):
        """raw_targets → ([(count, BASE, selector_or_None)], exclusions).

        Falls back to a synthesized plan from the coarse stream names
        when raw_targets is absent (legacy serialized rulesets, sigpack
        rules): uri/body are true scalars (exact), args/headers yield
        only the blob (exact=False) — so legacy negated/numeric rules on
        collections ABSTAIN instead of mass-firing."""
        excl: Dict[str, set] = {}
        plan: List[tuple] = []
        for tok in self.raw_targets:
            t = tok.strip()
            if not t:
                continue
            if t.startswith("!"):
                parsed = parse_exclusion_token(t)
                if parsed is not None:
                    # same kinds expansion as the runtime ctl path: an
                    # "!ARGS:x" exclusion must also reach rules iterating
                    # the GET/POST-specific collections (:
                    # the two exclusion paths disagreed)
                    kinds, sel = parsed
                    for kind in kinds:
                        excl.setdefault(kind, set()).add(sel)
                continue
            count = t.startswith("&")
            if count:
                t = t[1:].strip()
            base, sep, sel = t.partition(":")
            plan.append((count, base.strip().upper(),
                         sel.strip().lower().encode() if sep else None))
        if not plan:
            # Legacy descriptors lost any subfield selector, so the
            # collection streams may NOT be per-value iterated (a rule
            # originally written against one header would fire on all of
            # them): collections yield only the blob (exact=False);
            # uri/body are true scalars.
            legacy = {"uri": (False, "REQUEST_URI", None),
                      "body": (False, "REQUEST_BODY", None),
                      "args": (False, "#BLOB", b"args"),
                      "headers": (False, "#BLOB", b"headers")}
            plan = [legacy[s] for s in self.targets if s in legacy]
        return plan, excl

    def _iter_entry(self, entry, streams: Dict[str, bytes],
                    cache: Optional[Dict],
                    extra_excl: Optional[Dict] = None):
        """Yield (text, exact, is_count, label) for one plan entry.

        label: the collection item's name (bytes) when iterating an
        UNSELECTED collection (so a hit can be attributed 'ARGS:q', not
        just 'ARGS'); None otherwise.

        exact=True: the text is one variable's value, exactly as
        ModSecurity would expose it (negation/numerics may consume it).
        exact=False: the text is the whole coarse stream blob — a sound
        superset for positive pattern operators only.

        ``extra_excl`` ({collection_kind: {selector, ...}}): request-time
        target exclusions from a matched ctl:ruleRemoveTargetById rule,
        merged with the rule's own compiled !VAR:x exclusions."""
        count, base, sel = entry
        if base == "#BLOB":   # legacy collection: whole stream, non-exact
            blob = streams.get(sel.decode())
            if blob:
                yield blob, False, False, None
            return
        cb = _COLLECTION_BASES.get(base)
        if cb is not None:
            kind, part = cb
            coll = _parse_collection(kind, streams, cache)
            if coll is None:
                # present but unparseable (e.g. a non-form body for
                # ARGS_POST): counts/negation abstain — a fabricated
                # exact 0 would false-fire "@eq 0" rules (# finding); positive pattern ops keep the blob superset
                if not count and sel is None:
                    # "files" is deliberately ABSENT: a FILES rule's
                    # bare extension pattern against the raw body blob
                    # fired on benign text ("run setup.sh after
                    # install") in any truncated multipart (# finding) — the context-anchored REQUEST_BODY twin
                    # rules (922131) own the malformed-framing case
                    coarse = {"headers": "headers", "cookies": "headers",
                              "args": "args", "queryargs": "args",
                              "bodyargs": "body",
                              "resp_headers": "resp_headers"}.get(kind)
                    blob = streams.get(coarse) if coarse else None
                    if blob:
                        yield blob, False, False, None
                return
            exd = self._exclusions.get(kind, set())
            if extra_excl:
                exd = exd | extra_excl.get(kind, set())
            if sel is not None:
                if sel in exd:
                    return   # the named subfield itself is excluded
                vals = [(None, n if part == "names" else v)
                        for lo, n, v in coll if lo == sel]
            else:
                # keep the item's ORIGINAL-CASE name so a hit can be
                # attributed to the specific variable ('ARGS:q',
                # 'REQUEST_HEADERS:X-Api-Key') in the attack export,
                # mirroring MATCHED_VAR_NAME's casing
                vals = [(n, n if part == "names" else v)
                        for lo, n, v in coll if lo not in exd]
            if count:
                yield str(len(vals)).encode(), True, True, None
            else:
                for name, v in vals:
                    yield v, True, False, name
            return
        blob_stream = _BLOB_BASES.get(base)
        if blob_stream is not None:
            if not count:
                blob = streams.get(blob_stream)
                if blob:
                    yield blob, False, False, None
            return  # counts on blob-approximated bases abstain
        stream = _SCALAR_BASES.get(base)
        if stream is None:
            return  # unknown base: abstain
        if base == "REQUEST_BODY":
            # ModSecurity: the multipart processor REPLACES the raw body
            # — REQUEST_BODY is not populated on a parsed multipart POST
            # (parts feed ARGS_POST/FILES instead).  Without this, every
            # multipart body confirms 942170-shaped rules (it ends in
            # "--boundary--") and every upload with a part Content-Type
            # confirms 921120 response-splitting (a header-shaped line
            # after CRLF) — observed blocking a benign file upload.  A
            # MALFORMED multipart keeps the blob (None → fall through):
            # framing desync must not blind raw-body rules.
            ct = _body_content_type(streams, cache)
            if (b"multipart/form-data" in ct
                    and _parse_body_form(streams, cache) is not None):
                return
        val = streams.get(stream)
        if val is None and stream in ("query", "filename", "basename"):
            # derivable from the raw uri when the caller passed only the
            # 4 scan streams (legacy callers / tests)
            uri = streams.get("uri", b"")
            q = uri.find(b"?")
            path = uri if q < 0 else uri[:q]
            val = {"query": b"" if q < 0 else uri[q + 1:],
                   "filename": path,
                   "basename": path.rsplit(b"/", 1)[-1]}[stream]
        if val is None:
            if stream in ("method", "protocol") and not count:
                # not derivable from the scan streams: positive ops keep
                # the historical whole-uri superset, negation abstains
                blob = streams.get("uri")
                if blob:
                    yield blob, False, False, None
            return
        if count:
            yield (b"1" if val else b"0"), True, True, None
        elif val:
            yield val, True, False, None

    def _op_match(self, text: bytes,
                  cache: Optional[Dict] = None) -> Optional[bool]:
        """Tri-state: True/False = evaluated; None = ABSTAIN (cannot
        evaluate: macro argument, unsupported operator, broken regex).
        The distinction is load-bearing for negation — a blind boolean
        would turn every abstain into an always-fire under "!@op".

        ``cache`` is the per-request memo (the same dict the transform
        layer uses): the quick-reject's lowercased haystack is keyed on
        the value object there, so one request's uri/blob lowers ONCE
        across every case-folded rule instead of once per rule (the
        first cut lowered per (rule, value) and was a measured
        regression)."""
        if self.op == "rx":
            if self.rx is None:
                return None   # unmatchable pattern: abstain
            lits = self.qr_literals
            if lits is not None:
                # mandatory-literal quick-reject: no literal in the
                # exact text the regex would search ⇒ the regex cannot
                # match — an EXACT False, so negation composes as usual
                if self.qr_caseless:
                    hay = text
                elif cache is None:
                    hay = text.lower()
                else:
                    # bytes keys cannot collide with the cache's other
                    # (tuple) key families; transform memoization hands
                    # every rule the SAME value object, so the bytes
                    # hash is computed once and reused
                    hay = cache.get(text)
                    if hay is None:
                        hay = text.lower()
                        cache[text] = hay
                for lit in lits:
                    if lit in hay:
                        break
                else:
                    self.qr_skips += 1  # concheck: ok telemetry-grade counter race between confirm workers
                    return False
                self.qr_evals += 1  # concheck: ok telemetry-grade, same as qr_skips
            return self.rx.search(text) is not None
        if self.op == "pm":
            low = text.lower()
            return any(w.lower() in low for w in self.words)
        arg = self.arg.lower() if self.fold else self.arg
        t = text.lower() if self.fold else text
        if self.op in ("contains", "containsWord"):
            return arg in t
        if self.op == "streq":
            return t == arg
        if self.op == "beginsWith":
            return t.startswith(arg)
        if self.op == "endsWith":
            return t.endswith(arg)
        if self.op == "within":
            return t in arg
        if self.op == "detectSQLi":
            from ingress_plus_tpu_torch.models.libdetect import detect_sqli
            return detect_sqli(text)
        if self.op == "detectXSS":
            from ingress_plus_tpu_torch.models.libdetect import detect_xss
            return detect_xss(text)
        if self.op in ("eq", "ge", "gt", "le", "lt"):
            # ModSecurity numeric compare with atoi semantics (leading
            # integer, else 0) on both sides; macro arguments (%{...})
            # can't resolve here → abstain
            if self.arg[:2] == b"%{":
                return None
            val, ref = _atoi(text), _atoi(self.arg)
            return {"eq": val == ref, "ge": val >= ref, "gt": val > ref,
                    "le": val <= ref, "lt": val < ref}[self.op]
        if self.op == "validateByteRange":
            # fires when any byte falls OUTSIDE the allowed ranges;
            # translate-with-delete keeps the whole scan in C with no
            # per-value set build — this runs on the always-confirm
            # path for every request with a body
            if self.allowed_bytes is None:
                return None
            return bool(text.translate(None, self._vbr_delete))
        if self.op == "validateUrlEncoding":
            # fires on '%' not followed by two hex digits
            return re.search(rb"%(?![0-9a-fA-F]{2})", text) is not None
        if self.op == "validateUtf8Encoding":
            try:
                text.decode("utf-8")
                return False
            except UnicodeDecodeError:
                return True
        if self.op == "unconditionalMatch":
            return True
        if self.op == "noMatch":
            return False
        if self.op == "ipMatch":
            # IP/CIDR list in the rule argument (CRS REMOTE_ADDR rules);
            # the list parses once, the per-request test is O(nets).
            # Unparseable text (a blob, not an address) abstains.
            nets = self._ip_nets()
            if nets is None:
                return None
            import ipaddress
            try:
                ip = ipaddress.ip_address(text.decode("ascii").strip())
            except ValueError:
                return None
            return any(ip in n for n in nets)
        # unsupported operator (@rbl, @geoLookup, @ipMatchFromFile, ...
        # — need external state we don't model): abstain — never match,
        # never block, regardless of negation
        return None

    def _ip_nets(self):
        """Parse @ipMatch's comma-separated IP/CIDR argument once; a
        fully-invalid list yields None (operator abstains)."""
        nets = getattr(self, "_ip_nets_cache", False)
        if nets is not False:
            return nets
        import ipaddress
        parsed = []
        for part in self.arg.decode("ascii", "replace").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                parsed.append(ipaddress.ip_network(part, strict=False))
            except ValueError:
                # ANY malformed entry poisons the whole list → abstain:
                # silently narrowing the list would under-match positive
                # rules and OVER-FIRE negated ones (ModSecurity rejects
                # the config outright; abstain is our fail-safe analog)
                parsed = None
                break
        # concheck: ok idempotent lazy-init cache — racers compute identical values, last write wins
        self._ip_nets_cache = parsed or None
        return self._ip_nets_cache


    def _entry_name(self, entry, label=None) -> str:
        """Human/export name of a plan entry: 'ARGS:q', 'REQUEST_BODY'…
        (the wallarm attack-export 'point' analog).  ``label`` (bytes):
        the matched item's own name when the entry iterated a whole
        collection — refines 'ARGS' to 'ARGS:q'."""
        count, base, sel = entry
        if sel is None and label:
            sel = label
        name = base.decode() if isinstance(base, bytes) else str(base)
        if name == "#BLOB":
            # legacy whole-stream entries: export the stream's SecLang
            # name, not the internal sentinel
            s = sel.decode("latin-1") if isinstance(sel, bytes) else str(sel)
            return {"args": "ARGS", "headers": "REQUEST_HEADERS",
                    "body": "REQUEST_BODY", "uri": "REQUEST_URI",
                    "resp_headers": "RESPONSE_HEADERS",
                    "resp_body": "RESPONSE_BODY"}.get(s, s.upper())
        if sel is not None:
            s = sel.decode("latin-1") if isinstance(sel, bytes) else str(sel)
            name = "%s:%s" % (name, s)
        return ("&" + name) if count else name

    def _entry_vals(self, entry, streams: Dict[str, bytes],
                    cache: Dict) -> list:
        """Materialized post-transform value list for one plan entry —
        ``[(val, exact, is_count, label), ...]`` in ``_iter_entry``
        order — cached per (entry, transform chain) in the REQUEST
        cache.  CRS rules cluster heavily on (target list, transform
        chain), so a request's ~60+ candidate walks share a handful of
        builds instead of re-iterating the generator and re-keying the
        per-value transform memo once per rule (measured: the iteration
        machinery, not ``re``, dominated confirm cost).  Only valid for
        exclusion-free evaluation — callers with compiled or ctl
        exclusions take the generator path."""
        key = ("#vals", entry, self._tkey)
        vals = cache.get(key)
        if vals is None:
            # one copy of the per-value transform dispatch: the cached
            # form is exactly the generator's output, materialized
            vals = list(self._transformed_iter(entry, streams, cache,
                                               None))
            cache[key] = vals
        return vals

    def _transformed_iter(self, entry, streams: Dict[str, bytes],
                          cache: Optional[Dict],
                          extra_excl: Optional[Dict]):
        """Generator twin of :meth:`_entry_vals` for evaluations the
        shared cache cannot serve — compiled ``!VAR:x`` exclusions,
        runtime ctl target exclusions, or cache-less library callers —
        yielding the same ``(val, exact, is_count, label)`` shape."""
        tkey = self._tkey
        for text, exact, is_count, label in self._iter_entry(
                entry, streams, cache, extra_excl):
            if is_count:
                val = text   # counts are numbers; transforms don't apply
            elif len(text) <= _TF_MEMO_MAXLEN:
                val = transform_cached(tkey, self.transforms, text)
            elif cache is None:
                val = apply_transforms(text, self.transforms)
            else:
                key = (tkey, text)
                val = cache.get(key)
                if val is None:
                    val = apply_transforms(text, self.transforms)
                    cache[key] = val
            yield val, exact, is_count, label

    def _build_qr_hay(self, streams: Dict[str, bytes],
                      cache: Dict) -> bytes:
        """Build (and cache) the whole-rule quick-reject haystack for
        this rule's (plan, chain) combo — the batched form of the
        per-value literal pre-check, consumed by the confirm plane's
        walk (models/confirm_plane.py confirm_one, where the literal
        scan itself is inlined; docs/CONFIRM_PLANE.md): every text
        ``_self_match`` would feed the regex, post-transform,
        separator-joined and LOWERED once.  Built at most once per
        request per (target plan, transform chain) — CRS rules cluster
        heavily on both, so a request's ~60+ candidates share a
        handful of builds through the request cache.  If no mandatory
        literal occurs in the haystack, no value can contain one
        (value ⊆ concat), every per-value check would return the exact
        False, and the rule's own match fails — chain links never
        evaluate, detail stays empty, so a reject is bit-identical to
        the full walk.  Lowered containment is exact for letter-free
        literals and sound for folded ones.  Only valid for
        ``_qr_rule_ok`` rules with no per-request ctl exclusions
        (exclusions shrink the value set; the shared haystack would
        over-include — sound for a REJECT, but the caller bails to
        keep the reasoning local)."""
        parts: List[bytes] = []
        for entry in self._plan:
            parts.extend(v for v, _e, _c, _l in
                         self._entry_vals(entry, streams, cache))
        hay = b"\x00".join(parts).lower()
        cache[("#qrh", self._plan_sig, self._tkey)] = hay
        return hay

    def matches_streams(self, streams: Dict[str, bytes],
                        cache: Optional[Dict] = None,
                        extra_excl: Optional[Dict] = None,
                        detail_out: Optional[list] = None) -> bool:
        """Evaluate against raw streams (applies own transforms).

        Negated operators ("!@op") invert per VARIABLE VALUE, mirroring
        ModSecurity: a variable matches when the operator does not;
        absent variables don't evaluate at all.  Negated and numeric
        operators refuse non-exact (whole-blob) values — they abstain
        rather than invert/atoi a concatenated stream.

        ``cache`` (per-request dict) memoizes parsed collections and
        transformed text across rules — many rules share a transform
        chain, and the prefilter-loss gate evaluates EVERY rule per
        request, where the cache turns O(rules × transforms) into
        O(distinct chains × distinct values)."""
        collect = any(link._matched_spec for link in self.chain)
        hit, cur = self._self_match(streams, cache, extra_excl,
                                    detail_out, collect)
        if not hit:
            return False
        # chain: sequential, ModSecurity-style — every link must match,
        # and each NORMAL link updates the matched-variable state that
        # later links' MATCHED_* targets consume (each rule in a ModSec
        # chain overwrites MATCHED_VARS with its own matches)
        for i, link in enumerate(self.chain):
            if link._matched_spec:
                cur = link._eval_matched(cur)
                if cur is None:
                    return False
                # the link's own matching SUBSET becomes the state its
                # successors see (ModSecurity overwrites MATCHED_VARS
                # with each rule's matches)
            else:
                need_next = any(l2._matched_spec
                                for l2 in self.chain[i + 1:])
                lh, lmv = link._self_match(streams, cache, extra_excl,
                                           None, need_next)
                if not lh:
                    return False
                if need_next:
                    cur = lmv
        return True

    def _self_match(self, streams: Dict[str, bytes],
                    cache: Optional[Dict],
                    extra_excl: Optional[Dict],
                    detail_out: Optional[list],
                    collect: bool):
        """THIS rule's own targets/operator only — no chain.

        Returns ``(hit, matched)``; ``matched`` is the [(name, value)]
        list of every EXACT matching variable when ``collect`` (the
        MATCHED_* chain state).  Blob fallbacks and counts never enter
        the list: a coarse stream blob is not a variable, and feeding it
        to a negated/numeric MATCHED_VAR link would bypass the
        exact-values-only restriction this method enforces for those
        operators on its own targets."""
        hit = False
        restrict = self.negate or self.op in NUMERIC_OPS
        matched: list = []
        # exclusion-free evaluation (the overwhelmingly common case)
        # iterates the request-cached post-transform value lists —
        # shared across every rule with the same (target entry,
        # transform chain); exclusions change the value SET per rule,
        # so those rules keep the per-rule generator path
        fast = cache is not None and not self._exclusions \
            and not extra_excl
        tkey = self._tkey
        for entry in self._plan:
            if fast:
                viter = cache.get(("#vals", entry, tkey))
                if viter is None:
                    viter = self._entry_vals(entry, streams, cache)
            else:
                viter = self._transformed_iter(entry, streams, cache,
                                               extra_excl)
            for val, exact, is_count, label in viter:
                if restrict and not exact:
                    continue  # abstain: blob values can't drive negation
                m = self._op_match(val, cache)
                if m is None:
                    continue   # abstain survives negation: never a hit
                if m != self.negate:
                    hit = True
                    if detail_out is not None:
                        # matched point for the attack export: variable
                        # name + bounded post-transform snippet (raw
                        # bodies stay out of the queue — see post.Hit)
                        snip = val if isinstance(val, bytes) else \
                            str(val).encode()
                        detail_out.append(
                            (self._entry_name(entry, label),
                             snip[:100].decode("latin-1")))
                    if collect:
                        if exact and not is_count:
                            matched.append(
                                (self._entry_name(entry, label),
                                 val if isinstance(val, bytes)
                                 else str(val).encode()))
                        continue   # keep scanning for further matches
                    break
            if hit and not collect:
                break
        return hit, matched

    #: chain-link pseudo-targets resolved against the tracked matches
    _MATCHED_BASES = {"MATCHED_VAR": ("one", "values"),
                      "MATCHED_VARS": ("all", "values"),
                      "MATCHED_VAR_NAME": ("one", "names"),
                      "MATCHED_VARS_NAMES": ("all", "names")}

    def _parse_matched_spec(self):
        """Precomputed at construction: list of (scope, part, is_count)
        — one per raw target token — when EVERY token is a MATCHED_*
        pseudo-variable (the CRS chain-link shape); None otherwise.
        '!'-excluded tokens are unsupported → None (normal evaluation,
        which abstains on empty targets)."""
        if not self.raw_targets:
            return None
        specs = []
        for t in self.raw_targets:
            t = t.strip()
            if not t:
                continue
            if t.startswith("!"):
                return None
            is_count = t.startswith("&")
            if is_count:
                t = t[1:].strip()
            sp = self._MATCHED_BASES.get(t.split(":", 1)[0].upper())
            if sp is None:
                return None
            specs.append((sp[0], sp[1], is_count))
        return specs or None

    def _eval_matched(self, matched_vals):
        """Evaluate this chain link against the tracked matched
        (name, value) pairs — OR over its target tokens (ModSecurity
        target-list semantics): MATCHED_VAR = the LAST match only,
        MATCHED_VARS = all; *_NAME(S) compare variable names; the
        &-count form compares the match COUNT (transforms don't apply
        to counts).  Own transforms apply to value/name candidates;
        negation is per candidate (every candidate exact by
        construction — _self_match only collects exact variables).

        Returns the SUBSET of ``matched_vals`` this link matched (the
        state its chain successors see — ModSecurity overwrites
        MATCHED_VARS with each rule's own matches), or None on no
        match.  A count-token hit keeps its candidate set unchanged
        (the match is the count, not any particular variable)."""
        out: list = []
        hit = False
        for scope, part, is_count in self._matched_spec:
            cands = matched_vals[-1:] if scope == "one" else matched_vals
            if is_count:
                m = self._op_match(str(len(cands)).encode())
                if m is not None and m != self.negate:
                    hit = True
                    for c in cands:
                        if c not in out:
                            out.append(c)
                continue
            for name, val in cands:
                cand = (name.encode("latin-1", "replace")
                        if part == "names" else val)
                v = apply_transforms(cand, self.transforms)
                m = self._op_match(v)
                if m is None:
                    continue
                if m != self.negate:
                    hit = True
                    if (name, val) not in out:
                        out.append((name, val))
        return out if hit else None
