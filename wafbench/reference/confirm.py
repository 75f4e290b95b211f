"""Exact confirm stage of the reference: the rule semantics of the
port's ``models/confirm.py`` (targets, transforms, operators, chains),
with the Python SQLi/XSS detectors, and none of its shortcuts: no
quick-reject literals, no cross-request transform memo, no cached value
lists, no per-request memo: each candidate rule parses and transforms
its own values.  The original module's docstring follows.

Exact CPU confirm stage.

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
from typing import Callable, Dict, List, Optional

from wafbench.reference.bodyparse import flatten_json, parse_multipart
from wafbench.reference.normalize import (
    html_entity_decode,
    url_decode_uni,
)
from wafbench.reference.unpack import SEP as _UNPACK_SEP

_WS = b" \t\n\r\f\v"

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


def _body_content_type(streams: Dict[str, bytes], raw: bool = False) -> bytes:
    """Content-Type header value (b"" when absent).  ``raw=True`` keeps
    the original case — the multipart boundary token is case-sensitive,
    so the delimiter must come from the unlowered value."""
    for lo, _n, v in (_parse_collection("headers", streams) or ()):
        if lo == b"content-type":
            return v if raw else v.lower()
    return b""


def _parse_body_form(streams: Dict[str, bytes]):
    """Multipart parse of the body stream (fields AND files come from
    the one walk); None = present-but-unparseable (abstain)."""
    return parse_multipart(streams.get("body", b""),
                           _body_content_type(streams, raw=True))


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


def _parse_collection(kind: str,
                      streams: Dict[str, bytes]) -> Optional[List[tuple]]:
    """(name_lower, name, value) triples for one collection kind.

    Returns [] when the backing stream is ABSENT/EMPTY (a faithful empty
    collection — counts are exactly 0) and None when a PRESENT stream
    cannot be faithfully parsed (counts/negation must abstain, not
    report a fabricated 0).  Header units are
    "name: value" joined by \\x1f (serve/normalize.py streams())."""
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
        hdrs = _parse_collection("headers", streams) or []
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
        ct = _body_content_type(streams)
        if not blob:
            out = []
        elif b"multipart/form-data" in ct:
            # RFC 7578 part parsing (serve/bodyparse.py): non-file
            # parts are ModSecurity's ARGS_POST; a malformed body
            # abstains rather than fabricate pairs
            form = _parse_body_form(streams)
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
        ct = _body_content_type(streams)
        if blob and b"multipart/form-data" in ct:
            form = _parse_body_form(streams)
            out = None if form is None else [
                (n.lower(), n, fn) for n, fn in form.files]
        else:
            out = []
    elif kind == "args":
        # ModSecurity's ARGS is ARGS_GET ∪ ARGS_POST (:
        # query-only counts fabricated '&ARGS @eq 0' hits on POSTs);
        # an abstaining body parse makes the whole union abstain
        q = _parse_collection("queryargs", streams)
        b = _parse_collection("bodyargs", streams)
        out = None if (q is None or b is None) else q + b
    else:
        out = None
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
        if self.op == "rx":
            flags = re.IGNORECASE if self.fold else 0
            try:
                self.rx = re.compile(self.arg, flags)
            except re.error as e:
                self.compile_error = str(e)
        self.allowed_bytes: Optional[frozenset] = None
        self._vbr_delete: bytes = b""
        if self.op == "validateByteRange":
            allowed = set()
            for lo, hi in _parse_byte_ranges(self.arg):
                allowed.update(range(lo, hi + 1))
            self.allowed_bytes = frozenset(allowed) if allowed else None
            if self.allowed_bytes is not None:
                # the allowed bytes, deleted by translate in _op_match
                self._vbr_delete = bytes(sorted(
                    b for b in self.allowed_bytes if 0 <= b <= 255))
        self.chain = [ConfirmRule(c) for c in confirm.get("chain", [])]
        self._plan, self._exclusions = self._compile_targets()
        self._matched_spec = self._parse_matched_spec()
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

    def _iter_entry(self, entry, streams: Dict[str, bytes]):
        """Yield (text, exact, is_count, label) for one plan entry.

        label: the collection item's name (bytes) when iterating an
        UNSELECTED collection (so a hit can be attributed 'ARGS:q', not
        just 'ARGS'); None otherwise.

        exact=True: the text is one variable's value, exactly as
        ModSecurity would expose it (negation/numerics may consume it).
        exact=False: the text is the whole coarse stream blob — a sound
        superset for positive pattern operators only."""
        count, base, sel = entry
        if base == "#BLOB":   # legacy collection: whole stream, non-exact
            blob = streams.get(sel.decode())
            if blob:
                yield blob, False, False, None
            return
        cb = _COLLECTION_BASES.get(base)
        if cb is not None:
            kind, part = cb
            coll = _parse_collection(kind, streams)
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
            ct = _body_content_type(streams)
            if (b"multipart/form-data" in ct
                    and _parse_body_form(streams) is not None):
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

    def _op_match(self, text: bytes) -> Optional[bool]:
        """Tri-state: True/False = evaluated; None = ABSTAIN (cannot
        evaluate: macro argument, unsupported operator, broken regex).
        The distinction is load-bearing for negation — a blind boolean
        would turn every abstain into an always-fire under "!@op"."""
        if self.op == "rx":
            if self.rx is None:
                return None   # unmatchable pattern: abstain
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
            from wafbench.reference.detect import detect_sqli_py as detect_sqli
            return detect_sqli(text)
        if self.op == "detectXSS":
            from wafbench.reference.detect import detect_xss_py as detect_xss
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
            # fires when any byte falls OUTSIDE the allowed ranges: a
            # byte is left once the allowed ones are deleted
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

    def _values(self, entry, streams: Dict[str, bytes]):
        """``(val, exact, is_count, label)`` for one plan entry: each
        text of :meth:`_iter_entry` through this rule's transform chain
        (counts are numbers, which transforms leave alone)."""
        for text, exact, is_count, label in self._iter_entry(entry,
                                                             streams):
            if not is_count:
                text = apply_transforms(text, self.transforms)
            yield text, exact, is_count, label

    def matches_streams(self, streams: Dict[str, bytes]) -> bool:
        """Evaluate against raw streams (applies own transforms).

        Negated operators ("!@op") invert per VARIABLE VALUE, mirroring
        ModSecurity: a variable matches when the operator does not;
        absent variables don't evaluate at all.  Negated and numeric
        operators refuse non-exact (whole-blob) values — they abstain
        rather than invert/atoi a concatenated stream."""
        collect = any(link._matched_spec for link in self.chain)
        hit, cur = self._self_match(streams, collect)
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
            else:
                need_next = any(l2._matched_spec
                                for l2 in self.chain[i + 1:])
                lh, lmv = link._self_match(streams, need_next)
                if not lh:
                    return False
                if need_next:
                    cur = lmv
        return True

    def _self_match(self, streams: Dict[str, bytes], collect: bool):
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
        for entry in self._plan:
            for val, exact, is_count, label in self._values(entry, streams):
                if restrict and not exact:
                    continue  # abstain: blob values can't drive negation
                m = self._op_match(val)
                if m is None:
                    continue   # abstain survives negation: never a hit
                if m != self.negate:
                    hit = True
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
