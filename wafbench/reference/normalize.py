"""Frozen copy of the port's ``serve/normalize.py`` (imports point at the reference).
Its original docstring follows.

Stream extraction + normalization variants.

The reference's wallarm module parses/decodes requests in-process (URL,
JSON, XML, base64, gzip unpack — SURVEY.md §3.3 step "parse request →
decode/unpack").  Here the equivalent: an HTTP request becomes up to
4 streams × 5 variants of byte rows for the scanner; variant semantics
match compiler/ruleset.py's soundness contract exactly:

    0 raw         — as received
    1 urldec      — urlDecodeUni + removeNulls
    2 urldec_html — urldec + htmlEntityDecode
    3 squash_raw  — raw minus SQUASH_BYTES
    4 squash_dec  — urldec_html minus SQUASH_BYTES

Variant rows that equal their parent variant (no %xx present, no entities,
no squashable bytes) are deduplicated — benign traffic mostly scans 1 row
per stream.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from wafbench.reference.consts import SQUASH_BYTES, VARIANTS
from wafbench.reference.consts import STREAMS, STREAM_INDEX
from wafbench.reference.unpack import unpack_body

_HEX = {ord(c): i for i, c in enumerate("0123456789abcdef")}
for i, c in enumerate("ABCDEF"):
    _HEX[ord(c)] = 10 + i

_NAMED_ENTITIES = {
    b"lt": b"<", b"gt": b">", b"amp": b"&", b"quot": b'"', b"apos": b"'",
    b"nbsp": b" ", b"sol": b"/", b"bsol": b"\\", b"colon": b":",
    b"semi": b";", b"equals": b"=", b"lpar": b"(", b"rpar": b")",
}

def url_decode_uni(data: bytes) -> bytes:
    """%XX and %uXXXX decoding (one pass, invalid sequences left intact),
    plus '+' → space, plus overlong-UTF-8 folding.  Mirrors ModSecurity
    urlDecodeUni (+t:utf8toUnicode) closely enough for the scan variant;
    the confirm stage uses this same function."""
    return fold_overlong_utf8(url_decode_uni_raw(data))


def url_decode_uni_raw(data: bytes) -> bytes:
    """The decode loop WITHOUT overlong folding — the streaming variant
    decoder (serve/stream.py IncrementalVariant) needs the two stages
    separate so an overlong pair split across chunks can be held and
    folded when its continuation byte arrives.

    Fast-pathed (the profile's #1 host-prep cost, code-drift
    satellite): '+' folds via one C-level replace, %-free rows return
    unchanged after one C-level scan, and rows WITH escapes process
    per-%-segment instead of per byte.  '+' inside a %-escape needs no
    special order: decoded bytes were never re-scanned for '+' in the
    byte loop either ("%2B" decodes to a literal '+'), and a '+' in an
    escape's hex positions makes it invalid in both forms."""
    if 0x2B in data:  # +
        data = data.replace(b"+", b" ")
    if 0x25 not in data:  # %
        return data
    parts = data.split(b"%")
    out = bytearray(parts[0])
    for p in parts[1:]:
        # p is everything after one '%' up to the next '%'
        if len(p) >= 5 and p[0] in (0x75, 0x55):  # %uXXXX
            hx = [_HEX.get(p[1 + k]) for k in range(4)]
            if all(h is not None for h in hx):
                code = (hx[0] << 12) | (hx[1] << 8) | (hx[2] << 4) | hx[3]
                out.append(code & 0xFF if code > 0xFF else code)
                out += p[5:]
                continue
        if len(p) >= 2:  # %XX
            h1, h2 = _HEX.get(p[0]), _HEX.get(p[1])
            if h1 is not None and h2 is not None:
                out.append((h1 << 4) | h2)
                out += p[2:]
                continue
        out.append(0x25)  # invalid escape: '%' left intact
        out += p
    return bytes(out)


def fold_overlong_utf8(data: bytes) -> bytes:
    """Fold OVERLONG UTF-8 encodings of ASCII to their codepoint.

    The classic IIS/PHP-era evasion encodes ``'`` as C0 A7 (2-byte
    overlong) or E0 80 A7 (3-byte): lenient decoders map it back to the
    metacharacter while strict scanners see opaque high bytes.  Folding
    here — inside the shared urldec step — makes the *payload* rules see
    the real metacharacter on scan AND confirm identically (the
    ModSecurity analog is t:utf8toUnicode plus 920250's
    @validateUtf8Encoding flag).  VALID multi-byte UTF-8 (C2..DF lead)
    is untouched: only overlong forms (C0/C1 lead; E0 80-9F lead pair)
    are folded, so legitimate international text survives byte-exact.
    """
    # fast path (hot: every url-decoded stream passes here) — three
    # C-level membership scans, no Python byte loop
    if 0xC0 not in data and 0xC1 not in data and 0xE0 not in data:
        return data
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        b = data[i]
        if b in (0xC0, 0xC1) and i + 1 < n and 0x80 <= data[i + 1] <= 0xBF:
            out.append(((b & 0x1F) << 6) | (data[i + 1] & 0x3F))
            i += 2
            continue
        if (b == 0xE0 and i + 2 < n and 0x80 <= data[i + 1] <= 0x9F
                and 0x80 <= data[i + 2] <= 0xBF):
            code = ((b & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6) \
                | (data[i + 2] & 0x3F)
            if code < 0x100:
                # overlong encoding of a byte-sized codepoint: fold.
                # Larger codepoints (U+0100-U+07FF) are NOT folded —
                # truncating them to a low byte would *invent*
                # metacharacters the input never encoded.
                out.append(code)
                i += 3
                continue
        out.append(b)
        i += 1
    return bytes(out)


def html_entity_decode(data: bytes) -> bytes:
    """&#NN; / &#xHH; / common named entities (one pass).

    Split-based (host-prep): every ARGS row contains '&' as
    the query separator, so the old per-byte Python walk ran on
    essentially all query traffic — now rows without a ';' return
    unchanged after two C-level scans, and rows with escapes process
    per-'&'-segment.  Semantics identical to the byte loop: an entity
    is a ';' within 9 bytes after the '&'; a failed parse keeps the
    literal '&' and the segment is emitted as-is (each '&' starts its
    own segment, so nothing needs rescanning)."""
    if 0x26 not in data or 0x3B not in data:  # & and ; both required
        return data
    parts = data.split(b"&")
    out = bytearray(parts[0])
    for p in parts[1:]:
        j = p.find(b";", 0, 9)
        if j > 0:
            body = p[:j]
            if body[:1] == b"#":
                num = body[1:]
                try:
                    code = (int(num[1:], 16) if num[:1] in (b"x", b"X")
                            else int(num))
                    out.append(code & 0xFF)
                    out += p[j + 1:]
                    continue
                except ValueError:
                    pass
            elif body.lower() in _NAMED_ENTITIES:
                out += _NAMED_ENTITIES[body.lower()]
                out += p[j + 1:]
                continue
        out.append(0x26)
        out += p
    return bytes(out)


def remove_nulls(data: bytes) -> bytes:
    return data.replace(b"\x00", b"")


_SQUASH_DELETE = bytes(sorted(SQUASH_BYTES))

#: anything the DECODE side of the variant chains reacts to: url-decode
#: triggers ('+', '%'), nulls, overlong-UTF-8 leads (C0/C1/E0), or a
#: *decodable-shaped* html entity — '&' with a ';' within the next 9
#: bytes (html_entity_decode's exact window; a bare '&', the query-arg
#: separator on virtually every ARGS row, decodes to itself).  No match
#: ⇒ dec == dec_html == raw, one early-exit C scan (benign
#: fast path).  Over-matching (an entity-shaped span that fails to
#: parse) only costs the slow path, never correctness.
_DECODE_SPECIALS = re.compile(rb"(?s)[+%\x00\xc0\xc1\xe0]|&.{0,8};")

#: the squash set as a scan — no match ⇒ squash(x) == x, so the three
#: squash variants collapse onto their parents
_SQUASH_SPECIALS = re.compile(
    b"[" + re.escape(bytes(sorted(SQUASH_BYTES))) + b"]")


def squash(data: bytes) -> bytes:
    """Delete SQUASH_BYTES (whitespace, backslash, quotes, caret) —
    one C-level translate, no Python byte loop."""
    return data.translate(None, _SQUASH_DELETE)


def variant_chain(data: bytes, variant: int) -> bytes:
    """Apply the canonical normalization for a scan variant id."""
    if variant == 0:
        return data
    dec = remove_nulls(url_decode_uni(data))
    if variant == 1:
        return dec
    dec_html = html_entity_decode(dec)
    if variant == 2:
        return dec_html
    if variant == 3:
        return squash(data)
    if variant == 4:
        return squash(dec_html)
    if variant == 5:
        # ws-collapse + urlDecode WITHOUT html decode: html entity decode
        # deletes factor bytes ("&#x61;" → "a") that such a rule's own
        # transform chain keeps — a prefilter-gate finding
        return squash(dec)
    raise ValueError("unknown variant %d" % variant)


def headers_blob(headers) -> bytes:
    """Canonical "key: value\\x1f..." header join — the ONE definition
    shared by the wire encoders (protocol.py) and the scan/confirm models
    below, so wire bytes and confirm bytes can never drift apart.  \\x1f
    (unit separator) survives every transform, matches no rule, and
    prevents cross-header false adjacency (\\n would trip the
    CRLF-injection rules on every request)."""
    # join in str space, encode ONCE (utf-8 is per-character local, so
    # one encode of the '\x1f'-joined string is byte-identical to
    # joining per-header encodes — host-prep)
    return "\x1f".join(
        ["%s: %s" % kv for kv in headers.items()]
    ).encode("utf-8", "surrogateescape")


@dataclass
class Request:
    """Neutral HTTP-request model (what the sidecar ships over UDS)."""

    method: str = "GET"
    uri: str = "/"
    #: "" = unknown (the sidecar wire doesn't carry it yet): confirm
    #: rules on REQUEST_PROTOCOL then abstain instead of evaluating a
    #: fabricated default
    protocol: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    tenant: int = 0          # EP routing: Ingress/namespace index
    request_id: str = ""
    mode: int = 2            # wallarm_mode: 0 off, 1 monitoring, 2 block,
                             # 3 safe_blocking (wire value; precedence
                             # order is models/pipeline.py MODE_STRENGTH
                             # — can only weaken the server's global mode)
    parsers_off: frozenset = frozenset()   # wallarm-parser-disable analog;
                             # per-location disables also ride the
                             # x-detect-tpu-parser-disable header
    client_ip: str = ""      # connection source IP from the TRUSTED plane
                             # (shim-injected acl.CLIENT_IP_HEADER, popped
                             # from headers at decode so it is never
                             # scanned); "" = unknown → ACLs abstain
    greylisted: bool = False  # safe_blocking input: source is greylisted
                              # (frame MODE_GREYLIST bit or ACL greylist)

    #: which stream the StreamEngine chunk-scans (Response: "resp_body")
    body_stream = "body"

    def streams(self, scan_extras: bool = True) -> Dict[str, bytes]:
        """stream name → base bytes (the 4 scan streams).

        ARGS is URL-decoded once *before* any rule transform, because
        ModSecurity's ARGS collection holds parsed query values, not raw
        query bytes — CRS rules without an explicit t:urlDecodeUni still
        expect decoded text there (a rule's own urlDecodeUni then catches
        double-encoding, same as the reference engine).

        ``scan_extras``: prefilter-only unpack segments (the url-decoded
        form-body copy).  Scan keeps them (soundness superset); the
        confirm twin (confirm_streams) drops them so scalar REQUEST_BODY
        rules with their own t:urlDecodeUni never see a double-decoded
        copy ModSecurity would not produce."""
        uri = self.uri.encode("utf-8", "surrogateescape")
        q = uri.find(b"?")
        args = url_decode_uni(uri[q + 1 :]) if q >= 0 else b""
        # Header values are separate match units in ModSecurity; the
        # shared headers_blob join keeps them separate (see its docstring)
        hdr = headers_blob(self.headers)
        # body unpack (gzip/b64/json/xml — SURVEY.md §3.3): the scan AND
        # the confirm stage both call streams(), so they see identical
        # unpacked bytes — the prefilter∧confirm contract holds through
        # every decode step (modulo the scan-only extra segments above)
        body = self.body
        if body:
            body = unpack_body(body, self.headers, self.parsers_off,
                               scan_extras=scan_extras)
        return {"uri": uri, "args": args, "headers": hdr, "body": body}

    def confirm_streams(self) -> Dict[str, bytes]:
        """streams() plus the scalar pseudo-streams the confirm stage's
        per-variable evaluator resolves (models/confirm.py
        _SCALAR_BASES): REQUEST_METHOD/PROTOCOL/FILENAME/BASENAME and
        the RAW query string (ModSecurity's QUERY_STRING is undecoded,
        unlike the scanner's decoded args stream).  The scanner contract
        is untouched — rows_for_requests iterates streams().  Scan-only
        extra segments are dropped (single-decode confirm semantics)."""
        s = self.streams(scan_extras=False)
        uri = s["uri"]
        q = uri.find(b"?")
        path = uri if q < 0 else uri[:q]
        s["query"] = b"" if q < 0 else uri[q + 1:]
        s["filename"] = path
        s["basename"] = path.rsplit(b"/", 1)[-1]
        s["method"] = self.method.encode("utf-8", "surrogateescape")
        if self.protocol:   # unknown protocol stays absent → abstain
            s["protocol"] = self.protocol.encode("utf-8", "surrogateescape")
        if self.client_ip:  # REMOTE_ADDR (@ipMatch rules); absent→abstain
            s["remote_addr"] = self.client_ip.encode("ascii", "replace")
        if self.parsers_off:
            # marker the confirm stage's body-processor selection reads
            # (models/confirm.py JSON branch) so a wallarm-parser-disable
            # location also switches off ARGS-from-JSON, matching the
            # unpack stage's gating; matches no SecLang base, so rules
            # never see it
            s["parsers_off"] = ",".join(sorted(self.parsers_off)).encode()
        return s


@dataclass
class Response:
    """Neutral upstream-HTTP-response model (the wallarm_parse_response /
    wallarm-unpack-response analog — SURVEY.md §2.1/§2.2 response rows).

    Duck-typed to flow through the SAME pipeline as Request (streams(),
    confirm_streams(), tenant/mode/request_id): response rules compile
    into the same ruleset with sv bits on the resp_* streams, so a
    response scan is just a detect() over different rows — request rules
    can't fire (their streams are absent) and vice versa."""

    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    tenant: int = 0
    request_id: str = ""
    mode: int = 2
    parsers_off: frozenset = frozenset()

    #: StreamEngine scans this stream for chunked/oversized bodies
    body_stream = "resp_body"
    #: postanalytics (post/channel.py Hit) records responses with a
    #: sentinel method and no uri — leak hits aggregate per tenant/client
    method = "RESPONSE"
    uri = ""

    def streams(self, scan_extras: bool = True) -> Dict[str, bytes]:
        hdr = headers_blob(self.headers)
        body = self.body
        if body:
            # same unpack stage as requests (wallarm-unpack-response):
            # gzip/base64/json/xml wrapped response bodies are scanned
            # decoded, honoring the same parser disables
            body = unpack_body(body, self.headers, self.parsers_off,
                               scan_extras=scan_extras)
        return {"resp_headers": hdr, "resp_body": body}

    def confirm_streams(self) -> Dict[str, bytes]:
        s = self.streams(scan_extras=False)
        s["status"] = str(self.status).encode()
        return s


@dataclass
class ScanRow:
    """One normalized row for the scanner."""

    request_index: int
    sv: int          # stream_index * len(VARIANTS) + variant
    data: bytes


def rows_for_requests(
    requests: List[Request],
    needed_sv: Optional[Iterable[int]] = None,
    max_row_bytes: int = 1 << 20,
) -> List[ScanRow]:
    """Expand requests into deduplicated scan rows.

    ``needed_sv``: stream-variant ids any rule actually uses (from
    CompiledRuleset.rule_sv_mask) — unused variants are never computed.
    A variant row identical to an already-emitted lower variant of the same
    stream is dropped, and the emitted row COVERS the higher sv id too via
    the engine-side sv mapping... (kept simple here: we emit the variant row
    only if its bytes differ from the base variant; rules for identical
    variants are satisfied because identical bytes produce identical match
    masks, and the pipeline maps rows to sv ids by actual content class).
    """
    needed = set(needed_sv) if needed_sv is not None else None
    rows: List[ScanRow] = []
    for qi, req in enumerate(requests):
        for sname, raw in req.streams().items():
            if not raw:
                continue
            raw = raw[:max_row_bytes]
            si = STREAM_INDEX[sname]
            cache: Dict[int, bytes] = {}
            for v in range(len(VARIANTS)):
                sv = si * len(VARIANTS) + v
                if needed is not None and sv not in needed:
                    continue
                data = variant_chain(raw, v)
                if not data:
                    continue
                cache[v] = data
                # dedup: identical to the raw (or any earlier) variant →
                # the earlier row's matches are identical; but sv-masking
                # differs per rule, so we must still emit a row marker.
                # We dedup by pointing at identical bytes (cheap: same
                # object), and the batcher merges identical (req, bytes)
                # rows while OR-ing their sv bits. Here: emit all, merge
                # happens in merge_rows().
                rows.append(ScanRow(request_index=qi, sv=sv, data=data))
    return rows


def merge_rows(rows: List[ScanRow]) -> Tuple[List[bytes], List[int], List[List[int]]]:
    """Merge rows with identical (request, bytes): scan once, credit all
    their sv ids.  Returns (data_list, request_index_list, sv_ids_list)."""
    merged: Dict[Tuple[int, bytes], List[int]] = {}
    for r in rows:
        merged.setdefault((r.request_index, r.data), []).append(r.sv)
    data_list: List[bytes] = []
    req_list: List[int] = []
    sv_list: List[List[int]] = []
    for (qi, data), svs in merged.items():
        data_list.append(data)
        req_list.append(qi)
        sv_list.append(sorted(set(svs)))
    return data_list, req_list, sv_list


def needed_variants_by_stream(
        needed_sv: Optional[Iterable[int]]) -> Dict[int, tuple]:
    """Per-stream-index tuples of the variant ids any rule needs —
    resolved once per ruleset install (DetectionPipeline caches this)
    instead of one set-membership test per (row, variant) per cycle."""
    needed = set(needed_sv) if needed_sv is not None else None
    nv = len(VARIANTS)
    return {
        si: tuple(v for v in range(nv)
                  if needed is None or si * nv + v in needed)
        for si in STREAM_INDEX.values()
    }


def merged_rows_for_requests(
    requests: List[Request],
    needed_sv: Optional[Iterable[int]] = None,
    max_row_bytes: int = 1 << 20,
    variants_for: Optional[Dict[int, tuple]] = None,
) -> Tuple[List[bytes], List[int], List[List[int]]]:
    """``merge_rows(rows_for_requests(...))`` in ONE pass — the serving
    hot path (host-prep offload; output is pinned byte- and
    order-identical to the two-pass composition by
    tests/test_unpack.py).

    What the fused pass saves, measured as the dominant terms of the
    profiled ``prep_us`` stage:

    * **shared decode intermediates** — ``variant_chain(raw, v)``
      recomputed the url-decode for variants 1/2/4/5 and the
      html-entity decode for 2/4 from scratch per variant; here ``dec``
      and ``dec_html`` are computed once per stream and every variant
      derives from them (identical composition order, so bytes cannot
      differ);
    * **no intermediate ScanRow materialization** — rows fold straight
      into the per-request dedup dict (one hash per row instead of
      dataclass + list append + a second full pass);
    * **two-tier benign fast path** — a row with no DECODE special
      (``_DECODE_SPECIALS``: '+', '%', NUL, overlong-UTF-8 leads, or
      an entity-shaped ``&...;``) has ``dec == dec_html == raw``, so
      variants 0/1/2 collapse onto raw and 3/4/5 onto ONE
      ``squash(raw)``; if the squash set is absent too, the whole
      stream is a single row carrying every needed sv id.  One or two
      early-exit regex scans replace five decode chains and five dedup
      hashes on clean traffic (and header rows — always
      squash-special, never decode-special — pay one squash, not
      three).
    """
    nv = len(VARIANTS)
    if variants_for is None:
        variants_for = needed_variants_by_stream(needed_sv)
    data_list: List[bytes] = []
    req_list: List[int] = []
    sv_list: List[List[int]] = []
    dec_specials = _DECODE_SPECIALS.search
    sq_specials = _SQUASH_SPECIALS.search
    stream_index = STREAM_INDEX
    d_append, r_append, s_append = (data_list.append, req_list.append,
                                    sv_list.append)
    for qi, req in enumerate(requests):
        # dedup scope matches merge_rows' (request, bytes) key: rows
        # merge across STREAMS of one request, never across requests
        index: Dict[bytes, int] = {}
        index_get = index.get
        for sname, raw in req.streams().items():
            if not raw:
                continue
            if len(raw) > max_row_bytes:
                raw = raw[:max_row_bytes]
            si = stream_index[sname]
            base = si * nv
            vs = variants_for[si]
            if not vs:
                continue
            if dec_specials(raw) is None:
                # decode side inert: variants 0/1/2 ARE raw and the
                # three squash variants share one squash(raw)
                if sq_specials(raw) is None:
                    groups = ((raw, [base + v for v in vs]),)
                else:
                    sq = raw.translate(None, _SQUASH_DELETE)
                    groups = (
                        (raw, [base + v for v in vs if v < 3]),
                        (sq, [base + v for v in vs if v >= 3]),
                    )
                for data, svs in groups:
                    if not data or not svs:
                        continue
                    j = index_get(data)
                    if j is None:
                        index[data] = len(data_list)
                        d_append(data)
                        r_append(qi)
                        s_append(svs)
                    else:
                        sv_list[j].extend(svs)
                continue
            dec: Optional[bytes] = None
            dec_html: Optional[bytes] = None
            for v in vs:
                sv = base + v
                # variant_chain(raw, v), intermediates shared
                if v == 0:
                    data = raw
                elif v == 3:
                    data = squash(raw)
                else:
                    if dec is None:
                        dec = remove_nulls(url_decode_uni(raw))
                    if v == 1:
                        data = dec
                    elif v == 5:
                        data = squash(dec)
                    else:
                        if dec_html is None:
                            dec_html = html_entity_decode(dec)
                        data = dec_html if v == 2 else squash(dec_html)
                if not data:
                    continue
                j = index_get(data)
                if j is None:
                    index[data] = len(data_list)
                    d_append(data)
                    r_append(qi)
                    s_append([sv])
                else:
                    sv_list[j].append(sv)
    # merge_rows sorts each row's sv ids; emission order here is
    # ascending within a stream but streams of one request may merge
    # out of si order, so sort the short lists the same way
    for svs in sv_list:
        if len(svs) > 1:
            svs.sort()
    return data_list, req_list, sv_list
