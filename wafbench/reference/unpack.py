"""Frozen copy of the port's ``serve/unpack.py`` (imports point at the reference).
Its original docstring follows.

Request-body unpacking: gzip/deflate, base64, JSON/XML extraction.

The reference's wallarm module decodes/unpacks bodies in its hot path
before signature matching (SURVEY.md §3.3 "parse request → decode/unpack
(url/json/xml/b64/gzip)").  TPU-native equivalent: unpacking is a host
(CPU) normalize stage — the PP "normalize" stage of SURVEY.md §2.4 — that
runs BEFORE rows are bucketed for the TPU scan, so the scanner only ever
sees plaintext.  The same function runs in the confirm stage (via
``Request.streams()``), keeping the prefilter∧confirm soundness contract:
both stages look at identical bytes.

Composition rule (bounded, in order):

    raw body ──inflate (gzip/zlib/deflate)──▶ base
    base     ──JSON field extraction──▶ extra segment (keys + string
             values, unescaped by the JSON parser — catches \\u003c-style
             escape hiding)
    base     ──XML text/attr extraction──▶ extra segment
    base     ──whole-body base64 decode──▶ extra segment

The scan bytes are ``base`` plus the extra segments joined with 0x1f (the
unit separator already used for header match units: survives every
transform chain, matched by no rule, prevents false adjacency).  Segments
identical to ``base`` are dropped.

Every step is bounded (``max_out``) and failure-tolerant: a truncated
gzip stream yields its decodable prefix; invalid JSON/XML/base64 yields
no segment.  Per-location parser disables (the reference's
``wallarm-parser-disable`` annotation → ``detect_tpu_parser_disable``
directive) arrive ONLY as the explicit ``parsers_off`` set — on the wire
they ride trusted mode-byte flag bits (protocol.PARSER_OFF_BITS), never
a request header, which a client could forge to switch the unpack stage
off and walk an encoded attack past the scanner.
"""

from __future__ import annotations

import base64
import binascii
import json
import re
import struct
import zlib
import xml.etree.ElementTree as ET
from typing import Dict, FrozenSet, Optional, Tuple

SEP = b"\x1f"
PARSERS = ("gzip", "base64", "json", "xml")

GZIP_MAGIC = b"\x1f\x8b"
# matches stream.DEFAULT_SCAN_CAP: the confirm stage must be able to see
# every byte the scanner saw, so the unpack bound and the scan bound are
# the same DoS limit (a 16KB zip bomb expands to at most this)
DEFAULT_MAX_OUT = 16 << 20


def header_lookup(headers: Dict[str, str], name: str) -> str:
    """Case-insensitive single-header lookup (the neutral Request model
    stores headers as received)."""
    name = name.lower()
    for k, v in headers.items():
        if k.lower() == name:
            return v
    return ""


def content_headers(headers: Dict[str, str]) -> Tuple[str, str]:
    """(content-type, content-encoding), both lowercased, in ONE pass
    over the header dict — unpack_body runs on every body'd request's
    scan AND confirm path, so the two separate case-folding walks it
    used to do were a measurable slice of host prep .

    FIRST match wins, exactly like header_lookup: the streaming path
    (serve/stream.py) still resolves these headers via header_lookup,
    and duplicate case-variant headers picking different values per
    path would give the buffered and streamed scans of identical bytes
    different parser selection — a bypass-shaped inconsistency."""
    ct: Optional[str] = None
    ce: Optional[str] = None
    for k, v in headers.items():
        lk = k.lower()
        if lk == "content-type":
            if ct is None:
                ct = v.lower()
        elif lk == "content-encoding" and ce is None:
            ce = v.lower()
    return ct or "", ce or ""


def inflate(data: bytes, max_out: int = DEFAULT_MAX_OUT,
            raw_deflate_ok: bool = False) -> Optional[bytes]:
    """Bounded gzip/zlib (and optionally raw-deflate) decompression.

    Returns the decodable prefix on truncated/corrupt-tail input (a
    streamed body capped mid-gzip must still yield its prefix for the
    confirm stage), or None when the input isn't a compressed stream at
    all.  ``max_out`` is the zip-bomb guard: output is hard-capped.
    """
    wbits_options = [47]          # 32+15: auto-detect gzip or zlib header
    if raw_deflate_ok:
        wbits_options.append(-15)  # raw deflate (Content-Encoding: deflate
                                   # from some servers omits the zlib header)
    for wbits in wbits_options:
        out = bytearray()
        src = data
        ok = False
        # multi-member loop: gzip permits concatenated members and
        # zlib.decompressobj stops at the first end marker — scanning
        # only member 1 would let gzip(benign)+gzip(attack) through while
        # the backend's gunzip sees both
        while src and len(out) < max_out:
            d = zlib.decompressobj(wbits)
            try:
                out += d.decompress(src, max_out - len(out))
            except zlib.error:
                break
            ok = True
            if not d.eof:
                break
            nxt = d.unused_data
            if len(nxt) >= len(src):   # no progress: corrupt trailer
                break
            src = nxt
        if ok and out:
            return bytes(out)
    return None


def extract_json(data: bytes, max_out: int = DEFAULT_MAX_OUT
                 ) -> Optional[bytes]:
    """All object keys + string values, depth-first, joined with 0x1f.

    The JSON parser unescapes \\uXXXX/\\n/... — this is the step that
    catches attacks hidden behind JSON string escaping, which no substring
    scan of the raw body can see."""
    try:
        obj = json.loads(data.decode("utf-8", "surrogateescape"))
    except Exception:
        return None
    segs = []
    total = 0
    stack = [obj]
    while stack and total < max_out:
        o = stack.pop()
        if isinstance(o, dict):
            for k, v in o.items():
                if isinstance(k, str) and k:
                    segs.append(k)
                    total += len(k) + 1
                stack.append(v)
        elif isinstance(o, list):
            stack.extend(o)
        elif isinstance(o, str) and o:
            segs.append(o)
            total += len(o) + 1
    if not segs:
        return None
    out = SEP.join(s.encode("utf-8", "surrogateescape") for s in segs)
    return out[:max_out]


def extract_xml(data: bytes, max_out: int = DEFAULT_MAX_OUT
                ) -> Optional[bytes]:
    """Text nodes + attribute values of a parseable XML document.

    ElementTree/expat refuses custom entity expansion (and modern expat
    rate-limits amplification), so this is billion-laughs-safe; input is
    additionally size-capped by the caller's row bound."""
    try:
        root = ET.fromstring(data.decode("utf-8", "surrogateescape"))
    except Exception:
        return None
    segs = []
    total = 0
    for el in root.iter():
        parts = list(el.attrib.values())
        if el.text:
            parts.append(el.text)
        if el.tail:
            parts.append(el.tail)
        for p in parts:
            p = p.strip()
            if p:
                segs.append(p)
                total += len(p) + 1
        if total >= max_out:
            break
    if not segs:
        return None
    out = SEP.join(s.encode("utf-8", "surrogateescape") for s in segs)
    return out[:max_out]


def grpc_content_kind(content_type: str) -> Optional[str]:
    """Shared gate for protobuf extraction: "framed" (gRPC 5-byte wire
    framing), "bare" (raw protobuf message), or None.  Both the batch
    unpack (unpack_body) and the streaming scan (stream.py
    StreamEngine.begin / StreamState) MUST use this one predicate — if
    they disagree, scan-stage prefilter hits get killed by a confirm
    that never extracted."""
    ct = content_type.lower()
    if "grpc" in ct:
        return "framed"
    if "protobuf" in ct or "x-proto" in ct:
        return "bare"
    return None


def split_grpc_frames(data: bytes, max_messages: int = 64):
    """gRPC wire framing (BASELINE config #5 "gRPC/JSON API traffic"):
    repeated ``[compressed u8][length u32 BE][message]``.  Returns the
    (inflated) message payloads; tolerant of a truncated trailing frame
    (streamed bodies may be capped mid-frame).  None when the body does
    not parse as gRPC framing at all."""
    out = []
    i, n = 0, len(data)
    while i + 5 <= n and len(out) < max_messages:
        compressed = data[i]
        if compressed not in (0, 1):
            return out or None
        (length,) = struct.unpack_from(">I", data, i + 1)
        if length > MAX_GRPC_MESSAGE:
            return out or None
        msg = data[i + 5:i + 5 + length]
        i += 5 + length
        if compressed:
            dec = inflate(msg)
            if dec is None:
                continue
            msg = dec
        out.append(msg)
    return out or None


MAX_GRPC_MESSAGE = 8 << 20


def _read_varint(data: bytes, i: int):
    """Protobuf varint at ``i`` → (value, next_index) or (None, i)."""
    shift = 0
    val = 0
    start = i
    while i < len(data) and i - start < 10:
        b = data[i]
        val |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return val, i
        shift += 7
    return None, start


def _pb_walk(data: bytes, depth: int, segs: list, budget: list) -> bool:
    """Strict protobuf wire walk: every field must parse to the end.
    Length-delimited fields try nested-message first (bounded depth),
    else are emitted as a text segment when they decode as mostly
    printable UTF-8.  Returns False on any malformed field — the caller
    treats the enclosing blob as opaque bytes."""
    i, n = 0, len(data)
    while i < n:
        if budget[0] <= 0:
            return True     # output budget hit: what we have is valid
        tag, i2 = _read_varint(data, i)
        if tag is None or i2 == i:
            return False
        field, wire = tag >> 3, tag & 7
        if field == 0:
            return False
        i = i2
        if wire == 0:       # varint
            v, i = _read_varint(data, i)
            if v is None:
                return False
        elif wire == 1:     # fixed64
            if i + 8 > n:
                return False
            i += 8
        elif wire == 5:     # fixed32
            if i + 4 > n:
                return False
            i += 4
        elif wire == 2:     # length-delimited
            ln, i = _read_varint(data, i)
            if ln is None or i + ln > n:
                return False
            blob = data[i:i + ln]
            i += ln
            if not blob:
                continue
            # speculative nested parse: roll back segments/budget on
            # failure, or a half-parsed blob double-counts its strings
            # AND burns max_out budget that later genuine fields need
            mark, spent = len(segs), budget[0]
            if depth > 0 and _pb_walk(blob, depth - 1, segs, budget):
                continue    # parsed as a nested message
            del segs[mark:]
            budget[0] = spent
            try:
                txt = blob.decode("utf-8")
                printable = sum(1 for c in txt if c.isprintable() or
                                c in "\t\n\r")
                if printable >= 0.8 * len(txt):
                    segs.append(blob)
                    budget[0] -= len(blob) + 1
            except UnicodeDecodeError:
                pass        # binary bytes field: nothing scannable
        else:
            return False    # wire types 3/4 (groups) unsupported = malformed
    return True


def extract_protobuf(data: bytes, max_out: int = 1 << 20,
                     max_depth: int = 8) -> Optional[bytes]:
    """String fields of a protobuf message (recursively, bounded depth
    and output size), 0x1f-joined — the scannable text of a gRPC body."""
    if not data:
        return None
    segs: list = []
    budget = [max_out]
    if not _pb_walk(data, max_depth, segs, budget):
        return None
    if not segs:
        return None
    return SEP.join(segs)[:max_out]


# strict base64 shape: charset (std + urlsafe), optional padding, optional
# interior whitespace; minimum length keeps short plain words from
# decoding to noise rows
_B64_RE = re.compile(rb"\A[A-Za-z0-9+/\-_\s]+={0,2}\s*\Z")
B64_MIN_LEN = 16


def decode_base64_like(data: bytes, max_out: int = DEFAULT_MAX_OUT
                       ) -> Optional[bytes]:
    """Decode a body that *looks like* one base64 token (the reference
    module does the same opportunistic unpack†).  None when the shape or
    decode fails — never raises."""
    s = data.strip()
    if len(s) < B64_MIN_LEN or not _B64_RE.match(s):
        return None
    compact = re.sub(rb"\s+", b"", s)
    compact = compact.replace(b"-", b"+").replace(b"_", b"/")
    compact += b"=" * (-len(compact) % 4)
    try:
        dec = base64.b64decode(compact, validate=True)
    except (binascii.Error, ValueError):
        return None
    return dec[:max_out] if dec else None


def unpack_body(body: bytes, headers: Dict[str, str],
                parsers_off: FrozenSet[str] = frozenset(),
                max_out: int = DEFAULT_MAX_OUT,
                scan_extras: bool = True) -> bytes:
    """The full unpack chain; returns the bytes the body stream scans.

    Identity for plain bodies (no compression, nothing extractable) —
    benign traffic pays one header lookup and two sniffs.

    ``scan_extras``: include the prefilter-only url-decoded form-body
    segment.  The SCAN path needs it (a fully-%25xx-encoded form payload
    would otherwise show the scanner no literal bytes — a
    prefilter-soundness fix); the CONFIRM path must NOT see it, or
    scalar REQUEST_BODY rules with t:urlDecodeUni (942170, 932240)
    evaluate a double-decoded copy ModSecurity would never produce.  Prefilter hits from the extra segment are a sound
    superset — the single-decode confirm decides."""
    if not body:
        return body
    off = parsers_off
    ct, ce = content_headers(headers)

    base = body
    if "gzip" not in off and (
            ce in ("gzip", "x-gzip", "deflate") or body[:2] == GZIP_MAGIC):
        dec = inflate(body, max_out, raw_deflate_ok=("deflate" in ce))
        if dec is not None:
            base = dec

    segs = [base]
    sniff = base.lstrip()[:5]
    if scan_extras and "urlencoded" in ct:
        # form bodies, SCAN PATH ONLY: one URL-decode segment, so the
        # scanner's decode variants reach DOUBLE-encoded payloads.  The
        # query string gets this for free (the args stream is
        # parse-decoded once, then variant 1 decodes again) but the body
        # stream's variants start from raw — a fully-%25xx-encoded form
        # payload never showed the scanner a single literal byte, losing
        # every factor while the confirm stage (parse-decoded value +
        # t:urlDecodeUni) would match: a prefilter-soundness hole
        #.  Confined to scan_extras so the confirm
        # stage keeps single-decode semantics (see docstring).
        from wafbench.reference.normalize import url_decode_uni

        dec = url_decode_uni(base)
        if dec != base:
            segs.append(dec)
    if "json" not in off and ("json" in ct or sniff[:1] in (b"{", b"[")):
        ext = extract_json(base, max_out)
        if ext is not None and ext != base:
            segs.append(ext)
    if "xml" not in off and ("xml" in ct or sniff == b"<?xml"):
        ext = extract_xml(base, max_out)
        if ext is not None and ext != base:
            segs.append(ext)
    if "base64" not in off and len(base) <= 4 * max_out:
        dec = decode_base64_like(base, max_out)
        if dec is not None:
            segs.append(dec)
    # gRPC / protobuf (BASELINE config #5).  Gated under the "json"
    # parser-disable bit (structured-body extraction family) — the wire
    # mode byte has no spare flag bits.
    pb_kind = grpc_content_kind(ct)
    if "json" not in off and pb_kind is not None:
        msgs = (split_grpc_frames(base) if pb_kind == "framed" else [base])
        for msg in msgs or []:
            ext = extract_protobuf(msg)
            if ext is not None and ext != base:
                segs.append(ext)

    if len(segs) == 1:
        return base
    return SEP.join(segs)


class IncrementalInflate:
    """Streaming gzip/deflate for the chunked-body path: feed() returns
    the next decompressed increment, bounded by ``max_total``.

    On corrupt input or bound overrun it goes dead (``error`` set) and
    returns b"" from then on — the stream engine surfaces that via the
    truncated/fail-open flag, never an exception."""

    def __init__(self, raw_deflate_ok: bool = False,
                 max_total: int = 16 << 20):
        self._d = zlib.decompressobj(47)
        self._raw_fallback = raw_deflate_ok
        self._first = True
        self.max_total = max_total
        self.total = 0
        self.error = False

    def feed(self, data: bytes) -> bytes:
        if self.error or not data:
            return b""
        out = bytearray()
        src = data
        # inner loop handles concatenated gzip members: on eof with bytes
        # left, start a fresh decompressobj on the remainder (a member
        # header split across chunks is fine — zlib buffers partial
        # headers internally)
        while src:
            room = self.max_total - self.total
            if room <= 0:
                self.error = True
                break
            try:
                chunk = self._d.decompress(src, room)
            except zlib.error:
                if self._first and self._raw_fallback:
                    # some proxies send Content-Encoding: deflate as raw
                    # deflate (no zlib header): retry the first chunk raw
                    self._d = zlib.decompressobj(-15)
                    self._raw_fallback = False
                    continue
                self.error = True
                break
            self._first = False
            out += chunk
            self.total += len(chunk)
            if self._d.unconsumed_tail:
                self.error = True   # bound hit mid-chunk
                break
            if self._d.eof:
                nxt = self._d.unused_data
                if not nxt:
                    break
                if len(nxt) >= len(src) and not chunk:
                    self.error = True   # no progress: corrupt trailer
                    break
                self._d = zlib.decompressobj(47)
                src = nxt
                continue
            break
        return bytes(out)

    @property
    def finished(self) -> bool:
        """True iff the compressed stream reached its end marker — an
        unfinished stream at body end means the scan saw only a prefix."""
        return self._d.eof and not self.error


class IncrementalGrpc:
    """Streaming gRPC-frame walker for the chunked-body path (BASELINE
    config #5): buffers wire bytes, and for every COMPLETED message
    yields its extracted protobuf text fields (0x1f-joined), which the
    stream engine scans as an extra row group.

    Bounded: one message is held at a time (≤ ``max_message``); framing
    violations kill the decoder (``dead``) — already-emitted text can
    only ever produce prefilter hits, which the confirm stage (whole-
    body re-extract) decides."""

    def __init__(self, max_message: int = MAX_GRPC_MESSAGE,
                 framed: bool = True):
        self._buf = bytearray()
        self.max_message = max_message
        self.framed = framed   # False: bare protobuf (application/
        self.dead = False      # x-protobuf) — one unframed message,
                               # buffered and extracted at flush()

    def feed(self, data: bytes) -> bytes:
        if self.dead or not data:
            return b""
        if not self.framed:
            room = self.max_message - len(self._buf)
            if room > 0:
                self._buf += data[:room]
            return b""
        self._buf += data
        out = []
        while len(self._buf) >= 5:
            compressed = self._buf[0]
            if compressed not in (0, 1):
                self.dead = True
                break
            (length,) = struct.unpack_from(">I", self._buf, 1)
            if length > self.max_message:
                self.dead = True
                break
            if len(self._buf) < 5 + length:
                break
            msg = bytes(self._buf[5:5 + length])
            del self._buf[:5 + length]
            if compressed:
                dec = inflate(msg)
                if dec is None:
                    continue
                msg = dec
            ext = extract_protobuf(msg)
            if ext:
                out.append(ext)
        if self.dead:
            self._buf.clear()
        return SEP.join(out) + SEP if out else b""

    def flush(self) -> bytes:
        """End of stream: bare-protobuf mode extracts its buffered
        message now (framed mode discards a trailing partial frame)."""
        if self.framed or self.dead or not self._buf:
            return b""
        ext = extract_protobuf(bytes(self._buf))
        self._buf.clear()
        return ext + SEP if ext else b""


class IncrementalBase64:
    """Streaming base64 decode with 4-byte alignment carry.

    Opportunistic like the one-shot path: the first chunk must pass the
    charset sniff to activate; any later charset violation kills the
    decoder (``dead``) — its already-scanned output can only ever produce
    prefilter hits, which the confirm stage (whole-body decode) rejects.
    """

    _CHARSET = re.compile(rb"\A[A-Za-z0-9+/\-_=\s]*\Z")

    def __init__(self):
        self._buf = b""
        self._sniff = b""
        self.started = False
        self.dead = False

    def feed(self, data: bytes) -> bytes:
        if self.dead or not data:
            return b""
        if not self._CHARSET.match(data):
            self.dead = True
            return b""
        if not self.started:
            # accumulate until the sniff threshold — bodies arriving a few
            # bytes per chunk must still activate
            self._sniff += data
            if len(self._sniff.strip()) < B64_MIN_LEN:
                return b""
            data, self._sniff = self._sniff, b""
            self.started = True
        buf = self._buf + re.sub(
            rb"\s+", b"", data).replace(b"-", b"+").replace(b"_", b"/")
        take = len(buf) // 4 * 4
        self._buf = buf[take:]
        if not take:
            return b""
        try:
            return base64.b64decode(buf[:take], validate=True)
        except (binascii.Error, ValueError):
            self.dead = True
            return b""

    def flush(self) -> bytes:
        if self.dead or not self._buf:
            return b""
        buf = self._buf + b"=" * (-len(self._buf) % 4)
        self._buf = b""
        try:
            return base64.b64decode(buf, validate=True)
        except (binascii.Error, ValueError):
            return b""
