"""Wire protocol between the native sidecar and the Python serve loop.

The reference ships requests from the nginx module to its engines
in-process; this split (SURVEY.md §3.3) crosses a process
boundary: nginx-side C++ shim / sidecar ⇄ UDS ⇄ this serve loop.  gRPC is
deliberately NOT used — no C++ gRPC toolchain in the build image — so the
frames are a fixed little-endian layout trivially encoded from C++
(native/sidecar/protocol.hpp mirrors this file byte-for-byte).

Request frame (client → server):
    magic   u32  'QTPI' (0x49505451 LE reads "QTPI"... bytes b"QTPI")
    length  u32  — payload length after this field
    req_id  u64
    tenant  u32
    mode    u8   — bits 0-1: 0 off, 1 monitoring, 2 block; bit 7:
                   MODE_STREAM; bits 3-6: parser-disable flags
                   (PARSER_OFF_BITS — trusted config plane)
    m_len   u8   — method length
    uri_len u32
    hdr_len u32  — headers blob: "key: value\\x1f..." pairs
    body_len u32
    bytes: method, uri, headers, body

Response frame (server → client):
    magic   u32  'RTPI' (b"RTPI")
    length  u32
    req_id  u64
    flags   u8   — bit0 attack, bit1 blocked, bit2 fail_open
    score   u32
    n_cls   u8
    n_rules u16
    cls ids u8 × n_cls
    rule ids u64 × n_rules

Streaming bodies (benchmark config #5): a request frame whose mode byte
has ``MODE_STREAM`` (0x80) set opens a body stream — its inline body bytes
are the FIRST chunk; further chunks arrive as chunk frames:

Chunk frame (client → server):
    magic   u32  'KTPI' (b"KTPI")
    length  u32
    req_id  u64
    flags   u8   — bit0 last chunk
    bytes: body chunk data (may be empty, e.g. a bare last marker)

The verdict response is sent after the last chunk (the reference's
incremental body parse† finishes at body end the same way).

Response-scan frame (client → server; the wallarm_parse_response /
wallarm-unpack-response analog — upstream HTTP responses scanned for the
95x leakage families; verdict returns as a normal RTPI frame):
    magic   u32  'PTPI' (b"PTPI")
    length  u32
    req_id  u64
    tenant  u32
    mode    u8   — same bits as the request frame (parser disables honor
                   detect_tpu_unpack_response); MODE_STREAM unused
    status  u16  — upstream HTTP status code
    hdr_len u32  — response headers blob, same "key: value\\x1f" layout
    body_len u32
    bytes: headers, body

WebSocket capture frame (client → server; the wallarm_parse_websocket
analog — raw upgraded-connection bytes, either direction; serve parses
RFC 6455 framing and scans messages — serve/websocket.py):
    magic   u32  'WTPI' (b"WTPI")
    length  u32
    req_id  u64  — unique per frame; correlates this frame's RTPI verdict
    stream  u64  — upgraded-connection id: keys persistent parser/scan
                   state across frames (sidecar rewrites it globally
                   unique, like req_id)
    tenant  u32
    mode    u8   — same bits as the request frame
    flags   u8   — bit0: direction is server→client; bit1: stream end
                   (connection closed — finalize and free state)
    bytes: raw WebSocket wire bytes (any chunking: partial frames fine)

Every WTPI frame gets exactly ONE RTPI verdict (sidecar bookkeeping is
identical to requests); the verdict is the stream's sticky attack state
after the messages this frame completed.

Responses may arrive out of order; req_id correlates.

Observability contract: the wire ``req_id`` IS the trace id.  decode_*
stamp it into ``Request.request_id``/``Response.request_id`` as a decimal
string, and it survives unchanged through batcher → pipeline → confirm →
postanalytics (post/queue.py ``Hit.request_id``), so a slow verdict is
attributable post-hoc via ``/traces/request?id=<req_id>`` and the
``/debug/slow`` exemplar ring (docs/OBSERVABILITY.md).  The sidecar
additionally stamps each frame's send→verdict time on its side of the
hop (surfaced via its --status-port JSON).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ingress_plus_tpu_torch.compiler.seclang import CLASSES
from ingress_plus_tpu_torch.models.acl import CLIENT_IP_HEADER
from ingress_plus_tpu_torch.serve.normalize import Request, Response, headers_blob

REQ_MAGIC = b"QTPI"
RESP_MAGIC = b"RTPI"
CHUNK_MAGIC = b"KTPI"
RSCAN_MAGIC = b"PTPI"
WS_MAGIC = b"WTPI"

_REQ_HEAD = struct.Struct("<QIBB III")   # req_id tenant mode m_len | uri hdr body
_RESP_HEAD = struct.Struct("<QBIBH")     # req_id flags score n_cls n_rules
_CHUNK_HEAD = struct.Struct("<QB")       # req_id flags
_RSCAN_HEAD = struct.Struct("<QIBH II")  # req_id tenant mode status | hdr body
_WS_HEAD = struct.Struct("<QQIBB")       # req_id stream tenant mode flags

FLAG_ATTACK = 1
FLAG_BLOCKED = 2
FLAG_FAIL_OPEN = 4

MODE_STREAM = 0x80     # request-frame mode bit: body arrives chunked
MODE_GREYLIST = 0x04   # request-frame mode bit: source IP is greylisted
                       # (trusted plane: shim/sidecar set it from their
                       # own greylist knowledge; safe_blocking blocks
                       # only these — models/pipeline.py finalize)
CHUNK_LAST = 1         # chunk-frame flag: final chunk of the stream
WS_DIR_S2C = 1         # ws-frame flag bit0: bytes are server→client
WS_END = 2             # ws-frame flag bit1: upgraded connection closed

# Mode-byte bits 3-6: per-location parser disables (wallarm-parser-disable
# → detect_tpu_parser_disable).  These ride the TRUSTED config plane
# (nginx conf → shim → frame), never a client-forwardable header — a
# client-supplied header could otherwise switch the unpack stage off and
# walk a gzip/base64-wrapped attack past the scanner.
PARSER_OFF_BITS = {"gzip": 0x08, "base64": 0x10, "json": 0x20, "xml": 0x40}
_PARSER_MASK = 0x78

MAX_FRAME = 8 << 20  # 8MB: bounded memory per connection


class ProtocolError(Exception):
    pass


def encode_chunk(req_id: int, data: bytes, last: bool = False) -> bytes:
    payload = _CHUNK_HEAD.pack(req_id, CHUNK_LAST if last else 0) + data
    return CHUNK_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_chunk(payload: bytes) -> Tuple[int, bool, bytes]:
    """Returns (req_id, last, data)."""
    if len(payload) < _CHUNK_HEAD.size:
        raise ProtocolError("short chunk frame")
    req_id, flags = _CHUNK_HEAD.unpack_from(payload)
    return req_id, bool(flags & CHUNK_LAST), payload[_CHUNK_HEAD.size:]


def encode_request(req: Request, req_id: int, mode: int = 2) -> bytes:
    for p in req.parsers_off:
        mode |= PARSER_OFF_BITS.get(p, 0)
    if req.greylisted:
        mode |= MODE_GREYLIST
    method = req.method.encode()
    uri = req.uri.encode("utf-8", "surrogateescape")
    headers = req.headers
    if req.client_ip:
        # symmetric with decode_request: the client IP rides the trusted
        # plane as the shim-injected header.  The TRUSTED value always
        # wins: any inbound copy of the header is dropped first, exactly
        # like the C shim (an attacker-supplied copy would otherwise
        # spoof ACL allow/deny/greylist decisions).
        headers = {k: v for k, v in headers.items()
                   if k.lower() != CLIENT_IP_HEADER}
        headers[CLIENT_IP_HEADER] = req.client_ip
    hdr = headers_blob(headers)
    payload = _REQ_HEAD.pack(req_id, req.tenant, mode, len(method),
                             len(uri), len(hdr), len(req.body))
    payload += method + uri + hdr + req.body
    return REQ_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_request(payload: bytes) -> Tuple[int, int, Request]:
    """payload = frame body after magic+length.  Returns (req_id, mode, Request)."""
    if len(payload) < _REQ_HEAD.size:
        raise ProtocolError("short request frame")
    req_id, tenant, mode, m_len, uri_len, hdr_len, body_len = \
        _REQ_HEAD.unpack_from(payload)
    off = _REQ_HEAD.size
    need = off + m_len + uri_len + hdr_len + body_len
    if len(payload) != need:
        raise ProtocolError("frame length mismatch: %d != %d"
                            % (len(payload), need))
    method = payload[off:off + m_len].decode("ascii", "replace")
    off += m_len
    uri = payload[off:off + uri_len].decode("utf-8", "surrogateescape")
    off += uri_len
    headers = {}
    hdr = payload[off:off + hdr_len]
    off += hdr_len
    if hdr:
        for pair in hdr.split(b"\x1f"):
            k, _, v = pair.partition(b": ")
            if k:
                headers[k.decode("utf-8", "surrogateescape")] = \
                    v.decode("utf-8", "surrogateescape")
    body = payload[off:off + body_len]
    parsers_off = frozenset(
        name for name, bit in PARSER_OFF_BITS.items() if mode & bit)
    # client IP rides the trusted plane as a shim-injected header; pop it
    # so ACLs see it and the scanner never does
    client_ip = ""
    for k in list(headers):
        if k.lower() == CLIENT_IP_HEADER:
            client_ip = headers.pop(k)
    return req_id, mode & ~(_PARSER_MASK | MODE_GREYLIST), Request(
        method=method, uri=uri, headers=headers, body=body, tenant=tenant,
        request_id=str(req_id), parsers_off=parsers_off,
        client_ip=client_ip, greylisted=bool(mode & MODE_GREYLIST))


def encode_response_scan(resp: Response, req_id: int, mode: int = 2) -> bytes:
    for p in resp.parsers_off:
        mode |= PARSER_OFF_BITS.get(p, 0)
    hdr = headers_blob(resp.headers)
    payload = _RSCAN_HEAD.pack(req_id, resp.tenant, mode,
                               resp.status & 0xFFFF, len(hdr),
                               len(resp.body))
    payload += hdr + resp.body
    return RSCAN_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_response_scan(payload: bytes) -> Tuple[int, int, Response]:
    """payload after magic+length.  Returns (req_id, mode, Response)."""
    if len(payload) < _RSCAN_HEAD.size:
        raise ProtocolError("short response-scan frame")
    req_id, tenant, mode, status, hdr_len, body_len = \
        _RSCAN_HEAD.unpack_from(payload)
    off = _RSCAN_HEAD.size
    if len(payload) != off + hdr_len + body_len:
        raise ProtocolError("response-scan frame length mismatch")
    headers = {}
    hdr = payload[off:off + hdr_len]
    off += hdr_len
    if hdr:
        for pair in hdr.split(b"\x1f"):
            k, _, v = pair.partition(b": ")
            if k:
                headers[k.decode("utf-8", "surrogateescape")] = \
                    v.decode("utf-8", "surrogateescape")
    body = payload[off:off + body_len]
    parsers_off = frozenset(
        name for name, bit in PARSER_OFF_BITS.items() if mode & bit)
    return req_id, mode & ~_PARSER_MASK, Response(
        status=status, headers=headers, body=body, tenant=tenant,
        request_id=str(req_id), parsers_off=parsers_off)


def encode_ws(req_id: int, stream_id: int, data: bytes, tenant: int = 0,
              mode: int = 2, s2c: bool = False, end: bool = False) -> bytes:
    flags = (WS_DIR_S2C if s2c else 0) | (WS_END if end else 0)
    payload = _WS_HEAD.pack(req_id, stream_id, tenant, mode, flags) + data
    return WS_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_ws(payload: bytes) -> Tuple[int, int, int, int, int, bytes]:
    """payload after magic+length.  Returns
    (req_id, stream_id, tenant, mode, flags, data)."""
    if len(payload) < _WS_HEAD.size:
        raise ProtocolError("short ws frame")
    req_id, stream_id, tenant, mode, flags = _WS_HEAD.unpack_from(payload)
    return req_id, stream_id, tenant, mode, flags, payload[_WS_HEAD.size:]


def encode_response(req_id: int, attack: bool, blocked: bool,
                    fail_open: bool, score: int, class_ids: List[int],
                    rule_ids: List[int]) -> bytes:
    flags = ((FLAG_ATTACK if attack else 0)
             | (FLAG_BLOCKED if blocked else 0)
             | (FLAG_FAIL_OPEN if fail_open else 0))
    # wire caps: u8 class count, u16 rule count (clamped, matching the
    # C++ twin, so the counts can never truncate and desync the decoder)
    class_ids = class_ids[:255]
    rule_ids = rule_ids[:65535]
    payload = _RESP_HEAD.pack(req_id, flags, score & 0xFFFFFFFF,
                              len(class_ids), len(rule_ids))
    payload += bytes(class_ids)
    payload += b"".join(struct.pack("<Q", r) for r in rule_ids)
    return RESP_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_response(payload: bytes):
    req_id, flags, score, n_cls, n_rules = _RESP_HEAD.unpack_from(payload)
    off = _RESP_HEAD.size
    cls = list(payload[off:off + n_cls])
    off += n_cls
    rules = [struct.unpack_from("<Q", payload, off + 8 * i)[0]
             for i in range(n_rules)]
    return {
        "req_id": req_id,
        "attack": bool(flags & FLAG_ATTACK),
        "blocked": bool(flags & FLAG_BLOCKED),
        "fail_open": bool(flags & FLAG_FAIL_OPEN),
        "score": score,
        "classes": [CLASSES[c] for c in cls if c < len(CLASSES)],
        "rule_ids": rules,
    }


class FrameReader:
    """Incremental frame splitter for a single-kind byte stream (thin
    wrapper over MultiFrameReader so the framing loop exists once)."""

    def __init__(self, magic: bytes):
        self._inner = MultiFrameReader({magic: "frame"})

    def feed(self, data: bytes) -> List[bytes]:
        return [payload for _, payload in self._inner.feed(data)]


class MultiFrameReader:
    """Frame splitter for a stream interleaving several frame kinds
    (request + chunk frames on the server's inbound side)."""

    def __init__(self, kinds: dict):
        self.kinds = {bytes(m): name for m, name in kinds.items()}
        self.buf = bytearray()

    def feed(self, data: bytes) -> List[Tuple[str, bytes]]:
        self.buf += data
        out = []
        while True:
            if len(self.buf) < 8:
                break
            kind = self.kinds.get(bytes(self.buf[:4]))
            if kind is None:
                raise ProtocolError("bad magic %r" % bytes(self.buf[:4]))
            (length,) = struct.unpack_from("<I", self.buf, 4)
            if length > MAX_FRAME:
                raise ProtocolError("frame too large: %d" % length)
            if len(self.buf) < 8 + length:
                break
            out.append((kind, bytes(self.buf[8:8 + length])))
            del self.buf[:8 + length]
        return out
