"""The serving entry's UDS frames, as the benchmark's client speaks them:
a copy of the request, chunk and verdict layouts of the port's
``serve/protocol.py`` (native/sidecar/protocol.hpp mirrors the same).

Request frame:  b"QTPI" u32 len | u64 req_id u32 tenant u8 mode u8 m_len
                u32 uri_len u32 hdr_len u32 body_len | method uri hdr body
Chunk frame:    b"KTPI" u32 len | u64 req_id u8 flags(bit0 last) | data
Verdict frame:  b"RTPI" u32 len | u64 req_id u8 flags(attack, blocked,
                fail_open) u32 score u8 n_cls u16 n_rules | cls ids u8 ...
                | rule ids u64 ...
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from wafbench.reference.consts import CLASSES, CLIENT_IP_HEADER
from wafbench.reference.normalize import Request, headers_blob

REQ_MAGIC = b"QTPI"
RESP_MAGIC = b"RTPI"
CHUNK_MAGIC = b"KTPI"

_REQ_HEAD = struct.Struct("<QIBB III")
_RESP_HEAD = struct.Struct("<QBIBH")
_CHUNK_HEAD = struct.Struct("<QB")

FLAG_ATTACK = 1
FLAG_BLOCKED = 2
FLAG_FAIL_OPEN = 4
MODE_BLOCK = 2
MODE_STREAM = 0x80
CHUNK_LAST = 1
MAX_FRAME = 8 << 20


class ProtocolError(Exception):
    pass


def encode_request(req: Request, req_id: int, mode: int = MODE_BLOCK) -> bytes:
    """A request frame; ``mode | MODE_STREAM`` opens a streamed body whose
    inline bytes (``req.body``) are its first chunk.  (The benchmark's
    traffic carries no client IP, which the trusted plane would add.)"""
    method = req.method.encode()
    uri = req.uri.encode("utf-8", "surrogateescape")
    hdr = headers_blob(req.headers)
    payload = _REQ_HEAD.pack(req_id, req.tenant, mode, len(method),
                             len(uri), len(hdr), len(req.body))
    payload += method + uri + hdr + req.body
    return REQ_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_request(frame: bytes) -> Tuple[int, int, Request]:
    """A request frame (magic and length included) back into what the
    server decodes from it: ``(req_id, mode, Request)``."""
    payload = frame[8:]
    req_id, tenant, mode, m_len, uri_len, hdr_len, body_len = \
        _REQ_HEAD.unpack_from(payload)
    off = _REQ_HEAD.size
    if len(payload) != off + m_len + uri_len + hdr_len + body_len:
        raise ProtocolError("frame length mismatch")
    method = payload[off:off + m_len].decode("ascii", "replace")
    off += m_len
    uri = payload[off:off + uri_len].decode("utf-8", "surrogateescape")
    off += uri_len
    hdr = payload[off:off + hdr_len]
    off += hdr_len
    headers = {}
    if hdr:
        for pair in hdr.split(b"\x1f"):
            k, _, v = pair.partition(b": ")
            if k:
                headers[k.decode("utf-8", "surrogateescape")] = \
                    v.decode("utf-8", "surrogateescape")
    client_ip = ""
    for k in list(headers):
        if k.lower() == CLIENT_IP_HEADER:
            client_ip = headers.pop(k)
    req = Request(method=method, uri=uri, headers=headers,
                  body=payload[off:off + body_len], tenant=tenant,
                  request_id=str(req_id), client_ip=client_ip)
    req.mode = mode & 0x03
    return req_id, mode, req


def encode_chunk(req_id: int, data: bytes, last: bool = False) -> bytes:
    payload = _CHUNK_HEAD.pack(req_id, CHUNK_LAST if last else 0) + data
    return CHUNK_MAGIC + struct.pack("<I", len(payload)) + payload


def decode_verdict(payload: bytes) -> dict:
    """A verdict frame's payload (after magic and length)."""
    req_id, flags, score, n_cls, n_rules = _RESP_HEAD.unpack_from(payload)
    off = _RESP_HEAD.size
    cls = payload[off:off + n_cls]
    off += n_cls
    rules = struct.unpack_from("<%dQ" % n_rules, payload, off)
    return {"req_id": req_id,
            "attack": bool(flags & FLAG_ATTACK),
            "blocked": bool(flags & FLAG_BLOCKED),
            "fail_open": bool(flags & FLAG_FAIL_OPEN),
            "score": score,
            "classes": sorted(CLASSES[c] if c < len(CLASSES) else str(c)
                              for c in cls),
            "rule_ids": sorted(rules)}


class VerdictReader:
    """Splits a byte stream into verdict frames."""

    def __init__(self):
        self.buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self.buf += data
        out = []
        while len(self.buf) >= 8:
            if bytes(self.buf[:4]) != RESP_MAGIC:
                raise ProtocolError("bad magic %r" % bytes(self.buf[:4]))
            (length,) = struct.unpack_from("<I", self.buf, 4)
            if length > MAX_FRAME:
                raise ProtocolError("frame too large: %d" % length)
            if len(self.buf) < 8 + length:
                break
            out.append(decode_verdict(bytes(self.buf[8:8 + length])))
            del self.buf[:8 + length]
        return out
