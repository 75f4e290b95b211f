"""Chunked body normalization of the reference: a frozen copy of the
port's ``serve/stream.py`` ``IncrementalVariant`` and ``StreamState``
(the per-chunk unpack and variant decoders, the confirm buffer and its
caps).  The reference feeds an upload's chunks through it, joins each
variant's increments and scans the whole row at once
(:mod:`wafbench.reference.verdict`); the port scans the increments wave
by wave with the state carried.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from wafbench.reference.normalize import (
    Request,
    fold_overlong_utf8,
    html_entity_decode,
    remove_nulls,
    squash,
    url_decode_uni_raw,
)
from wafbench.reference.unpack import (
    GZIP_MAGIC,
    IncrementalBase64,
    IncrementalGrpc,
    IncrementalInflate,
    header_lookup,
)

# longest suffix that might be an incomplete %-escape: %, %X, %u, %uX..%uXXX
_URL_TAIL = re.compile(rb"%(?:u[0-9a-fA-F]{0,3}|[0-9a-fA-F])?$")
# longest suffix that might be an incomplete &entity; (decoder looks for
# ';' within 9 bytes of '&', so anything longer can never decode)
_ENT_TAIL = re.compile(rb"&[#a-zA-Z0-9]{0,8}$")

DEFAULT_BODY_CAP = 1 << 20   # raw bytes kept for the confirm stage
DEFAULT_SCAN_CAP = 16 << 20  # bytes scanned per stream (DoS bound);
                             # beyond it chunks pass unscanned and the
                             # verdict is flagged


def _split_tail(buf: bytes, pat: re.Pattern) -> Tuple[bytes, bytes]:
    m = pat.search(buf)
    return (buf[: m.start()], buf[m.start():]) if m else (buf, b"")


class IncrementalVariant:
    """Streaming ``variant_chain``: feed() returns the next decoded
    increment, flush() releases held tails at end of stream."""

    def __init__(self, variant: int):
        self.variant = variant
        self._url_tail = b""   # undecoded bytes (possible split escape)
        self._fold_tail = b""  # decoded bytes (possible split overlong seq)
        self._ent_tail = b""   # url-decoded bytes (possible split entity)

    @staticmethod
    def _overlong_split(buf: bytes):
        """Split off the longest suffix that could be an incomplete
        overlong-UTF-8 sequence (C0/C1/E0 lead, or E0 80-9F pair) so
        fold_overlong_utf8 over chunked input equals the one-shot fold."""
        if buf and buf[-1] in (0xC0, 0xC1, 0xE0):
            return buf[:-1], buf[-1:]
        if len(buf) >= 2 and buf[-2] == 0xE0 and 0x80 <= buf[-1] <= 0x9F:
            return buf[:-2], buf[-2:]
        return buf, b""

    def feed(self, data: bytes) -> bytes:
        v = self.variant
        if v == 0:
            return data
        if v == 3:
            return squash(data)
        safe, self._url_tail = _split_tail(self._url_tail + data, _URL_TAIL)
        raw = self._fold_tail + url_decode_uni_raw(safe)
        raw, self._fold_tail = self._overlong_split(raw)
        dec = remove_nulls(fold_overlong_utf8(raw))
        if v == 1:
            return dec
        if v == 5:                   # squash(urldec) — no html stage
            return squash(dec)
        safe2, self._ent_tail = _split_tail(self._ent_tail + dec, _ENT_TAIL)
        out = html_entity_decode(safe2)
        return squash(out) if v == 4 else out

    def flush(self) -> bytes:
        v = self.variant
        if v in (0, 3):
            return b""
        raw = self._fold_tail + url_decode_uni_raw(self._url_tail)
        self._url_tail, self._fold_tail = b"", b""
        out = remove_nulls(fold_overlong_utf8(raw))
        if v == 1:
            return out
        if v == 5:
            return squash(out)
        out = html_entity_decode(self._ent_tail + out)
        self._ent_tail = b""
        return squash(out) if v == 4 else out


class StreamState:
    """Carry for one streaming request.  Touched by one thread at a
    time — no locking."""

    def __init__(self, request: Request,
                 variants: Sequence[Tuple[int, int, int]],
                 n_words: int, version: str, body_cap: int,
                 scan_cap: int = DEFAULT_SCAN_CAP,
                 pb_kind: Optional[str] = None):
        self.request = request          # body stays b"" (scanned separately)
        # [(variant_id, sv_id, src)] — src 0 scans the (inflated) body,
        # src 1 its incremental base64 decode, src 2 its gRPC/protobuf
        # text fields (same sv ids: each is another normalization of the
        # body stream)
        self.variants = list(variants)
        self.norms = [IncrementalVariant(v) for v, _, _ in self.variants]
        # numpy uint32: the scan's row dedup keys on these words' bytes
        self.match = np.zeros((len(self.variants), n_words), np.uint32)
        self.state = np.zeros((len(self.variants), n_words), np.uint32)
        self.version = version          # ruleset fingerprint at begin
        self.base_hits: Optional[np.ndarray] = None  # (R,) from prefilter
        self.acc = bytearray()          # capped raw body for confirm
        self.body_cap = body_cap
        self.scan_cap = scan_cap
        self.body_len = 0
        self.scanned_len = 0
        self.chunks = 0
        self.truncated = False
        self.aborted = False
        self.error = False
        self.t0 = time.perf_counter()
        # unpack stage: gzip by Content-Encoding here, by magic-byte sniff
        # on the first bytes in feed(); base64 opportunistically (the
        # decoder switches itself off on the first non-base64 chunk, so
        # other streams scan no extra rows).  JSON/XML field extraction is
        # batch-path only: the decompressed bytes are scanned as they are.
        self._parsers_off = request.parsers_off
        ce = header_lookup(request.headers, "content-encoding").lower()
        self.inflater: Optional[IncrementalInflate] = None
        # _sniff_buf holds the first byte(s) until the 2-byte gzip magic
        # can be decided, so 1-byte chunking cannot defeat the sniff
        self._sniff_buf = b""
        self._sniff_done = "gzip" in self._parsers_off
        if "gzip" not in self._parsers_off and ce in (
                "gzip", "x-gzip", "deflate"):
            self.inflater = IncrementalInflate(
                raw_deflate_ok=("deflate" in ce), max_total=scan_cap)
            self._sniff_done = True
        self.b64: Optional[IncrementalBase64] = (
            IncrementalBase64() if any(s == 1 for _, _, s in self.variants)
            else None)
        # gRPC/protobuf extraction rows (src=2): ``pb_kind`` comes from
        # StreamEngine.begin's one grpc_content_kind call, the decision
        # that gated the src=2 rows.  Bare protobuf (no gRPC framing)
        # buffers and extracts at flush.
        self.grpc: Optional[IncrementalGrpc] = (
            IncrementalGrpc(framed=(pb_kind != "bare"))
            if any(s == 2 for _, _, s in self.variants) else None)

    def _unpack(self, data: bytes) -> bytes:
        """Raw chunk → scannable base bytes (inflate stage)."""
        if not self._sniff_done:
            self._sniff_buf += data
            if len(self._sniff_buf) < 2:
                return b""          # hold until the magic is decidable
            data, self._sniff_buf = self._sniff_buf, b""
            self._sniff_done = True
            if data[:2] == GZIP_MAGIC:
                self.inflater = IncrementalInflate(max_total=self.scan_cap)
        if self.inflater is None:
            return data
        out = self.inflater.feed(data)
        if self.inflater.error:
            # corrupt or overrun: the scanned prefix stands, the rest
            # passes unscanned and is surfaced as truncated at finish
            self.truncated = True
        return out

    def feed(self, data: bytes) -> List[Tuple["StreamState", int, bytes]]:
        """Raw chunk → per-variant scan increments."""
        self.chunks += 1
        self.body_len += len(data)
        room = self.body_cap - len(self.acc)
        if room > 0:
            self.acc += data[:room]
        if len(data) > max(room, 0):
            self.truncated = True
        base = self._unpack(data)
        scan_room = self.scan_cap - self.scanned_len
        if scan_room <= 0:
            if base:
                self.truncated = True
            return []  # scan bound hit: remaining bytes pass unscanned
        if len(base) > scan_room:
            self.truncated = True
            base = base[:scan_room]
        b64_inc = self.b64.feed(base) if (self.b64 and base) else b""
        grpc_inc = self.grpc.feed(base) if (self.grpc and base) else b""
        # scan_cap bounds all scanned bytes: the base64-decoded and
        # gRPC-extracted rows are scanned too, so they use budget
        self.scanned_len += len(base) + len(b64_inc) + len(grpc_inc)
        out = []
        for vi, (_v, _sv, src) in enumerate(self.variants):
            inp = (base, b64_inc, grpc_inc)[src]
            if inp and (inc := self.norms[vi].feed(inp)):
                out.append((self, vi, inc))
        return out

    def flush(self) -> List[Tuple["StreamState", int, bytes]]:
        held = b""
        if not self._sniff_done and self._sniff_buf:
            # the stream ended before the magic was decidable: the held
            # byte(s) are plain body bytes
            held, self._sniff_buf = self._sniff_buf, b""
            self._sniff_done = True
        if self.inflater is not None and not self.inflater.finished:
            # the compressed stream ended without its end marker: only a
            # prefix was scanned — surfaced at finish
            self.truncated = True
        b64_tail = self.b64.flush() if self.b64 is not None else b""
        grpc_tail = b""
        if self.grpc is not None:
            grpc_tail = (self.grpc.feed(held) if held else b"") \
                + self.grpc.flush()
            # flush-time extraction uses scan budget like feed-time
            self.scanned_len += len(grpc_tail)
        out = []
        for vi, (_v, _sv, src) in enumerate(self.variants):
            inc = b""
            if src == 0 and held:
                inc += self.norms[vi].feed(held)
            if src == 1 and b64_tail:
                inc += self.norms[vi].feed(b64_tail)
            if src == 2 and grpc_tail:
                inc += self.norms[vi].feed(grpc_tail)
            inc += self.norms[vi].flush()
            if inc:
                out.append((self, vi, inc))
        return out
