"""WebSocket (RFC 6455) traffic analysis — the wallarm_parse_websocket path.

The reference's module parses WebSocket frames on upgraded connections
when ``wallarm_parse_websocket on;`` is rendered (wallarm-parse-websocket
annotation — SURVEY.md §2.1 wallarm annotations row; §2.2 module row
"request parsing/decoding").  Until this module, our annotation parsed and
the directive rendered but no code path ever scanned a WebSocket payload.

Serve-side design: raw upgraded-connection bytes ride WTPI frames
(serve/protocol.py) from the shim/sidecar, one frame per captured read,
either direction.  Each direction's byte stream is parsed incrementally
into RFC 6455 frames (masking, 16/64-bit lengths, fragmentation, control
frames), and every text/binary MESSAGE is scanned through the SAME
streaming engine as chunked HTTP bodies (serve/stream.py — carried NFA
state, so a payload split across fragments or captures still matches):

- client→server messages scan the request ``body`` stream → the attack
  rule families (sqli/xss/rce/...) apply;
- server→client messages scan ``resp_body`` → the CRS-95x leakage
  families apply (data-leak detection inside a socket stream).

Verdict model: every WTPI frame is answered by exactly one RTPI frame
(the sidecar's pending/deadline bookkeeping is unchanged).  The verdict
reflects the messages COMPLETED by that frame, OR-merged with the
stream's sticky verdict — once any message in the stream scanned as an
attack, every later frame of the stream reports it too, so an enforcing
shim can kill the tunnel even if the first verdict raced past it.

Protocol errors (bad RSV bits, fragmented control frame, non-minimal
length...) poison the stream: scanning stops and every later verdict
carries fail_open (pass-and-flag, the tri-layer fail-open contract) —
a parser that blocked on malformed-but-proxied traffic would be a
self-inflicted outage, exactly what wallarm-fallback exists to prevent.

Bounds: per-message scan is capped (``msg_cap``) the same way streamed
bodies are (StreamState.scan_cap bounds total scanned bytes per message);
beyond the cap bytes pass unscanned and the verdict is flagged truncated
via the stream engine's fail-open surfacing.  Frame size is bounded by
the parser.  Per-connection stream count is bounded by the serve loop
(MAX_WS_PER_CONN there).

The extension NOT implemented: permessage-deflate (RSV1).  The shim does
not negotiate it away yet, so a deflated stream poisons → fail-open
(visible in metrics), never a silent miss.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ingress_plus_tpu_torch.serve.unpack import unpack_body

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

_DATA_OPS = (OP_TEXT, OP_BINARY)
_CTRL_OPS = (OP_CLOSE, OP_PING, OP_PONG)

#: direction indexes (match protocol.py WS_DIR_S2C flag semantics)
DIR_C2S = 0
DIR_S2C = 1


class WSError(Exception):
    """RFC 6455 violation — the stream is unparseable from here on."""


class WSFrameParser:
    """Incremental RFC 6455 frame splitter for ONE direction.

    ``feed(data) -> [(fin, opcode, payload), ...]`` with client masking
    removed.  Raises WSError on protocol violations; the caller poisons
    the stream (fail-open) — after a raise the parser must not be fed
    again.  Accepts both masked (client→server) and unmasked frames: the
    capture point can sit on either side of the proxy.
    """

    def __init__(self, max_frame: int = 8 << 20):
        self.buf = bytearray()
        self.max_frame = max_frame

    def feed(self, data: bytes) -> List[tuple]:
        self.buf += data
        out = []
        while True:
            frame = self._next()
            if frame is None:
                return out
            out.append(frame)

    def _next(self) -> Optional[tuple]:
        buf = self.buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        fin = bool(b0 & 0x80)
        if b0 & 0x70:
            # RSV bits: an extension (permessage-deflate) we can't decode
            raise WSError("RSV bits set (ws extensions unsupported)")
        opcode = b0 & 0x0F
        if opcode not in _DATA_OPS + _CTRL_OPS + (OP_CONT,):
            raise WSError("reserved opcode 0x%x" % opcode)
        masked = bool(b1 & 0x80)
        length = b1 & 0x7F
        off = 2
        if length == 126:
            if len(buf) < 4:
                return None
            length = int.from_bytes(buf[2:4], "big")
            off = 4
            if length < 126:
                raise WSError("non-minimal 16-bit length")
        elif length == 127:
            if len(buf) < 10:
                return None
            length = int.from_bytes(buf[2:10], "big")
            off = 10
            if length >> 63:
                raise WSError("MSB set in 64-bit length")
            if length < 1 << 16:
                raise WSError("non-minimal 64-bit length")
        if length > self.max_frame:
            raise WSError("frame payload too large: %d" % length)
        if opcode in _CTRL_OPS:
            if not fin:
                raise WSError("fragmented control frame")
            if length > 125:
                raise WSError("control frame payload > 125")
        if masked:
            if len(buf) < off + 4:
                return None
            mask = bytes(buf[off:off + 4])
            off += 4
        else:
            mask = b""
        if len(buf) < off + length:
            return None
        payload = bytes(buf[off:off + length])
        if mask and length:
            # big-int XOR: C-speed unmasking without numpy on this path
            rep = (mask * (length // 4 + 1))[:length]
            payload = (int.from_bytes(payload, "little")
                       ^ int.from_bytes(rep, "little")
                       ).to_bytes(length, "little")
        del self.buf[:off + length]
        return fin, opcode, payload


@dataclass
class WSClientMessage:
    """One client→server WebSocket message, duck-typed like Request so it
    flows through StreamEngine/DetectionPipeline unchanged (the same
    contract Response uses for the rscan path — normalize.py).  Only the
    ``body`` stream exists: method/uri/protocol scalars are ABSENT so
    confirm rules targeting them abstain (a ws message has no method —
    fabricating one would fire the 911/920 method-validation families on
    every message)."""

    body: bytes = b""
    tenant: int = 0
    request_id: str = ""
    mode: int = 2
    parsers_off: frozenset = frozenset()
    headers: Dict[str, str] = field(default_factory=dict)  # always empty;
    # StreamEngine.begin consults content-encoding — absent means the
    # gzip magic-byte sniff still guards binary messages

    body_stream = "body"
    method = "WEBSOCKET"    # postanalytics sentinel (post/channel.py Hit)
    uri = ""

    def streams(self) -> Dict[str, bytes]:
        # same unpack stage as HTTP bodies (the chunk scan's magic-byte
        # sniff inflates too — scan and confirm must see identical bytes)
        body = self.body
        if body:
            body = unpack_body(body, self.headers, self.parsers_off)
        return {"body": body} if body else {}

    def confirm_streams(self) -> Dict[str, bytes]:
        return self.streams()


@dataclass
class WSServerMessage:
    """One server→client message — resp_body stream, leak families."""

    body: bytes = b""
    tenant: int = 0
    request_id: str = ""
    mode: int = 2
    parsers_off: frozenset = frozenset()
    headers: Dict[str, str] = field(default_factory=dict)

    body_stream = "resp_body"
    method = "WS_RESPONSE"
    uri = ""
    status = 0              # absent → RESPONSE_STATUS rules abstain

    def streams(self) -> Dict[str, bytes]:
        body = self.body
        if body:
            body = unpack_body(body, self.headers, self.parsers_off)
        return {"resp_body": body} if body else {}

    def confirm_streams(self) -> Dict[str, bytes]:
        return self.streams()


class _Direction:
    __slots__ = ("parser", "handle", "msg", "scanned", "closed")

    def __init__(self, max_frame: int):
        self.parser = WSFrameParser(max_frame=max_frame)
        self.handle = None      # open StreamState for the current message
        self.msg = None         # the message object behind the handle
        self.scanned = 0        # bytes fed to the open message's scan
        self.closed = False


class WSStream:
    """Serve-side state for ONE upgraded connection (both directions).

    Driven by the serve loop: ``feed()`` per WTPI frame returns the
    verdict futures of every message that frame completed; ``close()``
    finalizes both directions (sidecar-synthesized end frame, connection
    teardown).  Not thread-safe — owned by one connection handler task,
    like the per-connection ``streams`` dict in server.py.
    """

    def __init__(self, batcher, tenant: int, mode: int, stream_id: int,
                 parsers_off: frozenset = frozenset(),
                 msg_cap: int = 1 << 20, max_frame: int = 8 << 20):
        self.batcher = batcher
        self.tenant = tenant
        self.mode = mode
        self.stream_id = stream_id
        self.parsers_off = parsers_off
        self.msg_cap = msg_cap
        self.dirs = (_Direction(max_frame), _Direction(max_frame))
        self.poisoned = False   # ws protocol error: fail-open from here on
        self.messages = 0
        # sticky verdict state: once a message scans as an attack, every
        # later frame verdict of the stream reports it (the enforcing
        # side may have missed the first one mid-tunnel)
        self.attack = False
        self.blocked = False
        self.score = 0
        self.classes: List[str] = []
        self.rule_ids: List[int] = []
        self.sticky_fail_open = False

    # ---------------------------------------------------------- intake

    def feed(self, direction: int, data: bytes) -> List[tuple]:
        """Parse raw captured bytes for one direction; scan message
        increments; return ``(message, verdict_future)`` pairs for the
        messages completed by this call."""
        if self.poisoned:
            return []
        d = self.dirs[direction]
        if d.closed:
            return []
        try:
            frames = d.parser.feed(data)
        except WSError:
            self._poison()
            return []
        pairs: List[tuple] = []
        for fin, opcode, payload in frames:
            if opcode in (OP_PING, OP_PONG):
                continue
            if opcode == OP_CLOSE:
                d.closed = True
                if d.handle is not None:
                    pairs.append((d.msg,
                                  self.batcher.finish_stream(d.handle)))
                    d.handle = None
                continue
            if opcode in _DATA_OPS:
                if d.handle is not None:
                    # data frame while a message is open (RFC 6455 §5.4)
                    self._poison()
                    return pairs
                d.msg = self._new_message(direction)
                d.handle = self.batcher.begin_stream(d.msg)
                d.scanned = 0
                self.messages += 1
            else:  # OP_CONT
                if d.handle is None:
                    self._poison()
                    return pairs
            if payload:
                room = self.msg_cap - d.scanned
                if room > 0:
                    self.batcher.feed_chunk(d.handle, payload[:room])
                    d.scanned += min(len(payload), room)
                if len(payload) > max(room, 0):
                    # beyond msg_cap: bytes pass unscanned (the
                    # per-message DoS bound; StreamState.scan_cap
                    # additionally bounds post-unpack scan work) — the
                    # engine surfaces truncation as fail-open at finish
                    d.handle.truncated = True
            if fin:
                pairs.append((d.msg, self.batcher.finish_stream(d.handle)))
                d.handle = None
        return pairs

    def close(self) -> List[tuple]:
        """End of the upgraded connection: finalize any open messages
        (their scanned prefix still yields a verdict — an attacker must
        not escape scanning by never sending FIN)."""
        pairs: List[tuple] = []
        for d in self.dirs:
            d.closed = True
            if d.handle is not None:
                pairs.append((d.msg, self.batcher.finish_stream(d.handle)))
                d.handle = None
        return pairs

    def abort(self) -> None:
        """Connection handler teardown: free engine state, no verdicts."""
        for d in self.dirs:
            if d.handle is not None:
                self.batcher.abort_stream(d.handle)
                d.handle = None
            d.closed = True

    # --------------------------------------------------------- verdict

    def merge(self, v) -> None:
        """Fold one completed message's verdict into the sticky state."""
        self.attack |= v.attack
        self.blocked |= v.blocked
        self.score = max(self.score, v.score)
        for c in v.classes:
            if c not in self.classes:
                self.classes.append(c)
        for r in v.rule_ids:
            if r not in self.rule_ids and len(self.rule_ids) < 64:
                self.rule_ids.append(r)
        self.sticky_fail_open |= v.fail_open

    def verdict(self, req_id: int):
        from ingress_plus_tpu_torch.models.pipeline import Verdict

        return Verdict(
            request_id=str(req_id), blocked=self.blocked,
            attack=self.attack, classes=list(self.classes),
            rule_ids=list(self.rule_ids), score=self.score,
            fail_open=self.sticky_fail_open or self.poisoned)

    # --------------------------------------------------------- helpers

    def _new_message(self, direction: int):
        cls = WSClientMessage if direction == DIR_C2S else WSServerMessage
        msg = cls(tenant=self.tenant,
                  request_id="%d.%d" % (self.stream_id, self.messages),
                  parsers_off=self.parsers_off)
        msg.mode = self.mode
        return msg

    def _poison(self) -> None:
        self.poisoned = True
        self.abort()
        try:
            self.batcher.pipeline.stats.count_fail_open()
        except Exception:
            pass
