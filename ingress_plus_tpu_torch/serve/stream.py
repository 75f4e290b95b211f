"""Streaming body scan — chunked request and response bodies of any size.

The port of ``ingress_plus_tpu/serve/stream.py`` (BASELINE config #5:
chunked 1 MB POST bodies).  A body is scanned once however it arrives:
the bitap state words (W per scan row) are carried from chunk to chunk,
so a factor that spans a chunk boundary is matched by the carried state,
with no overlap window.

Pieces:

- ``IncrementalVariant`` — streaming normalization: the one-shot
  ``variant_chain`` decoders (urlDecodeUni, htmlEntityDecode, squash)
  applied incrementally, holding back the longest suffix that could be a
  split escape or entity until the next chunk completes it.  Guaranteed:
  concat(feed*, flush) == variant_chain(concat(chunks)).
- ``StreamState`` — per-request carry: per-variant (match, state) words,
  decoder tails, and the capped raw body kept for the confirm stage.
- ``StreamEngine`` — batches the increments of many concurrent streams
  into ``CHUNK_L``-wide waves (power-of-two row counts), scans each wave
  with the per-byte scan of the pipeline engine's device
  (``ops/step_scan.py::StepScanner``: the CUDA kernel on ``cuda``, the
  plain ``scan_bytes`` on ``cpu``), and at stream end folds the final
  match words into rule hits on the host and hands them to
  ``DetectionPipeline.finalize``.

The per-byte scan is the one with an exact state after each row's
length; the pair scan zeroes the state of short rows and cannot chain.
``StreamEngine`` catches no scan error: a kernel fault reaches the
caller.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.bitap import (
    factors_to_rules,
    matches_to_factors,
)
from ingress_plus_tpu_torch.compiler.ruleset import VARIANTS
from ingress_plus_tpu_torch.compiler.seclang import STREAM_INDEX
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline, Verdict
from ingress_plus_tpu_torch.ops.scan import (
    from_numpy_u32,
    pad_rows,
    to_numpy_u32,
)
from ingress_plus_tpu_torch.ops.step_scan import StepScanner
from ingress_plus_tpu_torch.serve.normalize import (
    Request,
    fold_overlong_utf8,
    html_entity_decode,
    remove_nulls,
    squash,
    url_decode_uni_raw,
)
from ingress_plus_tpu_torch.serve.unpack import (
    GZIP_MAGIC,
    IncrementalBase64,
    IncrementalGrpc,
    IncrementalInflate,
    grpc_content_kind,
    header_lookup,
)
from ingress_plus_tpu_torch.utils.trace import (
    EV_STREAM_FINISH,
    EV_STREAM_WAVE,
    flight,
)

# longest suffix that might be an incomplete %-escape: %, %X, %u, %uX..%uXXX
_URL_TAIL = re.compile(rb"%(?:u[0-9a-fA-F]{0,3}|[0-9a-fA-F])?$")
# longest suffix that might be an incomplete &entity; (decoder looks for
# ';' within 9 bytes of '&', so anything longer can never decode)
_ENT_TAIL = re.compile(rb"&[#a-zA-Z0-9]{0,8}$")

CHUNK_L = 2048               # bytes per row of one scan wave
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


@dataclass
class StreamStats:
    """What the stream engine did, on the host clock.  ``wave_us`` is
    the part of ``scan_us`` spent in the scanner's round trip (copies to
    the device, the scan, copies back, which wait for the scan);
    ``finish_us`` includes the confirm stage, over ``finishes`` streams;
    ``feed_us`` is the chunks' incremental decode and normalize
    (``StreamState.feed`` / ``flush``), which the batcher books.  Written
    by one thread at a time: the lane worker while the dispatch thread
    holds the batcher's swap lock, or the oversized side lane holding
    it."""

    waves: int = 0
    wave_rows: int = 0
    scanned_bytes: int = 0
    scan_us: int = 0
    wave_us: int = 0
    finish_us: int = 0
    finishes: int = 0
    feed_us: int = 0


class StreamEngine:
    """Chunk-batch scanner + stream finisher.  Reads the pipeline's live
    tables on every call, so a ruleset swap is seen at once."""

    def __init__(self, pipeline: DetectionPipeline,
                 body_cap: int = DEFAULT_BODY_CAP):
        self.pipeline = pipeline
        self.body_cap = body_cap
        self.stats = StreamStats()
        self._scanner: Optional[StepScanner] = None

    # -------------------------------------------------------- lifecycle

    def begin(self, request: Request,
              body_cap: Optional[int] = None) -> StreamState:
        """``body_cap`` overrides the confirm-buffer bound, for a caller
        that already holds the whole body in memory."""
        p = self.pipeline
        si = STREAM_INDEX[getattr(request, "body_stream", "body")]
        base = [(v, si * len(VARIANTS) + v, 0) for v in range(len(VARIANTS))
                if si * len(VARIANTS) + v in p.needed_sv]
        off = request.parsers_off
        variants = list(base)
        if "base64" not in off:
            # a second row group scanning the incremental base64 decode
            # of the body; costs nothing unless the body is base64-shaped
            variants += [(v, sv, 1) for v, sv, _ in base]
        pb_kind = grpc_content_kind(
            header_lookup(request.headers, "content-type"))
        if "json" not in off and pb_kind is not None:
            # gRPC text-field extraction rows (src=2)
            variants += [(v, sv, 2) for v, sv, _ in base]
        return StreamState(request, variants, p.ruleset.tables.n_words,
                           p.ruleset.version,
                           body_cap if body_cap is not None
                           else self.body_cap, pb_kind=pb_kind)

    # ------------------------------------------------------------ scan

    def scanner(self) -> StepScanner:
        """The step scanner of the pipeline engine's live tables (a new
        one after a ruleset swap)."""
        tables = self.pipeline.engine.tables.scan
        if self._scanner is None or self._scanner.tables is not tables:
            self._scanner = StepScanner(tables)
        return self._scanner

    def _scan_wave(self, scanner: StepScanner, tokens: np.ndarray,
                   lengths: np.ndarray, state: np.ndarray,
                   match: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One wave through the scanner on its tables' device; numpy
        uint32 (match, state) back."""
        dev = scanner.tables.device
        m, s = scanner(torch.from_numpy(tokens).to(dev),
                       torch.from_numpy(lengths),
                       from_numpy_u32(state, dev), from_numpy_u32(match, dev))
        return to_numpy_u32(m), to_numpy_u32(s)

    def scan(self, items: List[Tuple[StreamState, int, bytes]]) -> None:
        """Scan increments for many (stream, variant) rows, batched into
        CHUNK_L-wide waves.  Items for the same (stream, variant) are
        concatenated in arrival order (the state carry makes that
        exact)."""
        t0 = time.perf_counter()
        merged: Dict[Tuple[int, int], List] = {}
        for st, vi, data in items:
            if st.aborted or st.error:
                continue
            if st.version != self.pipeline.ruleset.version:
                # ruleset swapped mid-stream: the old state words mean
                # nothing against the new tables → fail-open at finish
                st.error = True
                continue
            merged.setdefault((id(st), vi), [st, vi, bytearray()])[2].extend(
                data)
        all_rows = list(merged.values())
        if not all_rows:
            return
        # Rows whose (state, match, pending bytes) are byte-identical
        # give identical results, so one representative is scanned and
        # its result broadcast.  Common case: a plain-ASCII body makes
        # several variants' increments equal and their states stay equal.
        groups: Dict[bytes, List] = {}
        for r in all_rows:
            st, vi, data = r
            key = (st.state[vi].tobytes() + st.match[vi].tobytes()
                   + bytes(data))
            groups.setdefault(key, []).append(r)
        rows = [g[0] for g in groups.values()]
        followers = {id(g[0]): g[1:] for g in groups.values()}
        scanner = self.scanner()
        offs = [0] * len(rows)
        stats = self.stats
        while True:
            wave = [(i, r) for i, r in enumerate(rows)
                    if offs[i] < len(r[2])]
            if not wave:
                break
            chunks = []
            for i, r in wave:
                seg = bytes(r[2][offs[i] : offs[i] + CHUNK_L])
                offs[i] += len(seg)
                chunks.append(seg)
            B = 8
            while B < len(wave):
                B *= 2
            tokens, lengths = pad_rows(
                chunks + [b""] * (B - len(wave)),
                max_len=CHUNK_L, round_to=CHUNK_L)
            W = wave[0][1][0].state.shape[1]
            state = np.zeros((B, W), np.uint32)
            match = np.zeros_like(state)
            for j, (i, r) in enumerate(wave):
                st, vi = r[0], r[1]
                state[j] = st.state[vi]
                match[j] = st.match[vi]
            tw = time.perf_counter()
            flight.begin(EV_STREAM_WAVE, arg=len(wave))
            try:
                m_out, s_out = self._scan_wave(scanner, tokens, lengths,
                                               state, match)
            finally:
                flight.end(EV_STREAM_WAVE)
            stats.wave_us += int((time.perf_counter() - tw) * 1e6)
            stats.waves += 1
            stats.wave_rows += len(wave)
            stats.scanned_bytes += int(lengths.sum())
            for j, (i, r) in enumerate(wave):
                for st, vi, _ in (r, *followers[id(r)]):
                    st.state[vi] = s_out[j]
                    st.match[vi] = m_out[j]
        stats.scan_us += int((time.perf_counter() - t0) * 1e6)

    # ---------------------------------------------------------- finish

    def finish(self, st: StreamState) -> Verdict:
        tf = time.perf_counter()
        flight.begin(EV_STREAM_FINISH, arg=st.body_len)
        try:
            return self._finish(st)
        finally:
            flight.end(EV_STREAM_FINISH)
            self.stats.finish_us += int((time.perf_counter() - tf) * 1e6)
            self.stats.finishes += 1

    def _finish(self, st: StreamState) -> Verdict:
        p = self.pipeline
        req = st.request
        if st.error or st.version != p.ruleset.version:
            p.stats.count_fail_open()
            return Verdict(request_id=req.request_id, blocked=False,
                           attack=False, classes=[], rule_ids=[], score=0,
                           fail_open=True, elapsed_us=int(
                               (time.perf_counter() - st.t0) * 1e6))
        cr = p.ruleset
        bt = cr.tables
        R = cr.n_rules
        body_hits = np.zeros((R,), dtype=bool)
        applies_any = np.zeros((R,), dtype=bool)
        for vi, (_v, sv, _src) in enumerate(st.variants):
            rr = factors_to_rules(bt, matches_to_factors(bt, st.match[vi]))
            applies = cr.rule_sv_mask[:, sv]
            body_hits |= rr & applies
            applies_any |= applies
        # rules with no prefilter factors must always reach confirm when
        # any applicable row was scanned (as the engine's mapping does)
        body_hits |= (bt.rule_nfactors == 0) & applies_any

        hits = body_hits
        if st.base_hits is not None:
            hits = hits | st.base_hits
        hits = p.mask_hits([req], hits[None])

        # confirm runs on the accumulated (capped) raw body, with the
        # request's parsers_off carried over so both stages see the same
        # bytes; dataclasses.replace keeps the concrete type (a Response
        # stays a Response, so its resp_* streams rebuild)
        confirm_req = replace(req, body=bytes(st.acc))
        v = p.finalize([confirm_req], hits, st.t0)[0]
        # scan/confirm caps were hit: the verdict rests on a prefix —
        # surface it the fail-open way (pass and flag, never silently)
        if st.truncated and not v.attack:
            v.fail_open = True
        p.stats.requests += 1
        return v
