"""The one traffic generator.  A mix is a data file,
``wafbench/traffic/<name>.json``, whose ``kind`` picks the body shape
and whose other keys are its parameters; :class:`Traffic` turns a mix
and a seed into the units a run sends, in order, each one request's wire
frames and, for the reference, what the frames carry.

Kinds:

``web``
    BASELINE config #1's mix: :func:`wafbench.corpus.generate_corpus`'s
    requests, drawn one after another from the seed
    (``attack_fraction`` of them attacks), each given its own
    ``x-request-id`` header (32 hex digits, as ingress-nginx sets it), so
    that no two requests of a run are the same bytes.
``upload``
    BASELINE config #5's streamed bodies: ``body_bytes`` each, sent in
    ``chunk_bytes`` chunk frames after a streaming request frame.  Each
    ``block`` of consecutive uploads holds every body shape of ``bodies``
    (``form``, ``json``, ``base64``, ``gzip``) equally often, and of each
    shape ``attack_fraction`` carry one planted attack, in an order drawn
    from the seed: a run of a few dozen uploads then does the same work
    whatever the seed (a gzip upload sends a quarter of the bytes it
    inflates to, so a seed's share of them would move the rate).  The
    attack is placed as :func:`wafbench.stream_corpus.stream_cases` places
    them: across a chunk boundary or inside a split %-escape (form, json),
    under base64, or at the tail of a gzip stream.

``load`` says how the units are sent (:mod:`wafbench.loadgen`):
``{"loop": "closed", "connections": C, "in_flight": N}`` keeps N units
outstanding on each of C connections (``stagger_s``: connection k starts
k * stagger_s seconds into the warm-up).  ``warmup`` is what comes
before the measured window (:mod:`wafbench.loadgen`): ``{"seconds": W}``
or ``{"units": N}``.
"""

from __future__ import annotations

import base64
import gzip
import json
import random
from dataclasses import dataclass, replace
from pathlib import Path
from typing import List, Optional

import numpy as np

from wafbench import corpus, stream_corpus
from wafbench.reference.normalize import Request
from wafbench.wire import MODE_BLOCK, MODE_STREAM, encode_chunk, encode_request

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

_HOST = "shop.example.com"
_AGENT = "Mozilla/5.0 (X11; Linux x86_64) Firefox/128.0"


@dataclass
class Unit:
    """One request as the client sends it and the reference reads it."""

    req_id: int
    frames: List[bytes]
    #: the request (an upload: without its body)
    request: Request
    #: an upload's body chunks as sent; None for a buffered request
    chunks: Optional[List[bytes]] = None

    @property
    def body_bytes(self) -> int:
        if self.chunks is not None:
            return sum(len(c) for c in self.chunks)
        return len(self.request.body)


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / (name + ".json")).read_text())


def iter_corpus(attack_fraction: float, seed: int):
    """``generate_corpus(n, attack_fraction, seed)``'s requests, one at a
    time and without end: its first n are that list's."""
    rng = random.Random(seed)
    i = 0
    while True:
        if rng.random() < attack_fraction:
            yield corpus._attack(rng, i).request
        else:
            yield corpus._benign(rng, i)
        i += 1


class Traffic:
    """The units of one mix and seed, generated on demand in order
    (``unit(i)`` for i = 0, 1, ...; the wire req_id is i + 1)."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.kind = mix["kind"]
        if self.kind not in ("web", "upload"):
            raise ValueError("unknown traffic kind %r" % self.kind)
        self._units: List[Unit] = []
        self._ids = random.Random("%d/x-request-id" % self.seed)
        if self.kind == "web":
            self._corpus = iter_corpus(float(mix["attack_fraction"]),
                                       self.seed)

    def unit(self, i: int) -> Unit:
        while len(self._units) <= i:
            self._units.append(self._make(len(self._units)))
        return self._units[i]

    def _request_id(self) -> str:
        return "%032x" % self._ids.getrandbits(128)

    def _make(self, i: int) -> Unit:
        rid = self._request_id()
        if self.kind == "web":
            req = next(self._corpus)
            req = replace(req, headers=dict(req.headers,
                                            **{"x-request-id": rid}))
            return Unit(i + 1, [encode_request(req, i + 1, MODE_BLOCK)], req)
        meta, body = self._upload(i, rid)
        step = int(self.mix["chunk_bytes"])
        chunks = [body[o:o + step] for o in range(0, len(body), step)]
        frames = [encode_request(meta, i + 1, MODE_BLOCK | MODE_STREAM)]
        frames += [encode_chunk(i + 1, c, last=(k == len(chunks) - 1))
                   for k, c in enumerate(chunks)]
        return Unit(i + 1, frames, meta, chunks)

    def _block(self, b: int) -> List[tuple]:
        """The (body shape, attack) of each upload of block ``b``."""
        mix = self.mix
        shapes = mix["bodies"]
        per = int(mix["block"]) // len(shapes)
        if per * len(shapes) != int(mix["block"]):
            raise ValueError("block %s is not a multiple of %d body shapes"
                             % (mix["block"], len(shapes)))
        attacks = round(float(mix["attack_fraction"]) * per)
        plan = [(k, j < attacks) for k in shapes for j in range(per)]
        order = np.random.default_rng([self.seed, b, 7]).permutation(len(plan))
        return [plan[j] for j in order]

    def _upload(self, i: int, rid: str):
        mix = self.mix
        size = int(mix["body_bytes"])
        step = int(mix["chunk_bytes"])
        rng = np.random.default_rng([self.seed, i])
        kind, attack = self._block(i // int(mix["block"]))[
            i % int(mix["block"])]
        # a chunk boundary away from both ends
        at = step * int(rng.integers(1, max(size // step, 2)))
        sc = stream_corpus
        headers = {"host": _HOST, "user-agent": _AGENT,
                   "content-type": "application/x-www-form-urlencoded",
                   "x-request-id": rid}
        if kind == "form":
            if not attack:
                body = b"comment=" + sc.filler(size - 8, rng)
            elif rng.random() < 0.5:
                # the boundary falls between UNION and SELECT
                body = sc._around(b"comment=", sc.SQLI,
                                  sc.SQLI.index(b" SELECT"), at, size, rng)
            else:
                # the boundary falls inside the first %3C
                body = sc._around(b"comment=", sc.XSS_ESCAPED, 2, at, size,
                                  rng)
        elif kind == "json":
            headers["content-type"] = "application/json"
            head, tail = b'{"comment": "', b'"}'
            inner = size - len(head) - len(tail)
            if attack:
                text = sc._around(b"", sc.SQLI, sc.SQLI.index(b" SELECT"),
                                  at - len(head), inner, rng)
            else:
                text = sc.filler(inner, rng, sep=b" ")
            body = head + text.replace(b"+", b" ") + tail
        elif kind == "base64":
            headers["content-type"] = "application/octet-stream"
            n = size * 3 // 4
            raw = (sc._around(b"", sc.XSS, 0, int(rng.integers(n // 8, n // 2)),
                              n, rng) if attack else sc.filler(n, rng))
            body = base64.b64encode(raw)
        elif kind == "gzip":
            headers["content-encoding"] = "gzip"
            raw = b"comment=" + sc.filler(
                size - 8 - (len(sc.SQLI) if attack else 0), rng)
            if attack:
                raw += sc.SQLI
            body = gzip.compress(raw, mtime=0)
        else:
            raise ValueError("unknown body shape %r" % kind)
        headers["content-length"] = str(len(body))
        meta = Request(method="POST", uri="/api/v1/upload", headers=headers,
                       request_id="upload-%d" % i)
        return meta, body
