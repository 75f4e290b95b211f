"""Copy of the port's ``utils/stream_corpus.py`` for the benchmark's traffic (its requests
are the reference's ``Request``).  Its original docstring follows.

Seeded streaming bodies — the stream lane's traffic.

BASELINE config #5 streams chunked POST bodies of about 1 MB.  Each
:class:`StreamCase` is one such body and the request (or response) it
belongs to, with any planted attack placed where it is hardest for a
chunked scan: across a chunk boundary, inside a split %-escape, at the
tail of a gzip stream, under base64, or only in the URI.  The filler is
benign form text, so a clean verdict is expected wherever no attack was
planted.

:func:`drive_streams` runs the cases through a stream engine the way an
oversized body is driven: ``begin`` with the whole body as the confirm
cap, the prefilter of the body-less request as base hits, fixed-size
chunks, ``scan``, ``flush``, ``finish``.  The streams are interleaved
chunk by chunk, so each ``scan`` call carries every stream's increment.
"""

from __future__ import annotations

import base64
import gzip
from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

from wafbench.reference.normalize import Request, Response

_WORDS = (b"lorem ipsum dolor sit amet consectetur adipiscing elit sed do "
          b"eiusmod tempor incididunt ut labore et dolore magna aliqua enim "
          b"ad minim veniam quis nostrud exercitation ullamco laboris nisi "
          b"aliquip ex ea commodo consequat duis aute irure in reprehenderit "
          b"voluptate velit esse cillum fugiat nulla pariatur excepteur sint "
          b"occaecat cupidatat non proident sunt culpa qui officia deserunt "
          b"mollit anim id est laborum").split()

SQLI = b"1' UNION SELECT password FROM users--"
XSS_ESCAPED = b"%3Cscript%3Ealert(document.cookie)%3C%2Fscript%3E"
XSS = b"<script>alert(document.cookie)</script>"
SQL_ERROR_LEAK = (b"You have an error in your SQL syntax; check the manual "
                  b"that corresponds to your MySQL server version")


@dataclass
class StreamCase:
    name: str
    #: the request (or response) without its body
    meta: Union[Request, Response]
    #: the body as it arrives, chunked by drive_streams
    body: bytes
    #: an attack was planted and the verdict must report it
    attack: bool


def filler(n: int, rng: np.random.Generator, sep: bytes = b"+") -> bytes:
    """``n`` bytes of benign form text: words joined by ``sep``."""
    n = max(n, 0)
    words = [_WORDS[i] for i in rng.integers(0, len(_WORDS), n // 3 + 8)]
    out = sep.join(words)
    while len(out) < n:
        out += sep + out
    return out[:n]


def _around(prefix: bytes, payload: bytes, cut: int, at: int, size: int,
            rng: np.random.Generator) -> bytes:
    """``prefix`` + filler + ``payload`` + filler, ``size`` bytes in all,
    with ``payload[cut]`` at offset ``at`` (a chunk boundary)."""
    start = at - cut
    head = prefix + filler(start - len(prefix), rng)
    tail = filler(max(size - start - len(payload), 0), rng)
    return head + payload + tail


def stream_cases(body_size: int, chunk: int, seed: int) -> List[StreamCase]:
    """Seven streams of about ``body_size`` bytes each; ``chunk`` is the
    chunk size ``drive_streams`` will use, so planted attacks can
    straddle its boundaries (``body_size`` must leave two chunks)."""
    if body_size < 2 * chunk:
        raise ValueError("body_size %d leaves fewer than two chunks of %d"
                         % (body_size, chunk))
    rng = np.random.default_rng(seed)
    mid = (body_size // chunk // 2) * chunk     # a chunk boundary
    form = {"host": "shop.example.com",
            "user-agent": "Mozilla/5.0 (X11; Linux x86_64) Firefox/128.0",
            "content-type": "application/x-www-form-urlencoded"}

    def post(name, body, headers=None, uri="/api/v1/upload"):
        h = dict(form if headers is None else headers)
        h["content-length"] = str(len(body))
        return Request(method="POST", uri=uri, headers=h,
                       request_id="stream-" + name)

    out = []

    def add(name, body, attack, meta=None):
        out.append(StreamCase(name, meta or post(name, body), body, attack))

    add("benign_form", b"comment=" + filler(body_size - 8, rng), False)
    # the boundary falls between UNION and SELECT
    add("sqli_split", _around(b"comment=", SQLI, SQLI.index(b" SELECT"), mid,
                              body_size, rng), True)
    # the boundary falls inside the first %3C
    add("xss_escape_split", _around(b"comment=", XSS_ESCAPED, 2, mid,
                                    body_size, rng), True)
    raw = b"comment=" + filler(body_size - 8 - len(SQLI), rng) + SQLI
    gz = gzip.compress(raw, mtime=0)
    add("gzip_tail", gz, True, post("gzip_tail", gz, dict(
        form, **{"content-encoding": "gzip"})))
    raw = _around(b"", XSS, 0, body_size * 3 // 8, body_size * 3 // 4, rng)
    b64 = base64.b64encode(raw)
    add("base64_hidden", b64, True, post("base64_hidden", b64, dict(
        form, **{"content-type": "application/octet-stream"})))
    body = b"comment=" + filler(body_size - 8, rng)
    add("uri_only", body, True, post(
        "uri_only", body,
        uri="/search?q=1'+UNION+SELECT+password+FROM+users--"))
    page = _around(b"<html><body><p>", SQL_ERROR_LEAK, 0, mid, body_size,
                   np.random.default_rng(seed + 1))
    page = page.replace(b"+", b" ")
    add("response_leak", page, True, Response(
        status=500, headers={"content-type": "text/html",
                             "content-length": str(len(page))},
        request_id="stream-response_leak"))
    return out


def drive_streams(engine, cases: Sequence[StreamCase], chunk: int,
                  metas: Sequence = None) -> list:
    """Run ``cases`` through ``engine`` (a ``StreamEngine``), interleaved
    chunk by chunk; returns one verdict per case.  ``metas`` replaces
    each case's meta (the same request in another package's types)."""
    metas = [c.meta for c in cases] if metas is None else list(metas)
    states = []
    for c, meta in zip(cases, metas):
        st = engine.begin(meta, body_cap=len(c.body))
        st.base_hits = engine.pipeline.prefilter([meta])[0]
        states.append(st)
    longest = max((len(c.body) for c in cases), default=0)
    for off in range(0, longest, chunk):
        items = []
        for c, st in zip(cases, states):
            if off < len(c.body):
                items += st.feed(c.body[off:off + chunk])
        engine.scan(items)
    items = []
    for st in states:
        items += st.flush()
    engine.scan(items)
    return [engine.finish(st) for st in states]
