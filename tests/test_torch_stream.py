"""The port's stream lane against the JAX package's, on the CPU.

The JAX side is ``serve/stream.py``'s ``StreamEngine`` on a
``DetectionPipeline(scan_impl="pair")``; the port's ``StreamEngine`` runs
on a ``device="cpu"`` pipeline, whose step scanner is the plain
``scan_bytes``.  Both load the committed bundled pack and are driven with
the same seeded bodies and chunks.  Tolerance: none — normalized bytes
and verdict fields must be equal.
"""

import dataclasses

import numpy as np
import pytest

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve import normalize as jnorm
from ingress_plus_tpu.serve.stream import StreamEngine as JaxStreamEngine
from ingress_plus_tpu_torch.compiler.bitap import reference_scan
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve import normalize as tnorm
from ingress_plus_tpu_torch.serve.stream import (
    IncrementalVariant,
    StreamEngine,
)
from ingress_plus_tpu_torch.utils.stream_corpus import (
    drive_streams,
    filler,
    stream_cases,
)
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

SEED = 20260729
BODY, CHUNK = 4000, 1000
NAMES = ("benign_form", "sqli_split", "xss_escape_split", "gzip_tail",
         "base64_hidden", "uri_only", "response_leak")

PAYLOADS = [
    b"hello%20world%u0041&lt;script&gt;alert(1)",
    b"a=1%2",                      # trailing incomplete escape
    b"x&#x3C;script&#62;y&amp",    # entities, one unterminated
    b"%75nion%20%73elect a from b",
    b"plain ascii only",
    b"&#none;&bogus;%zz%",         # junk escapes pass through
    b"a\xc0\xbcscript\xe0\x80\xbcb%c0%af",   # overlong UTF-8, raw and escaped
    b"%u003cscript%u003e%00x\x00y+z",
]


@pytest.mark.parametrize("variant", range(6))
@pytest.mark.parametrize("payload", PAYLOADS)
def test_incremental_variant_equals_variant_chain(variant, payload):
    """Every split point reproduces the JAX one-shot normalization."""
    want = jnorm.variant_chain(payload, variant)
    assert tnorm.variant_chain(payload, variant) == want
    for cut in range(len(payload) + 1):
        inc = IncrementalVariant(variant)
        got = inc.feed(payload[:cut]) + inc.feed(payload[cut:]) + inc.flush()
        assert got == want, (variant, cut, payload)


def test_incremental_variant_many_chunks():
    payload = (b"a%3Cscript%3E" * 50) + b"&lt;" * 30 + b"%u0041%4"
    for variant in range(6):
        inc = IncrementalVariant(variant)
        got = b"".join(inc.feed(payload[i:i + 7])
                       for i in range(0, len(payload), 7)) + inc.flush()
        assert got == jnorm.variant_chain(payload, variant)


@pytest.fixture(scope="module")
def lanes():
    """(JAX pipeline, port CPU pipeline) on the bundled pack."""
    jpl = JaxPipeline(JaxRuleset.load(BUNDLED_PACK), scan_impl="pair",
                      fail_open=False)
    tpl = DetectionPipeline(load_pack(), device="cpu", fail_open=False)
    return jpl, tpl


@pytest.fixture(scope="module")
def cases():
    return {c.name: c for c in stream_cases(BODY, CHUNK, SEED)}


def _jax_meta(m):
    cls = jnorm.Response if isinstance(m, tnorm.Response) else jnorm.Request
    return cls(**{f.name: getattr(m, f.name)
                  for f in dataclasses.fields(cls)})


def _key(v):
    return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids), v.score,
            v.classes, v.matches, v.fail_open, v.generation)


def test_stream_cases_cover_every_body_kind(cases):
    assert tuple(cases) == NAMES
    assert [c.attack for c in cases.values()] == [False] + [True] * 6
    assert cases["gzip_tail"].body[:2] == b"\x1f\x8b"
    assert isinstance(cases["response_leak"].meta, tnorm.Response)


@pytest.mark.parametrize("name", NAMES)
def test_stream_verdict_equals_jax(lanes, cases, name):
    jpl, tpl = lanes
    c = cases[name]
    got = drive_streams(StreamEngine(tpl), [c], CHUNK)[0]
    want = drive_streams(JaxStreamEngine(jpl), [c], CHUNK,
                         metas=[_jax_meta(c.meta)])[0]
    assert _key(got) == _key(want)
    assert got.attack == c.attack and not got.fail_open


def test_interleaved_streams_equal_jax(lanes, cases):
    """All kinds at once, interleaved chunk by chunk: one scan call
    carries every stream's increment, and rows of different streams share
    waves."""
    jpl, tpl = lanes
    cs = list(cases.values())
    eng = StreamEngine(tpl)
    got = drive_streams(eng, cs, CHUNK)
    want = drive_streams(JaxStreamEngine(jpl), cs, CHUNK,
                         metas=[_jax_meta(c.meta) for c in cs])
    assert [_key(v) for v in got] == [_key(v) for v in want]
    assert [v.attack for v in got] == [c.attack for c in cs]
    st = eng.stats
    assert st.waves > 0 and st.wave_rows > st.waves
    assert st.scanned_bytes >= sum(len(c.body) for c in cs) // 2


def _run_capped(engine, meta, body, cap):
    st = engine.begin(meta, body_cap=len(body))
    st.base_hits = engine.pipeline.prefilter([meta])[0]
    st.scan_cap = cap
    for off in range(0, len(body), CHUNK):
        engine.scan(st.feed(body[off:off + CHUNK]))
    engine.scan(st.flush())
    return st, engine.finish(st)


def test_scan_cap_truncation_fails_open(lanes, cases):
    """Bytes past scan_cap pass unscanned, and the verdict says so; with
    no cap the same body is an attack (its LFI rules have prefilter
    factors, so only the scan puts them before the confirm stage)."""
    jpl, tpl = lanes
    meta = cases["benign_form"].meta
    rng = np.random.default_rng(SEED)
    body = (b"comment=" + filler(1500, rng) + b"../../etc/passwd"
            + filler(1000, rng))
    st, got = _run_capped(StreamEngine(tpl), meta, body, 64)
    jst, want = _run_capped(JaxStreamEngine(jpl), _jax_meta(meta), body, 64)
    assert _key(got) == _key(want)
    assert got.fail_open and not got.attack
    assert st.truncated and jst.truncated
    _, whole = _run_capped(StreamEngine(tpl), meta, body, 1 << 20)
    assert whole.attack and not whole.fail_open


def _run_swapped(pipeline, engine, meta, body, swap_to):
    original = pipeline.ruleset
    st = engine.begin(meta, body_cap=len(body))
    st.base_hits = pipeline.prefilter([meta])[0]
    engine.scan(st.feed(body[:CHUNK]))
    pipeline.swap_ruleset(swap_to)
    try:
        for off in range(CHUNK, len(body), CHUNK):
            engine.scan(st.feed(body[off:off + CHUNK]))
        engine.scan(st.flush())
        return st, engine.finish(st)
    finally:
        pipeline.swap_ruleset(original)


def test_ruleset_swap_mid_stream_fails_open(lanes, cases):
    """A stream begun under one ruleset generation cannot finish under
    another: its state words mean nothing against the new tables."""
    jpl, tpl = lanes
    c = cases["sqli_split"]
    jcr, tcr = JaxRuleset.load(BUNDLED_PACK), load_pack()
    jcr.version = tcr.version = "swapped-generation"
    before = tpl.stats.fail_open
    eng = StreamEngine(tpl)
    old_scanner = eng.scanner()
    st, got = _run_swapped(tpl, eng, c.meta, c.body, tcr)
    _, want = _run_swapped(jpl, JaxStreamEngine(jpl), _jax_meta(c.meta),
                           c.body, jcr)
    assert _key(got) == _key(want)
    assert got.fail_open and not got.attack and st.error
    assert tpl.stats.fail_open == before + 1
    # the engine's scanner follows the live tables, never a cached set
    assert eng.scanner() is not old_scanner
    assert eng.scanner().tables is tpl.engine.tables.scan


def test_chunking_does_not_change_the_carry(lanes, cases):
    """The carried state and match words after a stream do not depend on
    how the body was cut: 1000-byte chunks, 1-byte-odd 333-byte chunks
    and the whole body in one chunk end in identical words."""
    _, tpl = lanes
    c = cases["xss_escape_split"]
    words = []
    for chunk in (CHUNK, 333, len(c.body)):
        eng = StreamEngine(tpl)
        st = eng.begin(c.meta, body_cap=len(c.body))
        for off in range(0, len(c.body), chunk):
            eng.scan(st.feed(c.body[off:off + chunk]))
        eng.scan(st.flush())
        words.append((st.state.copy(), st.match.copy()))
    for s, m in words[1:]:
        np.testing.assert_array_equal(s, words[0][0])
        np.testing.assert_array_equal(m, words[0][1])
    assert words[0][1].any()


def test_tiny_chunks_carry_state_across_every_boundary(lanes, cases):
    """Three-byte chunks split every factor longer than three bytes: each
    variant's match words after the stream must equal the numpy oracle's
    one-shot scan of the whole normalized body, which only a state
    carried across every chunk (and every wave) can give."""
    jpl, tpl = lanes
    meta = cases["benign_form"].meta
    body = (b"q=1'+UNION+SELECT+password+FROM+users--&c=%3Cscript%3E"
            b"alert(1)%3C%2Fscript%3E")
    eng = StreamEngine(tpl)
    st = eng.begin(meta, body_cap=len(body))
    st.base_hits = tpl.prefilter([meta])[0]
    for off in range(0, len(body), 3):
        eng.scan(st.feed(body[off:off + 3]))
    eng.scan(st.flush())
    checked = 0
    for vi, (v, _sv, src) in enumerate(st.variants):
        if src == 0:
            want = reference_scan(tpl.ruleset.tables,
                                  tnorm.variant_chain(body, v))
            np.testing.assert_array_equal(st.match[vi], want)
            checked += 1
    assert checked >= 2 and st.match.any()
    got = eng.finish(st)
    jeng = JaxStreamEngine(jpl)
    jmeta = _jax_meta(meta)
    jst = jeng.begin(jmeta, body_cap=len(body))
    jst.base_hits = jpl.prefilter([jmeta])[0]
    for off in range(0, len(body), 3):
        jeng.scan(jst.feed(body[off:off + 3]))
    jeng.scan(jst.flush())
    assert _key(got) == _key(jeng.finish(jst))
    assert got.attack and eng.stats.waves > len(body) // 3
