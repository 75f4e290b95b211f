"""The confirm's whitespace transforms in C++ against their Python bodies,
on the CPU.

``csrc/transforms.cc`` (``models/native_transforms.py``), built by g++ at
first use into the port's build directory, must give byte for byte what
``t_compresswhitespace_py`` and ``t_removewhitespace_py`` (``re.sub``)
give: on random strings over the whitespace bytes and their neighbours,
on random bytes, on edges (empty, all whitespace, leading and trailing
runs, every byte value, 1 MiB of whitespace), and on the eight 1 MiB
upload bodies of the ``1mib.closed8`` traffic, raw and url-decoded.  The
same strings go through an ASan + UBSan build of both (the runner
``csrc/transforms_check.cc``).  ``IPT_NO_NATIVE_CONFIRM`` selects the
Python bodies; stream verdicts are equal either way; the long-value
counters of ``/metrics`` advance on a long value alone.  Tolerance: none.
"""

from __future__ import annotations

import ctypes
import os
import random

import pytest

import chip_smoke
from ingress_plus_tpu_torch.models import confirm
from ingress_plus_tpu_torch.models import native_transforms as nt
from ingress_plus_tpu_torch.ops import cuda_build
from ingress_plus_tpu_torch.serve.normalize import url_decode_uni
from wafbench.gen import Traffic, load_mix

ENV = "IPT_NO_NATIVE_CONFIRM"
#: the bytes of Python's bytes ``\s`` and those beside them that are not
ALPHABET = b" \t\n\v\f\r\x1c\x1d\x1e\x1f\x85\xa0a\x00"
WHITESPACE = b" \t\n\v\f\r"
#: one large seed of the kind the benchmark draws
UPLOAD_SEED = 3_405_691_582

#: transform -> (the dispatching function, its Python body)
PAIRS = {
    "compressWhitespace": ("t_compresswhitespace", "t_compresswhitespace_py"),
    "removeWhitespace": ("t_removewhitespace", "t_removewhitespace_py"),
}


def _alphabet_strings():
    rng = random.Random(20260729)
    return [bytes(rng.choice(ALPHABET) for _ in range(rng.randint(0, 40)))
            for _ in range(20000)]


def _urandom_strings():
    out = [os.urandom(random.randint(0, 300)) for _ in range(2000)]
    return out + [os.urandom(1 << 16) for _ in range(4)]


def _edges():
    out = [b"", bytes(range(256)), bytes(range(255, -1, -1))]
    out += [bytes([b]) for b in range(256)]
    out += [bytes([b]) * k for b in WHITESPACE for k in (2, 3, 17)]
    out += [WHITESPACE, WHITESPACE * 50, b" a", b"a ", b"  a", b"a  ",
            b" a ", b"\ta\t", b"\n\na b\r\n", b"a \x0b b", b" \x1c ",
            b"\x85 \xa0", b"a" * 1000 + b" \t" * 300 + b"b", b"a b c d"]
    rng = random.Random(7)
    for _ in range(200):
        core = bytes(rng.choice(b"ab ") for _ in range(rng.randint(0, 20)))
        lead = bytes(rng.choice(WHITESPACE) for _ in range(rng.randint(0, 4)))
        trail = bytes(rng.choice(WHITESPACE) for _ in range(rng.randint(0, 4)))
        out.append(lead + core + trail)
    out += [b" " * (1 << 20), WHITESPACE * ((1 << 20) // 6)]
    return out


def _uploads():
    """The ``1mib.closed8`` upload bodies 0-7 of one seed, raw and
    url-decoded (the confirm's raw body and its decoded form)."""
    traffic = Traffic(load_mix("1mib.closed8"), UPLOAD_SEED)
    bodies = [b"".join(traffic.unit(i).chunks) for i in range(8)]
    return bodies + [url_decode_uni(b) for b in bodies]


FAMILIES = {
    "alphabet": _alphabet_strings,
    "urandom": _urandom_strings,
    "edges": _edges,
    "uploads_1mib": _uploads,
}


@pytest.fixture(scope="module")
def strings():
    return {k: f() for k, f in FAMILIES.items()}


@pytest.fixture(scope="module")
def sanitized(strings):
    """Every family's strings through one run of the sanitized build:
    {family: [(string, (compressed, removed))]}, its stderr and exit
    code."""
    flat = [s for v in strings.values() for s in v]
    got, err, rc = nt.run_sanitized(flat)
    out, at = {}, 0
    for k, v in strings.items():
        out[k] = list(zip(v, got[at:at + len(v)]))
        at += len(v)
    return out, len(flat), len(got), err, rc


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_native_equals_python(strings, family, name, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    native, py = (getattr(confirm, f) for f in PAIRS[name])
    assert confirm.TRANSFORMS[name] is native
    changed = 0
    for data in strings[family]:
        got, want = native(data), py(data)
        assert got == want, "%s %s on %r: %r, want %r" % (
            name, family, data[:80], got[:80], want[:80])
        assert type(got) is bytes
        changed += got is not data
    assert changed > 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_sanitized_build_equals_python_and_reports_nothing(
        sanitized, family):
    rows, n, ran, err, rc = sanitized
    for report in chip_smoke.SANITIZER_REPORTS:
        assert report not in err, err[-4000:]
    assert rc == 0 and ran == n, err[-4000:]
    for data, (compressed, removed) in rows[family]:
        assert compressed == confirm.t_compresswhitespace_py(data), data[:80]
        assert removed == confirm.t_removewhitespace_py(data), data[:80]


def test_the_sanitized_build_is_an_asan_ubsan_build_of_both_sources():
    path = nt.sanitized_binary()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("transforms_check_")
    data = path.read_bytes()
    assert b"__asan_init" in data and b"__ubsan_handle" in data
    assert b"ipt_compress_whitespace" in data
    assert b"ipt_remove_whitespace" in data
    assert nt.run_sanitized([]) == ([], "", 0)


def test_build_lands_in_the_port_build_dir_with_the_twins_flags():
    path = nt._LIB.build()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libtransforms_") and path.exists()
    assert nt._LIB.flags == cuda_build.GXX_FLAGS
    assert nt._LIB.compiler == "g++"
    # microsecond calls keep the interpreter lock, as the twin's do
    assert isinstance(nt._LIB.load(), ctypes.PyDLL)


def test_a_value_that_needs_no_change_comes_back_as_itself(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    compress, remove = confirm.t_compresswhitespace, confirm.t_removewhitespace
    for data in (b"", b"abc", b"a b c", b" a b ", b"\x1c\x85\xa0"):
        assert compress(data) is data
    for data in (b"", b"abc", b"\x1c\x85\xa0\x00"):
        assert remove(data) is data
    for data in (b"a  b", b"a\tb", b"\n", b"a\x0bb"):
        assert compress(data) is not data
    for data in (b" ", b"a b", b"\r"):
        assert remove(data) is not data
    traffic = Traffic(load_mix("1mib.closed8"), UPLOAD_SEED)
    b64 = [u for u in (traffic.unit(i) for i in range(20))
           if u.request.headers["content-type"] == "application/octet-stream"]
    assert b64
    for unit in b64:
        body = b"".join(unit.chunks)
        assert compress(body) is body and remove(body) is body


def test_the_switch_selects_the_python_bodies(monkeypatch):
    calls = []
    for name in ("t_compresswhitespace_py", "t_removewhitespace_py"):
        fn = getattr(confirm, name)
        monkeypatch.setattr(confirm, name,
                            lambda d, fn=fn, name=name:
                            calls.append(name) or fn(d))
    monkeypatch.delenv(ENV, raising=False)
    assert nt.native_transforms() is nt._LIB.load()
    assert confirm.apply_transforms(
        b" a \t b ", ["compressWhitespace", "removeWhitespace"]) == b"ab"
    assert calls == []
    monkeypatch.setenv(ENV, "1")
    assert nt.native_transforms() is None
    assert confirm.apply_transforms(
        b" a \t b ", ["compressWhitespace", "removeWhitespace"]) == b"ab"
    assert calls == ["t_compresswhitespace_py", "t_removewhitespace_py"]


def _key(v):
    return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids), v.score,
            v.classes, v.matches, v.fail_open)


def test_stream_verdicts_are_equal_with_and_without_the_switch(monkeypatch):
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.stream import StreamEngine
    from ingress_plus_tpu_torch.utils.stream_corpus import (
        drive_streams,
        stream_cases,
    )
    from ingress_plus_tpu_torch.weights import load_pack

    cases = stream_cases(4000, 1000, 20260729)
    native = []
    monkeypatch.setattr(confirm, "compress_whitespace",
                        lambda d, fn=confirm.compress_whitespace:
                        native.append(len(d)) or fn(d))
    engine = StreamEngine(DetectionPipeline(load_pack(), device="cpu"))
    monkeypatch.delenv(ENV, raising=False)
    want = [_key(v) for v in drive_streams(engine, cases, 1000)]
    assert any(n > confirm._TF_MEMO_MAXLEN for n in native)
    monkeypatch.setenv(ENV, "1")
    calls = len(native)
    got = [_key(v) for v in drive_streams(engine, cases, 1000)]
    assert len(native) == calls
    assert got == want
    assert sum(k[1] for k in got) >= 5


def test_the_long_value_counters_advance_on_a_long_value_alone(tmp_path):
    from ingress_plus_tpu.analysis.promlint import (
        check_exposition as jax_check,
    )
    from ingress_plus_tpu_torch.analysis.promlint import check_exposition
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    cr = compile_ruleset(parse_seclang(
        'SecRule ARGS|REQUEST_BODY "@rx (?i)union\\s+select" "id:1,'
        'phase:2,block,t:none,t:urlDecodeUni,t:compressWhitespace,'
        'severity:CRITICAL,tag:\'attack-sqli\'"'))
    p = DetectionPipeline(cr, mode="block", device="cpu")
    st = p.stats
    b = Batcher(p, max_batch=16)
    attack = b"1%27%20UNION%0A%20%09SELECT%20x"
    try:
        short = b.submit(Request(uri="/p?q=" + attack.decode(), headers={},
                                 body=b"", request_id="short"))
        assert short.result(timeout=120).blocked
        assert (st.confirm_long_transform_us,
                st.confirm_long_transform_bytes) == (0, 0)
        body = b"comment=" + b"a%20b+c%09" * 300 + attack
        h = b.begin_stream(Request(
            method="POST", uri="/upload",
            headers={"content-type": "application/x-www-form-urlencoded"},
            body=b"", request_id="long"))
        for at in range(0, len(body), 1000):
            b.feed_chunk(h, body[at:at + 1000])
        assert b.finish_stream(h).result(timeout=120).blocked
        text = ServeLoop(b, socket_path=str(tmp_path / "s.sock")
                         )._metrics_text()
    finally:
        b.close()
    # the raw body, and its ARGS value, each once through the rule's chain
    value = url_decode_uni(body[len(b"comment="):])
    assert len(value) > confirm._TF_MEMO_MAXLEN
    assert st.confirm_long_transform_bytes == len(body) + len(value)
    assert st.confirm_long_transform_us > 0
    assert check_exposition(text) == [] == jax_check(text)
    lines = text.splitlines()
    assert "ipt_confirm_long_transform_us_sum %d" % (
        st.confirm_long_transform_us) in lines
    assert "ipt_confirm_long_transform_bytes_total %d" % (
        st.confirm_long_transform_bytes) in lines
