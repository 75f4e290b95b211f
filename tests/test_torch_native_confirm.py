"""The port's native confirm twin against its Python detectors and the
JAX package, on the CPU.

``ingress_plus_tpu_torch/csrc/libdetect.cc`` (a byte copy of
``native/confirm/libdetect.cc``), built by g++ at first use into the
port's build directory, must give the same booleans as the port's
Python detectors (and the JAX package's) on every input: the
handcrafted payloads and the fuzz alphabet of ``test_native_confirm.py``,
the labeled corpus's scan streams, seeded text and binary fuzz, and the
4096-byte window.  The dispatch must take the twin, send NUL windows to
Python and obey ``IPT_NO_NATIVE_CONFIRM``; a failed build raises; and
the port's pipeline verdicts, confirmed natively, equal the JAX
pipeline's.  Tolerance: none.
"""

import ctypes
import dataclasses
import random
import re
import sys
import threading
from pathlib import Path

import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.models import libdetect as jax_libdetect
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.utils.benign_fixtures import fixture_requests
from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
from ingress_plus_tpu_torch.models import libdetect
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.ops import cuda_build
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack
from test_native_confirm import FUZZ_ALPHABET, FUZZ_WORDS, HANDCRAFTED

REPO = Path(__file__).resolve().parents[1]
ENV = "IPT_NO_NATIVE_CONFIRM"


@pytest.fixture(scope="module")
def lib():
    """The port's twin, built and loaded (whatever the environment)."""
    return libdetect._TWIN.load()


def _agree(lib, data: bytes) -> None:
    """Native == the port's Python == the JAX package's Python."""
    if b"\x00" in data:          # c_char_p data: the dispatch sends it to Python
        return
    want = (libdetect.detect_sqli_py(data), libdetect.detect_xss_py(data))
    assert want == (jax_libdetect.detect_sqli_py(data),
                    jax_libdetect.detect_xss_py(data)), data[:120]
    got = (bool(lib.ipt_detect_sqli(data, len(data))),
           bool(lib.ipt_detect_xss(data, len(data))))
    assert got == want, "native %s, python %s on %r" % (got, want, data[:120])


def test_copy_is_byte_identical_to_the_jax_source():
    port = (REPO / "ingress_plus_tpu_torch" / "csrc" / "libdetect.cc")
    assert port.read_bytes() == \
        (REPO / "native" / "confirm" / "libdetect.cc").read_bytes()


def test_build_lands_in_the_port_build_dir_with_the_makefile_flags(lib):
    path = libdetect._TWIN.build()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("liblibdetect_") and path.exists()
    assert lib._name == str(path)
    make = (REPO / "native" / "confirm" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    assert re.search(r"\$\(CXX\) \$\(CXXFLAGS\) -shared ", make)
    assert cuda_build.GXX_FLAGS == tuple(flags + ["-shared"])
    assert libdetect._TWIN.compiler == "g++"
    # microsecond calls keep the interpreter lock (no reacquire waits
    # behind busy threads)
    assert isinstance(lib, ctypes.PyDLL)


@pytest.mark.parametrize("payload", HANDCRAFTED)
def test_handcrafted(lib, payload):
    _agree(lib, payload)


def test_corpus_streams(lib):
    n = 0
    for lr in generate_corpus(n=400, attack_fraction=0.4, seed=17):
        for stream in lr.request.streams().values():
            _agree(lib, stream)
            n += 1
    assert n > 400


def test_fuzz_text(lib):
    rng = random.Random(20260729)
    for _ in range(3000):
        parts = []
        for _ in range(rng.randint(1, 24)):
            if rng.random() < 0.3:
                parts.append(rng.choice(FUZZ_WORDS))
            else:
                parts.append(bytes([rng.choice(FUZZ_ALPHABET)]))
        _agree(lib, b"".join(parts))


def test_fuzz_binary(lib):
    rng = random.Random(7)
    for _ in range(500):
        _agree(lib, bytes(rng.randrange(1, 256)
                          for _ in range(rng.randint(0, 200))))


def test_the_4096_byte_window(lib, monkeypatch):
    late = b"A" * 5000 + b"' UNION SELECT x FROM y--"
    early = b"A" * 4000 + b"' OR 1=1--"
    for data in (late, early):
        _agree(lib, data[:4096])
        assert libdetect.detect_sqli(data) == \
            libdetect.detect_sqli_py(data) == jax_libdetect.detect_sqli_py(data)
    assert not libdetect.detect_sqli(late)     # past the window: unseen
    assert libdetect.detect_sqli(early)
    # the dispatch slices before the NUL guard: a NUL past the window
    # still takes the twin, one inside it takes Python
    calls = []
    py = libdetect.detect_sqli_py
    monkeypatch.setattr(libdetect, "detect_sqli_py",
                        lambda d, n=4096: calls.append(d) or False)
    window = early.ljust(4096, b" ")
    assert libdetect.detect_sqli(window + b"\x00" * 200) == py(window)
    assert py(window) and calls == []
    assert not libdetect.detect_sqli(b"1' UNION SELECT\x00 a FROM b--")
    assert len(calls) == 1


def test_dispatch_native_nul_and_the_switch(lib, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    py = []
    monkeypatch.setattr(libdetect, "detect_sqli_py",
                        lambda d, n=4096: py.append(("sqli", d)) or False)
    monkeypatch.setattr(libdetect, "detect_xss_py",
                        lambda d, n=4096: py.append(("xss", d)) or False)
    assert libdetect.native_library() is lib
    assert libdetect.detect_sqli(b"1' UNION SELECT a FROM b--")
    assert not libdetect.detect_sqli(b"hello world")
    assert libdetect.detect_xss(b"<script>x</script>")
    assert py == []                               # all three went native
    assert not libdetect.detect_xss(b"<script>\x00</script>")
    assert py == [("xss", b"<script>\x00</script>")]
    monkeypatch.setenv(ENV, "1")
    assert libdetect.native_library() is None
    assert not libdetect.detect_sqli(b"1' UNION SELECT a FROM b--")
    assert py[-1] == ("sqli", b"1' UNION SELECT a FROM b--")


def test_threads_share_the_twin(lib):
    """The pooled confirm workers call the twin from many threads: they
    give the single thread's answers."""
    rng = random.Random(11)
    inputs = [b"".join(rng.choice(FUZZ_WORDS + [b"x", b" ", b"'", b"="])
                       for _ in range(rng.randint(1, 40)))
              for _ in range(400)]
    want = [(lib.ipt_detect_sqli(d, len(d)), lib.ipt_detect_xss(d, len(d)))
            for d in inputs]
    got = [None] * 16
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            got[i] = [(lib.ipt_detect_sqli(d, len(d)),
                       lib.ipt_detect_xss(d, len(d)))
                      for _ in range(5) for d in inputs]
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert all(g == want * 5 for g in got)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    broken = tmp_path / "libdetect.cc"
    broken.write_text("int ipt_detect_sqli(const char* d, unsigned long n) "
                      "{ return n +; }\n")
    twin = cuda_build.KernelLibrary(broken, dict(libdetect._TWIN.prototypes),
                                    init=None, compiler="g++",
                                    flags=cuda_build.GXX_FLAGS)
    monkeypatch.setattr(libdetect, "_TWIN", twin)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on libdetect.cc"):
        DetectionPipeline(load_pack(), device="cpu")
    with pytest.raises(RuntimeError, match="error"):
        libdetect.detect_sqli(b"1' OR 1=1--")
    monkeypatch.setattr(libdetect, "_TWIN", cuda_build.KernelLibrary(
        broken, {}, init=None, compiler="no-such-compiler-g++"))
    with pytest.raises(RuntimeError, match="no-such-compiler-g\\+\\+ not found"):
        libdetect.native_library()
    # switched off, nothing is built and the Python detectors answer
    monkeypatch.setenv(ENV, "1")
    pl = DetectionPipeline(load_pack(), device="cpu")
    assert pl.detect([Request(uri="/q?id=1'+UNION+SELECT+a+FROM+b--",
                              request_id="r")])[0].attack


def _key(v):
    return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids), v.score,
            v.classes, v.matches, v.fail_open, v.generation)


def test_pipeline_verdicts_with_native_confirm_equal_jax(lib, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    calls = {"native": 0, "python": 0}

    class Counting:
        def __init__(self, inner):
            self.inner = inner

        def ipt_detect_sqli(self, d, n):
            calls["native"] += 1
            return self.inner.ipt_detect_sqli(d, n)

        def ipt_detect_xss(self, d, n):
            calls["native"] += 1
            return self.inner.ipt_detect_xss(d, n)

    counting = Counting(lib)
    monkeypatch.setattr(libdetect, "native_library", lambda: counting)
    for name in ("detect_sqli_py", "detect_xss_py"):
        fn = getattr(libdetect, name)

        def spy(d, n=4096, fn=fn):
            calls["python"] += 1
            return fn(d, n)
        monkeypatch.setattr(libdetect, name, spy)
    jreqs = [lr.request for lr in jax_corpus(n=256, seed=20260729,
                                             attack_fraction=0.4)]
    jreqs += fixture_requests()
    treqs = [Request(**{f.name: getattr(r, f.name)
                        for f in dataclasses.fields(Request)})
             for r in jreqs]
    jpl = JaxPipeline(JaxRuleset.load(BUNDLED_PACK), scan_impl="pair",
                      fail_open=False)
    tpl = DetectionPipeline(load_pack(), device=torch.device("cpu"),
                            fail_open=False)
    want = [_key(v) for i in range(0, len(jreqs), 64)
            for v in jpl.detect(jreqs[i:i + 64])]
    got = [_key(v) for i in range(0, len(treqs), 64)
           for v in tpl.detect(treqs[i:i + 64])]
    assert got == want
    assert sum(k[1] for k in got) > 50
    assert calls["native"] > 0 and calls["python"] == 0
