"""The port's native code under the sanitizers made for it, on the CPU.

- ``tests/test_sanitizers.py`` on the port (``ported``): the port's CPU
  serve loop on the file's three rules behind the ASan+UBSan sidecar,
  then the TSan sidecar, 200 requests from loadgen; the sanitizer
  builds come from ``ops/cuda_build.py build_native`` (targets
  ``sidecar_asan``, ``loadgen_asan``, ``sidecar_tsan``, the flags of
  ``native/sidecar/Makefile``'s ``SAN_ASAN`` / ``SAN_TSAN``), never from
  ``make`` in ``native/``.
- ``csrc/libdetect.cc`` linked with ``csrc/libdetect_check.cc`` under
  ASan+UBSan (``models/libdetect.py run_sanitized``) over the twin
  tests' strings, the evasion corpus, the 10000 benign requests, the
  prefilter gate's mutants and hand-made edges: no report, exit 0, and
  on every string without a NUL the two bits of the Python detectors.
- What ``chip_smoke.py`` phase 19 decides on the card, checked here:
  the parser of compute-sanitizer's output, the case plan (from
  ``plan_segments`` alone), and the plain versions on the plan's edge
  rows against the JAX package's ``ops/scan.py``.  Tolerance: none.
"""

import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.ops import scan as jscan
from ingress_plus_tpu.ops.pallas_scan import PallasByteScanner
from ingress_plus_tpu_torch.models import libdetect
from ingress_plus_tpu_torch.ops import cuda_build
from ingress_plus_tpu_torch.ops import pair_scan as tpair
from ingress_plus_tpu_torch.ops import scan as tscan
from ingress_plus_tpu_torch.ops.cuda_build import build_native, native_dir
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.utils.evasion import (
    generate_benign,
    generate_evasion,
)
from ingress_plus_tpu_torch.utils.prefilter_gate import mutate_request
from test_native_confirm import FUZZ_ALPHABET, FUZZ_WORDS, HANDCRAFTED
from torch_ported_tests import ported

REPO = Path(__file__).resolve().parents[1]

#: ``make -C native/sidecar <target>`` as the port builds it
_TARGETS = {"asan": ("sidecar_asan", "loadgen_asan"),
            "tsan": ("sidecar_tsan",), "all": ("sidecar", "loadgen")}


def _build(target):
    build_native(_TARGETS[target])


globals().update(ported("test_sanitizers", {}, patch={
    "_build": _build, "SIDECAR_DIR": native_dir()}))


def test_sanitizer_targets_take_the_makefiles_flags():
    make = (REPO / "native" / "sidecar" / "Makefile").read_text()
    flags = {k: tuple(v.split()) for k, v in
             re.findall(r"^(SAN_\w+) = (.*)$", make, re.M)}
    assert flags == {"SAN_ASAN": cuda_build.SAN_ASAN,
                     "SAN_TSAN": cuda_build.SAN_TSAN}
    rules = {t: (line, src) for t, line, src in re.findall(
        r"^(\w+_[at]san): .*\n\t\$\(CXX\) (.*) -o \$@ (\w+\.cc)$", make,
        re.M)}
    assert set(rules) == set(cuda_build.SANITIZER_BINARIES)
    for t, (line, src) in rules.items():
        sub, cc, tflags, inputs, extra = cuda_build.NATIVE_TARGETS[t]
        want = line.replace("$(SAN_ASAN)", " ".join(flags["SAN_ASAN"]))
        want = want.replace("$(SAN_TSAN)", " ".join(flags["SAN_TSAN"]))
        assert (sub, cc, " ".join(tflags), inputs, extra) == (
            "sidecar", "g++", want, (src,), ())
    # the default build does not grow; the key covers the new targets
    assert not set(cuda_build.SANITIZER_BINARIES) & set(
        cuda_build.NATIVE_BINARIES)


# ------------------------------------------------- the twin under ASan


def _streams(requests):
    return [s for r in requests for s in r.streams().values()]


def _twin_test_strings():
    """The strings ``tests/test_torch_native_confirm.py`` holds the twin
    to: handcrafted payloads, the labeled corpus's streams, text and
    binary fuzz, the 4096-byte window."""
    out = list(HANDCRAFTED)
    out += _streams(lr.request for lr in generate_corpus(
        n=400, attack_fraction=0.4, seed=17))
    rng = random.Random(20260729)
    for _ in range(3000):
        out.append(b"".join(
            rng.choice(FUZZ_WORDS) if rng.random() < 0.3
            else bytes([rng.choice(FUZZ_ALPHABET)])
            for _ in range(rng.randint(1, 24))))
    rng = random.Random(7)
    out += [bytes(rng.randrange(1, 256) for _ in range(rng.randint(0, 200)))
            for _ in range(500)]
    out += [b"A" * 5000 + b"' UNION SELECT x FROM y--",
            b"A" * 4000 + b"' OR 1=1--"]
    return out


def _gate_mutants(n=2048, fuzz_per_attack=2, seed=20260729):
    """The prefilter gate's mutants at phase 15's size (``run_gate``'s
    own seeding)."""
    rng = random.Random(seed ^ 0x5eed)
    return [mutate_request(rng, lr.request)
            for lr in generate_corpus(n=n, attack_fraction=0.3, seed=seed)
            if lr.is_attack for _ in range(fuzz_per_attack)]


def _edges():
    """The empty string, one byte of each value, every byte value,
    unterminated quotes and comments, deep nesting, 64 KiB of one token,
    and strings with NUL."""
    out = [b"", bytes(range(256)), bytes(range(255, -1, -1))]
    out += [bytes([b]) for b in range(256)]
    out += [b"'", b'"', b"`", b"1' OR '1'='1", b'" OR "a"="a', b"'--",
            b"/*", b"1 /* union select", b"<!--", b"<script", b"--",
            b"#", b"\\", b"'\\", b"&#", b"&#x3c;scr"]
    out += [b"(" * 5000, b"((((((((select 1", b"<" * 3000 + b"script",
            b"<a " * 2000, b"'" * 4097, b'"(' * 3000]
    out += [tok * (65536 // len(tok)) for tok in
            (b"a", b"'", b"<", b"(", b"/*", b"select ", b"union ",
             b"<script>", b"&#60;", b"\xff")]
    out += [b"\x00", b"\x00" * 4096, b"1' OR 1=1\x00--", b"<scr\x00ipt>",
            b"\x00' UNION SELECT a FROM b--", b"a" * 4095 + b"\x00"]
    return out


FAMILIES = {
    "twin_tests": _twin_test_strings,
    "evasion": lambda: _streams(s.labeled.request
                                for s in generate_evasion()),
    "benign_10000": lambda: _streams(lr.request
                                     for lr in generate_benign(10_000)),
    "gate_mutants": lambda: _streams(_gate_mutants()),
    "edges": _edges,
}


@pytest.fixture(scope="module")
def sanitized():
    """Every family's strings (each string once, in order) through one
    run of the sanitized twin: {family: [(string, (sqli, xss))]}, its
    stderr and exit code."""
    fams = {k: list(dict.fromkeys(f())) for k, f in FAMILIES.items()}
    strings = [s for v in fams.values() for s in v]
    bits, err, rc = libdetect.run_sanitized(strings)
    out, at = {}, 0
    for k, v in fams.items():
        out[k] = list(zip(v, bits[at:at + len(v)]))
        at += len(v)
    return out, len(strings), bits, err, rc


def test_the_sanitized_twin_is_an_asan_ubsan_build_of_both_sources():
    path = libdetect.sanitized_binary()
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libdetect_check_")
    data = path.read_bytes()
    assert b"__asan_init" in data and b"__ubsan_handle" in data
    assert b"ipt_detect_sqli" in data and b"ipt_detect_xss" in data
    # no strings: no lines, no report
    bits, err, rc = libdetect.run_sanitized([])
    assert (bits, rc) == ([], 0)


def test_the_sanitized_twin_reports_nothing(sanitized):
    _, n, bits, err, rc = sanitized
    for report in chip_smoke.SANITIZER_REPORTS:
        assert report not in err, err[-4000:]
    assert rc == 0, err[-4000:]
    assert len(bits) == n > 15_000


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_sanitized_twin_equals_the_python_detectors(sanitized, family):
    """Both bits equal the Python detectors on every string without a
    NUL (the twin's contract: the dispatch hands NUL windows to Python,
    so those are checked for memory only)."""
    rows = sanitized[0][family]
    assert rows
    checked = 0
    for data, got in rows:
        if b"\x00" in data[:4096]:
            continue
        want = (libdetect.detect_sqli_py(data), libdetect.detect_xss_py(data))
        assert got == want, "%s: native %s, python %s on %r" % (
            family, got, want, data[:120])
        checked += 1
    assert checked > (0 if family == "edges" else len(rows) // 2)
    if family in ("twin_tests", "evasion", "gate_mutants"):
        assert any(s or x for _, (s, x) in rows)


# ------------------------------------------- phase 19's parser and plan

_CLEAN = """========= COMPUTE-SANITIZER
sanitize-child {"identical": true, "cases": 20}
========= ERROR SUMMARY: 0 errors
"""
_RACE_CLEAN = """========= COMPUTE-SANITIZER
sanitize-child {"identical": true, "cases": 20}
========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, 0 warnings)
"""
_ERRORS = """========= COMPUTE-SANITIZER
========= Invalid __global__ read of size 16 bytes
=========     at pair_scan_kernel<true>+0x1a0 in pair_scan.cu:177
sanitize-child {"identical": true, "cases": 20}
========= ERROR SUMMARY: 3 errors
"""
#: the answer of a card host under gVisor (an NVIDIA H100 80GB HBM3):
#: the tool instruments nothing
_REFUSED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
torch.AcceleratorError: CUDA error: unknown error
========= Target application returned an error
========= ERROR SUMMARY: 3 errors
"""


@pytest.mark.parametrize("rc,text,status,why", [
    (0, _CLEAN, "clean", None),
    (0, _RACE_CLEAN, "clean", None),
    (86, _ERRORS, "failed", "3 reports"),
    (0, _CLEAN.replace("0 errors", "2 errors"), "failed", "2 reports"),
    (0, _RACE_CLEAN.replace("0 hazards", "1 hazard"), "failed", "1 reports"),
    (0, "\n".join(_CLEAN.splitlines()[:2]), "failed", "no summary line"),
    (1, _CLEAN, "failed", "exit code 1"),
    (0, _CLEAN.replace('"identical": true', '"identical": false'), "failed",
     "launches disagree with their plain versions"),
    (0, _CLEAN.replace("sanitize-child", "child"), "failed",
     "no sanitize-child line"),
    (86, _REFUSED, "refused", chip_smoke.SANITIZE_REFUSED),
])
def test_sanitizer_outcome(rc, text, status, why):
    out = chip_smoke.sanitizer_outcome(rc, text)
    assert (out["status"], out["why"]) == (status, why)


def test_sanitizer_argv_filters_the_scan_kernels():
    argv = chip_smoke.sanitizer_argv("/cuda/bin/compute-sanitizer",
                                     "racecheck")
    assert argv[:5] == ["/cuda/bin/compute-sanitizer", "--tool",
                        "racecheck", "--error-exitcode",
                        str(chip_smoke.SANITIZE_EXIT)]
    pairs = [argv[i + 1] for i, a in enumerate(argv) if a == "--kernel-name"]
    assert pairs == ["kns=pair_scan_kernel", "kns=step_scan_kernel"]
    assert argv[-2:] == [str(REPO / "chip_smoke.py"), "--sanitize-child"]


@pytest.mark.parametrize("W", [225, 285])
def test_the_case_plan_covers_what_phase_19_must(W):
    """The bundled pack (W=225) and the 2x pack (W=285): both pair
    configurations and the carried step path run on every case; split
    and unsplit launches; a partial last block, split and unsplit; lanes
    past W; lengths 0, 1, odd, L-1, L and above L; uncarried launches."""
    from ingress_plus_tpu_torch.ops.segments import plan_segments

    plan = chip_smoke.sanitize_plan(W)
    shapes = {(c["B"], c["L"]) for c in plan}
    assert shapes == set(chip_smoke.SANITIZE_SHAPES)
    for c in plan:
        p = plan_segments(c["B"], c["L"], W)
        assert (c["G"], c["segments"]) == (p.G, p.segments)
        assert c["segments_run"] == ([None, c["L"]] if p.segments > 1
                                     else [None])
        assert c["lanes_past_w"]
    assert {(c["B"], c["L"]) for c in plan if c["segments"] > 1} == {
        (8, 2048), (8, 16384), (3, 1900)}
    partial = {(c["segments"] > 1) for c in plan if c["partial_block"]}
    assert partial == {True, False}
    assert all(c["carried"] for c in plan if c["segments"] > 1)
    assert {(c["B"], c["L"]) for c in plan if not c["carried"]} == set(
        chip_smoke.SANITIZE_UNCARRIED)
    assert any(c["L"] % 2 for c in plan)
    rng = np.random.default_rng(0)
    seen = set()
    for c in plan:
        n = chip_smoke.sanitize_lengths(c["B"], c["L"], c["G"], rng)
        assert n.shape == (c["B"],) and n.min() >= 0 and n.max() <= c["L"] + 1
        L = c["L"]
        seen |= {("0", 0 in n), ("1", 1 in n), ("odd", bool((n % 2).any())),
                 ("L-1", L - 1 in n), ("L", L in n), ("above L", L + 1 in n)}
        if c["segments"] > 1:
            assert L + 1 in n and c["G"] - 1 in n
    assert {k for k, v in seen if v} == {"0", "1", "odd", "L-1", "L",
                                         "above L"}


RULES = """
SecRule ARGS "@rx (?i)union\\s+select" "id:1,phase:2,block,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS "@rx (?i)<script[^>]*>" "id:2,phase:2,block,severity:CRITICAL,tag:'attack-xss'"
SecRule ARGS "@rx /etc/(?:passwd|shadow)" "id:3,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@rx (?:;|\\|)\\s*(?:cat|ls|id)\\b" "id:5,phase:2,block,severity:ERROR,tag:'attack-rce'"
SecRule ARGS "@rx [^a-z]{3}x" "id:6,phase:2,block,severity:ERROR,tag:'attack-generic'"
"""


@pytest.fixture(scope="module")
def small_pack():
    """Two words; rule 6 starts on a class that holds NUL, so a zero pad
    byte scanned as a byte (not as the dead class) changes the state."""
    cr = compile_ruleset(parse_seclang(RULES))
    assert cr.tables.n_words == 2
    assert (np.asarray(cr.tables.init_mask)
            & np.asarray(cr.tables.byte_table)[0]).any()
    return (jscan.ScanTables.from_bitap(cr.tables),
            tscan.ScanTables.from_bitap(cr.tables, torch.device("cpu")))


def _edge_rows(B, L, W, seed):
    """The plan's edge rows of one shape (at most 8 rows: the lengths
    :func:`chip_smoke.sanitize_lengths` leads with), their tokens and a
    carried state and match, as numpy arrays."""
    from ingress_plus_tpu_torch.ops.segments import plan_segments

    rng = np.random.default_rng(seed)
    case = {"B": min(B, 8), "L": L, "carried": True,
            "G": plan_segments(B, L, W).G}
    return chip_smoke.sanitize_inputs(case, W, rng)


@pytest.mark.parametrize("B,L", [s for s in chip_smoke.SANITIZE_SHAPES
                                 if s[1] <= 2048])
def test_plain_versions_on_the_plans_edge_rows_equal_jax(small_pack, B, L):
    """The port's plain pair scan (what ``ByteScanner`` / ``PairScanner``
    run on CPU tensors, and what phase 19 holds the kernels to) and
    ``scan_bytes`` against the JAX package's ``scan_pairs`` and
    ``scan_bytes`` on the plan's edge rows, carried state and match
    included.  An odd L is outside ``scan_pairs``' contract (even L):
    there the pair scan is held to the JAX Pallas kernel's match
    (interpret mode) and to the JAX reference with lengths clamped to L,
    the kernels' rule (the JAX reference pads a zero byte that a length
    above L then scans)."""
    jt, tt = small_pack
    W = tt.n_words
    toks, lens, match, state = _edge_rows(B, L, W, seed=B * 7 + L)
    t = [torch.from_numpy(x.copy()) for x in (toks, lens)]
    ms = [tscan.from_numpy_u32(x, torch.device("cpu"))
          for x in (match, state)]
    got_m, got_s = tscan.scan_bytes(tt, *t, ms[1], ms[0])
    want_m, want_s = jscan.scan_bytes_jit(jt, toks, lens, state, match)
    np.testing.assert_array_equal(tscan.to_numpy_u32(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(tscan.to_numpy_u32(got_s), np.asarray(want_s))
    for scanner in (tpair.ByteScanner(tt), tpair.PairScanner(tt)):
        pm, ps = scanner(*t, ms[1], ms[0])
        if L % 2 == 0:
            wm, ws = jscan.scan_pairs_jit(jt, toks, lens, state, match)
        else:
            wm, ws = PallasByteScanner(jt)(
                np.pad(toks, ((0, 0), (0, 1))), np.minimum(lens, L), state,
                match, mode="reference")
            km, _ = PallasByteScanner(jt, TB=8, CL=16, MR=8)(
                toks, lens, state, match, interpret=True)
            np.testing.assert_array_equal(tscan.to_numpy_u32(pm),
                                          np.asarray(km))
        np.testing.assert_array_equal(tscan.to_numpy_u32(pm), np.asarray(wm))
        np.testing.assert_array_equal(tscan.to_numpy_u32(ps), np.asarray(ws))
    assert np.asarray(want_m).any()


def test_granule_padding_copies_only_what_a_kernel_would_overread():
    """A scan kernel copies whole 16-byte granules: a token buffer that is
    misaligned, or whose storage ends before the next 16-byte boundary,
    is copied into a zero-padded buffer; any other is passed as is."""
    whole = torch.arange(64, dtype=torch.uint8).view(4, 16)
    assert cuda_build.granule_padded(whole) is whole
    short = torch.arange(15, dtype=torch.uint8).view(3, 5)
    padded = cuda_build.granule_padded(short)
    assert padded is not short and torch.equal(padded, short)
    assert padded.untyped_storage().nbytes() == 16
    assert int(torch.empty(0, dtype=torch.uint8).set_(
        padded.untyped_storage())[15]) == 0
    base = torch.arange(48, dtype=torch.uint8)
    view = base[3:35].view(2, 16)        # misaligned, storage reaches past
    moved = cuda_build.granule_padded(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    inner = base[16:31].view(3, 5)       # aligned, storage reaches past
    assert cuda_build.granule_padded(inner) is inner
    ids = torch.arange(6, dtype=torch.int32).view(2, 3)   # 24 bytes
    assert torch.equal(cuda_build.granule_padded(ids), ids)
    assert cuda_build.granule_padded(ids).untyped_storage().nbytes() == 32


#: two ``cuobjdump -sass`` dumps of one kernel, with ``-lineinfo`` (its
#: header names the source) and without (shortened from a card run)
_SASS_LINEINFO = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit
identifier = /repo/ingress_plus_tpu_torch/csrc/pair_scan.cu

	code for sm_90a
		Function : _ZN12_GLOBAL__N_116pair_scan_kernelILb1EEEvPKvPKiS4_PKjiS6_S6_S6_S6_PjS7_iiii
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe40000000f00 */
        /*0010*/                   S2R R0, SR_TID.X ;                         /* 0x0000000000007919 */
"""
_SASS_PLAIN = _SASS_LINEINFO.replace(
    "identifier = /repo/ingress_plus_tpu_torch/csrc/pair_scan.cu\n", "")


def test_sass_code_keeps_functions_and_instructions_only():
    code = chip_smoke.sass_code(_SASS_LINEINFO)
    assert code == chip_smoke.sass_code(_SASS_PLAIN)
    assert [ln.split()[0] for ln in code] == ["Function", "/*0000*/",
                                              "/*0010*/"]
    changed = _SASS_PLAIN.replace("S2R R0, SR_TID.X", "S2R R0, SR_TID.Y")
    assert chip_smoke.sass_code(changed) != code


# ------------------------------------ phase 19 rehearsed on the CPU

_CHILD_OK = ('sanitize-child {"cases": 18, "launches": 72, "identical": '
             'true, "kernel_launches": {"pair_scan": 48, "step_scan": 24}, '
             '"check_failures": {}}')


def _rehearse(tmp_path, monkeypatch, tool_text, tool_rc, child_rc=0,
              front=None):
    """``chip_smoke.phase_sanitizers`` with a stand-in compute-sanitizer
    (prints ``tool_text``, exits ``tool_rc``), a stand-in checked child
    (prints a clean line, exits ``child_rc``), the SASS comparison
    stubbed, and the sanitized sidecars in front of a CPU server (or
    ``front``'s result)."""
    tool = tmp_path / "compute-sanitizer"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n%sEOF\nexit %d\n"
                    % (tool_text, tool_rc))
    tool.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_compute_sanitizer",
                        lambda: str(tool))
    real = chip_smoke.logged_run

    def logged_run(argv, env, path, limit):
        if "--checked" in argv:
            argv = [sys.executable, "-c", "print(%r); raise SystemExit(%d)"
                    % (_CHILD_OK, child_rc)]
        return real(argv, env, path, limit)

    monkeypatch.setattr(chip_smoke, "logged_run", logged_run)
    monkeypatch.setattr(chip_smoke, "sass_lineinfo_equal", lambda pairs: {
        k: {"equal": True, "instructions": 1, "first_difference": None}
        for k in pairs})
    if front is not None:
        monkeypatch.setattr(chip_smoke, "sanitized_front_door",
                            lambda *a: front)
    bins = build_native(cuda_build.NATIVE_BINARIES
                        + cuda_build.SANITIZER_BINARIES)
    return chip_smoke.phase_sanitizers(
        bins, {"pair_scan": None, "step_scan": None}, "cpu",
        server_args=("--platform", "cpu", "--hard-deadline-ms", "20000"))


def test_phase_19_records_a_refusing_tool_and_passes_on_the_rest(
        tmp_path, monkeypatch):
    res = _rehearse(tmp_path, monkeypatch, _REFUSED, 86)
    assert {k: v["status"] for k, v in res["tools"].items()} == {
        t: "refused" for t in chip_smoke.SANITIZE_TOOLS}
    assert res["checked"]["identical"] and res["checked"]["rc"] == 0
    for leg in ("asan", "tsan"):
        f = res["front_door"][leg]
        assert (f["requests"], f["reports"]) == (200, 0) and f["attacks"] > 0


@pytest.mark.parametrize("tool_text,tool_rc,child_rc,want", [
    (_ERRORS, 86, 0, "phase 19 memcheck: 3 reports"),
    (_CLEAN.replace("sanitize-child", "child"), 0, 0,
     "phase 19 memcheck: no sanitize-child line"),
    (_CLEAN, 0, 1, "phase 19 checked build: exit 1"),
])
def test_phase_19_fails_on_a_report_or_a_failed_child(
        tmp_path, monkeypatch, tool_text, tool_rc, child_rc, want):
    with pytest.raises(SystemExit) as e:
        _rehearse(tmp_path, monkeypatch, tool_text, tool_rc, child_rc,
                  front={})
    assert str(e.value).startswith(want)


def test_phase_19_fails_without_compute_sanitizer(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_sanitizers({}, {}, "cpu")
    assert "compute-sanitizer not found" in str(e.value)
