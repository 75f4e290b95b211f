"""The front door's two helpers, on the CPU.

- ``ops/cuda_build.py build_native``: the C++ sidecar, loadgen and the
  nginx module's harnesses built from ``native/``'s sources with its
  Makefiles' flags into ``build/native/<key>``: once per key, safely from
  two processes at once, never into ``native/``, and a failed compile
  raises with the compiler's output.
- ``utils/uds.py socket_path``: a unix socket path that fits AF_UNIX
  under a temporary directory too deep for it; a CPU server listens on
  it and the sidecar and loadgen reach it; the fault matrix's drill
  fleet binds through it.
- ``chip_smoke.front_invariants``, the only checks phase 17 leg C makes
  of the rendered front door at its 50 ms deadline.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

import chip_smoke
from ingress_plus_tpu_torch.ops.cuda_build import (
    NATIVE,
    NATIVE_BINARIES,
    NATIVE_BUILD,
    build_native,
    native_dir,
)
from ingress_plus_tpu_torch.utils import uds
from ingress_plus_tpu_torch.utils.export_corpus import export
from ingress_plus_tpu_torch.utils.uds import MAX_SOCKET_PATH, socket_path

REPO = Path(__file__).resolve().parent.parent

RULES = r"""
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
"""


def _native_copy(tmp_path, tail: str) -> Path:
    """A copy of ``native/``'s sidecar and shim sources with ``tail``
    appended to ``sidecar.cc``: the build key hashes the sources, so the
    copy builds apart from ``native/``'s."""
    root = tmp_path / "native"
    for sub in ("sidecar", "shim"):
        shutil.copytree(NATIVE / sub, root / sub, ignore=shutil.ignore_patterns(
            "*.o", "sidecar", "loadgen", "*_asan", "*_tsan", "shim_selftest",
            "shim_harness"))
    src = root / "sidecar" / "sidecar.cc"
    src.write_text(src.read_text() + tail)
    return root


def _tree_state(root: Path):
    return sorted((str(p), p.stat().st_mtime_ns)
                  for p in root.rglob("*") if p.is_file())


def test_build_is_keyed_idempotent_and_leaves_its_sources_alone(tmp_path):
    """On a copy of the sources (the JAX tests run ``make`` in
    ``native/`` itself, at any time): built once per key, into
    ``build/native/<key>``, nothing written beside the sources."""
    root = _native_copy(tmp_path, "\n// built once\n")
    before = _tree_state(root)
    out_dir = native_dir(root)
    try:
        first = build_native(root=root)
        stamps = {t: p.stat().st_mtime_ns for t, p in first.items()}
        again = build_native(root=root)
        assert again == first and set(first) == set(NATIVE_BINARIES)
        assert {t: p.stat().st_mtime_ns for t, p in again.items()} == stamps
        for p in first.values():
            assert p.parent == out_dir and os.access(p, os.X_OK)
        assert _tree_state(root) == before
        # every binary runs: without arguments each says what it needs
        for t in NATIVE_BINARIES:
            out = subprocess.run([str(first[t])], capture_output=True,
                                 text=True, timeout=30)
            assert out.returncode == 2 and out.stderr.strip(), t
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def test_the_default_build_reads_the_repositorys_native_sources():
    assert native_dir() == native_dir(NATIVE)
    assert native_dir().parent == NATIVE_BUILD
    assert set(build_native()) == set(NATIVE_BINARIES)


_BUILD = """
import sys
from pathlib import Path
from ingress_plus_tpu_torch.ops.cuda_build import build_native
print(build_native(["sidecar", "shim_harness"], root=Path(sys.argv[1]),
                   force=True)["sidecar"])
"""


def test_two_processes_building_at_once_leave_whole_binaries(tmp_path):
    root = _native_copy(tmp_path, "\n// a copy\n")
    out_dir = native_dir(root)
    assert out_dir != native_dir()
    try:
        procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(root)],
                                  cwd=str(REPO), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(2)]
        outs = [p.communicate(timeout=300) for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
        assert {o.strip() for o, _ in outs} == {str(out_dir / "sidecar")}
        assert sorted(p.name for p in out_dir.iterdir()) == [
            "shim_harness", "sidecar"]     # no temporary left behind
        for t in ("sidecar", "shim_harness"):
            out = subprocess.run([str(out_dir / t)], capture_output=True,
                                 text=True, timeout=30)
            assert out.returncode == 2 and "usage" in out.stderr.lower()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def test_a_failing_compile_raises_with_the_compilers_output(tmp_path):
    root = _native_copy(tmp_path, "\nint broken = undeclared_name;\n")
    out_dir = native_dir(root)
    try:
        with pytest.raises(RuntimeError) as err:
            build_native(["sidecar"], root=root)
        assert "undeclared_name" in str(err.value)
        assert "error" in str(err.value)
        assert not (out_dir / "sidecar").exists()
        assert list(out_dir.iterdir()) == []
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def test_socket_path_keeps_short_paths_and_moves_long_ones(tmp_path):
    assert socket_path(tmp_path, "s.sock") == str(tmp_path / "s.sock")
    deep = "/" + "d" * 140
    p = socket_path(deep, "serve.sock")
    assert len(p.encode()) <= MAX_SOCKET_PATH
    assert p.startswith(uds.SHORT_ROOT + "/ipt") and p.endswith("/serve.sock")
    assert os.path.isdir(os.path.dirname(p))
    with pytest.raises(ValueError):
        socket_path(deep, "x" * 100 + ".sock")


def test_drill_fleet_sockets_fit_under_a_deep_tmpdir(tmp_path, monkeypatch):
    """The fault matrix's fleet scenarios bind their in-process nodes
    and front under ``tempfile``'s directory: under a 150-character
    TMPDIR they start, serve and fail over (the paths go through
    ``socket_path``)."""
    import tempfile

    from ingress_plus_tpu_torch.utils.faults import run_fault_matrix

    deep = tmp_path / ("t" * (150 - len(str(tmp_path)) - 1))
    deep.mkdir()
    monkeypatch.setenv("TMPDIR", str(deep))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert len(tempfile.gettempdir()) == 150
    report = run_fault_matrix(only=["fleet_node_kill"], device="cpu")
    assert report["passed"], report


def _wait_socket(path, proc, what):
    for _ in range(600):
        try:
            with socket.socket(socket.AF_UNIX) as s:
                s.connect(path)
            return
        except OSError:
            pass
        assert proc.poll() is None, "%s died: %s" % (what, proc.stderr.read())
        time.sleep(0.1)
    raise AssertionError("%s never listened on %s" % (what, path))


def test_under_a_150_character_tmpdir_the_front_door_reaches_a_server(
        tmp_path, monkeypatch):
    """The C++ tools copy a socket path into ``sun_path`` with
    ``strncpy`` and cut it silently at 107 bytes: under a deep TMPDIR
    the helper's path keeps server, sidecar and loadgen on one name."""
    long_tmp = tmp_path / ("t" * (150 - len(str(tmp_path)) - 1))
    long_tmp.mkdir()
    assert len(str(long_tmp)) == 150
    monkeypatch.setenv("TMPDIR", str(long_tmp))
    monkeypatch.setattr("tempfile.tempdir", None)
    import tempfile

    work = tempfile.mkdtemp()
    assert work.startswith(str(long_tmp))
    serve_sock = socket_path(work, "serve.sock")
    side_sock = socket_path(work, "side.sock")
    for p in (serve_sock, side_sock):
        assert len(p.encode()) <= MAX_SOCKET_PATH
    rules = Path(work) / "rules"
    rules.mkdir()
    (rules / "tiny.conf").write_text(RULES)
    bins = build_native(["sidecar", "loadgen"])
    env = dict(os.environ, TMPDIR=str(long_tmp))
    procs = []
    try:
        serve = subprocess.Popen(
            [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
             "--socket", serve_sock, "--rules-dir", str(rules),
             "--platform", "cpu", "--scan-impl", "pair", "--no-warmup",
             "--hard-deadline-ms", "5000", "--http-port", "0"],
            cwd=str(REPO), env=env, stderr=subprocess.PIPE, text=True)
        procs.append(serve)
        _wait_socket(serve_sock, serve, "server")
        side = subprocess.Popen(
            [str(bins["sidecar"]), "--listen", side_sock, "--upstream",
             serve_sock, "--deadline-ms", "60000"],
            env=env, stderr=subprocess.PIPE, text=True)
        procs.append(side)
        _wait_socket(side_sock, side, "sidecar")
        corpus = Path(work) / "c.bin"
        n = export(str(corpus), n=64, seed=5, attack_fraction=0.3)
        for sock in (side_sock, serve_sock):
            out = subprocess.run(
                [str(bins["loadgen"]), "--socket", sock, "--corpus",
                 str(corpus), "--connections", "2", "--inflight", "4",
                 "--requests", str(n)],
                capture_output=True, text=True, timeout=120, env=env)
            assert out.returncode == 0, out.stderr
            r = json.loads(out.stdout)
            assert r["requests"] == n and r["fail_open"] == 0
            assert r["attacks"] > 0 and r["blocked"] == r["attacks"]
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)


# leg C's invariants on the numbers of a card run of the rendered front
# door (NVIDIA H100, the rendered 50 ms deadline, 2058 requests whose
# library verdicts hold 136 attacks): at 4 x 8 38 failed open at the
# sidecar; at 8 x 32 2026 of 2058 (98.4%) did, and the servers' own
# ladder failed 972 more open (degraded verdicts).  That run sent
# block-mode frames; leg C sends monitoring ones, so ``blocked`` is 0.
_REFERENCE = 136


def _card_run(requests, fail_open, attacks):
    return {"requests": requests, "fail_open": fail_open,
            "attacks": attacks, "blocked": 0}


def _side(requests, failed):
    return {"requests_in": requests, "responses": requests - failed,
            "fail_open_deadline": failed, "fail_open_upstream": 0,
            "fail_open_overload": 0, "late_responses": failed,
            "bad_frames": 0}


@pytest.mark.parametrize("run,side,degraded", [
    (_card_run(2058, 38, 133), _side(2058, 38), 0),
    (_card_run(2058, 2026, 1), _side(2058, 2026), 972),
])
def test_front_invariants_accept_a_card_runs_fail_open(run, side, degraded):
    assert chip_smoke.front_invariants(run, side, _REFERENCE, degraded) == []


def test_front_invariants_reject_what_no_host_speed_explains():
    run, side = _card_run(2058, 2026, 1), _side(2058, 2026)
    bad = chip_smoke.front_invariants(run, dict(side, bad_frames=1),
                                      _REFERENCE, 972)
    assert bad == ["bad_frames 1"]
    lost = chip_smoke.front_invariants(_card_run(2058, 100, 30),
                                       _side(2058, 100), _REFERENCE, 0)
    assert lost == ["attacks 30 + fail_open 100 < reference 136"]
    extra = chip_smoke.front_invariants(_card_run(2058, 0, 140),
                                        _side(2058, 0), _REFERENCE, 0)
    assert extra == ["attacks 140 > reference 136 + degraded 0"]
    assert chip_smoke.front_invariants(
        dict(run, blocked=3), side, _REFERENCE, 972) == ["blocked 3"]
    undrained = dict(side, late_responses=2000)
    assert chip_smoke.front_invariants(run, undrained, _REFERENCE, 972) == [
        "late_responses 2000 != fail_open_deadline 2026 (not drained)"]
    assert chip_smoke.front_invariants(
        dict(run, fail_open=2031), dict(side, fail_open_upstream=5,
                                        responses=27),
        _REFERENCE, 972) == ["fail_open_upstream 5"]
