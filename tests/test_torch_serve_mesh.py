"""Mesh-backed serving on the port (``parallel/serve_mesh.MeshEngine``):
the DP x TP sharded step behind the single-device engine API, so the
same pipeline, batcher and confirm chain serve over a mesh.  Verdicts
are held to the JAX package's ``MeshEngine`` pipeline on the same
requests (its mesh on the eight virtual CPU devices of
tests/conftest.py, the port's on eight entries of ``cpu``); then the
hot swap, ``--mesh`` with ``--lanes``, a shard kernel failure on a card
stand-in, and a ``--mesh 2x4 --platform cpu`` server over the wire."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.parallel.serve_mesh import MeshEngine as JaxMesh
from ingress_plus_tpu.parallel.serve_mesh import parse_mesh_spec as jax_spec
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.parallel.serve_mesh import (
    MeshEngine,
    batch_mesh,
    parse_mesh_spec,
    run_lane_measurement,
)
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

REPO = Path(__file__).resolve().parents[1]

RULES = """
SecRule ARGS|REQUEST_BODY "@rx (?i)union\\s+select" "id:942100,phase:2,block,t:urlDecodeUni,t:lowercase,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS|REQUEST_BODY "@rx (?i)<script[^>]*>" "id:941100,phase:2,block,t:urlDecodeUni,t:htmlEntityDecode,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS "@rx /etc/(?:passwd|shadow)" "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@pm sleep( benchmark( xp_cmdshell" "id:942150,phase:2,block,severity:ERROR,tag:'attack-sqli'"
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jcr = jax_compile(jax_parse(RULES))
    path = tmp_path_factory.mktemp("pack") / "tiny"
    jcr.save(str(path))
    return jcr, CompiledRuleset.load(str(path))


def _requests():
    return [
        JaxRequest(method="GET",
                   uri="/p?q=1%27%20UNION%20SELECT%20password%20FROM%20users",
                   headers={}, body=b""),
        JaxRequest(method="GET", uri="/index.html?page=3", headers={},
                   body=b""),
        JaxRequest(method="GET", uri="/p?q=%3Cscript%3Ealert(1)%3C/script%3E",
                   headers={}, body=b""),
        JaxRequest(method="GET", uri="/p?f=../../etc/passwd", headers={},
                   body=b""),
        JaxRequest(method="POST", uri="/login", headers={},
                   body=b"user=jo&pass=hunter2"),
    ]


def _port(reqs):
    return [Request(**{f.name: getattr(r, f.name)
                       for f in dataclasses.fields(JaxRequest)})
            for r in reqs]


def _vt(v):
    return (v.request_id, v.attack, v.blocked, tuple(sorted(v.rule_ids)),
            v.score, tuple(v.classes), v.fail_open)


def _mesh_pipeline(cr, spec="2x4", impl=None):
    return DetectionPipeline(cr, mode="block", fail_open=False, device="cpu",
                             engine=MeshEngine(cr, parse_mesh_spec(
                                 spec, platform="cpu"), scan_impl=impl))


def test_parse_mesh_spec():
    m = parse_mesh_spec("data=2,model=4", platform="cpu")
    assert m.shape == {"data": 2, "model": 4}
    m = parse_mesh_spec("2x4", platform="cpu")
    assert m.shape == {"data": 2, "model": 4}
    assert m.devices() == [torch.device("cpu")] * 8
    for bad in ("data=0,model=4", "16x16", "3x3", "2x", "model=4"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, platform="cpu")
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        parse_mesh_spec("2x2", n_devices=2, platform="cpu")


def test_mesh_spec_on_cuda_counts_cards():
    """On cuda the mesh names distinct cards: without one it raises, and
    more entries than cards is refused."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="needs"):
            parse_mesh_spec("1x%d" % (n + 1))
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        parse_mesh_spec("1x1")


@pytest.mark.parametrize("impl", ["pair", "take"])
def test_mesh_pipeline_verdicts_equal_jax(tiny, impl):
    jcr, cr = tiny
    jreqs = _requests()
    ref = JaxPipeline(jcr, mode="block", fail_open=False)
    ref.engine = JaxMesh(jcr, jax_spec("2x4"), scan_impl=impl)
    want = [_vt(v) for v in ref.detect(jreqs)]
    assert any(w[1] for w in want) and not all(w[1] for w in want)
    got = [_vt(v) for v in _mesh_pipeline(cr, impl=impl).detect(
        _port(jreqs))]
    assert got == want
    single = DetectionPipeline(cr, mode="block", device="cpu")
    assert [_vt(v) for v in single.detect(_port(jreqs))] == got


def test_mesh_pipeline_verdicts_equal_jax_on_the_bundled_pack():
    """Seeded corpus traffic (bodies, headers, mixed stream-variants)
    through both packages' 2x4 mesh pipelines on the committed pack."""
    jcr, cr = JaxRuleset.load(str(BUNDLED_PACK)), load_pack()
    jreqs = [lr.request for lr in generate_corpus(n=48, seed=3)]
    ref = JaxPipeline(jcr, mode="block", fail_open=False)
    ref.engine = JaxMesh(jcr, jax_spec("2x4"), scan_impl="pair")
    want = [_vt(v) for v in ref.detect(jreqs)]
    got = [_vt(v) for v in _mesh_pipeline(cr).detect(_port(jreqs))]
    assert got == want
    assert 0 < sum(w[1] for w in want) < len(want)


def test_mesh_engine_surface(tiny):
    _, cr = tiny
    eng = MeshEngine(cr, parse_mesh_spec("2x4", platform="cpu"))
    assert eng.scan_impl == "pair" and eng.device == torch.device("cpu")
    assert not eng.head_slicing_active()
    info = eng.device_info()
    assert info["mesh"]["data"] == 2 and info["mesh"]["model"] == 4
    assert info["mesh"]["shard_launches"] == [[0] * 4, [0] * 4]
    assert info["n_rules"] == cr.n_rules
    assert eng.tables.device == torch.device("cpu")
    with pytest.raises(ValueError, match="cannot run"):
        eng.scan_impl = "pallas2"
    eng.scan_impl = "take"
    assert eng.rebuilt(cr).scan_impl == "take"
    eng.drop_compiled()
    p = DetectionPipeline(cr, mode="block", device="cpu", engine=eng)
    assert [v.attack for v in p.detect(_port(_requests()))] == \
        [True, False, True, True, False]


def test_mesh_engine_survives_hot_swap(tiny):
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    jcr, cr = tiny
    b = Batcher(_mesh_pipeline(cr), max_batch=8, max_delay_s=0.0001)
    try:
        cr2 = CompiledRuleset.load(str(BUNDLED_PACK))
        b.swap_ruleset(cr2)
        assert isinstance(b.pipeline.engine, MeshEngine)
        assert b.pipeline.engine.ruleset is cr2
        got = [_vt(f.result(timeout=60))
               for f in [b.submit(r) for r in _port(_requests())]]
        want = [_vt(v) for v in DetectionPipeline(
            cr2, mode="block", device="cpu").detect(_port(_requests()))]
        assert got == want
    finally:
        b.close()


def test_mesh_launch_counts_outlive_a_swap(tiny, monkeypatch):
    """The per-shard launch grid of ``/debug/kernels`` ``mesh`` keeps
    counting across ``swap_ruleset`` and ``rebuilt`` (the batcher's hot
    swap), as the kernels' own tallies do, and counts the serving cycles
    only: launches under the rollout's scope stay out.  Each shard's
    "kernel" is stood in for by the plain scan, so launches count on the
    CPU."""
    from ingress_plus_tpu_torch.ops.cuda_build import (
        ROLLOUT_SCOPE,
        launch_scope,
    )
    from ingress_plus_tpu_torch.ops.scan import scan_pairs
    from ingress_plus_tpu_torch.parallel.shard import ShardedEngine

    def plain_kernel(self, device, s):
        tabs = self.shard_tables(device, s).scan
        return lambda tok, ln: scan_pairs(tabs, tok, ln)

    monkeypatch.setattr(ShardedEngine, "scanner", plain_kernel)
    _, cr = tiny
    cr2 = CompiledRuleset.load(str(BUNDLED_PACK))
    eng = MeshEngine(cr, parse_mesh_spec("2x4", platform="cpu"))

    def served(e, ruleset):
        DetectionPipeline(ruleset, mode="block", device="cpu",
                          engine=e).detect(_port(_requests()))
        return e.mesh_info()["shard_launches"]

    first = served(eng, cr)
    assert all(n > 0 for row in first for n in row)
    per_step = [list(r) for r in first]
    eng.swap_ruleset(cr2)
    assert eng.mesh_info()["shard_launches"] == per_step
    twice = served(eng, cr2)
    assert all(n > m for r2, r1 in zip(twice, per_step)
               for n, m in zip(r2, r1))
    snap = [list(r) for r in twice]
    new = eng.rebuilt(cr)
    assert new.mesh_info()["shard_launches"] == snap
    with launch_scope(ROLLOUT_SCOPE):
        served(new, cr)
    assert new.mesh_info()["shard_launches"] == snap
    assert served(new, cr) == eng.mesh_info()["shard_launches"]
    assert new.mesh_info()["shard_launches"] != snap


@pytest.mark.parametrize("lanes", [0, 2])
def test_mesh_with_lanes_is_refused(lanes):
    from ingress_plus_tpu_torch.serve.server import build_default_batcher

    with pytest.raises(ValueError, match="--mesh"):
        build_default_batcher(mesh_spec="2x4", n_lanes=lanes,
                              platform="cpu", warmup=False)


def test_mesh_maps_the_single_device_kernels_to_pallas2(tiny, capsys):
    """``--scan-impl pallas3`` under ``--mesh`` becomes ``pallas2``, as in
    the JAX server — which a CPU mesh then refuses (pallas2 is the card's
    kernel)."""
    from ingress_plus_tpu_torch.serve.server import build_default_batcher

    with pytest.raises(ValueError, match="cannot run"):
        build_default_batcher(mesh_spec="1x1", scan_impl="pallas3",
                              platform="cpu", warmup=False)
    assert "--scan-impl pallas3 -> pallas2" in capsys.readouterr().err
    b = build_default_batcher(mesh_spec="1x2", platform="cpu",
                              warmup=False)
    try:
        assert isinstance(b.pipeline.engine, MeshEngine)
        # auto on cpu: the bake-off's fastest of pair and take
        timings = b.pipeline.engine.sharded.last_timings
        assert set(timings) == {"pair", "take"}
        assert b.pipeline.engine.scan_impl == min(timings, key=timings.get)
    finally:
        b.close()


def test_shard_kernel_failure_fails_the_batch_open(tiny, monkeypatch):
    """A mesh pipeline on a card whose shard kernel raises: its batches
    fail open through the breaker, which opens, and the breaker-open
    batches fail open too — ``detect_cpu_only`` is never reached.  The
    card is stood in for: the engine's device reads ``cuda:0`` while
    its tensors stay on the CPU, and every shard scanner raises as a
    failed kernel launch does."""
    from ingress_plus_tpu_torch.ops.pair_scan import PairScanner
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    class Raising(PairScanner):
        def __call__(self, *a, **kw):
            raise RuntimeError("pair-scan kernel launch failed: CUDA "
                               "error 700")

    _, cr = tiny
    p = _mesh_pipeline(cr)
    eng = p.engine
    monkeypatch.setattr(eng, "device", torch.device("cuda", 0))
    sh = eng.sharded
    monkeypatch.setattr(sh, "scanner", lambda device, s: Raising(
        sh.shard_tables(device, s).scan))
    reached = []
    monkeypatch.setattr(p, "detect_cpu_only",
                        lambda reqs: reached.append(len(reqs)) or [])
    b = Batcher(p, max_batch=8, max_delay_s=0.001, hard_deadline_s=5.0,
                breaker_failures=1, breaker_cooldown_s=60.0,
                lane_devices=[torch.device("cpu")])
    try:
        verdicts = []
        for _ in range(4):
            verdicts += [f.result(timeout=30) for f in
                         [b.submit(r) for r in _port(_requests())]]
            if not b.device_available():
                break
        assert not b.device_available()
        verdicts += [f.result(timeout=30) for f in
                     [b.submit(r) for r in _port(_requests())]]
        assert reached == []
        assert b.stats.cpu_fallback_batches == 0
        assert b.stats.breaker_fail_open_batches >= 1
        assert verdicts and all(v.fail_open and not v.blocked
                                for v in verdicts)
    finally:
        b.close()


def test_batch_mesh_puts_every_device_on_data():
    m = batch_mesh(["cpu", "cpu", "cpu"])
    assert m.shape == {"data": 3, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            batch_mesh()


def test_lane_measurement_on_cpu(tiny):
    _, cr = tiny
    rep = run_lane_measurement(cr, 1, n_req=32, max_batch=8,
                               device="cpu", tier_warmup=False)
    assert rep["platform"] == "cpu" and rep["verdicts"] == 32
    assert rep["req_per_s_mesh"] > 0 and rep["fail_open"] == 0
    assert rep["per_lane"][0]["requests"] >= 32


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_mesh_serving_over_wire(tmp_path):
    """A ``--mesh 2x4 --platform cpu`` server subprocess answers over the
    UDS protocol with the sharded step's verdicts, and reports its mesh
    on ``/rules/stats`` and ``/debug/kernels``."""
    from ingress_plus_tpu_torch.serve.protocol import (
        RESP_MAGIC,
        FrameReader,
        decode_response,
        encode_request,
    )

    rules_dir = tmp_path / "rules"
    rules_dir.mkdir()
    (rules_dir / "tiny.conf").write_text(RULES)
    sock_path = str(tmp_path / "mesh.sock")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
         "--socket", sock_path, "--http-port", str(port),
         "--rules-dir", str(rules_dir), "--platform", "cpu",
         "--scan-impl", "pair", "--mesh", "2x4", "--max-delay-us", "1000",
         "--no-warmup",
         "--hard-deadline-ms", "10000"],
        cwd=str(REPO), env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            if Path(sock_path).exists():
                try:
                    s = socket.socket(socket.AF_UNIX)
                    s.connect(sock_path)
                    s.close()
                    break
                except OSError:
                    pass
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.time() < deadline, "socket never appeared"
            time.sleep(0.1)
        s = socket.socket(socket.AF_UNIX)
        s.connect(sock_path)
        s.sendall(encode_request(
            Request(uri="/q?a=1+union+select+2"), req_id=9001))
        s.sendall(encode_request(Request(uri="/benign"), req_id=9002))
        reader = FrameReader(RESP_MAGIC)
        got = {}
        s.settimeout(120)
        while len(got) < 2:
            for f in reader.feed(s.recv(65536)):
                r = decode_response(f)
                got[r["req_id"]] = r
        s.close()
        assert got[9001]["attack"] and got[9001]["blocked"]
        assert 942100 in got[9001]["rule_ids"]
        assert not got[9002]["attack"]

        def get(path):
            with urllib.request.urlopen("http://127.0.0.1:%d%s"
                                        % (port, path), timeout=30) as r:
                return json.loads(r.read())

        dev = get("/rules/stats")["device"]
        assert dev["scan_impl"] == "pair"
        assert (dev["mesh"]["data"], dev["mesh"]["model"]) == (2, 4)
        kern = get("/debug/kernels")
        assert kern["mesh"]["devices"] == [["cpu"] * 4] * 2
        # the CPU launches no kernel
        assert kern["mesh"]["shard_launches"] == [[0] * 4] * 2
        assert kern["pair_scan"]["launches"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=20)
