"""The port stands alone: no JAX, nothing of ``ingress_plus_tpu``.

``ingress_plus_tpu_torch`` shares a prefix with ``ingress_plus_tpu``, so
every check here compares whole dotted names, never prefixes.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ingress_plus_tpu_torch"


def _is_jax_package(name: str) -> bool:
    return name == "ingress_plus_tpu" or name.startswith("ingress_plus_tpu.")


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_name_predicate_tells_the_packages_apart():
    assert _is_jax_package("ingress_plus_tpu")
    assert _is_jax_package("ingress_plus_tpu.ops.scan")
    assert not _is_jax_package("ingress_plus_tpu_torch")
    assert not _is_jax_package("ingress_plus_tpu_torch.ops.scan")


def test_no_source_file_imports_jax_or_the_jax_package():
    # build/ holds what the package builds at run time, not its sources
    files = sorted(p for p in PORT.rglob("*.py")
                   if p.relative_to(PORT).parts[0] != "build")
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (f, name)
            assert not _is_jax_package(name), (f, name)


_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
import torch
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.weights import load_pack
pl = DetectionPipeline(load_pack(), device="cpu")
from ingress_plus_tpu_torch.serve.stream import StreamEngine
v = pl.detect([Request(uri="/q?id=1'+UNION+SELECT+password+FROM+users--",
                       headers={"host": "a.example"}, request_id="r1"),
               Request(uri="/index.html", headers={"host": "a.example"},
                       request_id="r2")])
eng = StreamEngine(pl)
meta = Request(method="POST", uri="/upload", headers={"host": "a.example"},
               request_id="s1")
st = eng.begin(meta)
st.base_hits = pl.prefilter([meta])[0]
for chunk in (b"comment=hello+1'+UNI", b"ON+SELECT+password+FROM+users--"):
    eng.scan(st.feed(chunk))
eng.scan(st.flush())
v.append(eng.finish(st))
print(json.dumps({
    "verdicts": [[x.request_id, x.attack, x.blocked, x.fail_open]
                 for x in v],
    "waves": eng.stats.waves,
    "modules": sorted(m for m in sys.modules
                      if m == "ingress_plus_tpu"
                      or m.startswith("ingress_plus_tpu.")
                      or m.split(".")[0] == "jax"
                      and sys.modules[m] is not None)}))
"""


def test_port_imports_and_detects_with_jax_absent():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] == []
    assert out["verdicts"] == [["r1", True, True, False],
                               ["r2", False, False, False],
                               ["s1", True, True, False]]
    assert out["waves"] >= 1


def test_kernel_impl_on_cpu_device_raises():
    from ingress_plus_tpu_torch.models.engine import DetectionEngine
    from ingress_plus_tpu_torch.weights import load_pack

    for impl in ("pallas", "pallas3"):
        with pytest.raises(ValueError, match="need CUDA"):
            DetectionEngine(load_pack(), scan_impl=impl, device="cpu")


def test_entry_point_without_device_raises_without_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.ops.scan import ScanTables
    from ingress_plus_tpu_torch.utils.device import resolve_device
    from ingress_plus_tpu_torch.weights import load_pack

    cr = load_pack()
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionPipeline(cr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanTables.from_bitap(cr.tables)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


_SERVE_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None   # and of the JAX package
import ingress_plus_tpu_torch.serve.server
import ingress_plus_tpu_torch.serve.websocket
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.batcher import Batcher
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.weights import load_pack
b = Batcher(DetectionPipeline(load_pack(), device="cpu", confirm_workers=2),
            max_batch=8, hard_deadline_s=30.0)
try:
    v = b.submit(Request(uri="/q?id=1'+UNION+SELECT+password+FROM+users--",
                         request_id="r1")).result(timeout=120)
finally:
    b.close()
print(json.dumps({
    "verdict": [v.request_id, v.attack, v.blocked, v.fail_open],
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_serve_plane_imports_and_batches_with_jax_absent():
    proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD],
                          cwd=str(REPO), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["modules"] == []
    assert out["verdict"] == ["r1", True, True, False]


_SERVER = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None
from ingress_plus_tpu_torch.serve.server import main
main(sys.argv[1:])
"""


def test_serve_subprocess_answers_a_frame_with_jax_absent(tmp_path):
    import socket
    import time

    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.protocol import (
        RESP_MAGIC,
        FrameReader,
        decode_response,
        encode_request,
    )

    sock = str(tmp_path / "iso.sock")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER, "--socket", sock, "--http-port", "0",
         "--platform", "cpu", "--scan-impl", "pair", "--no-warmup",
         "--hard-deadline-ms", "5000"],
        cwd=str(REPO), env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not Path(sock).exists():
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.time() < deadline, "socket never appeared"
            time.sleep(0.1)
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(60)
        s.connect(sock)
        s.sendall(encode_request(Request(
            uri="/q?id=1'+UNION+SELECT+password+FROM+users--"), 42))
        reader, got = FrameReader(RESP_MAGIC), []
        while not got:
            data = s.recv(1 << 16)
            assert data, "server closed the connection"
            got = reader.feed(data)
        s.close()
        r = decode_response(got[0])
        assert (r["req_id"], r["attack"], r["blocked"], r["fail_open"]) == \
            (42, True, True, False)
    finally:
        proc.terminate()
        proc.wait(timeout=20)


_ROLLOUT_CHILD = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None
import ingress_plus_tpu_torch.analysis
import ingress_plus_tpu_torch.compiler.profile
import ingress_plus_tpu_torch.utils.benign_fixtures
from ingress_plus_tpu_torch.compiler import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.control.rollout import (
    _DRILL_CANDIDATE, _DRILL_INCUMBENT, RolloutConfig, RolloutController)
from ingress_plus_tpu_torch.utils.faults import _mk_batcher
inc = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
cand = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
b = _mk_batcher(cr=inc, device="cpu")
ro = RolloutController(b, RolloutConfig(corpus_n=32))
b.rollout = ro
report = ro.admit(ruleset=cand)
b.close()
print(json.dumps({
    "state": report["state"], "new_fns": report["replay"]["new_fns"],
    "rules": [inc.n_rules, cand.n_rules],
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def test_compiler_and_rollout_admit_with_jax_absent():
    """The compiler, the analyzers and a rollout admission import and
    run with jax and the JAX package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _ROLLOUT_CHILD],
                          cwd=str(REPO), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"state": "shadow", "new_fns": 0, "rules": [2, 3],
                   "modules": []}


_POST_LEARN_CHILD = r"""
import json, sys, tempfile
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None   # and of the JAX package
import ingress_plus_tpu_torch.post.export
import ingress_plus_tpu_torch.learn.train
from ingress_plus_tpu_torch.learn.train import TrainConfig, train_from_dataset
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.post import PostChannel
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.utils.export_corpus import build_feature_dataset
from ingress_plus_tpu_torch.weights import load_pack
ds = build_feature_dataset(n=32, seed=3, ruleset=load_pack(), batch=16,
                           include_fixtures=False, device="cpu")
head = train_from_dataset(ds, TrainConfig(iters=20))
pl = DetectionPipeline(load_pack(), device="cpu", scoring_head=head)
ch = PostChannel(spool_dir=tempfile.mkdtemp(), brute=False)
reqs = [lr.request for lr in generate_corpus(n=16, seed=3)]
for r, v in zip(reqs, pl.detect(reqs)):
    ch.record(r, v)
print(json.dumps({
    "rows": ds.n, "head": head.version == head.fingerprint(),
    "exported": ch.exporter.flush_once() > 0,
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def test_post_plane_and_scoring_head_run_with_jax_absent():
    """The feature export, the trainer, a head-scored pipeline and the
    post channel's export, in a process where jax and the JAX package
    cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", _POST_LEARN_CHILD],
                          cwd=str(REPO), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rows": 32, "head": True, "exported": True,
                   "modules": []}


_TOOLING_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None   # and of the JAX package
from ingress_plus_tpu_torch.compiler.packgen import scale_rules
from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
from ingress_plus_tpu_torch.models.libdetect import detect_sqli, native_library
from ingress_plus_tpu_torch.utils.evalf1 import evaluate
from ingress_plus_tpu_torch.utils.microbench import best_time
from ingress_plus_tpu_torch.utils.platform import ensure_live_backend
rep = evaluate(n=32, batch=32, seed=5,
               device=ensure_live_backend("cpu"))
print(json.dumps({
    "native": native_library() is not None,
    "sqli": detect_sqli(b"1' UNION SELECT a FROM b--"),
    "scaled": len(scale_rules(load_bundled_rules(), 0.5)),
    "f1": [rep.n, rep.platform],
    "timed": best_time(lambda k, rep: None, 1, device="cpu") >= 0,
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def test_native_twin_and_tooling_run_with_jax_absent():
    """The native confirm twin, packgen, evalf1, the microbench timing
    and the card probe import and run with jax and the JAX package
    unimportable."""
    env = _env()
    env.pop("IPT_NO_NATIVE_CONFIRM", None)
    proc = subprocess.run([sys.executable, "-c", _TOOLING_CHILD],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"native": True, "sqli": True, "scaled": 1007,
                   "f1": [32, "cpu"], "timed": True, "modules": []}


_SCALE_OUT_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None   # and of the JAX package
import ingress_plus_tpu_torch.parallel
import ingress_plus_tpu_torch.parallel.dcn
import ingress_plus_tpu_torch.parallel.mesh
import ingress_plus_tpu_torch.parallel.serve_mesh
import ingress_plus_tpu_torch.parallel.shard
import ingress_plus_tpu_torch.parallel.stream
import ingress_plus_tpu_torch.serve.front
import ingress_plus_tpu_torch.control.fleetctl
import ingress_plus_tpu_torch.control.fleetobs
import ingress_plus_tpu_torch.control.retune
import ingress_plus_tpu_torch.control.retuned
import ingress_plus_tpu_torch.utils.promparse
import ingress_plus_tpu_torch.utils.slo
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.parallel.serve_mesh import (
    MeshEngine, parse_mesh_spec)
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.faults import run_fault_matrix
from ingress_plus_tpu_torch.weights import load_pack
cr = load_pack()
pl = DetectionPipeline(cr, device="cpu", engine=MeshEngine(
    cr, parse_mesh_spec("2x4", platform="cpu")))
v = pl.detect([Request(uri="/q?id=1'+UNION+SELECT+password+FROM+users--",
                       headers={"host": "a.example"}, request_id="r1")])
rep = run_fault_matrix(only=["fleet_node_kill"], device="cpu")
print(json.dumps({
    "verdict": [v[0].request_id, v[0].attack, v[0].blocked],
    "fleet": rep["passed"],
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def test_mesh_and_fleet_run_with_jax_absent():
    """``parallel/``, the front, the fleet observer and controller, the
    retune daemon and their utilities import, and a 2x4 mesh pipeline
    and a fleet node-kill drill run, with jax and the JAX package
    unimportable."""
    proc = subprocess.run([sys.executable, "-c", _SCALE_OUT_CHILD],
                          cwd=str(REPO), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"verdict": ["r1", True, True], "fleet": True,
                   "modules": []}


_FRONT_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None
sys.modules["torch"] = None        # the front must not need torch at all
import runpy
runpy.run_module("ingress_plus_tpu_torch.serve", run_name="__main__")
"""


def test_front_process_runs_without_torch(tmp_path):
    """``python -m ingress_plus_tpu_torch.serve --front`` starts and
    answers with torch itself unimportable: the front imports no kernel
    and can create no CUDA context.  With its one backend absent, it
    answers a request with its own fail-open verdict."""
    import socket
    import time

    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.protocol import (
        RESP_MAGIC,
        FrameReader,
        decode_response,
        encode_request,
    )

    sock = str(tmp_path / "front.sock")
    proc = subprocess.Popen(
        [sys.executable, "-c", _FRONT_CHILD, "--front", "--socket", sock,
         "--http-port", "0", "--backend",
         "n0=%s" % (tmp_path / "absent.sock"), "--platform", "cuda"],
        cwd=str(REPO), env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while not Path(sock).exists():
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.time() < deadline, "socket never appeared"
            time.sleep(0.05)
        s = socket.socket(socket.AF_UNIX)
        s.settimeout(30)
        s.connect(sock)
        s.sendall(encode_request(Request(uri="/q?a=1"), 7))
        reader, got = FrameReader(RESP_MAGIC), []
        while not got:
            data = s.recv(1 << 16)
            assert data, "front closed the connection"
            got = reader.feed(data)
        s.close()
        r = decode_response(got[0])
        assert (r["req_id"], r["attack"], r["fail_open"]) == (7, False, True)
    finally:
        proc.terminate()
        proc.wait(timeout=20)


_CONTROL_CHILD = r"""
import json, sys, tempfile
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["jaxlib"] = None
sys.modules["ingress_plus_tpu"] = None   # and of the JAX package
import ingress_plus_tpu_torch.control.admission as admission
import ingress_plus_tpu_torch.control.annotations
import ingress_plus_tpu_torch.control.config
import ingress_plus_tpu_torch.control.deploy as deploy
import ingress_plus_tpu_torch.control.model
import ingress_plus_tpu_torch.control.objects as objects
import ingress_plus_tpu_torch.control.sync as sync
import ingress_plus_tpu_torch.control.template
from chip_smoke import config4_manifests
items, cm = config4_manifests(1)
ings = [objects.Ingress.from_dict(d) for d in items]
r = sync.SyncController().sync(ings, objects.ConfigMap.from_dict(cm),
                               push=False)
print(json.dumps({
    "action": r.action, "tenants": len(r.configuration.tenant_tags()),
    "lint": admission.lint_rendered(r.rendered),
    "admitted": admission.validate(ings[0], ings).allowed,
    "written": deploy.write_static(tempfile.mkdtemp()),
    "modules": sorted(m for m in sys.modules
                      if (m == "ingress_plus_tpu"
                          or m.startswith("ingress_plus_tpu.")
                          or m.split(".")[0] == "jax")
                      and sys.modules[m] is not None)}))
"""


def test_controller_render_layer_runs_with_jax_absent():
    """The seven controller modules (objects, annotations, config, model,
    template, admission, deploy) and the whole of sync import, render,
    admit, sync config #4 and write the manifests with jax and the JAX
    package unimportable."""
    proc = subprocess.run([sys.executable, "-c", _CONTROL_CHILD],
                          cwd=str(REPO), env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"action": "reload", "tenants": 256, "lint": [],
                   "admitted": True,
                   "written": ["configmap.yaml", "deployment.yaml",
                               "fleet.yaml", "service.yaml"],
                   "modules": []}


def test_control_package_imports_no_torch():
    """``import ingress_plus_tpu_torch.control`` (which ``python -m
    ingress_plus_tpu_torch.control.fleetobs`` and ``.retuned`` run first)
    and its render layer need neither torch nor numpy."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "sys.modules['numpy'] = None\n"
            "import ingress_plus_tpu_torch.control as c\n"
            "import ingress_plus_tpu_torch.control.admission\n"
            "import ingress_plus_tpu_torch.control.deploy\n"
            "g = c.GlobalConfig()\n"
            "print(len(c.render(c.build_configuration([], g), g)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) > 0
