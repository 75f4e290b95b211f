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
