"""concheck over the port's own serve plane.

The JAX package's ``tests/test_concheck.py`` runs here whole against the
port's ``analysis/`` (fixture trees, the whole-tree gate under the
port's baseline, the CLI, the instrumented-lock twin, the pinned
counter fixes on the port's ``PipelineStats`` and ``BatcherStats``).
The cases below hold the port's report to the JAX package's over its
own tree and pin what only the port has: its thread boundary and the
admission CUDA stream made once.
"""

import ast
import json
import re

from torch_ported_tests import ported

from ingress_plus_tpu_torch.analysis.concheck import (
    BASELINE_PATH,
    run_concheck,
)
from ingress_plus_tpu_torch.analysis.threadmap import (
    PACKAGE_ROOT,
    SERVE_PLANE_FILES,
    THREAD_ROOTS,
    parse_tree,
)

globals().update(ported("test_concheck", exclude={}))


_ROOTS = re.compile(r"from thread roots \{([^}]*)\}")


def _split(f):
    """(finding key with the thread-root set cut out, that set)."""
    m = _ROOTS.search(f.message)
    roots = frozenset(m.group(1).split(",")) if m else frozenset()
    return ((f.check, f.severity, f.subject, _ROOTS.sub("", f.message),
             f.suppressed), roots)


def test_findings_equal_the_jax_packages_over_its_own_tree():
    """Finding for finding (lines aside: the files differ), with and
    without each package's baseline.  One difference is the port's on
    purpose: on a card the shadow thread runs the candidate's own
    prefilter, so ``PipelineStats`` counters the JAX shadow's
    ``detect_cpu_only`` never touched gain the ``shadow`` root."""
    from ingress_plus_tpu.analysis.concheck import (
        run_concheck as jax_run_concheck,
    )

    for bl in ("auto", None):
        port = dict(map(_split, run_concheck(baseline_path=bl).findings))
        ref = dict(map(_split, jax_run_concheck(baseline_path=bl).findings))
        assert sorted(port) == sorted(ref), bl
        gained = {k[2] for k in port if port[k] != ref[k]}
        for k in port:
            assert port[k] - ref[k] <= {"shadow"} and ref[k] <= port[k], k
        assert gained and all(s.startswith("PipelineStats.")
                              for s in gained), gained


def test_admission_stream_is_made_once_without_a_race():
    """The admission CUDA stream is made when the controller is built,
    so no thread root mutates it: a lazy check-then-set in
    ``_admission_device`` was reached from the control thread and the
    admission worker both."""
    report = run_concheck(baseline_path=None)
    assert not [f for f in report.findings if "_admit_stream" in f.message]
    tree = ast.parse((PACKAGE_ROOT / "control" / "rollout.py").read_text())
    writers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Attribute)
                        and t.attr == "_admit_stream" for t in node.targets):
                    writers.add(fn.name)
    assert writers == {"__init__"}


def test_admission_stream_is_none_on_a_cpu_controller():
    from ingress_plus_tpu_torch.control.rollout import (
        RolloutConfig,
        RolloutController,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.weights import load_pack

    b = Batcher(DetectionPipeline(load_pack(), device="cpu"))
    try:
        ro = RolloutController(b, RolloutConfig())
        assert ro._admit_stream is None
        with ro._admission_device():
            pass
    finally:
        b.close()


def test_baseline_reasons_describe_the_port():
    spec = json.loads(BASELINE_PATH.read_text())
    by_class = {e["class"]: e["reason"] for e in spec["suppressions"]}
    assert set(by_class) == {"PipelineStats", "ConfirmJob"}
    reason = by_class["PipelineStats"]
    assert "candidate's own kernels" in reason
    assert "CUDA stream" in reason
    assert "detect_cpu_only replay" not in reason


def test_every_root_entry_is_a_function_of_the_port():
    mm = parse_tree()
    assert len(THREAD_ROOTS) == 11
    for root in THREAD_ROOTS:
        for entry in root.entries:
            assert entry in mm.functions, (root.name, entry)


def test_threads_outside_the_serve_plane_are_the_documented_ones():
    """Every ``threading.Thread`` the port starts outside
    ``SERVE_PLANE_FILES`` is one that ``threadmap`` names as lying
    outside the boundary (a load generator, a process of its own, a drill
    harness, a test double); ``parallel/`` starts none."""
    outside = set()
    for path in PACKAGE_ROOT.rglob("*.py"):
        rel = path.relative_to(PACKAGE_ROOT).as_posix()
        if rel.startswith("build/") or rel in SERVE_PLANE_FILES:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr == "Thread":
                outside.add(rel)
    assert outside == {"serve/client.py", "serve/front.py",
                       "control/fleetobs.py", "control/fleetctl.py",
                       "utils/faults.py"}
