"""``tests/torch_ported_tests.py`` ``ported()`` on small generated files.

A generated "JAX test file" (``ingress_plus_tpu`` names, rewritten onto
the port) constructs the port without a device in the ways the JAX
package's files do: through a function-local import, and inside the
port's own helpers (``build_feature_dataset`` resolves ``None``;
``build_default_batcher`` defaults its ``platform`` to ``"cuda"``).  A
twin of it runs in a pytest child beside a hand-written test of its
own and a later module: the port's pipelines land on the CPU for the
twin's cases only, and the port is as it was for the others.  A stale
``exclude`` name fails the import.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from torch_ported_tests import ported

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

#: the file ``ported()`` rewrites: every construction leaves the device out
_JAX_FILE = '''
from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang

RULES = (\'SecRule ARGS "@rx (?i)union\\\\s+select" \'
         \'"id:1001,phase:2,deny,t:urlDecodeUni,tag:\\\'attack-sqli\\\'"\\n\')


def _cr():
    return compile_ruleset(parse_seclang(RULES))


def test_local_import_gets_the_device():
    from ingress_plus_tpu.models.pipeline import DetectionPipeline

    assert DetectionPipeline(_cr()).engine.device.type == "cpu"


def test_helper_pipeline_gets_the_device(tmp_path, monkeypatch):
    from ingress_plus_tpu.models import pipeline
    from ingress_plus_tpu.serve.server import build_default_batcher
    from ingress_plus_tpu.utils.export_corpus import build_feature_dataset

    seen = []
    init = pipeline.DetectionPipeline.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        seen.append(self.engine.device.type)

    monkeypatch.setattr(pipeline.DetectionPipeline, "__init__", spy)
    build_feature_dataset(n=8, ruleset=_cr(), include_fixtures=False,
                          batch=8)
    (tmp_path / "r.conf").write_text(RULES)
    build_default_batcher(rules_dir=str(tmp_path), warmup=False).close()
    assert seen == ["cpu", "cpu"]
'''

#: the port as it is, whatever ran before in the process
_AS_IT_IS = '''
def _port_as_it_is():
    import ingress_plus_tpu_torch.models.engine as engine
    import ingress_plus_tpu_torch.utils.device as device
    from ingress_plus_tpu_torch.serve.server import build_default_batcher

    assert device.resolve_device.__qualname__ == "resolve_device"
    assert engine.resolve_device is device.resolve_device
    assert "cuda" in build_default_batcher.__defaults__
'''

_TWIN = '''
import sys
sys.path[:0] = [%r, %r]
from pathlib import Path
from torch_ported_tests import ported

globals().update(ported("gen_jax", exclude={}, root=Path(__file__).parent))
%s

def test_own_case_sees_the_port_as_it_is():
    _port_as_it_is()
''' % (str(TESTS), str(REPO), _AS_IT_IS)

_LATER = '''
%s

def test_later_module_sees_the_port_as_it_is():
    _port_as_it_is()
''' % _AS_IT_IS


@pytest.fixture(scope="module")
def child_outcomes(tmp_path_factory):
    """{test name: PASSED / FAILED / ...} of one pytest child over the
    generated twin and a module that runs after it."""
    d = tmp_path_factory.mktemp("ported")
    (d / "gen_jax.py").write_text(_JAX_FILE)
    (d / "test_a_twin.py").write_text(_TWIN)
    (d / "test_b_later.py").write_text(_LATER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", str(d)],
        cwd=str(d), env=env, capture_output=True, text=True, timeout=600)
    out = dict((m.group(2), m.group(1)) for m in re.finditer(
        r"^(PASSED|FAILED|ERROR|SKIPPED) \S+::(\w+)", p.stdout, re.M))
    assert len(out) == 4, p.stdout + p.stderr
    return out


def test_function_local_import_gets_the_cpu(child_outcomes):
    assert child_outcomes["test_local_import_gets_the_device"] == "PASSED"


def test_library_helpers_pipelines_get_the_cpu(child_outcomes):
    assert child_outcomes["test_helper_pipeline_gets_the_device"] == "PASSED"


def test_other_tests_see_the_port_as_it_is(child_outcomes):
    assert child_outcomes["test_own_case_sees_the_port_as_it_is"] == "PASSED"
    assert child_outcomes["test_later_module_sees_the_port_as_it_is"] \
        == "PASSED"


def test_stale_exclude_name_fails_the_import(tmp_path):
    (tmp_path / "gen_jax.py").write_text(_JAX_FILE)
    got = ported("gen_jax", exclude={"test_local_import_gets_the_device":
                                     "a reason"}, root=tmp_path)
    assert "test_local_import_gets_the_device" not in got
    assert "test_helper_pipeline_gets_the_device" in got
    with pytest.raises(LookupError, match="test_gone"):
        ported("gen_jax", exclude={"test_gone": "a reason"}, root=tmp_path)


def test_twins_import_nothing_of_the_jax_package():
    """A twin that holds no test of its own reads its JAX file as text
    and imports nothing of ``ingress_plus_tpu``."""
    twins = [p for p in sorted(TESTS.glob("test_torch_*.py"))
             if "ported(" in p.read_text()
             and "def test_" not in p.read_text()]
    assert len(twins) >= 38
    for p in twins:
        assert not re.search(r"^\s*(from|import) ingress_plus_tpu\b",
                             p.read_text(), re.M), p.name


def test_card_files_run_whole_on_the_cpu():
    """``chip_smoke.py`` phase 18 holds each file's card passes to its
    CPU leg's count less the card's exclusions: so each file's CPU twin
    runs it whole."""
    import chip_smoke

    for name in chip_smoke.CARD_FILES:
        twins = [p for p in TESTS.glob("test_torch_%s*.py" % name[5:])
                 if 'ported("%s", exclude={})' % name in p.read_text()]
        assert len(twins) == 1, name


def test_card_phase_rehearsal_on_cpu(monkeypatch):
    """Phase 18's child on the CPU: every case but the one left out
    passes, and the count is held to what the file collects."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CARD_EXCLUDE", {
        "test_anomaly_mode": ("test_resolve_macros_helper",)})
    got = chip_smoke.phase_card_files("rehearsal", device="cpu",
                                      files=("test_anomaly_mode",))
    f = got["files"]["test_anomaly_mode"]
    assert (f["collected"], f["excluded"], f["passed"], f["failed"]) \
        == (10, 1, 9, 0)
    assert got["passed"] == 9


def test_card_phase_fails_when_a_case_fails(monkeypatch):
    """A card run without a card: every case raises, and the phase
    fails rather than counting it."""
    import chip_smoke

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(SystemExit, match="phase 18"):
        chip_smoke.phase_card_files("rehearsal", device="cuda",
                                    files=("test_anomaly_mode",))
