"""The port's quality gates (``utils/quality_report.py``,
``utils/prefilter_gate.py``), held to the JAX package.

The JAX package's ``tests/test_quality.py`` runs here against the port
on a CPU pipeline of the bundled pack.  The cases below hold
``build_report`` and ``run_gate`` to the JAX package's at small sizes,
pin that both default to the card (and raise without one), and that
the report's CLI writes where it is told, never into ``reports/``.
"""

import hashlib
import json
from pathlib import Path

import pytest
from torch_ported_tests import ported

from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.utils import prefilter_gate, quality_report

REPO = Path(__file__).resolve().parent.parent

globals().update(ported("test_quality", exclude={}))


@pytest.fixture(scope="module")
def pipeline():
    return DetectionPipeline(compile_ruleset(load_bundled_rules()),
                             mode="monitoring", device="cpu")


_BLOCKS = ("evasion", "benign", "benign_fixture", "ruleset")


def test_build_report_equals_the_jax_packages():
    from ingress_plus_tpu.utils.quality_report import (
        build_report as jax_build_report,
    )

    port = quality_report.build_report(n_benign=400, device="cpu")
    ref = jax_build_report(n_benign=400)
    for block in _BLOCKS:
        assert port[block] == ref[block], block
    assert (port["platform"], port["scan_impl"]) == ("cpu", "pair")
    assert port["evasion"]["total"] >= 400
    assert port["benign"]["total"] == 400


def test_run_gate_equals_the_jax_packages(pipeline):
    from ingress_plus_tpu.utils.prefilter_gate import (
        run_gate as jax_run_gate,
    )

    kw = dict(n=192, fuzz_per_attack=2, seed=1234, batch=64,
              progress=False)
    # the reference is a second CPU pipeline: the parity path runs, and
    # two plain scans of one pack must agree on every chunk
    port = prefilter_gate.run_gate(pipeline=pipeline, reference=pipeline,
                                   **kw)
    ref = jax_run_gate(**kw)
    for k in ref:
        if k != "elapsed_s":
            assert port[k] == ref[k], k
    assert port["mismatches"] == 0
    assert port["normal_rule_hits"] == port["confirm_only_rule_hits"] > 0
    assert port["requests_fuzzed"] > 0
    assert port["reference_chunks"] == -(-port["requests_total"] // 64)
    assert port["reference_unequal_chunks"] == 0


def test_run_gate_counts_an_unequal_reference_chunk(pipeline):
    """A reference whose prefilter differs on a chunk is counted."""

    class _Off:
        def prefilter(self, chunk):
            out = pipeline.prefilter(chunk)
            out[0] = ~out[0]
            return out

    rep = prefilter_gate.run_gate(n=32, fuzz_per_attack=1, seed=9,
                                  batch=16, pipeline=pipeline,
                                  reference=_Off(), progress=False)
    assert rep["reference_unequal_chunks"] == rep["reference_chunks"] > 0
    assert rep["mismatches"] == 0


def test_mutate_request_equals_the_jax_packages():
    import random

    from ingress_plus_tpu.utils.evasion import (
        request_digest as jax_digest,
    )
    from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
    from ingress_plus_tpu.utils.prefilter_gate import (
        mutate_request as jax_mutate,
    )
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus
    from ingress_plus_tpu_torch.utils.evasion import request_digest

    port_rng, ref_rng = random.Random(5), random.Random(5)
    port = [prefilter_gate.mutate_request(port_rng, lr.request)
            for lr in generate_corpus(n=400, attack_fraction=0.5, seed=2)
            for _ in range(3)]
    ref = [jax_mutate(ref_rng, lr.request)
           for lr in jax_corpus(n=400, attack_fraction=0.5, seed=2)
           for _ in range(3)]
    assert request_digest(port) == jax_digest(ref)


def test_the_card_is_the_default_and_no_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quality_report.build_report(n_benign=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefilter_gate.run_gate(n=8, progress=False)
    for main, size in ((quality_report.main, "--n-benign"),
                       (prefilter_gate.main, "--n")):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([size, "8"])


def test_report_cli_writes_under_chiprun_out_by_default(tmp_path, capsys,
                                                        monkeypatch):
    committed = REPO / "reports" / "QUALITY.json"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    asked = {}

    def report(n_benign, device):
        asked.update(n_benign=n_benign, device=str(device))
        return {"evasion": {"detected": 1, "total": 1, "detection_rate": 1},
                "benign": {"false_positives": 0, "total": n_benign,
                           "fp_rate": 0.0}}

    monkeypatch.setattr(quality_report, "build_report", report)
    monkeypatch.chdir(tmp_path)
    assert quality_report.main(["--n-benign", "40", "--platform",
                                "cpu"]) == 0
    assert asked == {"n_benign": 40, "device": "cpu"}
    rep = json.loads((tmp_path / "chiprun_out" / "QUALITY.json").read_text())
    assert rep["benign"]["total"] == 40
    assert "wrote" in capsys.readouterr().out
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before
