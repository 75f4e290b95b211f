"""Whole runs of the harness against the port's server on the CPU (the
harness's look for a card skipped), with the timed path sound and with
it broken underneath, and the card's own run.

Each broken run plants one fault in the server through a
``sitecustomize`` on its import path and must come out not correct:
an answer altered where it is produced, half the requests never
answered, and a stream step that returns its state unchanged.  (The
exchange between cards does not exist in a one-card cell.)"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from wafbench import manifest, run
from wafbench.gen import load_mix
from wafbench.manifest import ROOT

WEB = "crs-block.web-mix.closed32"
UPLOAD = "crs-upload-stream.1mib.closed8"
CPU_SERVER = ["--scan-impl", "pair"]
#: the closed loop's mix with a warm-up a CPU server gets through
WEB_MIX = dict(load_mix("web-mix.closed32"), warmup={"units": 200})
SMALL_UPLOADS = {"kind": "upload", "body_bytes": 24576, "chunk_bytes": 8192,
                 "bodies": ["form", "json", "base64", "gzip"], "block": 4,
                 "attack_fraction": 1.0,
                 "load": {"loop": "closed", "connections": 2, "in_flight": 1,
                          "stagger_s": 0.2},
                 "warmup": {"seconds": 1}}


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return tmp_path


def _fault(tmp_path, body: str) -> dict:
    d = tmp_path / "fault"
    d.mkdir()
    (d / "sitecustomize.py").write_text(textwrap.dedent(body))
    return {"PYTHONPATH": os.pathsep.join([str(d), str(ROOT)])}


def test_sound_run_is_correct_and_its_line_has_the_contracts_keys(
        tmpdir_env, leaves_no_process):
    res = run.run_cell(WEB, 2**31 + 5, 3.0, False, platform="cpu",
                       server_extra=CPU_SERVER, mix=WEB_MIX)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 100
    assert set(res["metrics"]) == {"req_per_s", "setup_s"}
    assert res["compared"] == {"wrong": {"value": 0, "limit": 0},
                               "unanswered": {"value": 0, "limit": 0}}


def test_traced_run_reads_no_device_metric_without_a_card(tmpdir_env):
    res = run.run_cell(UPLOAD, 11, 3.0, True, platform="cpu",
                       server_extra=CPU_SERVER, mix=SMALL_UPLOADS)
    assert res["correct"]
    assert list(res)[-2:] == ["breakdown", "compared"]
    # the CPU run's trace holds no device operation: busy 0, no roofline
    assert res["device"]["busy_s"] == 0.0
    assert "kernel.scan_roofline.stream" not in res["metrics"]


def test_without_a_card_the_run_prints_no_result(tmpdir_env):
    p = subprocess.run(
        [sys.executable, "-m", "wafbench.run", "--workload", WEB, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_an_altered_answer_is_not_correct(tmpdir_env):
    env = _fault(tmpdir_env, """
        from ingress_plus_tpu_torch.models import pipeline
        _orig = pipeline.DetectionPipeline.finalize_join
        def finalize_join(self, *a, **k):
            out = _orig(self, *a, **k)
            for v in out:
                if v.rule_ids:
                    v.rule_ids = v.rule_ids[1:]
                    break
            return out
        pipeline.DetectionPipeline.finalize_join = finalize_join
    """)
    res = run.run_cell(WEB, 2**31 + 6, 3.0, False, platform="cpu",
                       server_extra=CPU_SERVER, server_env=env, mix=WEB_MIX)
    assert not res["correct"] and res["compared"]["wrong"]["value"] > 0


def test_half_the_requests_left_out_is_not_correct(tmpdir_env, monkeypatch):
    env = _fault(tmpdir_env, """
        from ingress_plus_tpu_torch.serve import server
        _orig = server.encode_response
        def encode_response(req_id, *a, **k):
            return _orig(req_id, *a, **k) if req_id % 2 else b""
        server.encode_response = encode_response
    """)
    res = run.run_cell(WEB, 2**31 + 7, 2.0, False, platform="cpu",
                       server_extra=CPU_SERVER, server_env=env, mix=WEB_MIX)
    assert not res["correct"]
    assert res["compared"]["unanswered"]["value"] * 3 > res["attempted"]


def test_a_stream_step_that_keeps_its_state_is_not_correct(tmpdir_env):
    env = _fault(tmpdir_env, """
        from ingress_plus_tpu_torch.serve import stream
        def _scan_wave(self, scanner, tokens, lengths, state, match):
            return match, state
        stream.StreamEngine._scan_wave = _scan_wave
    """)
    res = run.run_cell(UPLOAD, 12, 3.0, False, platform="cpu",
                       server_extra=CPU_SERVER, server_env=env,
                       mix=SMALL_UPLOADS)
    assert not res["correct"] and res["compared"]["wrong"]["value"] > 0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "python -m pytest wafbench/tests -m card")


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  manifest.load_manifest()["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, tmpdir_env, cell):
    p = subprocess.run(
        [sys.executable, "-m", "wafbench.run", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
