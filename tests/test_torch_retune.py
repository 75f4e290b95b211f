"""The port's retune library (control/retune.py) and daemon CLI
(control/retuned.py) against the JAX package's, on the CPU.

The same rules and the same profile BYTES through both retuners give
the same retuned pack fingerprint and the same gate reports (the
determinism contract of docs/RETUNE.md); the port's staged-rollout gate
drives the retuned pack to LIVE on a CPU batcher; the profile export
surface of the port's serve loop gives canonical bytes; and ``python -m
ingress_plus_tpu_torch.control.retuned --once`` prints one typed cycle
record."""

import asyncio
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from ingress_plus_tpu.compiler.profile import MeasuredProfile as JaxProfile
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile
from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.control import retune as port_retune
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.normalize import Request

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

RULES = r"""
SecRule ARGS|REQUEST_BODY "@rx (?i)union\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,t:lowercase,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS|REQUEST_BODY "@rx (?i)<script[^>]*>" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS "@rx /etc/(?:passwd|shadow)" \
    "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@rx (?i)(?:sleep|benchmark)\(\d+" \
    "id:942150,phase:2,block,severity:ERROR,tag:'attack-sqli'"
SecRule REQUEST_URI "@rx \.(?:bak|old|orig)$" \
    "id:930130,phase:1,block,severity:ERROR,tag:'attack-disclosure'"
"""

ATTACKS = ["/q?a=1+union+select+2", "/p?x=<script>alert(1)</script>",
           "/f?name=../../etc/passwd", "/s?id=sleep(5)--"]


def _traffic(cls, n=64):
    out = []
    for i in range(n):
        uri = ATTACKS[i % len(ATTACKS)] if i % 4 == 0 \
            else "/benign/page?q=hello+world+%d" % i
        out.append(cls(uri=uri, request_id="t%d" % i,
                       headers={"host": "a.example",
                                "user-agent": "ua/1.0"}))
    return out


@pytest.fixture(scope="module")
def profiles():
    """One profile measured by the JAX pipeline, then loaded by both
    packages from the same canonical bytes."""
    pipe = JaxPipeline(jax_compile(jax_parse(RULES)), mode="block")
    pipe.detect(_traffic(JaxRequest))
    raw = JaxProfile.from_rule_stats(pipe.rule_stats).to_json()
    return JaxProfile.from_json(raw), MeasuredProfile.from_json(raw)


def test_port_profile_of_the_same_traffic_equals_jax(profiles):
    """The port's pipeline measures the same per-rule rates (the timing
    fields are measurements and differ)."""
    pipe = DetectionPipeline(compile_ruleset(parse_seclang(RULES)),
                             mode="block", device="cpu")
    pipe.detect(_traffic(Request))
    ours = MeasuredProfile.from_rule_stats(pipe.rule_stats)
    theirs = profiles[0]
    assert ours.requests == theirs.requests
    assert sorted(ours.rules) == sorted(theirs.rules)
    for rid, rec in theirs.rules.items():
        for k in ("candidate_rate", "confirmed_rate", "qr_skip_rate"):
            assert ours.rules[rid][k] == rec[k], (rid, k)


def test_retune_equals_jax_on_the_same_profile_bytes(profiles):
    import retune as jax_retune

    jprof, prof = profiles
    want = jax_retune.retune(rules=jax_parse(RULES), profile=jprof,
                             staged=False, ab=False)
    got = port_retune.retune(rules=parse_seclang(RULES), profile=prof,
                             staged=False, ab=False, device="cpu")
    assert got["ok"] and want["ok"]
    assert got["retuned_fingerprint"] == want["retuned_fingerprint"]
    assert got["static_fingerprint"] == want["static_fingerprint"]
    assert got["profile"] == want["profile"]
    assert got["replay"] == want["replay"]
    for arm in ("static", "retuned"):
        assert got["inflation"][arm] == want["inflation"][arm], arm
    assert got["reduction"] == want["reduction"]
    cr = got.pop("_retuned_cr")
    assert cr.version == got["retuned_fingerprint"]
    json.dumps(got)


def test_retune_staged_gate_reaches_live_on_cpu(profiles):
    _, prof = profiles
    rep = port_retune.retune(rules=parse_seclang(RULES), profile=prof,
                             staged=True, ab=False, device="cpu")
    assert rep["ok"], rep
    assert rep["rollout"]["state"] == "live"
    assert rep["rollout"]["violations"] == []
    assert rep["rollout"]["serving"] == rep["retuned_fingerprint"]


def test_rules_stats_profile_export(tmp_path):
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    pipe = DetectionPipeline(compile_ruleset(parse_seclang(RULES)),
                             mode="block", device="cpu")
    b = Batcher(pipe, max_delay_s=0.001, hard_deadline_s=30.0)
    serve = ServeLoop(b, str(tmp_path / "ipt.sock"))
    try:
        for r in _traffic(Request, 16):
            b.submit(r).result(30)
        _status, _ctype, body = asyncio.run(serve._route_http(
            "GET", "/rules/stats?format=profile", b""))
        prof = MeasuredProfile.from_json(body)
        assert prof.requests == 16
        assert body == prof.to_json().encode()
    finally:
        b.close()


def test_daemon_cli_once_prints_a_typed_record(tmp_path):
    """``retuned --once`` against an aggregator that does not answer:
    the drift probe degrades to no drift, and the one cycle record is a
    typed skip, journaled."""
    from ingress_plus_tpu_torch.control.retuned import (
        JOURNAL_NAME,
        SKIP_NO_DRIFT,
        main,
    )

    out = io.StringIO()
    with redirect_stdout(out):
        main(["--fleet-url", "127.0.0.1:1", "--node", "n0=127.0.0.1:1",
              "--lkg-dir", str(tmp_path), "--once", "--platform", "cpu"])
    rec = json.loads(out.getvalue())
    assert rec["result"] == SKIP_NO_DRIFT and rec["cycle"] == 1
    journal = (tmp_path / JOURNAL_NAME).read_text().splitlines()
    assert json.loads(journal[-1])["result"] == SKIP_NO_DRIFT
