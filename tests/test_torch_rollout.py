"""The port's guarded ruleset rollout against the JAX package's, on the CPU.

``control/rollout.py`` of both packages drives in-process batchers and
``ServeLoop``s on the same SecLang packs (each compiled by its own
package).  Where the outcome is deterministic it must be equal: the
admission reports, the rejection stage and reason, the states, the
canary split, the quarantine record, the LKG files and the HTTP bodies
(timestamps aside).  The rest pins the port's own contract: staged
rollouts under concurrent traffic, the LKG restart, the server's
``--rules-dir`` / ``--lkg-dir`` startup, and a card stand-in in which
admission, shadow, canary and a breaker-open canary batch never reach
``detect_cpu_only``.
"""

import asyncio
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.control import rollout as jro
from ingress_plus_tpu.learn import head as jhead
from ingress_plus_tpu.serve.server import ServeLoop as JaxServeLoop
from ingress_plus_tpu.utils import faults as jfaults
from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.control import rollout as tro
from ingress_plus_tpu_torch.learn import head as thead
from ingress_plus_tpu_torch.control.rollout import (
    CANARY,
    LIVE,
    REJECTED,
    ROLLED_BACK,
    SHADOW,
    RolloutConfig,
    RolloutController,
    RolloutRejected,
    load_lkg,
    persist_lkg,
)
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.serve.server import ServeLoop
from ingress_plus_tpu_torch.utils import faults as tfaults
from ingress_plus_tpu_torch.utils.faults import _collect, _requests

REPO = Path(__file__).resolve().parents[1]

_OVERBLOCK = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)drop\\s+table" \
    "id:955200,phase:2,block,severity:CRITICAL,tag:'attack-sqli'"
"""
#: a candidate MISSING the sqli rule: golden attacks the incumbent
#: catches become false negatives -> new_fns gate
_LOSSY = """
SecRule REQUEST_URI|ARGS "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
"""
SOURCES = {"inc": tro._DRILL_INCUMBENT, "cand": tro._DRILL_CANDIDATE,
           "broken": tro._DRILL_BROKEN,
           "overblock": tro._DRILL_INCUMBENT + _OVERBLOCK, "lossy": _LOSSY}


@pytest.fixture(scope="module")
def packs():
    return {k: compile_ruleset(parse_seclang(v)) for k, v in SOURCES.items()}


@pytest.fixture(scope="module")
def jpacks():
    return {k: jax_compile(jax_parse(v)) for k, v in SOURCES.items()}


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


def _fast_config(mod, lkg_dir=None, **kw):
    cfg = mod.RolloutConfig(steps=(0.25, 1.0), step_min_requests=8,
                            shadow_min_requests=4, shadow_sample=1.0,
                            corpus_n=32, diff_min_compared=4,
                            lkg_dir=lkg_dir)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _rollout_batcher(packs, lkg_dir=None, **cfg_kw):
    b = tfaults._mk_batcher(cr=packs["inc"], device="cpu")
    ro = RolloutController(b, _fast_config(tro, lkg_dir, **cfg_kw))
    b.rollout = ro
    return b, ro


def _jax_rollout_batcher(jpacks, lkg_dir=None, **cfg_kw):
    b = jfaults._mk_batcher(cr=jpacks["inc"])
    ro = jro.RolloutController(b, _fast_config(jro, lkg_dir, **cfg_kw))
    b.rollout = ro
    return b, ro


@contextlib.contextmanager
def _pair(packs, jpacks, **kw):
    b, ro = _rollout_batcher(packs, **kw)
    jb, jr = _jax_rollout_batcher(jpacks, **kw)
    try:
        yield ro, jr
    finally:
        b.close()
        jb.close()


def _rejection(ro, ruleset):
    with pytest.raises((RolloutRejected, jro.RolloutRejected)) as ei:
        ro.admit(ruleset=ruleset)
    return ei.value.report


def _drive(b, ro, terminal, tag="d", timeout_s=60.0):
    verdicts, violations = [], []
    deadline = time.monotonic() + timeout_s
    wave = 0
    while ro.state not in terminal and time.monotonic() < deadline:
        futs = [b.submit(r) for r in _requests(24, attack_every=4,
                                               tag="%s%d" % (tag, wave))]
        vs, viol = _collect(futs, timeout_s=30)
        verdicts += vs
        violations += viol
        wave += 1
    assert not violations, violations
    return verdicts


# ----------------------------------------------------- parity with JAX

def test_packs_compile_identically(packs, jpacks):
    for k in SOURCES:
        assert packs[k].version == jpacks[k].version, k


def test_hash_frac_and_canary_split_match_jax():
    ids = ["req-%d" % i for i in range(500)]
    assert [tro._hash_frac(i) for i in ids] == [jro._hash_frac(i)
                                                for i in ids]
    items = [(0.0, Request(uri="/", request_id=i), None) for i in ids]
    for step in range(4):
        splits = []
        for mod in (tro, jro):
            ro = mod.RolloutController.__new__(mod.RolloutController)
            ro.canary_active = True
            ro.config = mod.RolloutConfig()
            ro.step_idx = step
            inc, cand = ro.split(items)
            splits.append(([x[1].request_id for x in inc],
                           [x[1].request_id for x in cand]))
        assert splits[0] == splits[1]
        assert len(splits[0][1]) > 0


@pytest.mark.parametrize("name,stage,reason,kw", [
    ("broken", "static", "rulecheck", {}),
    ("overblock", "replay", "benign_blocks", {}),
    ("lossy", "replay", "new_fns", {"corpus_n": 256}),
    ("inc", "load", "already_live", {}),
])
def test_admission_rejections_match_jax(packs, jpacks, name, stage, reason,
                                        kw):
    """A bad pack is rejected at the same stage, for the same reason,
    with the same structured detail, and changes nothing."""
    with _pair(packs, jpacks, **kw) as (ro, jr):
        got, want = _rejection(ro, packs[name]), _rejection(jr, jpacks[name])
        assert got == want
        assert (got["stage"], got["reason"]) == (stage, reason)
        assert ro.state == jr.state == REJECTED
        assert ro.swap_rejected == jr.swap_rejected == {reason: 1}
        assert ro.batcher.pipeline.ruleset.version == packs["inc"].version
    if name == "broken":
        checks = {f["check"] for f in got["detail"]["findings"]}
        assert "regex.confirm-unparsable" in checks


def test_admission_report_and_concurrent_admit_match_jax(packs, jpacks):
    with _pair(packs, jpacks) as (ro, jr):
        got = ro.admit(ruleset=packs["cand"])
        want = jr.admit(ruleset=jpacks["cand"])
        assert got == want
        assert got["state"] == SHADOW and got["replay"]["new_fns"] == 0
        assert ro.state == jr.state == SHADOW
        assert _rejection(ro, packs["cand"]) == _rejection(jr,
                                                          jpacks["cand"])


def test_override_validation_matches_jax():
    cases = [{"steps": [0.5, 0.2]}, {"steps": [0.5]}, {"steps": ["x"]},
             {"step_min_requests": 0}, {"nope": 1},
             {"shadow_sample": 2.0}, {"steps": [0.5, 1.0]},
             {"shadow_min_requests": 3, "shadow_sample": 0.5}]
    for raw in cases:
        out = []
        for mod in (tro, jro):
            try:
                out.append(("ok", mod.validate_overrides(dict(raw))))
            except ValueError as e:
                out.append(("error", str(e)))
        assert out[0] == out[1], raw


def test_midcanary_rollback_and_quarantine_match_jax(packs, jpacks,
                                                     tmp_path):
    records = []
    for which in ("port", "jax"):
        lkg = tmp_path / which
        if which == "port":
            b, ro = _rollout_batcher(packs, lkg_dir=str(lkg))
        else:
            b, ro = _jax_rollout_batcher(jpacks, lkg_dir=str(lkg))
        try:
            ro.admit(ruleset=(packs if which == "port" else jpacks)["cand"])
            _drive(b, ro, (CANARY, LIVE, REJECTED, ROLLED_BACK), tag="c")
            assert ro.state == CANARY, ro.state
            ro.record_candidate_failure("test_forced")
            assert ro.state == ROLLED_BACK
            assert ro.rollback_reason == "candidate_dispatch_failures"
            assert b.pipeline.ruleset.version == packs["inc"].version
            assert b.pipeline.frozen_rule_stats is None
            assert not ro.canary_active and not ro.shadow_active
            vs, viol = _collect([b.submit(r) for r in
                                 _requests(12, attack_every=4, tag="rb")], 30)
            assert not viol
            hits = [v for v in vs if v.attack]
            assert hits and all(v.generation == packs["inc"].version
                                for v in hits)
            q = json.loads(next((lkg / "quarantine").glob("*.json"))
                           .read_text())
            records.append((ro.state, ro.rollbacks, ro.swap_rejected,
                            {k: q[k] for k in ("version", "artifact",
                                               "reason")}))
        finally:
            b.close()
    assert records[0] == records[1]
    assert records[0][3]["version"] == packs["cand"].version


def test_lkg_files_match_jax_and_cross_load(packs, jpacks, tmp_path):
    """The same pack persisted by either package: the same pointer file,
    the same JSON, the same arrays — and each package loads the other's
    LKG."""
    a, b = tmp_path / "port", tmp_path / "jax"
    pa = persist_lkg(packs["cand"], a)
    pb = jro.persist_lkg(jpacks["cand"], b)
    assert pa.name == pb.name
    assert (a / "LKG").read_bytes() == (b / "LKG").read_bytes()
    assert pa.with_suffix(".json").read_bytes() == \
        pb.with_suffix(".json").read_bytes()
    with np.load(pa.with_suffix(".npz")) as x, \
            np.load(pb.with_suffix(".npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert sorted(p.name for p in a.iterdir()) == sorted(
        p.name for p in b.iterdir())
    assert load_lkg(b).version == jro.load_lkg(a).version == \
        packs["cand"].version


def _route(serve, method, path, payload=b""):
    status, _ctype, body = asyncio.run(
        serve._route_http(method, path, payload))
    return status, json.loads(body)


def _strip_ts(body):
    """A /rollout body without its clock readings (the port's
    ``admission_s`` stage seconds among them)."""
    body = dict(body)
    body.pop("admission_s", None)
    body["history"] = [{k: v for k, v in e.items() if k != "ts"}
                       for e in body.get("history", [])]
    body.pop("lkg_dir", None)
    return body


def test_http_bodies_match_jax(packs, jpacks, tmp_path):
    """The same sequence of control-plane requests to both servers: the
    same statuses and bodies (clock readings and paths aside)."""
    out = []
    for which in ("port", "jax"):
        d = tmp_path / which
        d.mkdir()
        if which == "port":
            b, ro = _rollout_batcher(packs, lkg_dir=str(d / "lkg"))
            serve = ServeLoop(b, str(d / "s.sock"))
            pk = packs
        else:
            b, ro = _jax_rollout_batcher(jpacks, lkg_dir=str(d / "lkg"))
            serve = JaxServeLoop(b, str(d / "s.sock"))
            pk = jpacks
        arts = {}
        for name in ("broken", "cand", "overblock"):
            arts[name] = d / name
            pk[name].save(arts[name])
        garbage = d / "garbage"
        garbage.with_suffix(".npz").write_bytes(b"not an npz")
        garbage.with_suffix(".json").write_text("{}")
        seq = [
            ("GET", "/rollout", None),
            ("GET", "/rules/stats?format=profile", None),
            ("POST", "/configuration/ruleset", {"path": str(arts["broken"])}),
            ("POST", "/configuration/ruleset",
             {"path": str(arts["overblock"])}),
            ("POST", "/configuration/ruleset", {"path": str(arts["cand"]),
                                                "steps": [0.5]}),
            ("POST", "/configuration/ruleset?mode=force",
             {"path": str(garbage)}),
            ("POST", "/configuration/ruleset", {"path": str(arts["cand"]),
                                                "step_min_requests": 4,
                                                "shadow_min_requests": 2}),
            ("GET", "/rollout", None),
            ("POST", "/rollout", {"action": "nope"}),
            ("POST", "/rollout", {"action": "abort"}),
            ("POST", "/configuration/ruleset", {"path": str(arts["cand"])}),
            # break-glass while a rollout is active: aborts it first
            ("POST", "/configuration/ruleset?mode=force",
             {"path": str(arts["cand"])}),
            ("GET", "/rollout", None),
        ]
        try:
            res = []
            for method, path, body in seq:
                payload = json.dumps(body).encode() if body else b""
                status, got = _route(serve, method, path, payload)
                got = json.loads(json.dumps(got).replace(str(d), "<dir>"))
                res.append((status, _strip_ts(got) if "/rollout" in path
                            or "history" in got else got))
            metrics = serve._metrics_text()
            res.append(sorted(ln for ln in metrics.splitlines()
                              if ln.startswith(("ipt_rollout_",
                                                "ipt_swap_rejected"))))
            out.append(res)
        finally:
            b.close()
    assert out[0] == out[1]
    statuses = [s for s, _ in out[0][:-1]]
    assert [s[:3] for s in statuses] == ["200", "200", "422", "422", "400",
                                         "400", "200", "200", "400", "200",
                                         "200", "200", "200"]
    assert out[0][1][1]["version"] == 1 and out[0][1][1]["byte_freq"]
    assert out[0][-2][1]["state"] == "rolled_back"
    assert out[0][-2][1]["rollback_reason"] == "force_swap"
    assert out[0][-2][1]["incumbent"] == packs["cand"].version
    assert 'ipt_swap_rejected_total{reason="rulecheck"} 1' in out[0][-1]


def test_staged_without_controller_is_409(packs, tmp_path):
    b = tfaults._mk_batcher(cr=packs["inc"], device="cpu")
    try:
        serve = ServeLoop(b, str(tmp_path / "ipt.sock"))
        art = tmp_path / "cand"
        packs["cand"].save(art)
        status, _body = _route(
            serve, "POST", "/configuration/ruleset?mode=staged",
            json.dumps({"path": str(art)}).encode())
        assert status.startswith("409")
        assert b.pipeline.ruleset.version == packs["inc"].version
        status, body = _route(serve, "GET", "/rollout")
        assert body == {"enabled": False}
    finally:
        b.close()


# ------------------------------------------------- the port's contract

def test_staged_rollout_reaches_live_under_concurrent_load(packs):
    """A staged rollout driven while concurrent batch AND streaming-body
    traffic is in flight: every admitted request resolves to exactly one
    verdict from exactly one generation, a stream fed across the promote
    fails open, and the incumbent's counters freeze into the drift
    snapshot."""
    b, ro = _rollout_batcher(packs)
    inc_v, cand_v = packs["inc"].version, packs["cand"].version
    stop = threading.Event()
    results, errors = [], []
    lock = threading.Lock()

    def worker(wid):
        wave = 0
        while not stop.is_set():
            futs = [b.submit(r) for r in
                    _requests(16, attack_every=4,
                              tag="w%d.%d." % (wid, wave))]
            vs, viol = _collect(futs, timeout_s=30)
            with lock:
                results.extend(vs)
                errors.extend(viol)
            wave += 1

    try:
        ro.admit(ruleset=packs["cand"])
        h = b.begin_stream(Request(uri="/post", request_id="pinned-stream"))
        b.feed_chunk(h, b"1 uni")
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while ro.state not in (LIVE, REJECTED, ROLLED_BACK) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert ro.state == LIVE, (ro.state, ro.rollback_reason)
        assert b.pipeline.ruleset.version == cand_v
        assert not errors, errors[:5]
        gens = {v.generation for v in results if v.generation}
        assert gens <= {inc_v, cand_v}, gens
        assert any(v.generation == cand_v for v in results)
        b.feed_chunk(h, b"on select 2")
        sv = b.finish_stream(h).result(timeout=30)
        assert sv.fail_open and not sv.blocked
        assert b.pipeline.frozen_rule_stats.version == inc_v
        vs, viol = _collect(
            [b.submit(r) for r in _requests(8, attack_every=4, tag="p")], 30)
        assert not viol
        hits = [v for v in vs if v.attack]
        assert hits and all(v.generation == cand_v for v in hits)
    finally:
        stop.set()
        b.close()


def test_rollback_triggers_confirm_errors_and_diff(packs):
    b, ro = _rollout_batcher(packs)
    try:
        ro.admit(ruleset=packs["cand"])
        ro.candidate.rule_stats.confirm_errors[0] = 3
        ro._evaluate()
        assert (ro.state, ro.rollback_reason) == (ROLLED_BACK,
                                                  "confirm_error_spike")
    finally:
        b.close()
    b, ro = _rollout_batcher(packs)
    try:
        ro.admit(ruleset=packs["cand"])
        ro.shadow_compared = 100
        ro.diff["new_block"] = 50
        ro._evaluate()
        assert (ro.state, ro.rollback_reason) == (ROLLED_BACK,
                                                  "verdict_diff")
    finally:
        b.close()


def test_candidate_carries_acl_and_tenant_state(packs):
    b, ro = _rollout_batcher(packs)
    try:
        b.set_tenant_tags({1: ("attack-xss",)})
        live = b.pipeline
        live.acl_store.swap({"edge": {"deny": ["203.0.113.0/24"]}})
        live.tenant_acl = {0: "edge"}
        live.default_acl = "edge"
        ro.admit(ruleset=packs["cand"])
        cand = ro.candidate
        assert cand.acl_store is live.acl_store
        assert cand.tenant_acl == live.tenant_acl
        assert cand.default_acl == "edge"
        assert cand.tenant_rule_mask.shape == (2, packs["cand"].n_rules)
        assert cand.tenant_rule_mask[1].sum() == 1
    finally:
        b.close()


def test_mirror_skips_unscanned_and_degraded_verdicts(packs):
    from ingress_plus_tpu_torch.models.pipeline import Verdict

    b, ro = _rollout_batcher(packs)
    try:
        ro.admit(ruleset=packs["cand"])
        req = Request(uri="/x", request_id="m1")
        ro.mirror(req, Verdict(request_id="m1", blocked=False, attack=False,
                               classes=[], rule_ids=[], score=0,
                               fail_open=True))
        ro.mirror(req, Verdict(request_id="m1", blocked=False, attack=False,
                               classes=[], rule_ids=[], score=0,
                               degraded=True,
                               generation=packs["inc"].version))
        assert ro.shadow_mirrored == 0 and ro._shadow_q.qsize() == 0
        ro.mirror(req, Verdict(request_id="m1", blocked=False, attack=False,
                               classes=[], rule_ids=[], score=0,
                               generation=packs["inc"].version))
        assert ro.shadow_mirrored == 1
    finally:
        b.close()


def test_overrides_do_not_leak_into_next_rollout(packs):
    b, ro = _rollout_batcher(packs)
    try:
        base_steps = ro.config.steps
        ro.admit(ruleset=packs["cand"],
                 overrides={"steps": [1.0], "step_min_requests": 2})
        assert ro.config.steps == (1.0,)
        with pytest.raises(RolloutRejected) as ei:
            ro.admit(ruleset=packs["broken"], overrides={"steps": [1.0]})
        assert ei.value.report["reason"] == "rollout_in_progress"
        ro.abort("test")
        ro.admit(ruleset=packs["cand"])
        assert ro.config.steps == base_steps
        assert ro.config.step_min_requests == 8
    finally:
        b.close()


def test_shadow_lane_is_budget_capped(packs):
    b, ro = _rollout_batcher(packs, shadow_cpu_budget=0.0)
    try:
        ro.admit(ruleset=packs["cand"])
        vs, viol = _collect(
            [b.submit(r) for r in _requests(48, attack_every=4, tag="bg")],
            30)
        assert not viol and len(vs) == 48
        deadline = time.monotonic() + 10
        while ro.shadow_dropped == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ro.shadow_dropped > 0 and ro.shadow_compared == 0
        assert ro.state == SHADOW
        for i in range(2 * ro.config.shadow_queue_cap):
            ro.mirror(Request(uri="/x", request_id="flood-%d" % i), vs[0])
        assert ro._shadow_q.qsize() <= ro.config.shadow_queue_cap
    finally:
        b.close()


def test_lkg_persist_load_roundtrip_and_corruption(packs, tmp_path):
    persist_lkg(packs["inc"], tmp_path)
    assert load_lkg(tmp_path).version == packs["inc"].version
    persist_lkg(packs["cand"], tmp_path)
    assert load_lkg(tmp_path).version == packs["cand"].version
    (tmp_path / "LKG").write_text("{not json")
    assert load_lkg(tmp_path) is None
    (tmp_path / "LKG").write_text(json.dumps({"artifact": "pack-gone"}))
    assert load_lkg(tmp_path) is None
    assert load_lkg(tmp_path / "never-created") is None


def test_promote_persists_lkg_and_restart_prefers_it(packs, tmp_path):
    b, ro = _rollout_batcher(packs, lkg_dir=str(tmp_path))
    try:
        ro.admit(ruleset=packs["cand"])
        _drive(b, ro, (LIVE, REJECTED, ROLLED_BACK), tag="lk")
        assert ro.state == LIVE
    finally:
        b.close()
    recovered = load_lkg(tmp_path)
    assert recovered.version == packs["cand"].version
    nb = tfaults._mk_batcher(cr=recovered, device="cpu")
    try:
        vs, viol = _collect(
            [nb.submit(r) for r in _requests(8, attack_every=4, tag="rs")],
            30)
        assert not viol and any(v.attack for v in vs)
    finally:
        nb.close()


def test_swap_drill_passes(tmp_path):
    rep = tro.run_swap_drill(lkg_dir=str(tmp_path), device="cpu")
    assert rep["passed"], json.dumps(rep, indent=2, default=str)
    drills = rep["drills"]
    assert drills["good_pack_to_live"]["state"] == "live"
    assert drills["broken_pack_rejected"]["state"] == "rejected"
    assert drills["mid_canary_rollback"]["state"] == "rolled_back"


def test_build_default_batcher_pack_sources(packs, tmp_path):
    """No rules dir and no LKG: the committed pack, which equals the
    port's compile of ``load_bundled_rules()``; a rules dir: its compile;
    an LKG: preferred over both.  A rollout controller is attached."""
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.serve.server import build_default_batcher

    want = compile_ruleset(load_bundled_rules()).version
    rules = tmp_path / "rules"
    rules.mkdir()
    (rules / "10-inc.conf").write_text(SOURCES["inc"])
    lkg = tmp_path / "lkg"
    for kw, version in (({}, want),
                        ({"rules_dir": str(rules)}, packs["inc"].version),
                        ({"rules_dir": str(rules), "lkg_dir": str(lkg)},
                         packs["inc"].version)):
        b = build_default_batcher(warmup=False, platform="cpu",
                                  scan_impl="pair", **kw)
        try:
            assert b.pipeline.ruleset.version == version
            assert b.rollout is not None
            assert b.rollout.config.lkg_dir == kw.get("lkg_dir")
        finally:
            b.close()
    persist_lkg(packs["cand"], lkg)
    b = build_default_batcher(warmup=False, platform="cpu",
                              scan_impl="pair", rules_dir=str(rules),
                              lkg_dir=str(lkg), rollout_steps=[0.5, 1.0])
    try:
        assert b.pipeline.ruleset.version == packs["cand"].version
        assert b.rollout.config.steps == (0.5, 1.0)
    finally:
        b.close()
    (rules / "20-bad.conf").write_text('SecRule ARGS "@rx x" "id:1,block\n')
    with pytest.raises(ValueError, match="does not compile"):
        build_default_batcher(warmup=False, platform="cpu",
                              rules_dir=str(rules))


# --------------------------------------------------- the card stand-in

class _FakeStream:
    made = []

    def __init__(self, device=None):
        _FakeStream.made.append(threading.current_thread().name)


@pytest.fixture()
def card_stand_in(monkeypatch):
    """Engines whose device reads ``cuda:0`` while their tensors stay on
    the CPU (the plain scan); ``arm()`` then makes the CUDA stream calls
    recorded no-ops and ``detect_cpu_only`` record every call (it would
    raise on a card pipeline)."""
    from ingress_plus_tpu_torch.models import pipeline as tpipe
    from ingress_plus_tpu_torch.models.engine import DetectionEngine

    class CardEngine(DetectionEngine):
        def __init__(self, cr):
            super().__init__(cr, device="cpu")
            self.device = torch.device("cuda", 0)

        def rebuilt(self, cr):
            return CardEngine(cr)

        def detect_device_multi(self, buckets, num_requests,
                                head_only=False, device=None):
            return super().detect_device_multi(
                buckets, num_requests, head_only, torch.device("cpu"))

    reached = []

    def cpu_only(self, requests):
        reached.append(len(list(requests)))
        raise RuntimeError("detect_cpu_only reached on a card pipeline")

    def arm():
        _FakeStream.made = []
        monkeypatch.setattr(tpipe.DetectionPipeline, "detect_cpu_only",
                            cpu_only)
        monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "stream",
                            lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
        monkeypatch.setattr(torch.cuda, "set_stream", lambda s: None)

    return CardEngine, reached, arm


def test_card_stand_in_never_reaches_detect_cpu_only(packs, card_stand_in):
    """On a card pipeline the admission replay, the shadow lane, the
    canary and a canary batch under an open breaker all complete without
    ``detect_cpu_only``: replay and shadow scan the candidate's own
    kernels (``detect_strict``) on streams of their own, launches
    tallied under the rollout scope, and the breaker-open batches of
    both generations fail open — counted like the incumbent's, never as
    the candidate's.  The replay report equals the CPU path's."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    CardEngine, reached, arm = card_stand_in
    cpu_b, cpu_ro = _rollout_batcher(packs)
    try:
        want = cpu_ro._replay_diff(
            cpu_ro.batcher.pipeline,
            DetectionPipeline(packs["cand"], device="cpu"))
    finally:
        cpu_b.close()
    arm()
    p = DetectionPipeline(packs["inc"], mode="block",
                          engine=CardEngine(packs["inc"]))
    b = Batcher(p, max_batch=16, max_delay_s=0.001, hard_deadline_s=30.0,
                breaker_cooldown_s=600.0,
                lane_devices=[torch.device("cpu")])
    ro = RolloutController(b, _fast_config(tro))
    b.rollout = ro
    try:
        report = ro.admit(ruleset=packs["cand"])
        assert report["replay"] == want
        assert ro.state == SHADOW
        _drive(b, ro, (CANARY, LIVE, REJECTED, ROLLED_BACK), tag="cs")
        assert ro.state == CANARY, (ro.state, ro.rollback_reason)
        assert ro.shadow_compared >= 4
        _drive_until = time.monotonic() + 30
        while ro.candidate_requests == 0 and time.monotonic() < _drive_until:
            _collect([b.submit(r) for r in
                      _requests(24, attack_every=4, tag="cc")], 30)
        assert ro.candidate_requests > 0
        # a stream for the admission thread and one for the shadow worker
        assert len(_FakeStream.made) >= 2
        # the breaker opens: both generations' batches fail open
        b.breaker.trip("test")
        vs, viol = _collect([b.submit(r) for r in
                             _requests(24, attack_every=4, tag="bo")], 30)
        assert not viol and vs and all(v.fail_open and not v.blocked
                                       for v in vs)
        assert b.stats.breaker_fail_open_batches >= 1
        assert b.stats.cpu_fallback_batches == 0
        assert ro.state in (CANARY, LIVE), (ro.state, ro.rollback_reason)
        assert ro.candidate_fail_open == 0 and ro.candidate_failures == 0
        assert reached == []
    finally:
        b.close()


# ----------------------------------------- the server, as a process

def _http(port, method, path, body=None, timeout=60):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(tmp_path, rules, lkg, tag):
    port = _free_port()
    sock = str(tmp_path / ("%s.sock" % tag))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
         "--socket", sock, "--http-port", str(port), "--platform", "cpu",
         "--scan-impl", "pair", "--no-warmup", "--hard-deadline-ms", "5000",
         "--rules-dir", str(rules), "--lkg-dir", str(lkg)],
        cwd=str(REPO), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()
        try:
            if _http(port, "GET", "/readyz", timeout=5)[0] == 200:
                return proc, port, sock
        except OSError:
            pass
        time.sleep(0.2)
    proc.kill()
    pytest.fail("server not ready")


def test_server_rules_dir_staged_rollout_and_lkg_restart(packs, tmp_path):
    """``--rules-dir`` + ``--lkg-dir`` as a process: a staged push over
    HTTP reaches live under wire traffic, SIGKILL mid-canary of the next
    push, and the restart serves the last pack that reached live."""
    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.protocol import encode_request

    rules = tmp_path / "rules"
    rules.mkdir()
    (rules / "10-inc.conf").write_text(SOURCES["inc"])
    lkg = tmp_path / "lkg"
    art = tmp_path / "cand"
    packs["cand"].save(art)
    art2 = tmp_path / "inc"
    packs["inc"].save(art2)
    knobs = {"steps": [0.5, 1.0], "step_min_requests": 8,
             "shadow_min_requests": 4, "shadow_sample": 1.0}

    def wave(sock, n, tag):
        units = [(i + 1, [encode_request(r, i + 1, mode=2)])
                 for i, r in enumerate(_requests(n, attack_every=4,
                                                 tag=tag))]
        return drive(sock, units, 2, 4, timeout=60)

    proc, port, sock = _start_server(tmp_path, rules, lkg, "a")
    try:
        assert _http(port, "GET", "/configuration")[1]["ruleset"] == \
            packs["inc"].version
        status, body = _http(port, "POST", "/configuration/ruleset",
                             {"path": str(art), **knobs})
        assert status == 200 and body["staged"], body
        deadline = time.monotonic() + 90
        n = 0
        while time.monotonic() < deadline:
            wave(sock, 24, "w%d." % n)
            n += 1
            st = _http(port, "GET", "/rollout")[1]
            if st["state"] in (LIVE, ROLLED_BACK, REJECTED):
                break
        assert st["state"] == LIVE, st
        assert load_lkg(lkg).version == packs["cand"].version
        # the next push: killed mid-rollout
        status, body = _http(port, "POST", "/configuration/ruleset",
                             {"path": str(art2), **knobs})
        assert status == 200, body
        wave(sock, 24, "k.")
        assert _http(port, "GET", "/rollout")[1]["state"] in (
            SHADOW, CANARY)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    proc, port, sock = _start_server(tmp_path, rules, lkg, "b")
    try:
        assert _http(port, "GET", "/configuration")[1]["ruleset"] == \
            packs["cand"].version
        out = wave(sock, 8, "r.")
        assert any(resp["attack"] for resp, _lat in out.values())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ------------------------------------------------ scoring-head rollouts

def _drill_scoring_head(threshold=3.0, version="drillhead-1", mod=thead):
    """Hand-built head over the drill pack's two CRS ids: weight 4 per
    rule, so any confirmed hit clears threshold 3 — decision-identical
    to the fixed weights (CRITICAL=5 >= anomaly threshold 5), which
    keeps the admission replay diff-free.  ``mod``: the JAX package's
    ``learn.head`` for its twin."""
    return mod.ScoringHead(rule_ids=[942100, 941100], weights=[4.0, 4.0],
                           bias=0.0, threshold=threshold, version=version)


def test_scoring_rollout_reaches_live_generation_correct(packs, jpacks,
                                                         tmp_path):
    """A scoring-head swap rides the full staged gates under load: every
    scanned verdict names exactly one of the two generations,
    candidate-served verdicts carry the learned margin, promote leaves
    the PACK untouched but installs the head, and the scorer LKG
    persists — the JAX package's files byte for byte in the ``.json``.
    The admission report equals the JAX controller's."""
    b, ro = _rollout_batcher(packs, lkg_dir=str(tmp_path / "port"))
    jb, jr = _jax_rollout_batcher(jpacks)
    head = _drill_scoring_head()
    inc_v = packs["inc"].version
    cand_gen = "%s+%s" % (inc_v, head.version)
    try:
        rep = ro.admit_scoring(head=head)
        assert rep == jr.admit_scoring(head=_drill_scoring_head(mod=jhead))
        assert rep["kind"] == "scorer" and rep["coverage"] == 1.0
        assert rep["replay"]["new_fns"] == 0
        assert set(ro.admission_seconds) == {"load", "coverage", "compile",
                                             "replay"}
        verdicts = _drive(b, ro, (LIVE, REJECTED, ROLLED_BACK), tag="sc")
        assert ro.state == LIVE, (ro.state, ro.rollback_reason)
        gens = {v.generation for v in verdicts if v.generation}
        assert gens <= {inc_v, cand_gen}, gens
        cand_served = [v for v in verdicts if v.generation == cand_gen]
        assert cand_served
        assert all(v.learned_score is not None for v in cand_served)
        assert all(v.learned_score is None for v in verdicts
                   if v.generation == inc_v)
        assert b.pipeline.ruleset.version == inc_v
        assert b.pipeline.scorer is not None
        assert b.pipeline.frozen_rule_stats is not None
        vs, viol = _collect([b.submit(r) for r in
                             _requests(8, attack_every=4, tag="scp")], 30)
        assert not viol
        hits = [v for v in vs if v.attack]
        assert hits and all(v.generation == cand_gen for v in hits)
        lkg = thead.load_lkg_scorer(tmp_path / "port")
        assert lkg is not None and lkg.version == head.version
        jhead.persist_lkg_scorer(_drill_scoring_head(mod=jhead),
                                 tmp_path / "jax")
        name = "scorer-%s.json" % head.version
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    finally:
        b.close()
        jb.close()


def test_scoring_admission_rejections(packs, jpacks, tmp_path):
    """Malformed artifact, alien rule-id map, and an over-passing head
    are each rejected at their own stage with zero traffic impact; each
    rejection report equals the JAX controller's."""
    b, ro = _rollout_batcher(packs)
    jb, jr = _jax_rollout_batcher(jpacks)

    def reject(**kw):
        with pytest.raises(RolloutRejected) as ei:
            ro.admit_scoring(**{k: v[0] for k, v in kw.items()})
        with pytest.raises(jro.RolloutRejected) as ej:
            jr.admit_scoring(**{k: v[1] for k, v in kw.items()})
        assert ei.value.report == ej.value.report
        return ei.value.report

    try:
        art = tmp_path / "garbage-head"
        art.with_suffix(".npz").write_bytes(b"not an npz")
        art.with_suffix(".json").write_text("{}")
        report = reject(artifact_path=(str(art), str(art)))
        assert report["stage"] == "load"
        assert ro.swap_rejected.get("scorer_load") == 1
        alien = [m.ScoringHead(rule_ids=[1, 2, 3], weights=[1.0] * 3,
                               bias=0.0, threshold=0.5, version="alien-1")
                 for m in (thead, jhead)]
        report = reject(head=alien)
        assert report["stage"] == "coverage"
        assert report["detail"]["coverage"] == 0.0
        # a 256-request corpus carries golden attacks the 2-rule pack
        # flags; an unreachable threshold loses them → replay gate
        ro._base_config.corpus_n = 256
        jr._base_config.corpus_n = 256
        report = reject(head=(
            _drill_scoring_head(threshold=99.0, version="lossy-1"),
            _drill_scoring_head(threshold=99.0, version="lossy-1",
                                mod=jhead)))
        assert report["stage"] == "replay"
        assert report["reason"] == "new_fns"
        assert report["detail"]["new_fns"] > 0
        assert b.pipeline.scorer is None
        vs, viol = _collect([b.submit(r) for r in
                             _requests(8, attack_every=4, tag="sar")], 30)
        assert not viol
        hits = [v for v in vs if v.attack]
        assert hits and all(v.generation == packs["inc"].version
                            for v in hits)
    finally:
        b.close()
        jb.close()


def test_scoring_midcanary_verdict_diff_rollback(packs, tmp_path):
    """Mid-canary divergence (the shadow_diverge fault site) trips the
    verdict-diff trigger: auto-rollback restores the fixed-weight
    scorer, the head is quarantined with the reason, and the incumbent
    never stops serving."""
    b, ro = _rollout_batcher(packs, lkg_dir=str(tmp_path))
    head = _drill_scoring_head(version="diverge-1")
    try:
        ro.admit_scoring(head=head)
        deadline = time.monotonic() + 60
        wave = 0
        while ro.state in (SHADOW, "admitted") \
                and time.monotonic() < deadline:
            _, viol = _collect([b.submit(r) for r in
                                _requests(24, attack_every=4,
                                          tag="dv%d" % wave)], 30)
            assert not viol, viol
            wave += 1
        assert ro.state == CANARY, (ro.state, ro.rollback_reason)
        tfaults.install(tfaults.FaultPlan.from_spec(
            "shadow_diverge:times=100"))
        verdicts = _drive(b, ro, (LIVE, REJECTED, ROLLED_BACK), tag="dx")
        assert verdicts is not None
        assert ro.state == ROLLED_BACK, (ro.state, ro.rollback_reason)
        assert ro.rollback_reason == "verdict_diff"
        assert b.pipeline.scorer is None
        vs, viol = _collect([b.submit(r) for r in
                             _requests(8, attack_every=4, tag="dvp")], 30)
        assert not viol
        hits = [v for v in vs if v.attack]
        assert hits and all(v.generation == packs["inc"].version
                            for v in hits)
        qfiles = list((tmp_path / "quarantine").glob("*.json"))
        assert qfiles
        q = json.loads(qfiles[0].read_text())
        assert q["reason"] == "verdict_diff"
        assert q["version"] == head.version
    finally:
        tfaults.clear()
        b.close()


@pytest.fixture()
def serve_stack(packs, tmp_path):
    b, ro = _rollout_batcher(packs, lkg_dir=str(tmp_path / "lkg"))
    serve = ServeLoop(b, str(tmp_path / "ipt.sock"))
    yield serve, b, ro, tmp_path
    b.close()


def test_endpoint_scoring_staged_force_and_status(serve_stack):
    """/configuration/scoring staged push lands in SHADOW; ?mode=force
    installs/clears one-shot; /scoring + /metrics expose the lane."""
    serve, b, ro, tmp_path = serve_stack
    status, body = _route(serve, "GET", "/scoring")
    assert status.startswith("200") and body["active"] is False
    assert "ipt_scorer_active 0" in serve._metrics_text()
    head = _drill_scoring_head(version="ep-1")
    art = tmp_path / "head-ep"
    head.save(art)
    status, body = _route(serve, "POST", "/configuration/scoring",
                          json.dumps({"path": str(art)}).encode())
    assert status.startswith("200"), body
    assert body["staged"] and body["kind"] == "scorer"
    assert ro.state == SHADOW and b.pipeline.scorer is None
    assert ro.abort("test")
    status, body = _route(serve, "POST",
                          "/configuration/scoring?mode=force",
                          json.dumps({"path": str(art)}).encode())
    assert status.startswith("200"), body
    assert body["mode"] == "force" and body["scoring"] == "ep-1"
    assert b.pipeline.scorer is not None
    status, body = _route(serve, "GET", "/scoring")
    assert body["active"] and body["head"]["version"] == "ep-1"
    assert body["generation"].endswith("+ep-1")
    m = serve._metrics_text()
    assert "ipt_scorer_active 1" in m
    assert 'ipt_scorer_info{version="ep-1"' in m
    assert "ipt_scorer_threshold 3.0" in m
    status, body = _route(serve, "POST",
                          "/configuration/scoring?mode=force",
                          json.dumps({"clear": True}).encode())
    assert status.startswith("200") and b.pipeline.scorer is None
    assert body["scoring"] is None
    assert _route(serve, "GET", "/scoring")[1]["active"] is False


def test_endpoint_scoring_malformed_and_staged_clear(serve_stack):
    serve, b, ro, tmp_path = serve_stack
    art = tmp_path / "garbage-ep"
    art.with_suffix(".npz").write_bytes(b"junk")
    art.with_suffix(".json").write_text("{}")
    status, body = _route(serve, "POST", "/configuration/scoring",
                          json.dumps({"path": str(art)}).encode())
    assert status.startswith("422"), (status, body)
    assert body["rejected"] and body["stage"] == "load"
    assert b.pipeline.scorer is None
    status, body = _route(serve, "POST", "/configuration/scoring",
                          json.dumps({"clear": True}).encode())
    assert status.startswith("400")
    assert "force" in body["error"]
    status, body = _route(serve, "POST",
                          "/configuration/scoring?mode=force",
                          json.dumps({"path": str(art)}).encode())
    assert status.startswith("400") and body["stage"] == "load"
    assert ro.swap_rejected.get("scorer_load") == 2


def test_card_stand_in_scoring_admission_never_reaches_cpu_only(
        packs, card_stand_in):
    """On a card pipeline a scoring head's admission (compile smoke and
    replay), shadow and canary run without ``detect_cpu_only``: the
    candidate scans on an engine of its own through ``detect_strict``,
    and the replay report equals the CPU path's."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    CardEngine, reached, arm = card_stand_in
    cpu_b, cpu_ro = _rollout_batcher(packs)
    try:
        want = cpu_ro.admit_scoring(head=_drill_scoring_head())["replay"]
    finally:
        cpu_b.close()
    arm()
    p = DetectionPipeline(packs["inc"], mode="block",
                          engine=CardEngine(packs["inc"]))
    b = Batcher(p, max_batch=16, max_delay_s=0.001, hard_deadline_s=30.0,
                lane_devices=[torch.device("cpu")])
    ro = RolloutController(b, _fast_config(tro))
    b.rollout = ro
    try:
        report = ro.admit_scoring(head=_drill_scoring_head())
        assert report["replay"] == want
        assert ro.candidate.engine is not p.engine
        _drive(b, ro, (LIVE, REJECTED, ROLLED_BACK), tag="cs")
        assert ro.state == LIVE, (ro.state, ro.rollback_reason)
        assert ro.shadow_compared >= 4
        assert b.pipeline.scorer is not None
        assert len(_FakeStream.made) >= 2
        assert reached == []
    finally:
        b.close()


def test_card_stand_in_shadow_ignores_the_brownout_ladder(packs,
                                                          card_stand_in):
    """The shadow lane's candidate scans on a card are full scans
    whatever the serving ladder's level: the candidate shares the
    incumbent's LoadController, and a ladder at fail-open (level 2) must
    not turn its shadow verdicts into fail-open ones that diff as lost
    hits against full incumbent verdicts (the CPU path's
    ``detect_cpu_only`` ignores the ladder too)."""
    from types import SimpleNamespace

    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher

    CardEngine, reached, arm = card_stand_in
    arm()
    p = DetectionPipeline(packs["inc"], mode="block",
                          engine=CardEngine(packs["inc"]))
    b = Batcher(p, max_batch=16, max_delay_s=0.001, hard_deadline_s=30.0,
                lane_devices=[torch.device("cpu")])
    ro = RolloutController(b, _fast_config(tro, shadow_min_requests=10**6,
                                           shadow_cpu_budget=1.0))
    b.rollout = ro
    try:
        ro.admit_scoring(head=_drill_scoring_head())
        # the candidate's ladder reads fail-open; the incumbent's serves
        ro.candidate.load_controller = SimpleNamespace(level=2)
        deadline = time.monotonic() + 60
        wave = 0
        while ro.shadow_compared < 8 and time.monotonic() < deadline:
            _, viol = _collect([b.submit(r) for r in _requests(
                24, attack_every=2, tag="lad%d" % wave)], 30)
            assert not viol
            wave += 1
        assert ro.shadow_compared >= 8
        assert ro.state == SHADOW, (ro.state, ro.rollback_reason)
        assert ro.diff == {"new_block": 0, "lost_hit": 0, "score_delta": 0}
        assert reached == []
    finally:
        b.close()
