"""The port's fleet control plane (control/fleetctl.py, retuned.py):
node-by-node staged rollout with the fleet LKG pointer, crash-mid-wave
recovery, the retune daemon's structured-skip ladder and the fleet
fault-matrix scenarios — the JAX package's tests of its fleet control,
on the port's CPU serve nodes."""

import json

import pytest

from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.control.fleetctl import (
    FLEET_CANARY,
    FLEET_IDLE,
    FLEET_LIVE,
    FLEET_LKG_POINTER,
    FleetController,
    HttpFleetNode,
    build_drill_fleet,
    load_fleet_lkg,
)
from ingress_plus_tpu_torch.control.retuned import (
    CYCLE_ERROR,
    SKIP_COOLDOWN,
    SKIP_MIN_INTERVAL,
    SKIP_NO_DRIFT,
    SKIP_NO_PROFILE,
    RetuneDaemon,
)
from ingress_plus_tpu_torch.control.rollout import _DRILL_CANDIDATE
from ingress_plus_tpu_torch.utils.faults import run_fault_matrix


def _teardown(harnesses, front):
    front.stop()
    for h in harnesses:
        h.close()


# --------------------------------------------------- staged fleet wave

def test_fleet_wave_to_live_and_lkg(tmp_path):
    """Happy path: central admission, canary, node-by-node promote,
    fleet LKG advanced with every node's ack."""
    harnesses, front, fleet, _ = build_drill_fleet(
        2, tmp_path, device="cpu")
    try:
        cr = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
        adm = fleet.begin(ruleset=cr)
        assert adm["ok"], adm
        assert fleet.state == FLEET_CANARY
        assert fleet.drive(deadline_s=60) == FLEET_LIVE
        assert all(n.serving_version == cr.version for n in fleet.nodes)
        assert fleet.acks == {n.name: cr.version for n in fleet.nodes}
        lkg = load_fleet_lkg(tmp_path)
        assert lkg and lkg["version"] == cr.version
        # the journal is terminal — a restart must NOT re-converge
        again = FleetController(fleet.nodes, tmp_path)
        assert again.recover()["recovered"] is False
    finally:
        _teardown(harnesses, front)


def test_fleet_recover_converges_mid_wave_crash(tmp_path):
    """Crash mid-wave: a fresh controller over the same journal + LKG
    dir converges every node back to the fleet LKG before anything
    else happens (the daemon calls recover() at every startup)."""
    harnesses, front, fleet, _ = build_drill_fleet(
        2, tmp_path, device="cpu")
    try:
        incumbent = fleet.nodes[0].serving_version
        cr = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
        assert fleet.begin(ruleset=cr)["ok"]
        # walk the wave until the canary node is actually mid-ramp,
        # then "crash": drop the controller on the floor
        for _ in range(3):
            fleet.traffic_pump(fleet.nodes[0])
            fleet.poll()
        assert json.loads(fleet.journal_path.read_text())["state"] in (
            FLEET_CANARY, "promoting")
        reborn = FleetController(fleet.nodes, tmp_path)
        rep = reborn.recover()
        assert rep["recovered"] is True
        assert rep["lkg"] == incumbent
        assert all(v == "converged" for v in rep["nodes"].values())
        assert all(n.serving_version == incumbent for n in reborn.nodes)
        assert reborn.state == FLEET_IDLE
        # idempotent: the rewritten journal is terminal now
        assert reborn.recover()["recovered"] is False
    finally:
        _teardown(harnesses, front)


# ---------------------------------------------------- skew tripwires

class _StubNode:
    def __init__(self, name):
        self.name = name


class _StubObs:
    def __init__(self, findings):
        self.findings = findings

    def healthz(self):
        return {"skew_findings": self.findings}


def test_alien_generation_tripwire(tmp_path):
    """A node serving a generation that is neither incumbent nor
    candidate trips the wave even when the fleet majority IS the
    incumbent — the finding's detail names both generations, so only
    the node's OWN generation may decide."""
    def fleet_with(findings):
        f = FleetController([_StubNode("n0"), _StubNode("n1")],
                            tmp_path, observer=_StubObs(findings))
        f.incumbent_version, f.candidate_version = "inc-1", "cand-2"
        return f

    def skew(node, gen, structured=True):
        f = {"kind": "generation_skew", "node": node,
             "detail": "serving pack generation %r; fleet majority "
                       "is %r" % (gen, "inc-1")}
        if structured:
            f["generation"] = gen
        return f

    # majority == incumbent: the alien node must still be flagged
    assert fleet_with([skew("n1", "evil-9")])._check_tripwires() \
        == "alien_generation:n1"
    # detail-only findings (older observers): parse the node's own %r
    assert fleet_with([skew("n1", "evil-9", structured=False)]) \
        ._check_tripwires() == "alien_generation:n1"
    # mid-wave incumbent/candidate split is the plan, not a tripwire
    assert fleet_with([skew("n0", "cand-2")])._check_tripwires() is None
    assert fleet_with([skew("n1", "inc-1")])._check_tripwires() is None


# --------------------------------------------- unreachable HTTP nodes

def test_http_node_unreachable_is_reported_not_raised(tmp_path):
    """A dead node is exactly when the fleet layer acts on it: every
    HttpFleetNode surface degrades to a structured answer, and
    fleet_rollback reports converge_failed instead of aborting
    mid-iteration with URLError."""
    node = HttpFleetNode("nx", "127.0.0.1:1", timeout_s=0.5)
    assert node.serving_version == ""
    assert node.state() == "unreachable"
    assert node.abort("drill") is False
    assert node.converge_to(None, artifact=tmp_path / "x.pack") is False
    assert "unreachable" in node.failure_reason()
    assert node.status_brief()["rollout_state"] == "unreachable"

    (tmp_path / FLEET_LKG_POINTER).write_text(json.dumps(
        {"artifact": "nope.pack", "version": "v1", "acks": {}}))
    fleet = FleetController([node], tmp_path)
    rep = fleet.fleet_rollback("node_dead_drill")
    assert rep["nodes"] == {"nx": "converge_failed"}
    assert json.loads(fleet.journal_path.read_text())["state"] \
        == "rolled_back"


# ------------------------------------------------ retune daemon ladder

class _Obs:
    """Observer twin: scripted /fleet/drift + merged-profile answers."""

    def __init__(self, drift=None, profile=None, err=""):
        self.drift = drift if drift is not None else {}
        self.profile = profile
        self.err = err

    def fleet_drift(self):
        if isinstance(self.drift, Exception):
            raise self.drift
        return self.drift

    def merged_profile(self):
        return self.profile

    def healthz(self):
        return {"merged_profile": {"error": self.err}}


def _daemon(tmp_path, obs, **kw):
    # the fleet is only touched past the profile gate; the ladder
    # tests never get there, so a bare object is an honest stand-in
    return RetuneDaemon(obs, object(), tmp_path, **kw)


def test_daemon_drift_probe(tmp_path):
    def probe(drift):
        return _daemon(tmp_path, _Obs(drift=drift))._drift_reason()

    assert probe({"fleet_went_quiet": [942100, 942440]}) \
        == "fleet_went_quiet:2 rules"
    assert probe({"nodes": {"n0": {"rules": [{"delta": -0.05}]}}}) \
        == "hit_rate_delta:0.0500"
    assert probe({"nodes": {"n0": {"rules": [{"delta": 0.001}]}}}) is None
    assert probe(RuntimeError("aggregator down")) is None


def test_daemon_skips_are_typed_and_journaled(tmp_path):
    obs = _Obs(drift={})
    d = _daemon(tmp_path, obs)
    rec = d.cycle()
    assert rec["result"] == SKIP_NO_DRIFT
    assert d.journal_tail()[-1]["result"] == SKIP_NO_DRIFT

    # actionable drift but the merged profile is degraded away (e.g. a
    # node publishing a newer PROFILE_VERSION): typed skip, not a crash
    obs2 = _Obs(drift={"fleet_went_quiet": [1]}, profile=None,
                err="node n2 profile schema v9 newer than v1")
    rec2 = _daemon(tmp_path, obs2).cycle()
    assert rec2["result"] == SKIP_NO_PROFILE
    assert "newer" in rec2["detail"]
    assert rec2["drift"] == "fleet_went_quiet:1 rules"


def test_daemon_rate_limit_and_cooldown(tmp_path):
    now = [1000.0]
    d = _daemon(tmp_path, _Obs(drift={"fleet_went_quiet": [1]}),
                min_interval_s=600.0, cooldown_s=300.0,
                clock=lambda: now[0])
    # a retune just happened: the limiter holds even under drift
    d._last_retune_at = 900.0
    assert d.cycle()["result"] == SKIP_MIN_INTERVAL
    # force bypasses the limiter AND the drift probe (break-glass) —
    # with no profile it then skips one rung further down the ladder
    rec = d.cycle(force=True)
    assert rec["result"] == SKIP_NO_PROFILE and rec["drift"] == "forced"
    # cooldown after a fleet rollback outranks even force
    d._cooldown_until = now[0] + 200.0
    rec = d.cycle(force=True)
    assert rec["result"] == SKIP_COOLDOWN
    assert "200s left" in rec["detail"]
    now[0] += 201.0
    assert d.cycle(force=True)["result"] != SKIP_COOLDOWN
    assert d.status()["cooldown_left_s"] == 0.0


def test_daemon_cycle_never_raises(tmp_path, monkeypatch):
    d = _daemon(tmp_path, _Obs())
    monkeypatch.setattr(
        d, "_cycle_inner",
        lambda now, force: (_ for _ in ()).throw(RuntimeError("boom")))
    rec = d.cycle()
    assert rec["result"] == CYCLE_ERROR
    assert "RuntimeError: boom" in rec["detail"]
    assert d.journal_tail()[-1]["result"] == CYCLE_ERROR


def test_daemon_journal_bounded(tmp_path):
    d = _daemon(tmp_path, _Obs(drift={}), max_journal_entries=8)
    for _ in range(30):
        d.cycle()
    lines = d.journal_path.read_text().splitlines()
    assert len(lines) <= 8
    assert json.loads(lines[-1])["cycle"] == 30   # newest survives
    # torn/corrupt lines are skipped, not fatal
    with d.journal_path.open("a") as f:
        f.write('{"cycle": 31, "result"')
    tail = d.journal_tail()
    assert tail and tail[-1]["cycle"] == 30


# --------------------------------------------------- fault matrix

@pytest.mark.parametrize("scenario", [
    "fleet_node_kill", "fleet_rollout_node_death",
    "fleet_partition_daemon"])
def test_fleet_fault_matrix_scenario(scenario):
    rep = run_fault_matrix(only=[scenario], device="cpu")
    res = rep["scenarios"][scenario]
    assert res["ok"], res["violations"]
