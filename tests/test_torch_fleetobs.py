"""The port's fleet telemetry plane (control/fleetobs.py,
utils/promparse.py, utils/slo.py): exposition parser round-trip, counter
conservation under concurrent traffic, histogram bucket-merge vs a
reference, traffic-weighted profile-merge determinism, skew/stale
detection, SLO burn math on an injected clock and the /fleet/*
surfaces — the JAX package's tests of its fleet plane, run on the
port's modules.  The port's promlint and ``dbg fleet`` renderer judge
the port's output, the JAX package's (pure functions of text) judge it
beside them and must agree, and the parser, the SLO engine and the
observer are held to the JAX ones on the same inputs.

Everything here runs in-process over fake node transports; the
fault-matrix ``fleet_scrape`` scenario covers the mid-run stale drill
against live port ServeLoops."""

import json
import math
import random
import threading
import time
import urllib.request

import pytest

from ingress_plus_tpu.analysis.promlint import (
    check_exposition as jax_check_exposition,
)
from ingress_plus_tpu_torch.analysis.promlint import check_exposition
from ingress_plus_tpu_torch.compiler.profile import (
    PROFILE_VERSION, MeasuredProfile, ProfileVersionError)
from ingress_plus_tpu.control.dbg import render_fleet as jax_render_fleet
from ingress_plus_tpu_torch.control.dbg import render_fleet
from ingress_plus_tpu_torch.control.fleetobs import FleetObserver, ScrapeError
from ingress_plus_tpu_torch.utils import promparse
from ingress_plus_tpu_torch.utils.faults import (
    FaultPlan, clear as faults_clear, install as faults_install,
    run_fault_matrix)
from ingress_plus_tpu_torch.utils.slo import SLO, SLOEngine
from ingress_plus_tpu_torch.utils.trace import Histogram

#: small fixed bucket set so the tests can reason about exact counts
BOUNDS = (100, 1000, 10000, 100000)


# --------------------------------------------------------------- fixtures

def node_exposition(requests=100, fail_open=0, degraded=0,
                    version="gen-a", e2e_us=(),
                    confirm=(1000, 1000, 1000)) -> str:
    """One node's /metrics text, shaped like the real serve loop's:
    counters, an info joint, a gauge, and a real Histogram rendering
    its own cumulative ``_bucket`` lines."""
    h = Histogram(BOUNDS)
    for us in e2e_us:
        h.observe(us)
    prep_us, engine_us, confirm_us = confirm
    lines = [
        "# HELP ipt_requests_total requests admitted",
        "# TYPE ipt_requests_total counter",
        "ipt_requests_total %d" % requests,
        "# HELP ipt_fail_open_total fail-open verdicts",
        "# TYPE ipt_fail_open_total counter",
        "ipt_fail_open_total %d" % fail_open,
        "# HELP ipt_degraded_verdicts_total degraded verdicts",
        "# TYPE ipt_degraded_verdicts_total counter",
        "ipt_degraded_verdicts_total %d" % degraded,
        "# HELP ipt_prep_us_sum cumulative prep time",
        "# TYPE ipt_prep_us_sum counter",
        "ipt_prep_us_sum %d" % prep_us,
        "# HELP ipt_engine_us_sum cumulative engine time",
        "# TYPE ipt_engine_us_sum counter",
        "ipt_engine_us_sum %d" % engine_us,
        "# HELP ipt_confirm_us_sum cumulative confirm time",
        "# TYPE ipt_confirm_us_sum counter",
        "ipt_confirm_us_sum %d" % confirm_us,
        "# HELP ipt_ruleset_info active pack generation",
        "# TYPE ipt_ruleset_info gauge",
        'ipt_ruleset_info{rules="3",version="%s"} 1' % version,
        "# HELP ipt_queue_depth current queue depth",
        "# TYPE ipt_queue_depth gauge",
        "ipt_queue_depth 2",
        "# HELP ipt_stage_us per-stage latency",
        "# TYPE ipt_stage_us histogram",
    ] + h.prometheus("ipt_stage_us", {"stage": "e2e"})
    return "\n".join(lines) + "\n"


def _prof(source: str, requests: int, cand: float,
          cost: float) -> MeasuredProfile:
    return MeasuredProfile(
        source=source, requests=requests,
        rules={942100: {"candidate_rate": cand,
                        "confirmed_rate": round(cand / 2, 6),
                        "confirm_us_per_candidate": cost,
                        "qr_skip_rate": 0.5}})


def default_payloads(requests=100, fail_open=0, degraded=0,
                     version="gen-a", e2e_us=(),
                     confirm=(1000, 1000, 1000), source="n",
                     quiet=()):
    return {
        "/metrics": node_exposition(requests, fail_open, degraded,
                                    version, e2e_us, confirm),
        "/healthz": json.dumps({"status": "ok"}),
        "/rules/stats?format=profile":
            _prof(source, requests, 0.1, 12.0).to_json(),
        "/rules/drift": json.dumps(
            {"went_quiet": [{"rule": r} for r in quiet]}),
    }


def mk_transport(payloads, fail=None):
    """Dict-backed node transport; ``fail()`` truthy simulates the node
    going down mid-scrape."""
    def _fetch(path: str) -> bytes:
        if fail is not None and fail():
            raise ScrapeError("node down")
        val = payloads[path]
        if callable(val):
            val = val()
        return val.encode() if isinstance(val, str) else val
    return _fetch


def mk_observer(node_payloads, fails=None) -> FleetObserver:
    obs = FleetObserver()
    for i, (name, payloads) in enumerate(node_payloads):
        obs.add_node(name, transport=mk_transport(
            payloads, fail=(fails or {}).get(name)))
    return obs


# ---------------------------------------------------------------- parser

def test_parser_round_trips_real_exposition():
    samples = [50, 500, 5000, 50000, 500000]
    text = node_exposition(requests=7, e2e_us=samples)
    exp = promparse.parse_exposition(text)
    assert exp.errors == []
    assert exp.types["ipt_requests_total"] == "counter"
    assert exp.types["ipt_stage_us"] == "histogram"
    assert exp.value("ipt_requests_total") == 7.0
    assert exp.value("ipt_ruleset_info", version="gen-a") == 1.0
    (rec,) = exp.histogram_series("ipt_stage_us").values()
    assert rec["labels"] == {"stage": "e2e"}
    assert rec["count"] == len(samples)
    assert rec["buckets"][-1][0] == math.inf
    # decode the cumulative buckets back into a Histogram: the round
    # trip must reproduce the original distribution exactly
    bounds = [int(le) for le, _v in rec["buckets"][:-1]]
    back = Histogram.from_cumulative(
        bounds, [v for _le, v in rec["buckets"]], rec["sum"])
    ref = Histogram(BOUNDS)
    for us in samples:
        ref.observe(us)
    assert back.snapshot() == ref.snapshot()


def test_parser_reports_errors_never_raises():
    exp = promparse.parse_exposition(
        "# TYPE broken\nipt_x{bad 1\nipt_y notafloat\n")
    assert exp.errors, "malformed input must surface as findings"
    assert all(isinstance(e, str) and "line " in e for e in exp.errors)
    # the valid-line subset still parses around the damage
    exp2 = promparse.parse_exposition(
        "ipt_ok_total 3\nipt_x{bad 1\n")
    assert exp2.value("ipt_ok_total") == 3.0
    assert len(exp2.errors) == 1


# ---------------------------------------------------------- conservation

def test_counter_conservation_under_concurrent_traffic():
    counts = [0, 0, 0]
    lock = threading.Lock()

    def metrics_for(i):
        def _render():
            with lock:
                c = counts[i]
            return node_exposition(requests=c)
        return _render

    node_payloads = []
    for i in range(3):
        p = default_payloads(source="n%d" % i)
        p["/metrics"] = metrics_for(i)
        node_payloads.append(("n%d" % i, p))
    obs = mk_observer(node_payloads)

    stop = threading.Event()

    def traffic(i):
        while not stop.is_set():
            with lock:
                counts[i] += 1
            time.sleep(0.001)

    threads = [threading.Thread(target=traffic, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    try:
        # while traffic is live, every cycle's fleet sum must equal the
        # sum of its own per-node addends — conservation is a per-cycle
        # invariant, not an end-state accident
        for _ in range(5):
            obs.scrape()
            fleet, per_node = obs.counters_snapshot()
            addends = per_node["ipt_requests_total"]
            assert set(addends) == {"n0", "n1", "n2"}
            assert fleet["ipt_requests_total"] == sum(addends.values())
    finally:
        stop.set()
        for t in threads:
            t.join()
    # quiesced: the fleet sum equals the independently-counted truth
    obs.scrape()
    fleet, _per = obs.counters_snapshot()
    assert fleet["ipt_requests_total"] == float(sum(counts))


# ------------------------------------------------------- histogram merge

def test_histogram_merge_matches_reference():
    rng = random.Random(42)
    ref = Histogram(BOUNDS)
    parts = []
    for _ in range(4):
        h = Histogram(BOUNDS)
        for _j in range(200):
            us = rng.randint(0, 200000)
            h.observe(us)
            ref.observe(us)
        parts.append(h)
    merged = Histogram.merge(parts)
    assert merged.snapshot() == ref.snapshot()
    assert merged.percentile(0.99) == ref.percentile(0.99)


def test_histogram_merge_and_decode_reject_bad_shapes():
    with pytest.raises(ValueError, match="bounds mismatch"):
        Histogram.merge([Histogram((1, 2)), Histogram((1, 3))])
    with pytest.raises(ValueError, match="non-monotonic"):
        Histogram.from_cumulative((100, 1000), [5, 3, 6])
    with pytest.raises(ValueError, match="does not match"):
        Histogram.from_cumulative((100, 1000), [1, 2])


# --------------------------------------------------------- profile merge

def test_profile_merge_is_weighted_and_order_insensitive():
    a = _prof("a", 100, 0.1, 10.0)
    b = _prof("b", 300, 0.3, 20.0)
    c = _prof("c", 0, 0.5, 40.0)     # idle node: zero traffic weight
    m1 = MeasuredProfile.merge([a, b, c])
    m2 = MeasuredProfile.merge([c, b, a])
    assert m1.content_hash() == m2.content_hash()
    assert m1.to_json() == m2.to_json()
    # repeat merge → hash-stable (the retune daemon's idempotence)
    assert (MeasuredProfile.merge([a, b, c]).content_hash()
            == m1.content_hash())
    assert m1.requests == 400
    rec = m1.rules[942100]
    # candidate rate averages over ALL traffic weight:
    # (100*0.1 + 300*0.3) / 400
    assert rec["candidate_rate"] == pytest.approx(0.25)
    # confirm cost averages per candidate volume:
    # (100*0.1*10 + 300*0.3*20) / (100*0.1 + 300*0.3)
    assert rec["confirm_us_per_candidate"] == pytest.approx(19.0)


def test_profile_merge_rejects_cross_version():
    a = _prof("a", 10, 0.1, 1.0)
    b = _prof("b", 10, 0.1, 1.0)
    b.version = PROFILE_VERSION + 1
    with pytest.raises(ProfileVersionError) as ei:
        MeasuredProfile.merge([a, b])
    assert ei.value.versions == (PROFILE_VERSION, PROFILE_VERSION + 1)
    with pytest.raises(ValueError):
        MeasuredProfile.merge([])


def test_profile_merge_all_idle_fleet():
    """Every node at zero requests (a fleet that just booted): the
    merge must not divide by zero — it falls back to the unweighted
    mean so a retune against the cold fleet still has a profile."""
    a = _prof("a", 0, 0.2, 10.0)
    b = _prof("b", 0, 0.4, 30.0)
    m = MeasuredProfile.merge([a, b])
    assert m.requests == 0
    rec = m.rules[942100]
    assert rec["candidate_rate"] == pytest.approx(0.3)
    # per-candidate cost weights by candidate volume even at w=1:
    # (0.2*10 + 0.4*30) / (0.2 + 0.4)
    assert rec["confirm_us_per_candidate"] == pytest.approx(23.333)
    # and the result is still order-canonical
    assert (MeasuredProfile.merge([b, a]).content_hash()
            == m.content_hash())


def test_profile_merge_single_node_is_near_identity():
    """A one-node fleet merges to the same rates it reported — the
    daemon must behave identically whether it fronts 1 node or 10."""
    a = _prof("solo", 500, 0.25, 15.0)
    a.byte_freq = [1.0 / 256] * 256
    m = MeasuredProfile.merge([a])
    assert m.requests == 500 and m.version == a.version
    assert m.rules[942100]["candidate_rate"] == pytest.approx(0.25)
    assert m.rules[942100]["confirm_us_per_candidate"] == \
        pytest.approx(15.0)
    assert m.rules[942100]["qr_skip_rate"] == pytest.approx(0.5)
    assert len(m.byte_freq) == 256
    assert sum(m.byte_freq) == pytest.approx(1.0)


def test_profile_merge_rule_absent_on_some_nodes():
    """A rule only one node ever saw still dilutes over ALL traffic
    weight (absence == zero candidates on that node), and an idle
    zero-request node alongside busy ones contributes nothing."""
    busy = _prof("busy", 300, 0.2, 10.0)
    quiet = MeasuredProfile(source="quiet", requests=100, rules={})
    idle = _prof("idle", 0, 0.9, 99.0)
    m = MeasuredProfile.merge([busy, quiet, idle])
    rec = m.rules[942100]
    # (300*0.2) / 400 — the quiet node's 100 requests count as zeros,
    # the idle node's w=0 silences its (stale) rates entirely
    assert rec["candidate_rate"] == pytest.approx(0.15)
    assert rec["confirm_us_per_candidate"] == pytest.approx(10.0)
    assert m.requests == 400


def test_profile_from_dict_rejects_newer_schema():
    """A node running a NEWER profile schema must be a structured skip
    at decode time (ProfileVersionError), not a silent mis-merge —
    the fleet plane turns this into a per-node merge error."""
    d = _prof("future", 10, 0.1, 1.0).to_dict()
    d["version"] = PROFILE_VERSION + 1
    with pytest.raises(ProfileVersionError):
        MeasuredProfile.from_dict(d)
    # same-or-older versions decode fine
    ok = MeasuredProfile.from_dict(
        _prof("now", 10, 0.1, 1.0).to_dict())
    assert ok.rules[942100]["candidate_rate"] == pytest.approx(0.1)


# ----------------------------------------------------------------- skew

def test_generation_p99_and_confirm_share_skew():
    fast = list(range(0, 5000, 100))
    slow = [90000] * 50
    node_payloads = []
    for i in range(3):
        odd = i == 2
        node_payloads.append(("n%d" % i, default_payloads(
            version="gen-b" if odd else "gen-a",
            e2e_us=slow if odd else fast,
            confirm=(1000, 1000, 5000) if odd else (1000, 1000, 1000),
            source="n%d" % i)))
    obs = mk_observer(node_payloads)
    health = obs.scrape()
    found = {(f["kind"], f["node"]) for f in health["skew_findings"]}
    assert ("generation_skew", "n2") in found
    assert ("p99_outlier", "n2") in found
    assert ("confirm_share_outlier", "n2") in found
    # the majority nodes are NOT flagged
    assert not any(node in ("n0", "n1") for _k, node in found)


def test_stale_node_excluded_then_recovers():
    down = {"n0": False}
    node_payloads = [("n%d" % i, default_payloads(source="n%d" % i))
                     for i in range(3)]
    obs = mk_observer(node_payloads,
                      fails={"n0": lambda: down["n0"]})
    obs.scrape()
    assert [n.up for n in obs.nodes] == [True, True, True]

    down["n0"] = True
    health = obs.scrape()
    assert health["nodes_up"] == 2 and health["nodes_stale"] == 1
    assert obs.nodes[0].stale and not obs.nodes[0].up
    fleet, per_node = obs.counters_snapshot()
    addends = per_node["ipt_requests_total"]
    # conservation over the reachable subset: the stale node neither
    # contributes an addend nor pollutes the gauge rollups
    assert set(addends) == {"n1", "n2"}
    assert fleet["ipt_requests_total"] == sum(addends.values())
    text = obs.fleet_metrics()
    assert "ipt_fleet_nodes_stale 1" in text
    assert 'node="n0"' not in text

    down["n0"] = False
    health = obs.scrape()
    assert health["nodes_up"] == 3 and health["nodes_stale"] == 0
    assert "ipt_fleet_nodes_stale 0" in obs.fleet_metrics()


def test_scrape_fault_sites_drive_the_scraper():
    node_payloads = [("n%d" % i, default_payloads(source="n%d" % i))
                     for i in range(3)]
    obs = mk_observer(node_payloads)
    saved_exc = None
    try:
        obs.scrape()
        faults_install(FaultPlan.from_spec("scrape_timeout:times=1"))
        health = obs.scrape()
    except BaseException as e:  # pragma: no cover - diagnostics only
        saved_exc = e
    finally:
        faults_clear()
    assert saved_exc is None
    # exactly the first-scraped node ate the injected fault
    assert health["nodes_up"] == 2 and health["nodes_stale"] == 1
    assert obs.nodes[0].error == "injected scrape timeout"


def test_fleet_scrape_fault_matrix_scenario():
    rep = run_fault_matrix(only=["fleet_scrape"], device="cpu")
    assert rep["passed"], rep["scenarios"]["fleet_scrape"]


# ------------------------------------------------------------- SLO burn

def test_slo_burn_math_on_injected_clock():
    now = [0.0]
    eng = SLOEngine((SLO("avail", "availability", 0.99),),
                    clock=lambda: now[0])
    assert eng.burn_rates()["avail"]["verdict"] == "no_data"

    eng.observe("avail", 0.0, 0.0)
    now[0] = 100.0
    eng.observe("avail", 90.0, 100.0)     # 10% errors, 1% budget
    rec = eng.burn_rates()["avail"]
    fast = rec["windows"]["fast"]
    assert fast["error_rate"] == pytest.approx(0.1)
    assert fast["burn"] == pytest.approx(10.0)
    # 10x burn on both windows warns but does not page (< 14.4)
    assert rec["verdict"] == "burning"

    now[0] = 200.0
    eng.observe("avail", 90.0, 200.0)     # the next 100 all failed
    rec = eng.burn_rates()["avail"]
    assert rec["windows"]["fast"]["burn"] >= 14.4
    assert rec["windows"]["slow"]["burn"] >= 14.4
    assert rec["verdict"] == "critical"
    assert eng.fleet_verdict() == "critical"


def test_slo_spike_that_recovered_stops_paging():
    now = [0.0]
    eng = SLOEngine((SLO("avail", "availability", 0.99),),
                    clock=lambda: now[0])
    eng.observe("avail", 0.0, 0.0)
    now[0] = 100.0
    eng.observe("avail", 50.0, 100.0)     # old spike: 50% errors
    now[0] = 2800.0
    eng.observe("avail", 1040.0, 1090.0)  # long clean stretch
    now[0] = 3000.0
    eng.observe("avail", 1050.0, 1100.0)
    rec = eng.burn_rates()["avail"]
    # fast window sees only the clean tail; slow still remembers
    assert rec["windows"]["fast"]["burn"] == pytest.approx(0.0)
    assert rec["windows"]["slow"]["burn"] > 1.0
    assert rec["verdict"] == "ok"


def test_slo_counter_reset_clamps_to_zero():
    now = [0.0]
    eng = SLOEngine((SLO("avail", "availability", 0.99),),
                    clock=lambda: now[0])
    eng.observe("avail", 100.0, 100.0)
    now[0] = 50.0
    eng.observe("avail", 5.0, 10.0)       # node restart: counters shrank
    rec = eng.burn_rates()["avail"]
    # negative deltas clamp: no data this span, never a negative burn
    assert rec["windows"]["fast"]["burn"] is None
    assert rec["verdict"] == "no_data"


def test_slo_engine_validates_inputs():
    with pytest.raises(KeyError):
        SLOEngine().observe("nope", 1, 1)
    with pytest.raises(ValueError):
        SLO("bad", "availability", 1.5)
    with pytest.raises(ValueError):
        SLO("bad", "throughput", 0.9)
    with pytest.raises(ValueError):
        SLOEngine((SLO("x", "availability", 0.9),
                   SLO("x", "latency", 0.9, budget_us=1)))
    lines = SLOEngine().prometheus_lines()
    text = "\n".join(lines)
    assert 'ipt_slo_burn_rate{slo="availability",window="fast"}' in text
    assert "# TYPE ipt_slo_verdict gauge" in text


# ------------------------------------------------- endpoints + renderer

def test_fleet_endpoints_promlint_and_dbg_render():
    node_payloads = [
        ("n%d" % i, default_payloads(
            source="n%d" % i, e2e_us=[200, 2000, 20000],
            quiet=(942100,) if i == 0 else ()))
        for i in range(3)]
    obs = mk_observer(node_payloads)
    obs.scrape()
    obs.scrape()

    status, ctype, body = obs.route("/fleet/metrics")
    assert status.startswith("200") and ctype.startswith("text/plain")
    text = body.decode()
    # the aggregated exposition passes its own lint (fleet mode allows
    # the deliberate node=/agg= labels, nothing else)
    assert check_exposition(text, fleet=True) == []
    assert jax_check_exposition(text, fleet=True) == []
    assert 'ipt_slo_burn_rate{slo="availability",window="fast"}' in text
    assert 'ipt_queue_depth{agg="mean"}' in text
    assert 'ipt_queue_depth{node="n1"}' in text
    # per-node lint must reject those same labels
    assert any("node-identity label" in f
               for f in check_exposition(text, fleet=False))
    assert check_exposition(text, fleet=False) == jax_check_exposition(
        text, fleet=False)

    for path in ("/fleet/healthz", "/fleet/drift", "/fleet/slo",
                 "/fleet/profile"):
        status, ctype, body = obs.route(path)
        assert status.startswith("200"), path
        json.loads(body)
    status, _ctype, body = obs.route("/fleet/nope")
    assert status.startswith("404")
    assert "/fleet/metrics" in json.loads(body)["routes"]

    drift = obs.fleet_drift()
    assert drift["fleet_went_quiet"] == [
        {"rule": "942100", "nodes": ["n0"]}]

    health = obs.healthz()
    out = render_fleet(health, obs.fleet_slo())
    assert out == jax_render_fleet(health, obs.fleet_slo())
    assert out.startswith("fleet:")
    for needle in ("n0", "n1", "n2", "generation", "availability",
                   "latency_p99"):
        assert needle in out, needle

    # the same surfaces over a real TCP port
    port = obs.serve_http(0)
    try:
        raw = urllib.request.urlopen(
            "http://127.0.0.1:%d/fleet/healthz" % port,
            timeout=10).read()
        assert json.loads(raw)["nodes_up"] == 3
    finally:
        obs.close()


def test_observer_registry_validates():
    obs = FleetObserver()
    obs.add_node("a", transport=mk_transport(default_payloads()))
    with pytest.raises(ValueError, match="duplicate"):
        obs.add_node("a", transport=mk_transport(default_payloads()))
    with pytest.raises(ValueError, match="target or a transport"):
        obs.add_node("b")


# ------------------------------------------------ parity with the JAX plane


def test_parser_equals_jax():
    from ingress_plus_tpu.utils import promparse as jax_promparse

    for text in (node_exposition(requests=7, e2e_us=[50, 5000, 500000]),
                 "# TYPE broken\nipt_x{bad 1\nipt_y notafloat\n"
                 "ipt_ok_total 3\n"):
        ours = promparse.parse_exposition(text)
        theirs = jax_promparse.parse_exposition(text)
        assert ours.types == theirs.types
        assert ours.errors == theirs.errors
        assert [(s.name, s.labels, s.value) for s in ours.samples] == \
            [(s.name, s.labels, s.value) for s in theirs.samples]


def test_slo_burn_equals_jax_on_one_clock():
    from ingress_plus_tpu.utils.slo import SLO as JaxSLO
    from ingress_plus_tpu.utils.slo import SLOEngine as JaxEngine

    now = [0.0]
    ours = SLOEngine((SLO("avail", "availability", 0.99),),
                     clock=lambda: now[0])
    theirs = JaxEngine((JaxSLO("avail", "availability", 0.99),),
                       clock=lambda: now[0])
    for t, good, total in ((0, 0, 0), (100, 90, 100), (200, 90, 200),
                           (2800, 1040, 1090), (3000, 1050, 1100)):
        now[0] = float(t)
        ours.observe("avail", float(good), float(total))
        theirs.observe("avail", float(good), float(total))
        assert ours.burn_rates() == theirs.burn_rates()
    assert ours.prometheus_lines() == theirs.prometheus_lines()


def test_observer_equals_jax_on_the_same_scrapes():
    """Skewed nodes, one going stale: the same findings, counters,
    drift and fleet exposition as the JAX observer on the same
    payloads."""
    from ingress_plus_tpu.control.fleetobs import FleetObserver as JaxObs

    fast = list(range(0, 5000, 100))
    slow = [90000] * 50
    payloads = [("n%d" % i, default_payloads(
        version="gen-b" if i == 2 else "gen-a",
        e2e_us=slow if i == 2 else fast,
        confirm=(1000, 1000, 5000) if i == 2 else (1000, 1000, 1000),
        source="n%d" % i, quiet=(942100,) if i == 0 else ()))
        for i in range(3)]
    down = {"n1": False}
    observers = []
    for cls in (FleetObserver, JaxObs):
        obs = cls()
        for name, p in payloads:
            obs.add_node(name, transport=mk_transport(
                p, fail=(lambda: down["n1"]) if name == "n1" else None))
        observers.append(obs)
    for step in range(3):
        down["n1"] = step == 1
        hs = [o.scrape() for o in observers]
        for key in ("nodes_up", "nodes_stale", "skew_findings"):
            assert hs[0][key] == hs[1][key], (step, key)
        assert observers[0].counters_snapshot() == \
            observers[1].counters_snapshot()
        assert observers[0].fleet_drift() == observers[1].fleet_drift()
        texts = [o.fleet_metrics().splitlines() for o in observers]
        keep = [[ln for ln in t if "scrape_seconds" not in ln
                 and "slo" not in ln] for t in texts]
        assert keep[0] == keep[1], step
