"""Brute/dirbust detection end to end through the port's server, on the
CPU: a replayed login flood through ``python -m ingress_plus_tpu_torch.serve``
(UDS wire, PostChannel, exporter drain) surfaces a "brute" event in the
attack export with rate evidence points, a wordlist sweep surfaces
"dirbust", and both feed the per-application counters on
``/wallarm-status`` — the analogs of ``tests/test_brute_e2e.py``.  Each
exported record is also held against the JAX package's detector fed the
same hits (same keys, counts and evidence).  The HTTP port is a free one.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

RULES = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("brute")
    rules_dir = tmp / "rules"
    rules_dir.mkdir()
    (rules_dir / "tiny.conf").write_text(RULES)
    sock = str(tmp / "ipt.sock")
    spool = tmp / "spool"
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # stderr to a FILE, not a pipe: an undrained pipe buffer can block
    # the serve process mid-run and hang the module
    errlog = (tmp / "serve.err").open("w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
         "--socket", sock, "--http-port", str(port),
         "--rules-dir", str(rules_dir), "--platform", "cpu",
         "--scan-impl", "pair", "--max-delay-us", "1000", "--no-warmup",
         "--hard-deadline-ms", "5000",
         "--spool-dir", str(spool), "--export-interval-s", "0.3",
         "--brute-threshold", "8", "--brute-window-s", "60",
         "--dirbust-threshold", "12"],
        cwd=str(REPO), env=env, stderr=errlog, text=True)
    for _ in range(600):
        if Path(sock).exists():
            try:
                c = socket.socket(socket.AF_UNIX)
                c.connect(sock)
                c.close()
                break
            except OSError:
                pass
        if proc.poll() is not None:
            raise RuntimeError(
                "server died: %s" % (tmp / "serve.err").read_text())
        time.sleep(0.1)
    else:
        proc.kill()
        raise RuntimeError("server socket never appeared")

    class S:
        pass

    s = S()
    s.sock, s.spool, s.port = sock, spool, port
    yield s
    proc.terminate()
    proc.wait(timeout=10)


def _replay(sock_path, requests_with_ids):
    from ingress_plus_tpu_torch.serve.protocol import (
        RESP_MAGIC,
        FrameReader,
        decode_response,
        encode_request,
    )

    s = socket.socket(socket.AF_UNIX)
    s.connect(sock_path)
    for req, rid in requests_with_ids:
        s.sendall(encode_request(req, req_id=rid))
    reader = FrameReader(RESP_MAGIC)
    got = {}
    s.settimeout(120)
    while len(got) < len(requests_with_ids):
        frames = reader.feed(s.recv(65536))
        for f in frames:
            r = decode_response(f)
            got[r["req_id"]] = r
    s.close()
    return got


def _spool_records(spool, want_class, timeout_s=15.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        recs = []
        for f in sorted(spool.glob("attacks*.jsonl")):
            recs += [json.loads(line) for line in
                     f.read_text().splitlines() if line.strip()]
        hits = [r for r in recs if r["class"] == want_class]
        if hits:
            return hits
        time.sleep(0.25)
    return []


def _jax_events(requests_with_ids, brute_class):
    """The JAX detector's events for the same clean requests, as the
    server's channel queues them (one hit each, one second apart; the
    wire req_id is the request id)."""
    from ingress_plus_tpu.post.brute import BruteConfig, BruteDetector
    from ingress_plus_tpu.post.channel import client_key
    from ingress_plus_tpu.post.queue import Hit
    from ingress_plus_tpu.serve.normalize import Request as JRequest

    det = BruteDetector(BruteConfig(window_s=60, threshold=8,
                                    dirbust_threshold=12))
    hits = []
    for i, (r, rid) in enumerate(requests_with_ids):
        jr = JRequest(method=r.method, uri=r.uri, headers=dict(r.headers),
                      body=r.body, request_id=str(rid))
        hits.append(Hit(ts=float(i), request_id=jr.request_id, tenant=0,
                        client=client_key(jr), method=jr.method,
                        uri=jr.uri, classes=(), rule_ids=(), score=0,
                        blocked=False, attack=False))
    return [a.to_dict() for a in det.observe(hits)
            if a.attack_class == brute_class]


def _same_event(got, want):
    """Equal apart from arrival timing (timestamps, and the evidence
    string's window seconds)."""
    for k in ("tenant", "client", "class", "count", "blocked",
              "max_score", "sample_uris", "sample_rule_ids",
              "sample_request_ids"):
        assert got[k] == want[k], k
    assert [p["var"] for p in got["sample_points"]] == \
        [p["var"] for p in want["sample_points"]]


def test_login_flood_raises_brute_event(server):
    from ingress_plus_tpu_torch.serve.normalize import Request

    flood = []
    for i in range(12):
        body = b"user=admin&pass=hunter%d" % i
        flood.append((Request(
            method="POST", uri="/account/login",
            headers={"host": "shop.example.com",
                     "x-real-ip": "203.0.113.77",
                     "content-type": "application/x-www-form-urlencoded"},
            body=body, request_id="flood-%d" % i), 8000 + i))
    got = _replay(server.sock, flood)
    # each login attempt is CLEAN — credential stuffing is not
    # per-request detectable, which is the point of the rate detector
    assert not any(v["attack"] for v in got.values())

    brutes = _spool_records(server.spool, "brute")
    assert brutes, "no brute event reached the export"
    b = brutes[0]
    assert b["client"] == "203.0.113.77"
    assert b["count"] >= 8
    assert any("/account/login" in u for u in b["sample_uris"])
    assert b["sample_points"] and \
        b["sample_points"][0]["var"] == "RATE:/account/login"
    assert "requests in" in b["sample_points"][0]["value"]
    (want,) = _jax_events(flood, "brute")
    _same_event(b, want)


def test_wordlist_sweep_raises_dirbust_event(server):
    from ingress_plus_tpu_torch.serve.normalize import Request

    sweep = []
    for i in range(15):
        sweep.append((Request(
            uri="/backup/%02d/config.old" % i,
            headers={"host": "shop.example.com",
                     "x-real-ip": "198.51.100.9"},
            request_id="sweep-%d" % i), 8100 + i))
    got = _replay(server.sock, sweep)
    assert not any(v["attack"] for v in got.values())

    events = _spool_records(server.spool, "dirbust")
    assert events, "no dirbust event reached the export"
    d = events[0]
    assert d["client"] == "198.51.100.9"
    assert d["sample_points"][0]["var"] == "SWEEP"
    assert "distinct paths" in d["sample_points"][0]["value"]
    (want,) = _jax_events(sweep, "dirbust")
    _same_event(d, want)


def test_rate_events_feed_status_counters(server):
    """The exported brute/dirbust events appear in the per-application
    counters (/wallarm-status export_events)."""
    deadline = time.time() + 15
    while time.time() < deadline:
        st = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/wallarm-status" % server.port,
            timeout=10).read())
        ev = st.get("export_events", {})
        if ev.get("brute") and ev.get("dirbust"):
            break
        time.sleep(0.25)
    assert ev.get("brute", 0) >= 1
    assert ev.get("dirbust", 0) >= 1
    assert ev.get("brute:0", 0) >= 1
