"""The port's shared admission front (serve/front.py): least-loaded
routing, ejection with backoff + half-open re-admission, the all-down
fail-open path and the HTTP observability plane — the JAX package's
tests of its front, on the port's CPU serve nodes, plus the HTTP plane
held byte for byte to the JAX front's on the same node states."""

import json
import time

import pytest

from ingress_plus_tpu_torch.control.fleetctl import build_drill_fleet
from ingress_plus_tpu_torch.serve.front import (
    DOWN,
    UP,
    BackendNode,
    FrontLoop,
)
from ingress_plus_tpu_torch.utils.faults import _front_wave


# ---------------------------------------------------------- unit layer

def test_backend_parse():
    n = BackendNode.parse("n0=/run/ipt/f0.sock@127.0.0.1:9941")
    assert (n.name, n.socket_path, n.readyz) \
        == ("n0", "/run/ipt/f0.sock", "127.0.0.1:9941")
    bare = BackendNode.parse("n1=/tmp/a.sock")
    assert bare.readyz is None and bare.ready()  # no probe = only UDS gates
    with pytest.raises(ValueError, match="NAME=SOCKET"):
        BackendNode.parse("just-a-socket-path")


def _front3():
    nodes = [BackendNode(name="n%d" % i, socket_path="/tmp/x%d" % i)
             for i in range(3)]
    return FrontLoop(nodes, "/tmp/unused-front.sock"), nodes


def test_pick_is_least_loaded_and_skips_tried():
    front, (a, b, c) = _front3()
    a.inflight, b.inflight, c.inflight = 5, 1, 3
    assert front.pick(set()) is b
    # per-request retry excludes nodes already tried on this request
    assert front.pick({"n1"}) is c
    c.state = DOWN
    assert front.pick({"n1"}) is a
    # every ready node at its inflight cap = shed, loudly counted
    a.inflight = a.inflight_cap
    assert front.pick({"n1"}) is None
    assert front.shed_capacity == 1
    # but a fully-tried fleet is NOT a capacity shed
    shed_before = front.shed_capacity
    assert front.pick({"n0", "n1", "n2"}) is None
    assert front.shed_capacity == shed_before


def test_eject_backoff_and_readmit_counters():
    front, (a, _b, _c) = _front3()
    front.eject(a, "connect_refused")
    assert (a.state, a.eject_reason, a.ejections) \
        == (DOWN, "connect_refused", 1)
    assert a.next_probe > time.monotonic()
    # idempotent: a down node cannot be ejected twice
    front.eject(a, "again")
    assert a.ejections == 1 and a.eject_reason == "connect_refused"
    front._readmit(a)
    assert (a.state, a.eject_reason, a.readmissions) == (UP, "", 1)


def test_route_http_surfaces():
    front, (a, b, c) = _front3()
    code, ctype, body = front.route_http("/metrics")
    assert code == "200 OK" and "text/plain" in ctype
    assert b"ipt_front_nodes_up 3" in body
    assert b'ipt_front_node_up{node="n1"} 1' in body

    code, _, body = front.route_http("/readyz?verbose=1")
    assert code == "200 OK" and json.loads(body)["nodes_up"] == 3
    for n in (a, b, c):
        front.eject(n, "drill")
    code, _, body = front.route_http("/readyz")
    # zero nodes: still answering (fail-open) but advertising 503 so
    # an upstream LB prefers a healthier front
    assert code == "503 Service Unavailable"
    assert json.loads(body) == {"ready": False, "nodes_up": 0}

    _, _, body = front.route_http("/front/nodes")
    rows = json.loads(body)          # the bare list, not a wrapper
    assert [r["name"] for r in rows] == ["n0", "n1", "n2"]
    assert all(r["state"] == DOWN for r in rows)
    assert front.route_http("/nope")[0].startswith("404")


# --------------------------------------------------- integration layer

def test_front_round_trip_kill_and_readmit(tmp_path):
    """One real node behind the front: verdicts round-trip; killing
    the node degrades EXPLICITLY (synthesized fail-open verdicts, no
    lost requests); reviving it re-admits via the half-open canary."""
    harnesses, front, _fleet, _ = build_drill_fleet(
        1, tmp_path, device="cpu")
    try:
        violations = []
        _front_wave(front, 16, "warm", violations)
        assert violations == []
        assert front.requests_total >= 16
        assert front.nodes[0].completed >= 16
        assert front.fail_open_front_total == 0

        harnesses[0].kill()
        _front_wave(front, 16, "dark", violations)
        assert violations == []      # exactly one verdict per request
        st = front.status()
        assert st["nodes_up"] == 0
        # every dark-window verdict was the synthesized fail-open one
        assert st["fail_open_front_total"] >= 16
        assert st["all_down_served"] >= 1

        harnesses[0].revive()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if front.nodes[0].state == UP:
                break
            time.sleep(0.1)
        assert front.nodes[0].state == UP
        assert front.nodes[0].readmissions >= 1
        _front_wave(front, 16, "back", violations)
        assert violations == []
        assert front.status()["fail_open_front_total"] \
            == st["fail_open_front_total"]   # no fail-open after revive
    finally:
        front.stop()
        for h in harnesses:
            h.close()


def test_idle_dead_node_is_ejected_by_its_probe(tmp_path):
    """A drill node killed while no request routes to it is ejected by
    the front's readiness probe alone, within a few probe intervals, as
    a SIGKILLed process is: the killed harness answers no probe.  (The
    JAX harness probes the node's in-process ``/readyz``, which a kill
    leaves answering 200, so there only a request that reaches the dead
    node ejects it.)  Reviving it re-admits it through the canary."""
    harnesses, front, _fleet, _ = build_drill_fleet(
        2, tmp_path, device="cpu")
    try:
        violations = []
        _front_wave(front, 8, "warm", violations)
        assert violations == []
        dead = front.nodes[1]
        assert dead.state == UP
        harnesses[1].kill()
        deadline = time.monotonic() + 5 * front.probe_interval_s + 0.5
        while time.monotonic() < deadline and dead.state == UP:
            time.sleep(0.02)
        assert dead.state != UP
        assert dead.forwarded == dead.completed   # no request went there
        harnesses[1].revive()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and dead.state != UP:
            time.sleep(0.05)
        assert dead.state == UP and dead.readmissions >= 1
    finally:
        front.stop()
        for h in harnesses:
            h.close()


def test_http_plane_equals_jax_front():
    """The same node states give the JAX front's /metrics, /readyz and
    /front/nodes bodies byte for byte (uptime pinned)."""
    from ingress_plus_tpu.serve import front as jfront

    ours, (a, b, c) = _front3()
    theirs = jfront.FrontLoop(
        [jfront.BackendNode(name="n%d" % i, socket_path="/tmp/x%d" % i)
         for i in range(3)], "/tmp/unused-front.sock")
    ja, jb, jc = theirs.nodes
    for f in (ours, theirs):
        f.started = 1000.0
        f.requests_total, f.retries_total = 17, 2
    for n in (a, ja):
        n.inflight, n.forwarded, n.completed = 3, 9, 6
    ours.eject(b, "connect_failed")
    theirs.eject(jb, "connect_failed")
    b.next_probe = jb.next_probe = 0.0
    for path in ("/metrics", "/readyz?verbose=1", "/front/nodes"):
        got, want = ours.route_http(path), theirs.route_http(path)
        if path == "/metrics":
            got = (got[0], got[1], b"\n".join(
                ln for ln in got[2].split(b"\n") if b"uptime" not in ln))
            want = (want[0], want[1], b"\n".join(
                ln for ln in want[2].split(b"\n") if b"uptime" not in ln))
        assert got == want, path


def test_front_module_imports_no_torch():
    """The front owns no detection state: importing it (and routing
    ``python -m ingress_plus_tpu_torch.serve --front``) loads neither
    torch nor any kernel module."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.argv = ['serve', '--front', '--help']\n"
            "import ingress_plus_tpu_torch.serve.front\n"
            "try:\n"
            "    import runpy\n"
            "    runpy.run_module('ingress_plus_tpu_torch.serve',"
            " run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.') or m.endswith(('pair_scan', "
            "'step_scan', 'cuda_build'))]\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(repo),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout + out.stderr
    assert "--backend" in out.stdout


# ------------------------------------------------ the drills' race

def _idle_kill_ejected(build, prefix: str, **kw) -> bool:
    """One 2-node drill fleet from ``build``: warm it, kill node n1 while
    no request routes to it, and report whether the front ejects it
    within ten probe intervals."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        harnesses, front, _fleet, _ = build(2, tmp, socket_prefix=prefix,
                                            **kw)
        try:
            _front_wave(front, 8, "warm", [])
            harnesses[1].kill()
            deadline = time.monotonic() + 10 * front.probe_interval_s
            while (time.monotonic() < deadline
                   and front.nodes[1].state == UP):
                time.sleep(0.02)
            return front.nodes[1].state != UP
        finally:
            front.stop()
            for h in harnesses:
                h.close()


def node_kill_rates(runs: int) -> dict:
    """``fleet_node_kill`` ``runs`` times on the JAX package's drill
    harness and on the port's, in one process, and one idle kill on each
    (whose front ejects a killed node that no request reaches?)."""
    import os
    import tempfile

    from ingress_plus_tpu.control.fleetctl import \
        build_drill_fleet as jax_build
    from ingress_plus_tpu.utils.faults import \
        run_fault_matrix as jax_matrix
    from ingress_plus_tpu_torch.utils.faults import run_fault_matrix

    prefix = os.path.join(tempfile.gettempdir(), "ipt-rate")
    out = {"runs": runs}
    for tag, matrix, kw in (("jax", jax_matrix, {}),
                            ("port", run_fault_matrix, {"device": "cpu"})):
        failed = []
        for i in range(runs):
            res = matrix(only=["fleet_node_kill"],
                         **kw)["scenarios"]["fleet_node_kill"]
            if not res["ok"]:
                failed.append((i, res["violations"]))
        out[tag] = {"failed": len(failed), "first_failures": failed[:3]}
    out["idle_kill_ejected"] = {
        "jax": _idle_kill_ejected(jax_build, prefix + "-jax"),
        "port": _idle_kill_ejected(build_drill_fleet, prefix + "-port",
                                   device="cpu")}
    return out


if __name__ == "__main__":
    # python tests/test_torch_front.py [RUNS]: the rates above as JSON
    import sys

    print(json.dumps(node_kill_rates(
        int(sys.argv[1]) if len(sys.argv) > 1 else 30)))
