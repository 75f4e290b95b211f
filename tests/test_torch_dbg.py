"""The port's ``dbg`` (``control/dbg.py``), held to the JAX package's.

A port ``ServeLoop`` on a CPU pipeline serves a little multi-tenant
traffic; every renderer gets the JSON (or exposition) of the endpoint
``dbg`` reads and must give the JAX renderer's text on it, and every
subcommand runs through ``main`` against the server's HTTP port.
"""

import asyncio
import contextlib
import io
import json
import socket
import threading

import pytest

from ingress_plus_tpu_torch.control import dbg

_RULES = (
    'SecRule ARGS "@rx (?i)union\\s+select" "id:942100,phase:2,block,'
    'severity:CRITICAL,tag:\'attack-sqli\'"\n'
    'SecRule ARGS "@rx <script" "id:941100,phase:2,block,'
    'severity:CRITICAL,tag:\'attack-xss\'"\n')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """(ServeLoop, "host:port") after 96 requests over 40 tenants."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.control.rollout import (
        RolloutConfig,
        RolloutController,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    cr = compile_ruleset(parse_seclang(_RULES))
    b = Batcher(DetectionPipeline(cr, mode="monitoring", device="cpu"),
                max_batch=16)
    b.rollout = RolloutController(b, RolloutConfig())
    futs = []
    for i in range(96):
        uri = ("/p?q=1%27%20UNION%20SELECT%20x" if i % 3 == 0 else
               "/c?m=%3Cscript%3E" if i % 3 == 1 else "/ok?page=%d" % i)
        futs.append(b.submit(Request(uri=uri, headers={"host": "a"},
                                     body=b"", request_id="r%d" % i,
                                     tenant=i % 40)))
    for f in futs:
        f.result(timeout=60)
    port = _free_port()
    serve = ServeLoop(b, socket_path=str(
        tmp_path_factory.mktemp("dbg") / "s.sock"), http_port=port)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def _run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(serve.start())
        started.set()
        loop.run_forever()

    th = threading.Thread(target=_run, daemon=True)
    th.start()
    assert started.wait(30)
    try:
        yield serve, "127.0.0.1:%d" % port
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)
        for s in serve._servers:
            s.close()
        b.close()


def _get(server, path):
    return dbg._call(server[1], path)


def _json(server, path):
    return json.loads(_get(server, path))


#: renderer → the endpoints whose bodies it takes, in order
_VIEWS = {
    "render_rules": ("/rules/stats?n=64", "/rules/health"),
    "render_drift": ("/rules/drift",),
    "render_breaker": ("/healthz",),
    "render_tenants": ("/tenants",),
    "render_faults": ("/faults",),
    "render_rollout": ("/rollout",),
    "render_scoring": ("/scoring",),
    "render_timeline": ("/debug/trace?cycles=6",),
    "render_latency": ("/metrics", "/debug/slow"),
}


@pytest.mark.parametrize("name", sorted(_VIEWS))
def test_renderer_equals_the_jax_packages(server, name):
    from ingress_plus_tpu.control import dbg as jax_dbg

    args = [_get(server, p) if p == "/metrics" else _json(server, p)
            for p in _VIEWS[name]]
    got = getattr(dbg, name)(*args)
    assert got == getattr(jax_dbg, name)(*args)
    assert got.strip()


@pytest.mark.parametrize("cmd", ["conf", "health", "metrics", "latency",
                                 "tenants", "rules", "drift", "breaker",
                                 "faults", "rollout", "scoring",
                                 "timeline"])
def test_subcommand_against_a_port_server(server, cmd):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dbg.main([cmd, "--server", server[1]])
    assert rc == 0
    assert out.getvalue().strip()


def test_subcommand_error_exits_one(capsys):
    assert dbg.main(["health", "--server",
                     "127.0.0.1:%d" % _free_port()]) == 1
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["rulecheck", "evadecheck", "concheck"])
def test_analyzer_subcommands_exit_zero(cmd, capsys):
    assert dbg.main([cmd]) == 0
    assert capsys.readouterr().out.startswith(cmd + ":")


def test_fleetctl_view_equals_the_jax_packages(tmp_path, capsys):
    from ingress_plus_tpu.control import dbg as jax_dbg
    from ingress_plus_tpu_torch.control.fleetctl import FLEET_JOURNAL
    from ingress_plus_tpu_torch.control.retuned import JOURNAL_NAME

    outs = []
    for lkg in (tmp_path / "empty", tmp_path / "full"):
        lkg.mkdir()
        if lkg.name == "full":
            (lkg / FLEET_JOURNAL).write_text(json.dumps({
                "version": "v2", "state": "rolled_back", "step": 1,
                "nodes": {"n0": "v2", "n1": "v1"},
                "reason": "fleet diff: new_block 3 > 2"}))
            (lkg / JOURNAL_NAME).write_text("\n".join(json.dumps(
                {"ts": 1.0 + i, "decision": "skip:no_drift"})
                for i in range(14)) + "\nnot json\n")
        for main in (dbg.main, jax_dbg.main):
            assert main(["fleetctl", "--lkg-dir", str(lkg)]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert outs[0] != outs[2]
