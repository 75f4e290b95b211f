"""The port's UDS serve loop against the JAX package's, on the CPU.

Both ``ServeLoop``s run in-process on temporary unix sockets, each over
its own package's ``Batcher`` on the committed bundled pack (the port on
``device="cpu"``, the JAX one with ``scan_impl="pair"``).  The same
frames — requests in every mode, response scans, chunked bodies and a
WebSocket exchange — go to both; every response frame must be the same
bytes.  Also: the two packages' encoders give equal bytes, ``/healthz``
reports the CPU backend, ``/configuration/ruleset`` swaps one-shot and
answers 409 to ``?mode=staged``, and ``python -m
ingress_plus_tpu_torch.serve`` without ``--platform cpu`` refuses to
start on a host with no card.
"""

import asyncio
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve import normalize as jnorm
from ingress_plus_tpu.serve import protocol as jproto
from ingress_plus_tpu.serve.batcher import Batcher as JaxBatcher
from ingress_plus_tpu.serve.server import ServeLoop as JaxServeLoop
from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve import normalize as tnorm
from ingress_plus_tpu_torch.serve import protocol as tproto
from ingress_plus_tpu_torch.serve.batcher import Batcher
from ingress_plus_tpu_torch.serve.server import ServeLoop
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

REPO = Path(__file__).resolve().parents[1]
SEED = 20260729
SQLI = b"1' UNION SELECT password FROM users--"
LEAK = (b"You have an error in your SQL syntax; check the manual that "
        b"corresponds to your MySQL server version")


def ws_frame(payload: bytes, opcode: int = 0x1, fin: bool = True,
             mask: bytes = b"") -> bytes:
    """One RFC 6455 frame (client frames masked)."""
    n = len(payload)
    head = bytearray([(0x80 if fin else 0) | opcode])
    m = 0x80 if mask else 0
    if n < 126:
        head.append(m | n)
    elif n < 1 << 16:
        head.append(m | 126)
        head += n.to_bytes(2, "big")
    else:
        head.append(m | 127)
        head += n.to_bytes(8, "big")
    if mask:
        head += mask
        payload = bytes(c ^ mask[i & 3] for i, c in enumerate(payload))
    return bytes(head) + payload


class _Running:
    """A ServeLoop on its own event-loop thread (no HTTP listener)."""

    def __init__(self, serve):
        self.serve = serve
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(serve.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30)

    def stop(self):
        for s in self.serve._servers:
            self.loop.call_soon_threadsafe(s.close)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.serve.batcher.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    kw = dict(max_batch=32, max_delay_s=0.002, hard_deadline_s=30.0)
    tb = Batcher(DetectionPipeline(load_pack(), device="cpu"), **kw)
    jb = JaxBatcher(JaxPipeline(JaxRuleset.load(BUNDLED_PACK),
                                scan_impl="pair"), **kw)
    port = _Running(ServeLoop(tb, str(tmp / "port.sock")))
    ref = _Running(JaxServeLoop(jb, str(tmp / "jax.sock")))
    yield port, ref
    port.stop()
    ref.stop()


def _frames(proto, norm):
    """(frames in send order, req_ids that expect a response)."""
    frames, ids = [], []
    reqs = [lr.request for lr in jax_corpus(n=40, seed=SEED, tenants=2)]
    modes = [2, 2, 1, 3, 0]
    for i, jr in enumerate(reqs):
        r = norm.Request(**{f.name: getattr(jr, f.name)
                            for f in dataclasses.fields(jnorm.Request)})
        r.greylisted = i % 7 == 3
        frames.append(proto.encode_request(r, 100 + i, mode=modes[i % 5]))
        ids.append(100 + i)
    for i, (status, body) in enumerate([(500, LEAK), (200, b"<html>ok")]):
        resp = norm.Response(status=status, request_id="",
                             headers={"content-type": "text/html"},
                             body=body)
        frames.append(proto.encode_response_scan(resp, 300 + i))
        ids.append(300 + i)
    # chunked bodies: the attack split across chunk frames; one stream
    # in mode off; one stream whose inline first chunk is empty
    body = b"comment=" + b"hello+world+" * 600 + b"&q=" + SQLI
    for sid, mode, first in ((400, 2, 100), (401, 0, 10), (402, 1, 0)):
        meta = norm.Request(method="POST", uri="/upload",
                            headers={"content-type":
                                     "application/x-www-form-urlencoded"},
                            body=body[:first])
        frames.append(proto.encode_request(meta, sid,
                                           mode=mode | proto.MODE_STREAM))
        cuts = list(range(first, len(body), 2500)) + [len(body)]
        for a, c in zip(cuts, cuts[1:]):
            frames.append(proto.encode_chunk(sid, body[a:c],
                                             last=c == len(body)))
        ids.append(sid)
    # a WebSocket exchange: benign text, an attack fragmented over two
    # capture frames, a server→client leak, then the close
    msg = ws_frame(b"hello there", mask=b"abcd")
    atk = ws_frame(b"q=" + SQLI, mask=b"wxyz")
    leak = ws_frame(LEAK)
    caps = [(500, msg, {}), (501, atk[:7], {}), (502, atk[7:], {}),
            (503, leak, {"s2c": True}), (504, b"", {"end": True})]
    for rid, data, kw in caps:
        frames.append(proto.encode_ws(rid, 77, data, tenant=1, mode=2, **kw))
        ids.append(rid)
    return frames, ids


def _exchange(path, frames, ids, timeout=120):
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(timeout)
    s.connect(path)
    try:
        s.sendall(b"".join(frames))
        reader = tproto.MultiFrameReader({tproto.RESP_MAGIC: "resp"})
        got = {}
        while set(got) != set(ids):
            data = s.recv(1 << 16)
            assert data, "server closed the connection"
            for _k, payload in reader.feed(data):
                got[tproto.decode_response(payload)["req_id"]] = payload
        return got
    finally:
        s.close()


def test_encoders_give_equal_bytes():
    tframes, tids = _frames(tproto, tnorm)
    jframes, jids = _frames(jproto, jnorm)
    assert tids == jids
    assert tframes == jframes
    for args in [(7, True, False, False, 12, [3, 8], [942100, 941100]),
                 (2 ** 40, False, False, True, 0, [], [])]:
        assert (tproto.encode_response(*args)
                == jproto.encode_response(*args))


def test_response_frames_equal_jax(servers):
    port, ref = servers
    frames, ids = _frames(tproto, tnorm)
    got = _exchange(port.serve.socket_path, frames, ids)
    want = _exchange(ref.serve.socket_path, frames, ids)
    assert got == want
    decoded = {k: tproto.decode_response(v) for k, v in got.items()}
    assert decoded[400]["attack"] and decoded[400]["blocked"]
    assert decoded[402]["attack"] and not decoded[402]["blocked"]
    assert not decoded[401]["attack"]
    assert decoded[300]["attack"] and not decoded[301]["attack"]
    assert decoded[502]["attack"] and not decoded[500]["attack"]
    assert not any(d["fail_open"] for d in decoded.values())


def test_healthz_reports_cpu_backend(servers):
    port, _ = servers
    status, _ctype, body = port.serve.http_get("/healthz")
    assert status.startswith("200")
    rob = json.loads(body)["robustness"]
    assert rob["device_path"]["backend"] == "cpu"
    assert rob["device_path"]["scan_impl"] == "pair"
    assert rob["breaker"]["state"] == "closed"
    status, _ctype, body = port.serve.http_get("/readyz")
    assert status.startswith("200") and json.loads(body)["ready"]
    status, _ctype, body = port.serve.http_get("/metrics")
    assert "ipt_engine_recompiles_total" in body.decode()
    status, _ctype, body = port.serve.http_get("/wallarm-status")
    assert json.loads(body) == {"postanalytics": "disabled"}


def test_debug_kernels_reports_launch_shapes(servers):
    """``/debug/kernels``: both kernels, no launch on the CPU; and the
    per-shape tally it serves counts launches, and the work of those
    whose lengths came from the host (clamped to [0, L])."""
    from ingress_plus_tpu_torch.ops.cuda_build import ScanKernel

    port, _ = servers
    status, _ctype, body = port.serve.http_get("/debug/kernels")
    assert status.startswith("200")
    assert json.loads(body) == {"pair_scan": {"launches": 0, "shapes": []},
                                "step_scan": {"launches": 0, "shapes": []}}
    k = ScanKernel("step_scan", class_ids=False)
    k._tally(4, 64, True, torch.tensor([0, 3, 64, 99], dtype=torch.int32))
    k._tally(4, 64, True, None)
    k._tally(4, 64, True, torch.tensor([-2, 1, 1, 2], dtype=torch.int32))
    k._tally(8, 2048, False, torch.arange(8, dtype=torch.int32))
    assert k.shape_snapshot() == [
        {"B": 4, "L": 64, "carried": True, "launches": 3, "known": 2,
         "steps": 3 + 64 + 64 + 1 + 1 + 2, "odd_rows": 3,
         "lengths": [0, 1, 1, 2]},
        {"B": 8, "L": 2048, "carried": False, "launches": 1, "known": 1,
         "steps": 28, "odd_rows": 4, "lengths": list(range(8))}]


RULES = """
SecRule REQUEST_URI|ARGS "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
"""


def test_configuration_ruleset_swap_and_staged_409(tmp_path):
    """One-shot swap from a checkpoint path (force, the only semantics
    without a rollout controller), 409 for an explicit staged request,
    a structured 4xx for an unloadable checkpoint — the JAX server's
    statuses without a controller."""
    ckpt = str(tmp_path / "tiny")
    compile_ruleset(parse_seclang(RULES)).save(ckpt)
    tb = Batcher(DetectionPipeline(load_pack(), device="cpu"),
                 max_batch=8, hard_deadline_s=30.0)
    jb = JaxBatcher(JaxPipeline(JaxRuleset.load(BUNDLED_PACK),
                                scan_impl="pair"),
                    max_batch=8, hard_deadline_s=30.0)
    loops = (ServeLoop(tb, str(tmp_path / "a.sock")),
             JaxServeLoop(jb, str(tmp_path / "b.sock")))
    try:
        out = []
        for serve in loops:
            res = [asyncio.run(serve._route_http(
                "POST", path, json.dumps(body).encode()))
                for path, body in (
                    ("/configuration/ruleset?mode=staged", {"path": ckpt}),
                    ("/configuration/ruleset", {"path": ckpt + "-none"}),
                    ("/configuration/ruleset", {"path": ckpt}))]
            out.append([(s, json.loads(b)) for s, _c, b in res])
        assert [s for s, _ in out[0]] == [s for s, _ in out[1]]
        assert out[0][0][0].startswith("409")
        assert out[0][1][0].startswith("400")
        assert out[0][1][1]["rejected"] and out[0][1][1]["stage"] == "load"
        assert out[0][2] == out[1][2]
        assert out[0][2][1]["mode"] == "force"
        assert tb.pipeline.ruleset.n_rules == 1
        v = tb.submit(tnorm.Request(uri="/q?a=1+union+select+2",
                                    request_id="s")).result(timeout=30)
        assert v.blocked and v.rule_ids == [942100]
    finally:
        tb.close()
        jb.close()


def test_serve_without_platform_refuses_to_start_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform works")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
         "--socket", str(tmp_path / "x.sock"), "--http-port", "0",
         "--no-warmup"],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "x.sock").exists()
