"""The serve plane's own clock in ``--trace-dir``'s profiler trace, and
the engine, confirm and stream counters on ``/metrics``.

Under ``--trace-dir`` the server profiles every thread and, when the
profiler stops, writes the flight recorder's spans into the same
Chrome trace as ``ipt.<event>`` events of category ``user_annotation``
on the profiler's clock (``utils/trace.py merge_flight_spans``), so
``wafbench/devtrace.py`` names each idle gap of the card by the span
the host sat in.  The counters split the engine and confirm stages into
thread CPU time and the engine's wait on the card, and give the stream
lane's feed, wave and finish time; each is booked where the work runs.
All on the CPU.
"""

from __future__ import annotations

import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from ingress_plus_tpu_torch.utils.trace import (
    ANCHOR_LIMIT_US,
    DEFAULT_RING_KB,
    EV_CYCLE,
    EV_ENGINE_SYNC,
    EVENT_NAMES,
    TRACE_RING_KB,
    FlightRecorder,
    _clock_anchor,
    flight,
    merge_flight_spans,
    profiled,
    ring_kb_for,
)
from wafbench import devtrace

REPO = Path(__file__).resolve().parent.parent
#: how far a torch op may stand out of the span it ran in, and the
#: clock anchor out of its bracket, in µs
SLACK_US = 200.0


def _trace(trace_dir: Path) -> dict:
    (path,) = trace_dir.glob("serve-*.json")
    return json.loads(path.read_text())


def _epoch_us(trace: dict, e: dict):
    """``[start, end]`` of an event as ``devtrace.read_window`` reads
    times: ``baseTimeNanoseconds / 1000 + ts`` µs of the Unix epoch."""
    a = trace.get("baseTimeNanoseconds", 0) / 1000.0 + float(e["ts"])
    return a, a + float(e["dur"])


@pytest.fixture
def recorder():
    """The process-wide recorder, on and empty, put back as it was."""
    kb, on = flight.ring_kb, flight.enabled
    flight.configure(ring_kb=1024, enabled=True)
    try:
        yield flight
    finally:
        flight.configure(ring_kb=kb, enabled=on)


def test_a_torch_op_on_an_earlier_thread_lies_in_its_flight_span(
        tmp_path, capsys):
    rec = FlightRecorder(ring_kb=1024)
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(30)
        rec.begin(EV_ENGINE_SYNC, cycle=3)
        torch.ones(192, 192).matmul(torch.ones(192, 192)).sum()
        rec.end(EV_ENGINE_SYNC, cycle=3)
        done.set()

    t = threading.Thread(target=work, name="ipt-device-9")
    t.start()
    time.sleep(0.05)          # the thread runs before the profiler starts
    with profiled(str(tmp_path), recorder=rec):
        go.set()
        assert done.wait(60)
    t.join(10)
    assert not t.is_alive()
    trace = _trace(tmp_path)
    mine = [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("tid") == t.native_id]
    (span,) = [e for e in mine if e["name"] == "ipt.engine_sync"]
    assert span["cat"] == "user_annotation" and span["pid"] == os.getpid()
    assert span["args"]["cycle"] == 3
    ops = [e for e in mine if e["name"] == "aten::matmul"]
    assert ops and all(e["cat"] == "cpu_op" for e in ops)
    s0, s1 = _epoch_us(trace, span)
    for op in ops:
        a, b = _epoch_us(trace, op)
        assert s0 - SLACK_US <= a and b <= s1 + SLACK_US, (span, op)
    # the clock check: the anchor's profiler stamps lie inside its
    # monotonic bracket by the offset the merge used
    err = capsys.readouterr().err
    m = re.search(r"anchor ([0-9.]+) us outside its bracket", err)
    assert m and float(m.group(1)) <= SLACK_US, err
    assert "1 flight spans merged, 0 flight events dropped" in err
    # no merged event lands in a category the device metrics count
    assert not [e for e in trace["traceEvents"]
                if str(e.get("name", "")).startswith("ipt.")
                and e.get("cat") in devtrace.DEVICE_CATS]


def test_b_read_window_names_a_gap_by_the_span_a_host_sleep_sat_in(
        tmp_path, recorder, monkeypatch):
    from ingress_plus_tpu_torch.serve.stream import StreamEngine, StreamState

    eng = StreamEngine(pipeline=None)
    stamps = []

    def slow_finish(st):
        stamps.append(time.time())
        time.sleep(0.3)               # the host works, the card waits
        stamps.append(time.time())

    monkeypatch.setattr(eng, "_finish", slow_finish)
    st = StreamState.__new__(StreamState)
    st.body_len = 4096
    with profiled(str(tmp_path), recorder=recorder):
        eng.finish(st)
    assert eng.stats.finishes == 1 and eng.stats.finish_us >= 300_000
    (path,) = tmp_path.glob("serve-*.json")
    win = devtrace.read_window(path, stamps[0] * 1e6, stamps[1] * 1e6)
    assert win.busy_s == 0.0
    (label, seconds), = win.gaps
    assert label == "ipt.stream_finish"
    assert 0.25 <= seconds <= 0.35


def _counters(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and line[0] != "#" and "{" not in line:
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def test_c_stream_and_engine_counters_are_booked_where_the_work_runs(
        tmp_path):
    from ingress_plus_tpu.analysis.promlint import (
        check_exposition as jax_check,
    )
    from ingress_plus_tpu_torch.analysis.promlint import check_exposition
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    cr = compile_ruleset(parse_seclang(
        'SecRule ARGS|REQUEST_BODY "@rx (?i)union\\s+select" "id:1,'
        'phase:2,block,severity:CRITICAL,tag:\'attack-sqli\'"'))
    b = Batcher(DetectionPipeline(cr, mode="block", device="cpu"),
                max_batch=16)
    rng = random.Random(2**31 + 18)
    n_uploads = 6
    try:
        futs = []
        for i in range(n_uploads):
            h = b.begin_stream(Request(
                method="POST", uri="/upload/%d" % i,
                headers={"content-type":
                         "application/x-www-form-urlencoded"},
                body=b"", request_id="u-%d" % i))
            for _ in range(rng.randint(2, 4)):
                chunk = bytes(rng.choice(b"abcdefgh=&%20+")
                              for _ in range(rng.randint(512, 2048)))
                if rng.random() < 0.3:
                    chunk += b"&q=1%27%20UNION%20SELECT%20x"
                b.feed_chunk(h, chunk)
            futs.append(b.finish_stream(h))
        for i in range(24):
            futs.append(b.submit(Request(
                uri=("/p?q=1%27%20UNION%20SELECT%20x" if i % 3 == 0
                     else "/ok?page=%d" % i),
                headers={}, body=b"", request_id="r-%d" % i)))
        for f in futs:
            f.result(timeout=120)
        text = ServeLoop(b, socket_path=str(tmp_path / "s.sock")
                         )._metrics_text()
    finally:
        b.close()
    assert check_exposition(text) == [] == jax_check(text)
    c = _counters(text)
    assert c["ipt_stream_finishes_total"] == n_uploads
    for name in ("ipt_stream_feed_us_sum", "ipt_stream_wave_us_sum",
                 "ipt_stream_finish_us_sum"):
        assert 0 < c[name] <= c["ipt_batch_us_sum"], name
    assert 0 < c["ipt_engine_cpu_us_sum"] <= c["ipt_engine_us_sum"]
    assert (c["ipt_engine_cpu_us_sum"] + c["ipt_engine_sync_us_sum"]
            <= c["ipt_engine_us_sum"])
    # one inline confirm walk: its CPU time fits in its wall time
    assert 0 < c["ipt_confirm_cpu_us_sum"] <= c["ipt_confirm_us_sum"]


def test_pooled_confirm_shares_book_their_cpu_when_joined():
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.normalize import Request

    cr = compile_ruleset(parse_seclang(
        'SecRule ARGS "@rx (?i)union\\s+select" "id:1,phase:2,block,'
        'severity:CRITICAL,tag:\'attack-sqli\'"'))
    p = DetectionPipeline(cr, mode="block", device="cpu", confirm_workers=2)
    try:
        verdicts = p.detect([Request(
            uri="/p?q=%d%%27%%20UNION%%20SELECT%%20x" % i, headers={},
            body=b"", request_id="r-%d" % i) for i in range(32)])
    finally:
        p.confirm_pool.close()
    assert all(v.blocked for v in verdicts)
    st = p.stats
    assert 0 < st.confirm_cpu_us and 0 < st.confirm_us
    assert 0 < st.engine_cpu_us
    assert st.engine_cpu_us + st.engine_sync_us <= st.engine_us


def test_d_the_trace_ring_keeps_a_closed_loop_burst():
    assert ring_kb_for(None, traced=False) == DEFAULT_RING_KB == 256
    assert ring_kb_for(None, traced=True) == TRACE_RING_KB
    assert ring_kb_for(512, traced=True) == 512
    rec = FlightRecorder(ring_kb=ring_kb_for(None, traced=True))
    # ~150k events on one thread: closed32's dispatch thread for ~100 s
    for i in range(1, 75_001):
        rec.begin(EV_CYCLE, cycle=i)
        rec.end(EV_CYCLE, cycle=i)
    assert rec.dropped() == 0
    assert len(rec.snapshot()["events"]) == 150_000
    small = FlightRecorder(ring_kb=ring_kb_for(None, traced=False))
    for i in range(1, 2_001):
        small.begin(EV_CYCLE, cycle=i)
        small.end(EV_CYCLE, cycle=i)
    assert small.dropped() > 0


def test_the_merge_refuses_spans_a_wrong_clock_would_misplace(tmp_path):
    rec = FlightRecorder(ring_kb=64)
    rec.begin(EV_ENGINE_SYNC, cycle=1)
    rec.end(EV_ENGINE_SYNC, cycle=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
        m0, m1, offset_ns = _clock_anchor(torch)
    path = tmp_path / "serve-1.json"
    prof.export_chrome_trace(str(path))
    before = path.read_bytes()
    # an offset 1 ms off puts the anchor outside its bracket: no span
    # is written, and the file stays as the profiler wrote it
    info = merge_flight_spans(str(path), rec, (m0, m1, offset_ns + 10**6))
    assert info["anchor_error_us"] > ANCHOR_LIMIT_US
    assert "outside its bracket" in info["refused"] and info["spans"] == 0
    assert path.read_bytes() == before
    info = merge_flight_spans(str(path), rec, (m0, m1, offset_ns))
    assert info["refused"] is None and info["spans"] == 1
    assert info["anchor_error_us"] <= ANCHOR_LIMIT_US
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]]
    assert names.count("ipt.engine_sync") == 1


def test_new_span_codes_have_names():
    names = {EVENT_NAMES[c] for c in range(18, 22)}
    assert names == {"stream_feed", "stream_wave", "stream_finish",
                     "engine_sync"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> bytes:
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=10) as r:
        return r.read()


def test_e_a_traced_server_merges_its_spans_and_sees_the_lane_worker(
        tmp_path):
    from ingress_plus_tpu_torch.serve.client import drive
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.protocol import encode_request

    trace_dir = tmp_path / "trace"
    port = _free_port()
    sock = str(tmp_path / "s.sock")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    log_path = tmp_path / "serve.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ingress_plus_tpu_torch.serve",
             "--socket", sock, "--http-port", str(port), "--platform",
             "cpu", "--scan-impl", "pair", "--no-warmup",
             "--hard-deadline-ms", "30000", "--trace-dir", str(trace_dir)],
            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 240
            while True:
                assert proc.poll() is None, log_path.read_text()
                assert time.time() < deadline, log_path.read_text()
                try:
                    _get(port, "/readyz")
                    break
                except OSError:
                    time.sleep(0.2)
            units = [(i + 1, [encode_request(Request(
                uri="/q?id=%d&x=1%%27%%20UNION%%20SELECT" % i, headers={},
                body=b"", request_id="t-%d" % i), i + 1)])
                for i in range(12)]
            out = drive(sock, units, 2, 4, timeout=120)
            assert len(out) == len(units)
            dbg = json.loads(_get(port, "/debug/trace"))
            assert dbg["otherData"]["ring_kb"] == TRACE_RING_KB
            metrics = _counters(_get(port, "/metrics").decode())
            assert 0 < metrics["ipt_engine_cpu_us_sum"] <= \
                metrics["ipt_engine_us_sum"]
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    m = re.search(r"(\d+) flight spans merged, (\d+) flight events "
                  r"dropped", text)
    assert m and int(m.group(1)) > 0 and m.group(2) == "0", text[-3000:]
    trace = _trace(trace_dir)
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("ipt.")]
    names = {e["name"] for e in spans}
    assert {"ipt.cycle", "ipt.device_busy", "ipt.confirm_share"} <= names
    # the lane worker started before the profiler; its torch ops are in
    # the trace, inside the device_busy spans it recorded
    busy = [e for e in spans if e["name"] == "ipt.device_busy"]
    lane = {e["tid"] for e in busy}
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e.get("tid") in lane]
    assert ops
    inside = 0
    for op in ops:
        a, b = _epoch_us(trace, op)
        inside += any(s0 - SLACK_US <= a and b <= s1 + SLACK_US
                      for s0, s1 in (_epoch_us(trace, s) for s in busy))
    assert inside > 0
