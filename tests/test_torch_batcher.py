"""The port's ``Batcher`` against the JAX package's, on the CPU.

Both batchers serve the committed bundled pack (the port on
``device="cpu"``, the JAX one with ``scan_impl="pair"``): the same seeded
corpus through one lane and through two, every body kind of
``utils/stream_corpus.py`` through the stream API, an oversized body
through the reroute to the stream lane, and the tenant-fair queue's
drain order.  Tolerance: none — every verdict field must be equal.
"""

import dataclasses
import queue as queue_mod
import random

import pytest

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve import normalize as jnorm
from ingress_plus_tpu.serve.batcher import Batcher as JaxBatcher
from ingress_plus_tpu.serve.batcher import _TenantFairQueue as JaxFairQueue
from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve import normalize as tnorm
from ingress_plus_tpu_torch.serve.batcher import (
    Batcher,
    TenantFull,
    _TenantFairQueue,
)
from ingress_plus_tpu_torch.utils.stream_corpus import stream_cases
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

SEED = 20260729
BODY, CHUNK = 4000, 1000


@pytest.fixture(scope="module")
def packs():
    return JaxRuleset.load(BUNDLED_PACK), load_pack()


def _port(r):
    cls = tnorm.Response if isinstance(r, jnorm.Response) else tnorm.Request
    return cls(**{f.name: getattr(r, f.name)
                  for f in dataclasses.fields(type(r))})


def _jax(m):
    cls = jnorm.Response if isinstance(m, tnorm.Response) else jnorm.Request
    return cls(**{f.name: getattr(m, f.name)
                  for f in dataclasses.fields(cls)})


def _vt(v):
    return (v.request_id, v.attack, v.blocked, tuple(sorted(v.rule_ids)),
            v.score, tuple(v.classes), v.fail_open, v.degraded, v.generation,
            tuple((m["rule_id"], m["var"], m["value"]) for m in v.matches))


def _pair(packs, n_lanes=1, **kw):
    jcr, cr = packs
    kw.setdefault("max_batch", 32)
    kw.setdefault("max_delay_s", 0.002)
    kw.setdefault("hard_deadline_s", 30.0)
    tb = Batcher(DetectionPipeline(cr, device="cpu"), n_lanes=n_lanes, **kw)
    jb = JaxBatcher(JaxPipeline(jcr, scan_impl="pair"), n_lanes=n_lanes,
                    **kw)
    return tb, jb


def _serve(b, reqs):
    futs = [b.submit(r) for r in reqs]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("n_lanes", [1, 2])
def test_batcher_verdicts_equal_jax(packs, n_lanes):
    jreqs = [lr.request for lr in jax_corpus(n=96, seed=SEED, tenants=2)]
    treqs = [_port(r) for r in jreqs]
    tb, jb = _pair(packs, n_lanes=n_lanes)
    try:
        got = [_vt(v) for v in _serve(tb, treqs)]
        want = [_vt(v) for v in _serve(jb, jreqs)]
        assert got == want
        assert sum(g[1] for g in got) > 0
        assert not any(g[6] for g in got)
        assert tb.lanes.n == n_lanes
        assert sum(ln.stats.requests for ln in tb.lanes.lanes) == len(treqs)
        if n_lanes > 1:
            assert all(ln.stats.requests for ln in tb.lanes.lanes)
        snap = tb.device_path_snapshot()
        assert snap["backend"] == "cpu"
        assert snap["lane_devices"] == ["cpu"] * n_lanes
    finally:
        tb.close()
        jb.close()


def test_breaker_render_names_each_lanes_device(packs):
    """``dbg breaker`` over a three-lane port batcher's ``/healthz``: one
    row a lane, each naming the port's device (``cpu``, where the JAX
    package names its runtime's ``TFRT_CPU``), and the JAX renderer
    gives the same text from the same body."""
    import asyncio
    import json

    from ingress_plus_tpu.control.dbg import render_breaker as jax_render
    from ingress_plus_tpu_torch.control.dbg import render_breaker
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    tb = Batcher(DetectionPipeline(packs[1], device="cpu"), n_lanes=3,
                 max_batch=8)
    try:
        _serve(tb, [_port(lr.request)
                    for lr in jax_corpus(n=24, seed=SEED, tenants=1)])
        serve = ServeLoop(tb, "/tmp/unused-port-lanes.sock")
        status, _ctype, body = asyncio.run(
            serve._route_http("GET", "/healthz", b""))
        assert status.startswith("200")
        health = json.loads(body)
        lanes = health["robustness"]["lanes"]
        assert [(ln["lane"], ln["device"]) for ln in lanes] == \
            [(0, "cpu"), (1, "cpu"), (2, "cpu")]
        out = render_breaker(health)
        rows = out.split("lanes:\n", 1)[1].splitlines()[1:]
        assert [r.split()[:2] for r in rows] == \
            [["0", "cpu"], ["1", "cpu"], ["2", "cpu"]]
        assert out == jax_render(health)
    finally:
        tb.close()


def _drive_stream_api(b, metas, cases):
    handles = [b.begin_stream(m) for m in metas]
    for off in range(0, max(len(c.body) for c in cases), CHUNK):
        for h, c in zip(handles, cases):
            if off < len(c.body):
                b.feed_chunk(h, c.body[off:off + CHUNK])
    futs = [b.finish_stream(h) for h in handles]
    return [f.result(timeout=120) for f in futs]


def test_stream_api_round_trip_equals_jax(packs):
    """begin_stream / feed_chunk / finish_stream on every body kind,
    interleaved chunk by chunk, through both batchers' dispatch loops."""
    cases = stream_cases(BODY, CHUNK, SEED)
    tb, jb = _pair(packs)
    try:
        got = _drive_stream_api(tb, [c.meta for c in cases], cases)
        want = _drive_stream_api(jb, [_jax(c.meta) for c in cases], cases)
    finally:
        tb.close()
        jb.close()
    assert [_vt(v) for v in got] == [_vt(v) for v in want]
    assert [v.attack for v in got] == [c.attack for c in cases]
    assert not any(v.fail_open for v in got)
    assert tb.stats.streams == len(cases)


def test_oversized_body_rerouted_not_truncated(packs):
    """A non-streamed body past the last L tier goes through the stream
    lane whole: the attack planted after 16 KB is found, as the JAX
    batcher finds it, where the batched path alone would cut it off."""
    jreq = jnorm.Request(
        method="POST", uri="/upload", request_id="big",
        headers={"host": "a.example",
                 "content-type": "application/x-www-form-urlencoded"},
        body=b"note=" + b"lorem+ipsum+" * 2000
        + b"&q=1'+UNION+SELECT+password+FROM+users--")
    assert len(jreq.body) > DetectionPipeline.L_BUCKETS[-1]
    treq = _port(jreq)
    tb, jb = _pair(packs)
    try:
        got = _serve(tb, [treq])[0]
        want = _serve(jb, [jreq])[0]
    finally:
        tb.close()
        jb.close()
    assert _vt(got) == _vt(want)
    assert got.attack and got.blocked and not got.fail_open
    assert tb.stats.oversized_rerouted == 1
    truncated = DetectionPipeline(packs[1], device="cpu")
    cut = truncated.detect([treq])[0]
    assert truncated.stats.truncated_rows > 0
    assert 942100 not in cut.rule_ids and 942100 in got.rule_ids


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait()[2])
        except queue_mod.Empty:
            return out


def test_fair_queue_drain_order_equals_jax():
    """Byte-weighted deficit round robin with tenant weights: the same
    puts drain in the same order from both queues, and a 10x flood does
    not starve the small tenant."""
    rng = random.Random(3)
    puts = [(rng.choice([1, 1, 1, 1, 2, 3]), i,
             rng.choice([0, 0, 100, 16384, 40000])) for i in range(300)]
    orders = []
    for cls in (_TenantFairQueue, JaxFairQueue):
        q = cls(1000, weights={3: 2.5})
        for tenant, i, cost in puts:
            q.put_nowait(("req", 0.0, (tenant, i), None), tenant=tenant,
                         cost_bytes=cost)
        assert q.seen_multi
        orders.append(_drain(q))
    assert orders[0] == orders[1]
    assert len(orders[0]) == len(puts)
    first = [t for t, _ in orders[0][:30]]
    assert first.count(2) >= 5 and first.count(3) >= 5


def test_fair_queue_caps_and_single_tenant_fifo():
    q = _TenantFairQueue(8, tenant_cap=3)
    for i in range(3):
        q.put_nowait(("req", 0.0, i, None), tenant=1)
    with pytest.raises(TenantFull):
        q.put_nowait(("req", 0.0, 3, None), tenant=1)
    for i in range(5):
        q.put_nowait(("req", 0.0, 10 + i, None), tenant=2 + i % 3)
    with pytest.raises(queue_mod.Full):
        q.put_nowait(("req", 0.0, 99, None), tenant=9)
    assert q.qsize() == 8 and q.effective_depth(1) > 3
    solo = _TenantFairQueue(100)
    for i in range(10):
        solo.put_nowait(("req", 0.0, i, None), tenant=0, cost_bytes=i * 999)
    assert _drain(solo) == list(range(10))
    assert not solo.seen_multi and not solo._qs and not solo._deficit
