"""The port's confirm plane against the JAX package's, on the CPU.

Pooled confirm workers, the worker-targeted wedge and the cross-cycle
verdict cache of ``ingress_plus_tpu_torch/models/confirm_plane.py``,
held against ``ingress_plus_tpu/models/confirm_plane.py`` on a seeded
small pack (compiled by the JAX compiler, loaded by both packages from
one checkpoint) and a shuffled corpus with runtime-ctl exclusions and
flood segments.  Tolerance: none — every verdict field and match point
must be equal.
"""

import dataclasses
import random
import time

import pytest

from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.models.confirm_plane import (
    VerdictCache as JaxVerdictCache,
)
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu.utils import faults as jfaults
from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.models.confirm_plane import (
    ConfirmPool,
    VerdictCache,
)
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.batcher import Batcher
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.faults import FaultPlan

RULES = """
SecRule ARGS|REQUEST_BODY "@rx (?i)union\\s+select" "id:942100,phase:2,block,t:urlDecodeUni,t:lowercase,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS|REQUEST_BODY "@rx (?i)<script[^>]*>" "id:941100,phase:2,block,t:urlDecodeUni,t:htmlEntityDecode,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS "@rx /etc/(?:passwd|shadow)" "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@pm sleep( benchmark( xp_cmdshell" "id:942150,phase:2,block,severity:ERROR,tag:'attack-sqli'"
SecRule REQUEST_URI "@beginsWith /internal/" \\
    "id:10001,phase:1,pass,nolog,ctl:ruleRemoveById=942100"
SecRule REQUEST_URI "@beginsWith /profile" \\
    "id:10002,phase:1,pass,nolog,ctl:ruleRemoveTargetById=942100;ARGS:bio"
SecRule REQUEST_URI "@streq /healthz" \\
    "id:10003,phase:1,pass,nolog,ctl:ruleEngine=Off"
"""


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """(JAX CompiledRuleset, port CompiledRuleset) of one checkpoint."""
    jcr = compile_ruleset(parse_seclang(RULES))
    path = tmp_path_factory.mktemp("pack") / "pack"
    jcr.save(str(path))
    return jcr, CompiledRuleset.load(str(path))


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _corpus(n=48, seed=17):
    """Shuffled JAX requests: attacks, ctl paths, a flood, benign forms."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = i % 8
        if kind == 0:
            r = JaxRequest(uri="/p?q=1%27%20UNION%20SELECT%20x%20FROM%20t",
                           request_id="atk-sqli-%d" % i)
        elif kind == 1:
            r = JaxRequest(uri="/x?v=<script>alert(1)</script>",
                           request_id="atk-xss-%d" % i)
        elif kind == 2:
            r = JaxRequest(uri="/internal/p?q=1 union select x",
                           request_id="ctl-rm-%d" % i)
        elif kind == 3:
            r = JaxRequest(uri="/profile?bio=union select creds",
                           request_id="ctl-tgt-%d" % i)
        elif kind == 4:
            r = JaxRequest(uri="/healthz", request_id="ctl-off-%d" % i)
        elif kind == 5:
            r = JaxRequest(uri="/flood?q=1 union select pw from users",
                           request_id="flood-%d" % i)
        else:
            r = JaxRequest(
                uri="/index.html?page=%d" % i,
                headers={"content-type":
                         "application/x-www-form-urlencoded"},
                body=b"user=a&pass=" + bytes(
                    rng.randrange(97, 123)
                    for _ in range(rng.randrange(4, 80))),
                request_id="benign-%d" % i)
        out.append(r)
    rng.shuffle(out)
    return out


def _port(r: JaxRequest) -> Request:
    return Request(**{f.name: getattr(r, f.name)
                      for f in dataclasses.fields(JaxRequest)})


def _vt(v):
    return (v.request_id, v.attack, v.blocked, tuple(v.rule_ids), v.score,
            tuple(v.classes), v.fail_open, v.degraded, v.confirm_worker,
            v.generation,
            tuple((m["rule_id"], m["var"], m["value"]) for m in v.matches))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_nworker_verdicts_equal_serial_and_jax(packs, workers):
    jcr, cr = packs
    jreqs = _corpus()
    treqs = [_port(r) for r in jreqs]
    serial = DetectionPipeline(cr, device="cpu", fail_open=False)
    want = [_vt(v) for v in serial.detect(treqs)]
    tp = DetectionPipeline(cr, device="cpu", fail_open=False,
                           confirm_workers=workers)
    jp = JaxPipeline(jcr, scan_impl="pair", fail_open=False,
                     confirm_workers=workers)
    try:
        got = [_vt(v) for v in tp.detect(treqs)]
        jgot = [_vt(v) for v in jp.detect(jreqs)]
    finally:
        tp.confirm_pool.close()
        jp.confirm_pool.close()
    # the serial walk stamps worker 0; pooled walks stamp qi % N
    strip = [w[:8] + w[9:] for w in want]
    assert [g[:8] + g[9:] for g in got] == strip
    assert got == jgot
    assert tp.stats.confirm_memo_hits == jp.stats.confirm_memo_hits
    assert tp.stats.confirm_memo_hits > 0      # the flood engaged it


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_nworker_batcher_verdicts_equal_serial(packs, workers):
    _, cr = packs
    treqs = [_port(r) for r in _corpus(seed=23)]
    want = {v.request_id: _vt(v)[:8] for v in DetectionPipeline(
        cr, device="cpu", fail_open=False).detect(treqs)}
    b = Batcher(DetectionPipeline(cr, device="cpu",
                                  confirm_workers=workers),
                max_batch=16, max_delay_s=0.001, hard_deadline_s=5.0)
    try:
        futs = [b.submit(r) for r in treqs]
        got = {r.request_id: _vt(f.result(timeout=60))[:8]
               for r, f in zip(treqs, futs)}
    finally:
        b.close()
    assert got == want


def test_wedged_worker_fails_only_its_share_open(packs):
    """slow_confirm pinned to worker 1 of 2 wedges past the pool's hang
    budget: exactly that share fails open, in both packages alike, the
    siblings' verdicts are exact, and the replaced worker serves the
    next batch clean."""
    jcr, cr = packs
    jreqs = _corpus(16, seed=31)
    treqs = [_port(r) for r in jreqs]
    tp = DetectionPipeline(cr, device="cpu", confirm_workers=2,
                           confirm_hang_budget_s=1.0)
    jp = JaxPipeline(jcr, scan_impl="pair", confirm_workers=2,
                     confirm_hang_budget_s=1.0)
    spec = "slow_confirm:worker=1,times=1,delay_s=6.0"
    try:
        want = [_vt(v) for v in tp.detect(treqs)]
        faults.install(FaultPlan.from_spec(spec))
        t0 = time.perf_counter()
        got = tp.detect(treqs)
        assert time.perf_counter() - t0 < 4.0    # bounded by the budget
        faults.clear()
        jfaults.install(jfaults.FaultPlan.from_spec(spec))
        jgot = jp.detect(jreqs)
        jfaults.clear()
        open_ids = [v.request_id for v in got if v.fail_open]
        assert open_ids == [v.request_id for v in jgot if v.fail_open]
        assert open_ids == [r.request_id for r in treqs[1::2]]
        for v, w in zip(got, want):
            if not v.fail_open:
                assert _vt(v) == w
        assert tp.stats.confirm_hangs == 1
        assert tp.confirm_pool.workers_replaced == 1
        assert [_vt(v) for v in tp.detect(treqs)] == want
    finally:
        tp.confirm_pool.close()
        jp.confirm_pool.close()


def test_verdict_cache_unit_parity():
    """The same operation sequence leaves both caches in the same state:
    second-occurrence gate, hits and misses, oldest-first eviction,
    invalidation."""
    ops = []
    rng = random.Random(5)
    for i in range(400):
        key = ("g%d" % (i // 150), rng.randrange(12), b"d%d" % rng.randrange(9))
        ops.append(("see", (key[0], key[2])))
        ops.append(("get", key))
        if rng.random() < 0.6:
            ops.append(("put", key, (bool(rng.randrange(2)), ())))
        if i == 300:
            ops.append(("invalidate",))
    results = []
    for cache in (VerdictCache(cap=16), JaxVerdictCache(cap=16)):
        trace = []
        for op in ops:
            if op[0] == "see":
                trace.append(cache.see(op[1]))
            elif op[0] == "get":
                trace.append(cache.get(op[1]))
            elif op[0] == "put":
                cache.put(op[1], op[2])
            else:
                cache.invalidate("test")
        results.append((trace, cache.snapshot(), len(cache)))
    assert results[0] == results[1]
    assert results[0][1]["evicted"] > 0 and results[0][1]["hits"] > 0


def test_verdict_cache_pipeline_parity(packs):
    """With the cross-cycle cache on, verdicts and cache counters over
    two cycles equal the JAX pipeline's, and equal the uncached ones."""
    jcr, cr = packs
    jreqs = _corpus(32, seed=41)
    treqs = [_port(r) for r in jreqs]
    plain = [_vt(v) for v in DetectionPipeline(cr, device="cpu").detect(
        treqs)]
    tp = DetectionPipeline(cr, device="cpu", confirm_cache_entries=256)
    jp = JaxPipeline(jcr, scan_impl="pair", confirm_cache_entries=256)
    for _ in range(2):
        got = [_vt(v) for v in tp.detect(treqs)]
        assert got == [_vt(v) for v in jp.detect(jreqs)]
        assert got == plain
    snap = tp.confirm_cache.snapshot()
    assert snap == jp.confirm_cache.snapshot()
    assert snap["hits"] > 0
    tp.swap_ruleset(cr)
    jp.swap_ruleset(jcr)
    assert tp.confirm_cache.snapshot() == jp.confirm_cache.snapshot()


def test_pool_inline_vs_workers_lifecycle():
    pool = ConfirmPool(n_workers=1)
    assert pool.inline and pool.snapshot()["workers"] == 1
    pool.close()
    pool = ConfirmPool(n_workers=3, hang_budget_s=1.0)
    try:
        assert not pool.inline
        assert [pool.submit(i, lambda i=i: i * 10).wait(5.0)
                for i in range(3)] == [0, 10, 20]
        pool.replace(1)
        assert pool.workers_replaced == 1
        assert pool.submit(1, lambda: "fresh").wait(5.0) == "fresh"
    finally:
        pool.close()


def test_fault_plan_confirm_worker_targeting():
    plan = FaultPlan.from_spec("slow_confirm:worker=1,times=2")
    try:
        faults.set_current_confirm_worker(0)
        assert plan.fire("slow_confirm") is None
        faults.set_current_confirm_worker(1)
        assert plan.fire("slow_confirm") is not None
        assert plan.fire("slow_confirm") is not None
        assert plan.fire("slow_confirm") is None
        snap = plan.snapshot()
        assert snap["rules"][0]["worker"] == 1
        assert snap["rules"][0]["fired"] == 2
    finally:
        faults.set_current_confirm_worker(None)


def test_confirm_workers_cli_parsing():
    from ingress_plus_tpu_torch.serve.server import _parse_confirm_workers

    assert _parse_confirm_workers("auto") == 0
    assert _parse_confirm_workers("4") == 4
    for bad in ("0", "-2"):
        with pytest.raises(SystemExit):
            _parse_confirm_workers(bad)
