"""The port's fail-safe serve plane against the JAX package's, on the CPU.

The brownout ladder (``LoadController``), the per-lane
``CircuitBreaker``, bounded admission and deadline shedding, the
prefilter-only rung, the breaker-open CPU-only path and a
``dispatch_hang`` fault through the port's ``Batcher``.  Where both
packages take the same inputs (observation sequences, requests on one
seeded pack), their outputs must be equal; the rest pins the port's own
contract.
"""

import dataclasses
import time

import pytest

from ingress_plus_tpu.compiler.ruleset import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.models.pipeline import LoadController as JaxLoad
from ingress_plus_tpu.serve.lanes import CircuitBreaker as JaxBreaker
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.models.pipeline import (
    DetectionPipeline,
    LoadController,
)
from ingress_plus_tpu_torch.serve.batcher import Batcher
from ingress_plus_tpu_torch.serve.lanes import CircuitBreaker
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.faults import FaultPlan

RULES = """
SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" \
    "id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-sqli'"
SecRule REQUEST_URI|ARGS "@rx (?i)<script" \
    "id:941100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS "@rx (?i)union\\s+all" \
    "id:942190,phase:2,block,t:urlDecodeUni,severity:WARNING,tag:'attack-sqli'"
"""
ATTACK_URI = "/q?a=1+union+select+2"


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    jcr = compile_ruleset(parse_seclang(RULES))
    path = tmp_path_factory.mktemp("pack") / "pack"
    jcr.save(str(path))
    return jcr, CompiledRuleset.load(str(path))


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    yield
    faults.clear()


def _requests():
    reqs = [JaxRequest(uri=ATTACK_URI, request_id="a"),
            JaxRequest(uri="/q?a=<script>alert(1)</script>", request_id="x"),
            JaxRequest(uri="/q?a=union+all+select", request_id="u"),
            JaxRequest(uri="/benign?x=1", request_id="b"),
            JaxRequest(method="POST", uri="/f", request_id="p",
                       headers={"content-type":
                                "application/x-www-form-urlencoded"},
                       body=b"q=1 UNION SELECT pw&t=union all")]
    return reqs, [Request(**{f.name: getattr(r, f.name)
                             for f in dataclasses.fields(JaxRequest)})
                  for r in reqs]


def _vt(v):
    return (v.request_id, v.attack, v.blocked, tuple(v.rule_ids), v.score,
            tuple(v.classes), v.fail_open, v.degraded)


def _mk_batcher(cr, **kw):
    kw.setdefault("max_batch", 16)
    kw.setdefault("max_delay_s", 0.001)
    b = Batcher(DetectionPipeline(cr, mode="block", device="cpu"), **kw)
    warm = [Request(uri="/w%d" % i, request_id="w%d" % i)
            for i in range(kw["max_batch"])]
    b.pipeline.detect(warm)
    return b


def test_load_controller_levels_equal_jax():
    """One observation sequence (climb, hold, dwell, spike clamp) gives
    the same level after every step in both packages."""
    t = 1000.0
    seq = [(50, 0.0), (150, 0.01), (50, 0.2), (150, 0.3), (150, 0.7),
           (150, 0.9), (250, 1.0), (250, 1.5), (10, 2.0), (10, 4.0),
           (10, 5.0), (10, 7.0), (10_000_000, 7.1), (80, 7.2),
           (10_000_000, 7.3), (10_000_000, 8.0), (0, 9.0), (0, 12.0)]
    for kw in (dict(up_us=(100.0, 200.0), down_factor=0.5, dwell_s=2.0,
                    alpha=1.0, up_confirm_s=0.5),
               dict(up_us=(100.0, 200.0), alpha=0.2),
               dict()):
        port, ref = LoadController(**kw), JaxLoad(**kw)
        if not kw:
            port.configure_deadline(0.25)
            ref.configure_deadline(0.25)
        got = [port.observe(v, now=t + dt) for v, dt in seq]
        want = [ref.observe(v, now=t + dt) for v, dt in seq]
        assert got == want
        assert port.snapshot() == ref.snapshot()
    assert max(got) >= 0


def test_circuit_breaker_transitions_equal_jax():
    """closed → open on errors, half-open canary after the cooldown,
    re-open on a failed canary, closed on a good one, immediate trip on
    a hang — the same route and snapshot after every step."""
    brks = [CircuitBreaker(failure_threshold=2, cooldown_s=0.15),
            JaxBreaker(failure_threshold=2, cooldown_s=0.15)]

    def step(fn):
        out = [fn(b) for b in brks]
        snaps = [b.snapshot() for b in brks]
        assert out[0] == out[1] and snaps[0] == snaps[1]
        return out[0], snaps[0]

    assert step(lambda b: b.route())[0] == "device"
    step(lambda b: b.record_failure())
    assert step(lambda b: b.state)[0] == "closed"
    step(lambda b: b.record_failure())
    assert step(lambda b: b.route())[0] == "fallback"
    time.sleep(0.2)
    assert step(lambda b: b.route())[0] == "canary"
    step(lambda b: b.record_failure())
    assert step(lambda b: b.state)[0] == "open"
    time.sleep(0.2)
    assert step(lambda b: b.route())[0] == "canary"
    step(lambda b: b.record_success())
    _, snap = step(lambda b: b.state)
    assert snap["state"] == "closed" and snap["closes"] == 1
    step(lambda b: b.trip("hang"))
    _, snap = step(lambda b: b.state)
    assert snap["trips"] == 3 and snap["last_trip_reason"] == "hang"


def test_bounded_admission_sheds_fail_open(packs):
    """Queue cap reached → requests shed fail-open at enqueue; every
    future resolves, none blocks."""
    b = _mk_batcher(packs[1], queue_cap=8, hard_deadline_s=0.5)
    faults.install(FaultPlan.from_spec("slow_confirm:times=50,delay_s=0.05"))
    try:
        futs = [b.submit(Request(uri="/x?i=%d" % i, request_id=str(i)))
                for i in range(200)]
        vs = [f.result(timeout=60) for f in futs]
        assert len(vs) == 200 and not any(v.blocked for v in vs)
        shed = dict(b.pipeline.stats.shed)
        assert shed.get("queue_full", 0) + shed.get("deadline", 0) > 0
        assert sum(1 for v in vs if v.fail_open) >= sum(shed.values())
    finally:
        b.close()


def test_deadline_shed_by_queue_math(packs):
    """Queue math predicts a deadline miss → shed at enqueue
    (reason="deadline"); close() drains the admitted one fail-open."""
    b = _mk_batcher(packs[1], queue_cap=1024, hard_deadline_s=0.25)
    b._stop.set()
    b._thread.join(timeout=5)
    b._batch_ewma.update(1.0)
    b._batch_ewma_n = 8
    f1 = b.submit(Request(uri="/a", request_id="a"))
    f2 = b.submit(Request(uri="/b", request_id="b"))
    assert not f1.done()
    assert f2.done() and f2.result().fail_open and f2.result().degraded
    assert b.pipeline.stats.shed.get("deadline") == 1
    b.close()
    assert f1.done() and f1.result().fail_open


def test_prefilter_only_verdicts_equal_jax(packs):
    """Ladder rung 1 (and the per-tenant rung): verdicts from the sound
    prefilter alone equal the JAX ``_finalize_prefilter_only``'s; they
    flag, never block, and carry degraded=True."""
    jcr, cr = packs
    jreqs, treqs = _requests()
    tp = DetectionPipeline(cr, device="cpu")
    jp = JaxPipeline(jcr, scan_impl="pair")
    tp.load_controller.level = jp.load_controller.level = 1
    got = [_vt(v) for v in tp.detect(treqs)]
    assert got == [_vt(v) for v in jp.detect(jreqs)]
    assert got[0][1] and not any(g[2] for g in got)
    assert all(g[7] for g in got)
    assert ([_vt(v) for v in tp.detect_tenant_degraded(treqs)]
            == [_vt(v) for v in jp.detect_tenant_degraded(jreqs)])
    tp.load_controller.level = jp.load_controller.level = 2
    fo = tp.detect(treqs[:1])
    assert [_vt(v) for v in fo] == [_vt(v) for v in jp.detect(jreqs[:1])]
    assert fo[0].fail_open and fo[0].degraded


def test_cpu_only_verdicts_equal_detect(packs):
    """The breaker-open path (every masked rule a confirm candidate, no
    device dispatch) gives detect's verdicts, as the JAX one does, and
    books no prefilter statistics."""
    jcr, cr = packs
    jreqs, treqs = _requests()
    tp = DetectionPipeline(cr, device="cpu")
    jp = JaxPipeline(jcr, scan_impl="pair")
    dev = [_vt(v) for v in tp.detect(treqs)]
    before = int(tp.rule_stats.candidates.sum())
    cpu = [_vt(v) for v in tp.detect_cpu_only(treqs)]
    assert cpu == dev
    assert cpu == [_vt(v) for v in jp.detect_cpu_only(jreqs)]
    assert int(tp.rule_stats.candidates.sum()) == before


def test_dispatch_hang_fails_open_trips_and_recovers(packs):
    """A dispatch_hang past the hang budget fails that batch open and
    trips the breaker; while open, batches ride the CPU-only path with
    exact verdicts; after the cooldown a half-open canary closes it."""
    jcr, cr = packs
    _, treqs = _requests()
    want = [_vt(v) for v in DetectionPipeline(cr, device="cpu").detect(
        treqs)]
    b = _mk_batcher(cr, hang_budget_s=1.0, breaker_cooldown_s=0.5,
                    hard_deadline_s=5.0)
    try:
        faults.install(FaultPlan.from_spec(
            "dispatch_hang:times=1,delay_s=4.0"))
        vs = [f.result(timeout=30) for f in [b.submit(treqs[0])]]
        assert vs[0].fail_open and not vs[0].blocked
        assert b.breaker.state == "open"
        assert b.stats.hangs == 1 and b.breaker.trips == 1
        fall = [f.result(timeout=30) for f in [b.submit(r) for r in treqs]]
        assert [_vt(v) for v in fall] == want
        assert b.stats.cpu_fallback_batches >= 1
        time.sleep(0.6)
        canary = [f.result(timeout=30)
                  for f in [b.submit(r) for r in treqs]]
        assert [_vt(v) for v in canary] == want
        assert b.breaker.state == "closed" and b.breaker.closes == 1
    finally:
        b.close()


@pytest.mark.parametrize("n_lanes", [1, 2])
@pytest.mark.parametrize("scanner", ["ByteScanner", "StepScanner"])
def test_card_pipeline_breaker_never_reaches_cpu_only(packs, monkeypatch,
                                                      scanner, n_lanes):
    """A pipeline on a card whose kernel raises: the batches fail open,
    the breaker opens, and the breaker-open batches fail open too —
    ``detect_cpu_only`` (which would move the detection work to the
    host) is never reached, and refuses a card pipeline if called.  The
    card is stood in for: the engine's device reads ``cuda:0`` while
    its tensors stay on the CPU, and every scanner it hands out raises
    as a failed kernel launch does."""
    import numpy as np
    import torch

    from ingress_plus_tpu_torch.ops import pair_scan, step_scan

    base = getattr(pair_scan if scanner == "ByteScanner" else step_scan,
                   scanner)

    class Raising(base):
        def __call__(self, *a, **kw):
            raise RuntimeError("%s: kernel launch failed: CUDA error 700"
                               % scanner)

    _, cr = packs
    _, treqs = _requests()
    p = DetectionPipeline(cr, mode="block", device="cpu")
    eng = p.engine
    monkeypatch.setattr(eng, "device", torch.device("cuda", 0))
    monkeypatch.setattr(eng, "_to_dev",
                        lambda x, device=None: torch.as_tensor(np.asarray(x)))
    monkeypatch.setattr(eng, "scanner_for",
                        lambda device=None: Raising(eng.tables.scan))
    reached = []
    real_cpu_only = p.detect_cpu_only
    monkeypatch.setattr(p, "detect_cpu_only",
                        lambda reqs: reached.append(len(reqs)) or [])
    with pytest.raises(RuntimeError, match="only on a CPU pipeline"):
        real_cpu_only(treqs)
    b = Batcher(p, max_batch=16, max_delay_s=0.001, hard_deadline_s=5.0,
                breaker_failures=1, breaker_cooldown_s=60.0,
                n_lanes=n_lanes,
                lane_devices=[torch.device("cpu")] * n_lanes)
    try:
        verdicts = []
        for _ in range(4):
            futs = [b.submit(r) for r in treqs]
            verdicts += [f.result(timeout=30) for f in futs]
            if not b.device_available():
                break
        assert not b.device_available()          # /readyz reads 503
        assert all(ln.breaker.state == "open" for ln in b.lanes.lanes)
        futs = [b.submit(r) for r in treqs]
        verdicts += [f.result(timeout=30) for f in futs]
        assert reached == []
        assert b.stats.cpu_fallback_batches == 0
        assert b.stats.breaker_fail_open_batches >= 1
        assert verdicts and all(v.fail_open and not v.blocked
                                for v in verdicts)
    finally:
        b.close()


def test_dispatch_raise_counts_toward_breaker(packs):
    b = _mk_batcher(packs[1], breaker_failures=2, breaker_cooldown_s=60.0)
    try:
        faults.install(FaultPlan.from_spec("dispatch_raise:times=2"))
        for i in range(2):
            v = b.submit(Request(uri=ATTACK_URI,
                                 request_id="r%d" % i)).result(timeout=30)
            assert v.fail_open and not v.blocked
        assert b.breaker.state == "open"
        assert b.lanes.primary.stats.errors == 2
    finally:
        b.close()


def test_recompile_gauge_counts_first_loads_only(packs):
    """The recompile gauge counts first loads per (kernel or table
    replica, device): 0 for every later dispatch whatever its shapes,
    and back up once a recompile_storm drops the scanners and replicas."""
    _, cr = packs
    _, treqs = _requests()
    p = DetectionPipeline(cr, device="cpu")
    p.detect(treqs[:1])
    assert p.stats.engine_compiles == 1          # the cpu table "replica"
    p.reset_detection_observations()
    for n in (1, 3, 5):
        p.detect(treqs[:n])
    assert p.stats.engine_compiles == 0
    faults.install(FaultPlan.from_spec("recompile_storm:times=1"))
    p.detect(treqs)
    assert p.stats.engine_compiles == 1
    p.detect(treqs)
    assert p.stats.engine_compiles == 1


def test_engine_serve_hooks_on_cpu(packs):
    """tables_for / scanner_for / exec_keys / rebuilt / drop_compiled on
    the CPU, where the only impl is ``pair``."""
    import torch

    from ingress_plus_tpu_torch.models.engine import (
        DetectionEngine,
        EngineTables,
    )

    _, cr = packs
    eng = DetectionEngine(cr, device="cpu")
    cpu = torch.device("cpu")
    assert eng.tables_for(None)[0] is eng.tables
    assert eng.tables_for(cpu)[0] is eng.tables
    copy = eng.tables.to(cpu)
    assert isinstance(copy, EngineTables)
    for k, v in eng.tables.to_numpy().items():
        assert (copy.to_numpy()[k] == v).all(), k
    assert eng.scanner_for() is None                  # the plain scan
    assert eng.exec_keys() == (("tables", "cpu"),)
    assert eng.scan_exec_shape(8, 2048) == (8, 2048)
    assert eng.scan_impl == "pair"
    twin = eng.rebuilt(cr)
    assert (twin.device, twin.scan_impl) == (eng.device, eng.scan_impl)
    assert twin.tables is not eng.tables
    eng.drop_compiled()
    assert eng._scanners == {} and eng._device_tables == {}
    for impl in ("pallas", "pallas2", "pallas3", "bogus"):
        with pytest.raises(ValueError):
            eng.scan_impl = impl
    with pytest.raises(ValueError, match="need CUDA"):
        DetectionEngine.check_impl("pallas3", cpu)


def test_profiled_writes_a_chrome_trace(tmp_path):
    import torch

    from ingress_plus_tpu_torch.utils.trace import profiled

    with profiled(str(tmp_path)):
        torch.ones(64).cumsum(0)
    traces = list(tmp_path.glob("serve-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with profiled(None):
        pass
