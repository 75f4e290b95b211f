"""``--scan-impl auto`` on the port against the JAX package, on the CPU.

The startup bake-off of the single engine
(``DetectionEngine.autoselect_scan_impl``), the sharded step
(``ShardedEngine.autoselect_scan_impl``, 2x4 mesh) and the mesh adapter
(``MeshEngine.autoselect_scan_impl``): the same candidate sets as the
JAX package's, the argmin installed, and after the bake-off the rule
hits and sharded outputs equal the JAX package's on the same seeded
inputs (tolerance: none, they are booleans and small integers).  Then
the edges: every candidate without a signal keeps the configured impl
in both packages; a candidate that raises stops the port's bake-off
(the JAX package would score it ``inf``); given the same times both
packages install the same impl; the bake-off's launches are tallied
under their own scope; and the server measures under ``auto`` only.  Which impl wins is
never asserted: it is a timing.
"""

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.compiler.ruleset import N_SV, VARIANTS
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import STREAM_INDEX
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.models import engine as jengine
from ingress_plus_tpu.ops.scan import pad_rows
from ingress_plus_tpu.parallel import ShardedEngine as JaxSharded
from ingress_plus_tpu.parallel import make_mesh as jax_mesh
from ingress_plus_tpu.parallel.serve_mesh import MeshEngine as JaxMesh
from ingress_plus_tpu.parallel.serve_mesh import parse_mesh_spec as jax_spec
from ingress_plus_tpu.utils import microbench as jmicro
from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.models import engine as tengine
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.ops import cuda_build
from ingress_plus_tpu_torch.parallel import ShardedEngine, make_mesh
from ingress_plus_tpu_torch.parallel import shard as tshard
from ingress_plus_tpu_torch.parallel.serve_mesh import (
    MeshEngine,
    parse_mesh_spec,
)
from ingress_plus_tpu_torch.utils import microbench as tmicro
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

CPU = torch.device("cpu")
CPU8 = ["cpu"] * 8

#: the JAX serve-mesh tests' four rules
RULES = """
SecRule ARGS|REQUEST_BODY "@rx (?i)union\\s+select" "id:942100,phase:2,block,t:urlDecodeUni,t:lowercase,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS|REQUEST_BODY "@rx (?i)<script[^>]*>" "id:941100,phase:2,block,t:urlDecodeUni,t:htmlEntityDecode,severity:CRITICAL,tag:'attack-xss'"
SecRule REQUEST_URI|ARGS "@rx /etc/(?:passwd|shadow)" "id:930120,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
SecRule ARGS "@pm sleep( benchmark( xp_cmdshell" "id:942150,phase:2,block,severity:ERROR,tag:'attack-sqli'"
"""

#: the JAX test's small bake-off shapes (tests/test_engine_impls.py,
#: tests/test_parallel.py, tests/test_serve_mesh.py)
ENGINE_KW = dict(B=32, L=64, n=1)
SHARDED_KW = dict(B=32, L=128, iters=3)
MESH_KW = dict(B=16, L=128, iters=2)


@pytest.fixture(scope="module")
def packs():
    """The committed pack, loaded by each package."""
    return JaxRuleset.load(str(BUNDLED_PACK)), load_pack()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jcr = jax_compile(jax_parse(RULES))
    path = tmp_path_factory.mktemp("pack") / "tiny"
    jcr.save(str(path))
    return jcr, CompiledRuleset.load(str(path))


def _batch(n_req=8, rows_per_req=2):
    """tests/test_parallel.py's batch: request q's rows contiguous."""
    payloads = [
        b"GET /search?q=1' UNION SELECT password FROM users--",
        b"<script>alert(1)</script>",
        b"; cat /etc/passwd",
        b"plain benign text about shoes and prices",
    ]
    rows, row_req = [], []
    for q in range(n_req):
        for r in range(rows_per_req):
            rows.append(payloads[(q + r) % len(payloads)])
            row_req.append(q)
    tokens, lengths = pad_rows(rows, round_to=64)
    sv = np.zeros((len(rows), N_SV), np.int8)
    a = STREAM_INDEX["args"] * len(VARIANTS)
    sv[:, a:a + len(VARIANTS)] = 1
    return tokens, lengths, np.asarray(row_req, np.int32), sv


def _argmin(timings):
    return min(timings, key=timings.get)


def test_engine_autoselect_installs_fastest(packs):
    """Twin of tests/test_engine_impls.py
    ``test_autoselect_installs_fastest``: the same candidates as the JAX
    engine on a CPU backend, the argmin installed, every time > 0."""
    jcr, cr = packs
    jeng = jengine.DetectionEngine(jcr)
    jeng.pallas_interpret = True
    want = jeng.autoselect_scan_impl(**ENGINE_KW)
    eng = tengine.DetectionEngine(cr, device=CPU)
    timings = eng.autoselect_scan_impl(**ENGINE_KW)
    assert set(timings) == set(want) == {"pair", "take"}
    assert eng.scan_impl == _argmin(timings)
    assert all(t > 0 for t in timings.values())


def test_engine_rule_hits_equal_jax_after_autoselect(packs):
    """Whatever won, the port's multi-bucket rule hits equal the JAX
    engine's on the corpus."""
    jcr, cr = packs
    eng = tengine.DetectionEngine(cr, device=CPU)
    timings = eng.autoselect_scan_impl(**ENGINE_KW)
    assert eng.scan_impl == _argmin(timings)
    pl = DetectionPipeline(cr, engine=eng)
    reqs = [lr.request for lr in generate_corpus(n=64, seed=20260729)]
    buckets, _ = pl._build_scan_buckets(reqs)
    Q = pl._pad_q(len(reqs))
    want = np.asarray(jengine.DetectionEngine(jcr, scan_impl="pair")
                      .detect_device_multi(tuple(buckets), Q))
    got = eng.detect_device_multi(tuple(buckets), Q)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_sharded_autoselect_on_2x4_equals_jax(packs):
    """Twin of the autoselect half of tests/test_parallel.py
    ``test_tp_scan_impl_parity_and_autoselect``: the 2x4 CPU mesh times
    the JAX package's candidates, installs its best, and its outputs
    before and after equal the JAX ``ShardedEngine``'s."""
    jcr, cr = packs
    tokens, lengths, row_req, row_sv = _batch()
    local_req = row_req % 4      # detect() takes SHARD-LOCAL request ids
    tenants = np.zeros((8,), np.int32)
    jeng = JaxSharded(jcr, jax_mesh(n_data=2, n_model=4), scan_impl="take")
    want = jeng.detect(tokens, lengths, local_req, row_sv, tenants, 8)
    eng = ShardedEngine(cr, make_mesh(2, 4, devices=CPU8), scan_impl="take")
    before = eng.detect(tokens, lengths, local_req, row_sv, tenants, 8)
    for w, g in zip(want, before):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert before[2].max() > 0           # parity must be non-vacuous
    jbest = jeng.autoselect_scan_impl(**SHARDED_KW)
    best = eng.autoselect_scan_impl(**SHARDED_KW)
    assert jbest in ("pair", "take") and best in ("pair", "take")
    assert eng.scan_impl == best == _argmin(eng.last_timings)
    assert set(eng.last_timings) == set(jeng.last_timings)
    after = eng.detect(tokens, lengths, local_req, row_sv, tenants, 8)
    for w, g in zip(want, after):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_mesh_engine_autoselect_returns_timings(tiny):
    """Twin of tests/test_serve_mesh.py
    ``test_mesh_autoselect_returns_timings``, with the JAX MeshEngine's
    candidate set beside it."""
    jcr, cr = tiny
    jeng = JaxMesh(jcr, jax_spec("2x4"))
    want = jeng.autoselect_scan_impl(**MESH_KW)
    mp = DetectionPipeline(cr, mode="block", fail_open=False, device="cpu",
                           engine=MeshEngine(cr, parse_mesh_spec(
                               "2x4", platform="cpu")))
    timings = mp.engine.autoselect_scan_impl(**MESH_KW)
    assert set(timings) >= {"take", "pair"}
    assert set(timings) == set(want)
    assert mp.engine.scan_impl in timings
    assert mp.engine.scan_impl == _argmin(timings)


def test_every_candidate_without_signal_keeps_the_configured_impl(
        packs, monkeypatch):
    """A K-difference <= 0 is no signal (``inf``); with every candidate
    at 0 both packages keep the impl they were configured with."""
    jcr, cr = packs
    monkeypatch.setattr(jmicro, "k_diff_time", lambda *a, **k: 0.0)
    monkeypatch.setattr(tmicro, "k_diff_time", lambda *a, **k: 0.0)
    jeng = jengine.DetectionEngine(jcr, scan_impl="take")
    want = jeng.autoselect_scan_impl(**ENGINE_KW)
    eng = tengine.DetectionEngine(cr, scan_impl="take", device=CPU)
    timings = eng.autoselect_scan_impl(**ENGINE_KW)
    assert want == timings == {"pair": float("inf"), "take": float("inf")}
    assert jeng.scan_impl == eng.scan_impl == "take"


def _engine(cr, which):
    if which == "engine":
        return tengine.DetectionEngine(cr, device=CPU)
    return ShardedEngine(cr, make_mesh(2, 4, devices=CPU8))


@pytest.mark.parametrize("which", ["engine", "sharded"])
def test_a_candidate_that_raises_stops_the_bake_off(packs, monkeypatch,
                                                    which):
    """The stated departure from the JAX package (which scores a failing
    candidate ``inf`` and serves another): the error propagates and the
    configured impl stays installed."""
    _, cr = packs
    eng = _engine(cr, which)
    module = tengine if which == "engine" else tshard

    def broken(*a, **k):
        raise RuntimeError("scan failed")

    monkeypatch.setattr(module, "scan_bytes", broken)
    with pytest.raises(RuntimeError, match="scan failed"):
        eng.autoselect_scan_impl(B=16, L=32, **(
            {"n": 1} if which == "engine" else {"iters": 1}))
    assert eng.scan_impl == "pair"


@pytest.mark.parametrize("faster", ["pair", "take"])
def test_the_least_time_is_installed_in_both_packages(packs, monkeypatch,
                                                      faster):
    """Given the same times, both packages install the same impl: the
    one with the least time a pass, whichever candidate that is."""
    jcr, cr = packs
    calls = []

    def times(*a, **k):
        calls.append(None)
        # candidates are timed in the order pair, take in both packages
        return 1e-3 if ("pair", "take")[(len(calls) - 1) % 2] == faster \
            else 2e-3

    monkeypatch.setattr(jmicro, "k_diff_time", times)
    monkeypatch.setattr(tmicro, "k_diff_time", times)
    jeng = jengine.DetectionEngine(jcr)
    want = jeng.autoselect_scan_impl(**ENGINE_KW)
    calls.clear()
    eng = tengine.DetectionEngine(cr, device=CPU)
    timings = eng.autoselect_scan_impl(**ENGINE_KW)
    assert timings == want
    assert jeng.scan_impl == eng.scan_impl == faster


@pytest.mark.parametrize("which", ["engine", "sharded"])
def test_bake_off_launches_are_tallied_under_their_own_scope(
        packs, monkeypatch, which):
    """Every scan of the bake-off runs inside
    ``launch_scope(AUTOSELECT_SCOPE)``: a kernel launched there does not
    count in the serving cycles' per-shape tally."""
    _, cr = packs
    eng = _engine(cr, which)
    module = tengine if which == "engine" else tshard
    scopes = []
    real = module.scan_pairs

    def spy(*a, **k):
        scopes.append(cuda_build.current_scope())
        return real(*a, **k)

    monkeypatch.setattr(module, "scan_pairs", spy)
    eng.autoselect_scan_impl(B=16, L=32, **(
        {"n": 1} if which == "engine" else {"iters": 1}))
    assert scopes and set(scopes) == {cuda_build.AUTOSELECT_SCOPE}
    assert cuda_build.current_scope() == cuda_build.SERVE_SCOPE


@pytest.mark.parametrize("mesh_spec", [None, "1x2"])
def test_server_measures_under_auto_only(monkeypatch, capsys, mesh_spec):
    """``build_default_batcher(scan_impl="auto")`` runs the bake-off once
    on the pipeline's engine (single or mesh), installs its argmin and
    prints the timings; an explicit impl measures nothing."""
    from ingress_plus_tpu_torch.serve.server import build_default_batcher

    cls = MeshEngine if mesh_spec else tengine.DetectionEngine
    small = MESH_KW if mesh_spec else ENGINE_KW
    real = cls.autoselect_scan_impl
    calls = []

    def measured(self, **kw):
        calls.append(real(self, **dict(small, **kw)))
        return calls[-1]

    monkeypatch.setattr(cls, "autoselect_scan_impl", measured)
    b = build_default_batcher(platform="cpu", warmup=False,
                              mesh_spec=mesh_spec)
    try:
        assert len(calls) == 1 and set(calls[0]) == {"pair", "take"}
        assert b.pipeline.engine.scan_impl == _argmin(calls[0])
    finally:
        b.close()
    err = capsys.readouterr().err
    assert "scan impl auto-select: %s  (pair=" % _argmin(calls[0]) in err
    b = build_default_batcher(platform="cpu", warmup=False,
                              mesh_spec=mesh_spec, scan_impl="take")
    try:
        assert len(calls) == 1 and b.pipeline.engine.scan_impl == "take"
    finally:
        b.close()
    assert "scan impl: take" in capsys.readouterr().err
