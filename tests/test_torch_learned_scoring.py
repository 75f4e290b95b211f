"""The port's learned scoring head against the JAX package's, on the CPU.

Analogs of ``tests/test_learned_scoring.py`` (the port's ``learn/``,
``models/pipeline.py`` hooks, the capture ring and the feature export),
each also holding the port's output to the JAX package's on the same
seeded inputs, plus the carry-across checks: trainers give heads of one
``fingerprint()``, a JAX-written artifact loads in the port, the port's
``.json`` is byte-identical to JAX's with equal arrays, and with the same
head the two pipelines give equal verdicts, ``learned_score`` and
``scorer_diff``.

Tolerance: none — the trainer is float64 numpy on both sides (weights
bit-equal), verdicts are compared field for field, and learned scores
are the same float32 dot.  The dense/sparse scorer parity keeps the JAX
test's 1e-4 (float32 sums in two orders).
"""

import json
from dataclasses import asdict

import numpy as np
import pytest

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.learn import features as jfeatures
from ingress_plus_tpu.learn import head as jhead
from ingress_plus_tpu.learn import train as jtrain
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve.normalize import Request as JRequest
from ingress_plus_tpu.utils import export_corpus as jexport
from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.control.rollout import (
    _DRILL_CANDIDATE,
    _DRILL_INCUMBENT,
)
from ingress_plus_tpu_torch.learn.features import (
    FeatureDataset,
    remap_columns,
)
from ingress_plus_tpu_torch.learn.head import (
    SCORER_LKG_POINTER,
    LearnedScorer,
    ScoringHead,
    load_lkg_scorer,
    persist_lkg_scorer,
)
from ingress_plus_tpu_torch.learn.train import (
    TrainConfig,
    calibrate_threshold,
    compare_scorers,
    fixed_flags,
    train_from_dataset,
    train_head,
)
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.models.rule_stats import BitmapRing, RuleStats
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.utils.export_corpus import build_feature_dataset
from ingress_plus_tpu_torch.weights import (
    BUNDLED_PACK,
    load_pack,
    scoring_head_from_jax,
)


@pytest.fixture(scope="module")
def packs():
    return {
        "inc": compile_ruleset(parse_seclang(_DRILL_INCUMBENT)),
        "cand": compile_ruleset(parse_seclang(_DRILL_CANDIDATE)),
    }


@pytest.fixture(scope="module")
def jax_packs():
    return {
        "inc": jax_compile(jax_parse(_DRILL_INCUMBENT)),
        "cand": jax_compile(jax_parse(_DRILL_CANDIDATE)),
    }


def _synthetic_arrays(n=400, f=24, seed=9):
    """Separable-ish synthetic activation data: attacks co-activate the
    first features, benign rows activate a 'prose' feature the fixed
    weights over-score — the FP class the head must learn away."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, f), dtype=np.uint8)
    y = np.zeros((n,), dtype=np.uint8)
    for i in range(n):
        if i % 3 == 0:
            y[i] = 1
            x[i, rng.integers(0, 4)] = 1
            x[i, 4 + rng.integers(0, 4)] = 1
        elif i % 7 == 0:
            x[i, 8] = 1          # benign prose hit (fixed-weight FP)
    rule_ids = np.arange(942100, 942100 + f, dtype=np.int64)
    rule_score = np.full((f,), 3, dtype=np.int64)
    return dict(x=x, y=y, rule_ids=rule_ids, rule_score=rule_score,
                anomaly_threshold=3)


def _synthetic_dataset(cls=FeatureDataset, **kw):
    return cls(**_synthetic_arrays(**kw))


def _head_fields(h):
    return {k: getattr(h, k) for k in ("rule_ids", "weights", "bias",
                                       "threshold", "provenance",
                                       "version")}


# -------------------------------------------------------------- features

def test_remap_columns_by_rule_id():
    x = np.array([[1, 2, 3]], dtype=np.float32)
    for fn in (remap_columns, jfeatures.remap_columns):
        out, cov = fn(x, [10, 20, 30], [30, 99, 10])
        assert out.tolist() == [[3.0, 0.0, 1.0]]
        assert cov == pytest.approx(2 / 3)
        out2, cov2 = fn(x, [10, 20, 30], [20, 20])
        assert out2.tolist() == [[2.0, 2.0]]
        assert cov2 == pytest.approx(1 / 3)


def test_feature_dataset_roundtrip_and_tamper(tmp_path):
    ds = _synthetic_dataset()
    path = tmp_path / "ds"
    ds.save(path)
    back = FeatureDataset.load(path)
    assert back.fingerprint() == ds.fingerprint()
    assert (back.x == ds.x).all() and (back.y == ds.y).all()
    assert back.anomaly_threshold == ds.anomaly_threshold
    # the JAX package reads the port's dataset and vice versa, with the
    # same fingerprint and the same JSON
    jds = jfeatures.FeatureDataset.load(path)
    assert jds.fingerprint() == ds.fingerprint()
    jpath = tmp_path / "jds"
    _synthetic_dataset(jfeatures.FeatureDataset).save(jpath)
    assert FeatureDataset.load(jpath).fingerprint() == ds.fingerprint()
    assert jpath.with_suffix(".json").read_bytes() == \
        path.with_suffix(".json").read_bytes()
    # tampered arrays no longer match the recorded content hash
    np.savez_compressed(path.with_suffix(".npz"), x=ds.x * 0, y=ds.y,
                        rule_ids=ds.rule_ids, rule_score=ds.rule_score)
    with pytest.raises(ValueError, match="hash mismatch"):
        FeatureDataset.load(path)


def test_feature_dataset_remap_to_new_pack():
    ds = _synthetic_dataset()
    new_ids = [942100, 999999]       # one shared, one alien
    ds2 = ds.remap(new_ids)
    assert ds2.x.shape == (ds.n, 2)
    assert (ds2.x[:, 0] == ds.x[:, 0]).all()
    assert not ds2.x[:, 1].any()
    jds2 = _synthetic_dataset(jfeatures.FeatureDataset).remap(new_ids)
    assert jds2.fingerprint() == ds2.fingerprint()


# --------------------------------------------------------------- trainer

def test_trainer_deterministic_and_hash_stable():
    ds = _synthetic_dataset()
    h1 = train_from_dataset(ds, TrainConfig(iters=120))
    h2 = train_from_dataset(ds, TrainConfig(iters=120))
    assert (h1.weights == h2.weights).all()
    assert h1.bias == h2.bias and h1.threshold == h2.threshold
    assert h1.fingerprint() == h2.fingerprint()
    assert h1.version == h2.version
    h3 = train_from_dataset(ds, TrainConfig(iters=121))
    assert h3.fingerprint() != h1.fingerprint()


@pytest.mark.parametrize("iters,seed", [(120, 20260804), (300, 7)])
def test_trainer_heads_equal_jax(iters, seed):
    """The same dataset and config: the JAX trainer's head and the
    port's have one fingerprint, bit-equal weights and equal
    provenance (the baseline comparison included)."""
    ds = _synthetic_dataset()
    jds = _synthetic_dataset(jfeatures.FeatureDataset)
    h = train_from_dataset(ds, TrainConfig(iters=iters, seed=seed))
    jh = jtrain.train_from_dataset(
        jds, jtrain.TrainConfig(iters=iters, seed=seed))
    assert h.fingerprint() == jh.fingerprint() == h.version == jh.version
    assert h.weights.tobytes() == jh.weights.tobytes()
    assert (h.bias, h.threshold) == (jh.bias, jh.threshold)
    assert h.provenance == jh.provenance


def test_trainer_drops_empty_rows():
    ds = _synthetic_dataset()
    w, b = train_head(ds.x, ds.y, TrainConfig(iters=50))
    jw, jb = jtrain.train_head(ds.x, ds.y, jtrain.TrainConfig(iters=50))
    assert w.shape == (ds.n_features,)
    assert np.isfinite(w).all() and np.isfinite(b)
    assert w.tobytes() == jw.tobytes() and b == jb
    with pytest.raises(ValueError, match="no rows"):
        train_head(np.zeros((4, 8)), np.zeros((4,)), TrainConfig())


def test_calibration_zero_new_fn():
    ds = _synthetic_dataset()
    head = train_from_dataset(ds, TrainConfig(iters=200))
    margins = ds.x.astype(np.float64) @ head.weights.astype(np.float64) \
        + head.bias
    baseline = fixed_flags(ds)
    anyhit = ds.x.any(axis=1)
    learned = (margins >= head.threshold) & anyhit
    y = ds.y.astype(bool)
    assert not (baseline & y & ~learned).any()
    cmp = compare_scorers(ds, head)
    assert cmp["new_fn_vs_fixed"] == 0
    assert cmp["fixed"]["fp"] > 0
    assert cmp["learned"]["fp"] < cmp["fixed"]["fp"]
    assert cmp["fp_reduction"] > 0
    assert len(cmp["calibration_curve"]) >= 3
    jds = _synthetic_dataset(jfeatures.FeatureDataset)
    assert cmp == jtrain.compare_scorers(
        jds, jhead.ScoringHead(**_head_fields(head)))


def test_calibrate_threshold_degenerate_paths():
    m = np.array([1.0, 2.0, 3.0])
    y = np.array([0, 0, 0])
    anyhit = np.array([True, True, True])
    t = calibrate_threshold(m, y, np.zeros(3, bool), anyhit)
    assert t > 3.0
    assert t == jtrain.calibrate_threshold(m, y, np.zeros(3, bool), anyhit)
    assert calibrate_threshold(m, y, np.zeros(3, bool),
                               np.zeros(3, bool)) == 0.0


# -------------------------------------------------------------- artifact

def test_head_roundtrip_and_tamper_rejection(tmp_path):
    ds = _synthetic_dataset()
    head = train_from_dataset(ds, TrainConfig(iters=80))
    path = tmp_path / "head"
    head.save(path)
    back = ScoringHead.load(path)
    assert back.fingerprint() == head.fingerprint()
    assert back.threshold == head.threshold
    assert back.provenance["dataset"] == ds.fingerprint()
    np.savez_compressed(path.with_suffix(".npz"),
                        rule_ids=head.rule_ids,
                        weights=head.weights * 2.0)
    with pytest.raises(ValueError, match="hash mismatch"):
        ScoringHead.load(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    meta["kind"] = "not_a_head"
    path.with_suffix(".json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="kind"):
        ScoringHead.load(path)


def test_head_artifacts_carry_across(tmp_path):
    """A JAX-written head loads in the port; the port's save of the same
    head writes a byte-identical ``.json`` and equal arrays, which the
    JAX loader reads back; ``scoring_head_from_jax`` rebuilds it."""
    jds = _synthetic_dataset(jfeatures.FeatureDataset)
    jh = jtrain.train_from_dataset(jds, jtrain.TrainConfig(iters=90))
    jh.save(tmp_path / "jax")
    head = ScoringHead.load(tmp_path / "jax")
    assert head.version == jh.version == head.fingerprint()
    assert head.provenance == jh.provenance
    head.save(tmp_path / "port")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    back = jhead.ScoringHead.load(tmp_path / "port")
    assert back.fingerprint() == jh.fingerprint()
    carried = scoring_head_from_jax(asdict(jh))
    assert carried.fingerprint() == jh.fingerprint()
    assert carried.provenance == jh.provenance
    bad = dict(asdict(jh), threshold=jh.threshold + 1.0)
    with pytest.raises(ValueError, match="do not match"):
        scoring_head_from_jax(bad)


def test_head_schema_validation():
    with pytest.raises(ValueError, match="length mismatch"):
        ScoringHead(rule_ids=[1, 2], weights=[0.5], bias=0.0,
                    threshold=1.0).validate()
    with pytest.raises(ValueError, match="non-finite"):
        ScoringHead(rule_ids=[1], weights=[np.nan], bias=0.0,
                    threshold=1.0).validate()
    with pytest.raises(ValueError, match="non-finite"):
        ScoringHead(rule_ids=[1], weights=[1.0], bias=0.0,
                    threshold=float("inf")).validate()
    with pytest.raises(ValueError, match="empty"):
        ScoringHead(rule_ids=[], weights=[], bias=0.0,
                    threshold=1.0).validate()


def test_scorer_lkg_roundtrip_and_corruption(tmp_path):
    """The port's scorer LKG has the JAX files: the same pointer name,
    a byte-identical ``.json`` and pointer, equal arrays; each package
    restores the other's."""
    ds = _synthetic_dataset()
    head = train_from_dataset(ds, TrainConfig(iters=60))
    persist_lkg_scorer(head, tmp_path / "port")
    back = load_lkg_scorer(tmp_path / "port")
    assert back is not None and back.version == head.version
    jh = jhead.ScoringHead(**_head_fields(head))
    jhead.persist_lkg_scorer(jh, tmp_path / "jax")
    assert SCORER_LKG_POINTER == jhead.SCORER_LKG_POINTER
    for name in (SCORER_LKG_POINTER, "scorer-%s.json" % head.version):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert load_lkg_scorer(tmp_path / "jax").version == head.version
    assert jhead.load_lkg_scorer(tmp_path / "port").version == head.version
    (tmp_path / "port" / SCORER_LKG_POINTER).write_text("{broken json")
    assert load_lkg_scorer(tmp_path / "port") is None
    assert load_lkg_scorer(tmp_path / "nonexistent") is None


# ------------------------------------------------ scoring parity/serving

class _RulesetShim:
    def __init__(self, rule_ids):
        self.rule_ids = np.asarray(rule_ids, dtype=np.int64)
        self.version = "shim"


def test_matmul_vs_reference_parity():
    ds = _synthetic_dataset()
    head = train_from_dataset(ds, TrainConfig(iters=80))
    scorer = LearnedScorer(head, _RulesetShim(ds.rule_ids))
    jscorer = jhead.LearnedScorer(jhead.ScoringHead(**_head_fields(head)),
                                  _RulesetShim(ds.rule_ids))
    rng = np.random.default_rng(4)
    bitmap = (rng.random((64, ds.n_features)) < 0.1)
    dense = scorer.score_batch(bitmap)
    assert dense.tobytes() == jscorer.score_batch(bitmap).tobytes()
    for qi in range(bitmap.shape[0]):
        rows = list(np.nonzero(bitmap[qi])[0])
        sparse = scorer.score_confirmed(rows)
        assert sparse == jscorer.score_confirmed(rows)
        assert dense[qi] == pytest.approx(sparse, abs=1e-4)
    assert scorer.score_confirmed([]) == pytest.approx(scorer.bias)
    assert scorer.score_batch(np.zeros((1, ds.n_features), bool))[0] \
        == pytest.approx(scorer.bias, abs=1e-6)
    assert scorer.snapshot() == jscorer.snapshot()


def test_duplicate_rule_id_binding_is_positional():
    ids = np.array([942520, 942520, 941100], dtype=np.int64)
    head = ScoringHead(rule_ids=ids, weights=[0.1, 2.0, 1.0], bias=0.0,
                       threshold=1.5, version="dup-1")
    scorer = LearnedScorer(head, _RulesetShim(ids))
    assert scorer.coverage == 1.0
    assert scorer.w.tolist() == pytest.approx([0.1, 2.0, 1.0])
    assert scorer.score_confirmed([1]) == pytest.approx(2.0)
    out, cov = remap_columns(np.array([[0.1, 2.0, 1.0]]), ids,
                             [941100, 942520, 942520])
    assert out[0].tolist() == pytest.approx([1.0, 0.1, 2.0])
    assert cov == 1.0
    out2, _ = remap_columns(np.array([[0.1, 2.0]]), [942520, 942520],
                            [942520, 942520, 942520])
    assert out2[0].tolist() == pytest.approx([0.1, 2.0, 0.1])


def _drill_head(threshold, w_sqli=4.0, w_xss=4.0, cls=ScoringHead):
    """Hand-built head over the drill pack's two CRS ids."""
    return cls(rule_ids=[942100, 941100], weights=[w_sqli, w_xss],
               bias=0.0, threshold=threshold, version="t-%s" % threshold)


def _attack_benign(R):
    return (R(uri="/search?q=1+union+select+password", request_id="atk-1"),
            R(uri="/benign?q=cats", request_id="ben-1"))


def _vkey(v):
    return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids), v.score,
            list(v.classes), v.learned_score, v.generation, v.fail_open)


def test_pipeline_scorer_divergence_and_exports(packs, jax_packs):
    attack, benign = _attack_benign(Request)
    jattack, jbenign = _attack_benign(JRequest)
    p = DetectionPipeline(packs["inc"], mode="block", device="cpu",
                          scoring_head=_drill_head(threshold=99.0))
    assert p.scorer is not None and p.scorer.coverage == 1.0
    v_atk, v_ben = p.detect([attack, benign])
    assert not v_atk.attack and not v_atk.blocked
    assert v_atk.score >= 5
    assert v_atk.learned_score == pytest.approx(4.0)
    assert v_ben.learned_score == pytest.approx(0.0)
    assert p.stats.scorer_diff == {"learned_pass": 1}
    assert v_atk.generation == packs["inc"].version + "+t-99.0"
    jp = JaxPipeline(jax_packs["inc"], mode="block",
                     scoring_head=_drill_head(99.0, cls=jhead.ScoringHead))
    assert [_vkey(v) for v in jp.detect([jattack, jbenign])] == \
        [_vkey(v_atk), _vkey(v_ben)]
    assert jp.stats.scorer_diff == p.stats.scorer_diff
    p2 = DetectionPipeline(packs["inc"], mode="block", device="cpu",
                           scoring_head=_drill_head(threshold=3.0))
    v_atk2, v_ben2 = p2.detect([attack, benign])
    assert v_atk2.attack and v_atk2.blocked
    assert not v_ben2.attack
    assert p2.stats.scorer_diff == {}


def test_pipeline_without_head_unchanged(packs):
    attack, _ = _attack_benign(Request)
    p = DetectionPipeline(packs["inc"], mode="block", device="cpu")
    v = p.detect([attack])[0]
    assert v.attack and v.learned_score is None
    assert v.generation == packs["inc"].version
    assert p.stats.scorer_diff == {}


def test_rule_id_remap_across_pack_swap(packs):
    attack, _ = _attack_benign(Request)
    head = _drill_head(threshold=3.0)
    p = DetectionPipeline(packs["inc"], mode="block", device="cpu",
                          scoring_head=head)
    idx_inc = int(np.nonzero(packs["inc"].rule_ids == 942100)[0][0])
    assert p.scorer.w[idx_inc] == pytest.approx(4.0)
    p.swap_ruleset(packs["cand"])
    assert p.scorer is not None
    assert p.scorer.coverage == 1.0
    idx_cand = int(np.nonzero(packs["cand"].rule_ids == 942100)[0][0])
    assert p.scorer.w[idx_cand] == pytest.approx(4.0)
    idx_new = int(np.nonzero(packs["cand"].rule_ids == 955100)[0][0])
    assert p.scorer.w[idx_new] == 0.0
    v = p.detect([attack])[0]
    assert v.attack and v.learned_score == pytest.approx(4.0)
    assert v.generation == packs["cand"].version + "+" + head.version
    p.set_scoring_head(None)
    assert p.scorer is None
    assert p.detect([attack])[0].generation == packs["cand"].version


@pytest.fixture(scope="module")
def bundled_dataset():
    """The feature export on the committed bundled pack, both packages
    (120 corpus requests + the 33 benign fixtures)."""
    port = build_feature_dataset(n=120, seed=20260729, ruleset=load_pack(),
                                 batch=64, device="cpu")
    jax = jexport.build_feature_dataset(
        n=120, seed=20260729, ruleset=JaxRuleset.load(BUNDLED_PACK),
        batch=64)
    return port, jax


def test_capture_ring_feature_export_equal_jax(bundled_dataset):
    ds, jds = bundled_dataset
    for k in ("x", "x_candidates", "y", "rule_ids", "rule_score"):
        a, b = getattr(ds, k), getattr(jds, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert ds.request_ids == jds.request_ids
    assert ds.meta == jds.meta
    assert ds.fingerprint() == jds.fingerprint()
    assert ds.x.any() and ds.y.sum() > 0


def test_bundled_head_verdicts_equal_jax(bundled_dataset):
    """A head trained on the bundled-pack export: the same head in both
    pipelines gives equal verdicts, learned scores and scorer_diff."""
    ds, jds = bundled_dataset
    head = train_from_dataset(ds, TrainConfig(iters=150))
    jh = jtrain.train_from_dataset(jds, jtrain.TrainConfig(iters=150))
    assert head.fingerprint() == jh.fingerprint()
    p = DetectionPipeline(load_pack(), mode="block", device="cpu",
                          scoring_head=head)
    jp = JaxPipeline(JaxRuleset.load(BUNDLED_PACK), mode="block",
                     scoring_head=jh)
    reqs = [lr.request for lr in generate_corpus(n=96, seed=11)]
    jreqs = [JRequest(**asdict(r)) for r in reqs]
    got = [_vkey(v) for v in p.detect(reqs)]
    want = [_vkey(v) for v in jp.detect(jreqs)]
    assert got == want
    assert p.stats.scorer_diff == jp.stats.scorer_diff
    assert any(k[6] is not None for k in got)


# ---------------------------------------------------------- capture ring

def test_capture_ring_bounded_and_reset(packs):
    rs = RuleStats(packs["inc"])
    r = int(packs["inc"].n_rules)
    ring = rs.enable_capture(cap_bytes=8 * (2 * ((r + 7) // 8)))
    assert ring.capacity == 8
    hits = np.zeros((4, r), dtype=bool)
    hits[:, 0] = True
    for _ in range(4):
        rs.observe_finalize(hits, [0], [False],
                            confirmed_rows=[[0], [], [], []])
    assert len(ring) == 8
    assert ring.appended == 16 and ring.dropped == 8
    cand, conf = rs.capture_snapshot()
    assert cand.shape == (8, r) and conf.shape == (8, r)
    assert cand[:, 0].all()
    assert conf[0, 0] and not conf[1].any()
    rs.observe_finalize(hits, [0], [False])
    assert len(ring) == 8 and ring.appended == 16
    rs.reset()
    assert len(ring) == 0 and ring.appended == 0
    rs.disable_capture()
    assert rs.capture is None


def test_bitmap_ring_snapshot_empty():
    ring = BitmapRing(16, cap_bytes=64)
    cand, conf = ring.snapshot()
    assert cand.shape == (0, 16) and conf.shape == (0, 16)


def test_capture_feeds_feature_export(packs, jax_packs):
    ds = build_feature_dataset(n=48, seed=5, ruleset=packs["inc"],
                               include_fixtures=False, batch=16,
                               device="cpu")
    assert ds.n == 48
    assert ds.n_features == packs["inc"].n_rules
    assert (ds.rule_ids == np.asarray(packs["inc"].rule_ids)).all()
    assert ds.x_candidates is not None
    assert (ds.x_candidates.astype(bool) | ~ds.x.astype(bool)).all()
    assert len(ds.request_ids) == 48
    assert ds.y.sum() > 0
    jds = jexport.build_feature_dataset(n=48, seed=5,
                                        ruleset=jax_packs["inc"],
                                        include_fixtures=False, batch=16)
    assert ds.fingerprint() == jds.fingerprint()
    assert ds.x_candidates.tobytes() == jds.x_candidates.tobytes()
