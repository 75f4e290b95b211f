"""The port's engine against the JAX package's, on the CPU.

Both engines are built from the committed bundled pack.  Tolerance:
none — table leaves are integer bit patterns or exact 0/1 floats, and
rule hits are booleans.
"""

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.models import engine as jengine
from ingress_plus_tpu_torch.models import engine as tengine
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.ops.scan import from_numpy_u32
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.weights import (
    BUNDLED_PACK,
    engine_tables_from_numpy,
    load_pack,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def engines():
    jax_engine = jengine.DetectionEngine(JaxRuleset.load(BUNDLED_PACK),
                                         scan_impl="pair")
    port_engine = tengine.DetectionEngine(load_pack(), device=CPU)
    return jax_engine, port_engine


def _jax_leaves(et) -> dict:
    """The JAX EngineTables' leaves as numpy, under the port's names."""
    s = et.scan
    out = {k: np.asarray(getattr(s, k))
           for k in ("byte_table", "init_mask", "final_mask", "byte_class",
                     "class_table", "pair_reach", "pair_final")}
    for k in ("factor_word", "factor_bit", "factor_rule", "rule_sv",
              "rule_score", "rule_class", "rule_no_prefilter", "rule_group"):
        out[k] = np.asarray(getattr(et, k))
    return out


@pytest.mark.parametrize("which", ["tables", "head_tables"])
def test_engine_tables_equal_jax(engines, which):
    jax_engine, port_engine = engines
    want = _jax_leaves(getattr(jax_engine, which))
    got = getattr(port_engine, which).to_numpy()
    assert set(got) == set(tengine.EngineTables.LEAVES) == set(want)
    for k in tengine.EngineTables.LEAVES:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype),
                                      err_msg=k)
    if which == "head_tables":
        assert got["byte_table"].shape[1] == 215 < 225


def test_engine_tables_from_jax_leaves_round_trip(engines):
    """Tables carried across from the JAX leaves equal the port's own."""
    jax_engine, port_engine = engines
    et = engine_tables_from_numpy(_jax_leaves(jax_engine.tables), CPU)
    mine = port_engine.tables.to_numpy()
    for k, v in et.to_numpy().items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)


def test_map_match_words_equal_jax_with_padded_requests(engines):
    """Seeded random match words, rows owned by a few of the requests:
    request slots with no rows (the padded tail, and a hole in the
    middle) are empty segments — JAX fills them with -inf, the port
    with 0; the rule hits must agree everywhere."""
    jax_engine, port_engine = engines
    rng = np.random.default_rng(7)
    B, W, Q = 24, 225, 16
    mw = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    mw[rng.random((B, W)) < 0.97] = 0
    row_req = rng.choice([0, 1, 2, 4, 5, 6], size=B).astype(np.int32)
    n_sv = port_engine.tables.rule_sv.shape[1]
    row_sv = (rng.random((B, n_sv)) < 0.2).astype(np.int8)
    want = jengine.map_match_words(jax_engine.tables, mw, row_req, row_sv, Q)
    got = tengine.map_match_words(
        port_engine.tables, from_numpy_u32(mw, CPU),
        torch.from_numpy(row_req), torch.from_numpy(row_sv), Q)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:3].any()                 # non-vacuous
    assert not got[0][3].any() and not got[0][7:].any()   # empty slots


@pytest.mark.parametrize("head_only", [False, True])
def test_detect_device_multi_equal_jax_on_corpus(engines, head_only):
    jax_engine, port_engine = engines
    pl = DetectionPipeline(port_engine.ruleset, engine=port_engine)
    reqs = [lr.request for lr in generate_corpus(n=96, seed=20260729)]
    if head_only:
        reqs = [r for r in reqs if not r.body]
    buckets, head_ok = pl._build_scan_buckets(reqs)
    assert head_ok == head_only
    Q = pl._pad_q(len(reqs))
    want = np.asarray(jax_engine.detect_device_multi(
        tuple(buckets), Q, head_only=head_only))
    got = port_engine.detect_device_multi(tuple(buckets), Q,
                                          head_only=head_only)
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("head_only", [False, True])
def test_take_rule_hits_equal_jax_take_and_port_pair(engines, head_only):
    """``take`` on the CPU (the plain per-byte ``scan_bytes``) gives the
    rule hits of the JAX engine's ``take`` and of the port's ``pair``
    on the same seeded requests and pack."""
    jax_engine, port_engine = engines
    cr = port_engine.ruleset
    jax_take = jengine.DetectionEngine(JaxRuleset.load(BUNDLED_PACK),
                                       scan_impl="take")
    port_take = tengine.DetectionEngine(cr, scan_impl="take", device=CPU)
    pl = DetectionPipeline(cr, engine=port_engine)
    reqs = [lr.request for lr in generate_corpus(n=48, seed=20260805)]
    if head_only:
        reqs = [r for r in reqs if not r.body]
    buckets, head_ok = pl._build_scan_buckets(reqs)
    assert head_ok == head_only
    Q = pl._pad_q(len(reqs))
    want = np.asarray(jax_take.detect_device_multi(
        tuple(buckets), Q, head_only=head_only))
    got = port_take.detect_device_multi(tuple(buckets), Q,
                                        head_only=head_only)
    pair = port_engine.detect_device_multi(tuple(buckets), Q,
                                           head_only=head_only)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pair)
    assert got.any()


def test_detect_single_bucket_equal_jax(engines):
    jax_engine, port_engine = engines
    pl = DetectionPipeline(port_engine.ruleset, engine=port_engine)
    reqs = [lr.request for lr in generate_corpus(n=24, seed=5)]
    buckets, _ = pl._build_scan_buckets(reqs)
    tok, ln, rr, rs = buckets[0]
    want = jax_engine.detect(tok, ln, rr, rs, pl._pad_q(len(reqs)))
    got = port_engine.detect(tok, ln, rr, rs, pl._pad_q(len(reqs)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_scan_impl_device_rules(engines):
    """Kernel impls need CUDA; the plain impl is the CPU path."""
    _, port_engine = engines
    cr = port_engine.ruleset
    for impl in ("pallas", "pallas2", "pallas3"):
        with pytest.raises(ValueError, match="cannot run on a cpu"):
            tengine.DetectionEngine(cr, scan_impl=impl, device=CPU)
    with pytest.raises(ValueError, match="unknown scan_impl"):
        tengine.DetectionEngine(cr, scan_impl="gather", device=CPU)
    take = tengine.DetectionEngine(cr, scan_impl="take", device=CPU)
    assert take.scanner_for() is None and take.head_slicing_active()
    assert take.exec_keys() == (("tables", "cpu"),)
    info = port_engine.device_info()
    assert info["scan_impl"] == "pair" and info["device"] == "cpu"
    assert (info["n_words"], info["n_classes"]) == (225, 58)
    assert port_engine.head_slicing_active()
    assert tengine.map_pad_total(9) == jengine.map_pad_total(9) == 16
