"""The committed bundled pack and the port's checkpoint loader.

``ingress_plus_tpu_torch/packs/crs_bundled`` is the JAX package's
compiler output, committed as data.  It must equal a fresh compile array
for array (exact: integer and boolean arrays, JSON descriptors), and any
pack the JAX package saves must load into the port unchanged.
"""

import numpy as np
import pytest

from ingress_plus_tpu.compiler import compile_ruleset
from ingress_plus_tpu.compiler.seclang import parse_seclang
from ingress_plus_tpu.compiler.sigpack import RULES_DIR, load_bundled_rules
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

TABLE_FIELDS = ("byte_table", "init_mask", "final_mask", "factor_word",
                "factor_bit", "factor_rule_indptr", "factor_rule_ids",
                "rule_nfactors", "factor_len")
RULE_FIELDS = ("rule_sv_mask", "rule_class", "rule_score", "rule_action",
               "rule_paranoia", "rule_ids")


def _assert_same_pack(got, want):
    for f in TABLE_FIELDS:
        a, b = getattr(got.tables, f), getattr(want.tables, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in RULE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.tables.n_head_words == want.tables.n_head_words
    assert got.tables.n_prefix_shared == want.tables.n_prefix_shared
    assert [m.confirm for m in got.rules] == [m.confirm for m in want.rules]
    assert [m.rule.tags for m in got.rules] == [m.rule.tags
                                                for m in want.rules]
    assert [m.has_prefilter for m in got.rules] == [
        m.has_prefilter for m in want.rules]
    assert got.ctl_specs == want.ctl_specs
    assert (got.anomaly_threshold, got.paranoia_hint) == (
        want.anomaly_threshold, want.paranoia_hint)


def test_committed_pack_equals_fresh_compile():
    fresh = compile_ruleset(load_bundled_rules(), base_path=RULES_DIR / "crs")
    got = load_pack()
    _assert_same_pack(got, fresh)
    assert got.version == fresh.fingerprint()
    assert (got.n_rules, got.tables.n_words, got.tables.n_factors) == (
        2009, 225, 920)
    assert got.reduction == fresh.reduction


def test_jax_save_round_trips_through_port_loader(tmp_path):
    rules = parse_seclang(
        'SecRule ARGS "@rx (?i)union\\s+select" '
        '"id:942100,phase:2,block,severity:CRITICAL,tag:\'attack-sqli\'"\n'
        'SecRule REQUEST_URI "@beginsWith /api" '
        '"id:1000,phase:1,pass,nolog,ctl:ruleRemoveById=942100"\n'
        'SecRule REQUEST_HEADERS:User-Agent "@pm nikto sqlmap" '
        '"id:913100,phase:1,block,severity:CRITICAL,tag:\'attack-scanner\'"')
    cr = compile_ruleset(rules)
    cr.save(tmp_path / "small")
    got = load_pack(tmp_path / "small")
    _assert_same_pack(got, cr)
    assert got.version == cr.fingerprint()
    assert got.ctl_specs


def test_bundled_pack_files_are_committed_data():
    for suffix in (".npz", ".json"):
        p = BUNDLED_PACK.with_suffix(suffix)
        assert p.is_file() and p.stat().st_size < 1 << 20
    with pytest.raises(FileNotFoundError):
        load_pack(BUNDLED_PACK.with_name("no_such_pack"))
