"""The port's SecLang compiler against the JAX package's, on the CPU.

The same SecLang text through both packages' ``parse_seclang`` +
``compile_ruleset`` must give the same pack: every table and per-rule
array (dtype and values), the confirm descriptors, the ctl specs, the
anomaly config, ``n_head_words``, ``n_prefix_shared``, the reduction
provenance and the ``version`` content hash — and the same JSON from
``save``.  Checked on the bundled CRS-shaped rules (which must also equal
the committed ``packs/crs_bundled``) and on a set of small sources, each
with the default reduction and with ``ReductionConfig.off()``.
"""

import json

import numpy as np
import pytest

from ingress_plus_tpu.compiler import reduce as jreduce
from ingress_plus_tpu.compiler.profile import MeasuredProfile as JaxProfile
from ingress_plus_tpu.compiler.ruleset import (
    CompiledRuleset as JaxRuleset,
    compile_ruleset as jax_compile,
)
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.compiler.sigpack import (
    load_bundled_rules as jax_bundled,
)
from ingress_plus_tpu_torch.compiler import compile_ruleset
from ingress_plus_tpu_torch.compiler import reduce as treduce
from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile
from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
from ingress_plus_tpu_torch.compiler.sigpack import (
    RULES_DIR,
    load_bundled_rules,
)
from ingress_plus_tpu_torch.weights import load_pack

TABLE_FIELDS = ("byte_table", "init_mask", "final_mask", "factor_word",
                "factor_bit", "factor_rule_indptr", "factor_rule_ids",
                "rule_nfactors", "factor_len")
RULE_FIELDS = ("rule_sv_mask", "rule_class", "rule_score", "rule_action",
               "rule_paranoia", "rule_ids")


def assert_same_pack(got, want):
    """Array for array (dtype and values) and every descriptor."""
    for f in TABLE_FIELDS:
        a, b = getattr(got.tables, f), getattr(want.tables, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in RULE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.tables.n_head_words == want.tables.n_head_words
    assert got.tables.n_prefix_shared == want.tables.n_prefix_shared
    assert [m.confirm for m in got.rules] == [m.confirm for m in want.rules]
    assert [m.rule.tags for m in got.rules] == [m.rule.tags
                                                for m in want.rules]
    assert [(m.variant, m.has_prefilter) for m in got.rules] == [
        (m.variant, m.has_prefilter) for m in want.rules]
    assert got.ctl_specs == want.ctl_specs
    assert (got.anomaly_threshold, got.paranoia_hint) == (
        want.anomaly_threshold, want.paranoia_hint)
    assert got.reduction == want.reduction
    assert got.version == want.version and got.version


def assert_same_save(got, want, tmp_path):
    """``save`` writes the same JSON and the same arrays."""
    got.save(tmp_path / "port")
    want.save(tmp_path / "jax")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def bundled():
    return (compile_ruleset(load_bundled_rules()),
            jax_compile(jax_bundled()))


def test_bundled_compile_equals_jax_and_committed_pack(bundled, tmp_path):
    got, want = bundled
    assert_same_pack(got, want)
    assert_same_pack(got, load_pack())
    assert (got.n_rules, got.tables.n_words, got.tables.n_factors) == (
        2009, 225, 920)
    assert_same_save(got, want, tmp_path)


def test_rules_data_is_a_copy_of_the_jax_tree():
    from ingress_plus_tpu.compiler.sigpack import RULES_DIR as JAX_RULES

    ours = sorted(p.relative_to(RULES_DIR) for p in RULES_DIR.rglob("*")
                  if p.is_file() and p.suffix in (".conf", ".txt", ".json"))
    theirs = sorted(p.relative_to(JAX_RULES) for p in JAX_RULES.rglob("*")
                    if p.is_file() and p.suffix in (".conf", ".txt",
                                                    ".json"))
    assert ours == theirs and len(ours) == 31
    for rel in ours:
        assert (RULES_DIR / rel).read_bytes() == (JAX_RULES / rel).read_bytes()


_SQLI = ('SecRule REQUEST_URI|ARGS|REQUEST_BODY "@rx (?i)union\\s+select" '
         '"id:942100,phase:2,block,t:urlDecodeUni,severity:CRITICAL,'
         'tag:\'attack-sqli\'"\n')
_XSS = ('SecRule REQUEST_URI|ARGS "@rx (?i)<script[^>]*>" '
        '"id:941100,phase:2,block,t:urlDecodeUni,t:htmlEntityDecode,'
        'severity:CRITICAL,tag:\'attack-xss\'"\n')

SOURCES = {
    "plain": _SQLI + _XSS,
    "chain": (
        'SecRule ARGS "@rx (?i)select\\s+\\w+\\s+from" '
        '"id:942200,phase:2,block,chain,severity:CRITICAL,'
        'tag:\'attack-sqli\'"\n'
        '    SecRule REQUEST_URI "@contains /admin" "t:lowercase"\n'
        + _XSS),
    "ctl": (
        _SQLI + _XSS
        + 'SecRule REQUEST_URI "@beginsWith /api/search" '
          '"id:1000,phase:1,pass,nolog,ctl:ruleRemoveById=942100"\n'
          'SecRule REQUEST_URI "@beginsWith /cms" '
          '"id:1001,phase:1,pass,nolog,'
          'ctl:ruleRemoveTargetById=941100;ARGS:body"\n'
          'SecRule REQUEST_HEADERS:X-Debug "@streq 1" '
          '"id:1002,phase:1,pass,nolog,ctl:ruleEngine=DetectionOnly"\n'),
    "anomaly": (
        'SecAction "id:900110,phase:1,nolog,pass,'
        'setvar:tx.inbound_anomaly_score_threshold=7,'
        'setvar:tx.critical_anomaly_score=5,'
        'setvar:tx.warning_anomaly_score=3"\n'
        'SecRule ARGS "@rx (?i)union\\s+select" '
        '"id:942100,phase:2,pass,t:urlDecodeUni,severity:CRITICAL,'
        'tag:\'attack-sqli\','
        'setvar:tx.anomaly_score_pl1=+%{tx.critical_anomaly_score}"\n'
        'SecRule ARGS "@rx (?i)sleep\\(\\d+\\)" '
        '"id:942160,phase:2,pass,severity:WARNING,tag:\'attack-sqli\','
        'setvar:tx.anomaly_score_pl1=+%{tx.warning_anomaly_score}"\n'
        'SecRule TX:ANOMALY_SCORE_PL1 '
        '"@ge %{tx.inbound_anomaly_score_threshold}" '
        '"id:949110,phase:2,deny,log,msg:\'Inbound Anomaly Score '
        'Exceeded\'"\n'),
    "pm": (
        'SecRule REQUEST_HEADERS:User-Agent "@pm nikto sqlmap nessus '
        'acunetix" "id:913100,phase:1,block,t:lowercase,'
        'severity:CRITICAL,tag:\'attack-scanner\'"\n'
        'SecRule ARGS "@pmFromFile sql-functions.txt" '
        '"id:942151,phase:2,block,t:lowercase,severity:CRITICAL,'
        'tag:\'attack-sqli\'"\n'),
    "negated": (
        _SQLI
        + 'SecRule REQUEST_METHOD "!@rx ^(?:GET|POST|HEAD)$" '
          '"id:911100,phase:1,block,severity:CRITICAL,'
          'tag:\'attack-protocol\'"\n'
          'SecRule REQUEST_HEADERS:Content-Length "!@rx ^\\d+$" '
          '"id:920160,phase:1,block,severity:CRITICAL,'
          'tag:\'attack-protocol\'"\n'),
    "comment_base64": (
        'SecRule ARGS "@rx (?i)union\\s+select" '
        '"id:942101,phase:2,block,t:replaceComments,t:compressWhitespace,'
        'severity:CRITICAL,tag:\'attack-sqli\'"\n'
        'SecRule ARGS "@rx <script" '
        '"id:941110,phase:2,block,t:base64Decode,severity:CRITICAL,'
        'tag:\'attack-xss\'"\n'),
    "paranoia": (
        _SQLI
        + 'SecRule ARGS "@rx (?i)\\bor\\b\\s+\\d+=\\d+" '
          '"id:942130,phase:2,block,severity:CRITICAL,'
          'tag:\'attack-sqli\',tag:\'paranoia-level/2\'"\n'
          'SecRule ARGS "@rx (?i)having\\s+\\d" '
          '"id:942230,phase:2,block,severity:WARNING,'
          'tag:\'attack-sqli\',tag:\'paranoia-level/3\'"\n'),
    "unsupported_regex": (
        _SQLI
        + 'SecRule ARGS "@rx (\\w+)=\\1" '
          '"id:942999,phase:2,block,severity:WARNING,'
          'tag:\'attack-sqli\'"\n'
          'SecRule ARGS "@rx (?<=x)eval\\(" '
          '"id:933999,phase:2,block,severity:WARNING,'
          'tag:\'attack-php\'"\n'),
    "response": (
        'SecRule RESPONSE_BODY "@rx (?i)you have an error in your sql" '
        '"id:951100,phase:4,block,severity:ERROR,tag:\'attack-leak\'"\n'
        'SecRule RESPONSE_STATUS "@rx ^5\\d\\d$" '
        '"id:950100,phase:3,pass,severity:WARNING,tag:\'attack-leak\'"\n'
        + _SQLI),
    "operators": (
        'SecRule ARGS "@contains /etc/passwd" '
        '"id:930120,phase:2,block,t:normalizePath,severity:CRITICAL,'
        'tag:\'attack-lfi\'"\n'
        'SecRule REQUEST_URI "@endsWith .bak" '
        '"id:930130,phase:1,block,severity:CRITICAL,tag:\'attack-lfi\'"\n'
        'SecRule ARGS "@detectSQLi" '
        '"id:942102,phase:2,block,severity:CRITICAL,tag:\'attack-sqli\'"\n'
        'SecRule &ARGS "@gt 50" '
        '"id:920380,phase:2,block,severity:CRITICAL,'
        'tag:\'attack-protocol\'"\n'),
    "cmdline": (
        'SecRule ARGS "@rx (?i)(?:;|\\|)\\s*(?:cat|wget|curl)\\b" '
        '"id:932100,phase:2,block,t:cmdLine,severity:CRITICAL,'
        'tag:\'attack-rce\'"\n'
        'SecRule ARGS "@rx \\$\\{jndi:" '
        '"id:944150,phase:2,block,t:lowercase,severity:CRITICAL,'
        'tag:\'attack-java\'"\n'),
}


def _both(text):
    base = RULES_DIR / "data"
    from ingress_plus_tpu.compiler.sigpack import RULES_DIR as JAX_RULES

    return (parse_seclang(text, base_dir=base),
            jax_parse(text, base_dir=JAX_RULES / "data"))


@pytest.mark.parametrize("reduction", ["default", "off"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_small_sources_compile_identically(name, reduction, tmp_path):
    ours, theirs = _both(SOURCES[name])
    assert len(ours) == len(theirs) > 0
    if reduction == "off":
        got = compile_ruleset(ours, reduction=treduce.ReductionConfig.off())
        want = jax_compile(theirs, reduction=jreduce.ReductionConfig.off())
    else:
        got, want = compile_ruleset(ours), jax_compile(theirs)
    assert_same_pack(got, want)
    assert_same_save(got, want, tmp_path)


def test_sources_exercise_what_they_name():
    """Each small source compiles into the feature it stands for."""
    def cr(name):
        return compile_ruleset(_both(SOURCES[name])[0])

    assert cr("ctl").ctl_specs
    assert cr("anomaly").anomaly_threshold == 7
    pm = cr("pm")
    assert {m.confirm["op"] for m in pm.rules} == {"pm"}
    neg = cr("negated")
    assert any(not m.has_prefilter for m in neg.rules)
    assert cr("paranoia").rule_paranoia.max() == 3
    assert any(not m.has_prefilter for m in cr("comment_base64").rules)
    assert any(not m.has_prefilter for m in cr("unsupported_regex").rules)
    assert cr("chain").rules[0].confirm.get("chain")


def test_save_load_round_trips_across_packages(tmp_path):
    ours, theirs = _both(SOURCES["ctl"] + SOURCES["anomaly"].replace(
        "942100", "942105"))
    got, want = compile_ruleset(ours), jax_compile(theirs)
    got.save(tmp_path / "port")
    want.save(tmp_path / "jax")
    assert_same_pack(JaxRuleset.load(tmp_path / "port"), want)
    assert_same_pack(CompiledRuleset.load(tmp_path / "jax"), got)
    assert_same_pack(CompiledRuleset.load(tmp_path / "port"), want)


def test_measured_profile_identical_after_the_same_traffic():
    """``MeasuredProfile.from_rule_stats(...).to_json()`` of both
    packages' pipelines after the same requests: byte-identical, once
    the one measured column (confirm nanoseconds) is the same."""
    from ingress_plus_tpu.models.pipeline import (
        DetectionPipeline as JaxPipeline,
    )
    from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    ours, theirs = _both(SOURCES["plain"] + SOURCES["cmdline"])
    tp = DetectionPipeline(compile_ruleset(ours), device="cpu")
    jp = JaxPipeline(jax_compile(theirs), scan_impl="pair")
    tp.detect([lr.request for lr in generate_corpus(n=48, seed=5)])
    jp.detect([lr.request for lr in jax_corpus(n=48, seed=5)])
    tp.rule_stats.confirm_ns[:] = jp.rule_stats.confirm_ns
    got = MeasuredProfile.from_rule_stats(tp.rule_stats).to_json()
    want = JaxProfile.from_rule_stats(jp.rule_stats).to_json()
    assert got == want
    body = json.loads(got)
    assert body["requests"] == 48 and body["rules"]
