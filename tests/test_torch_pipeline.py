"""The port's request→verdict pipeline against the JAX package's, on the
CPU, on the committed bundled pack.

The JAX side is ``DetectionPipeline(scan_impl="pair")``; the port runs its
plain scan on ``device="cpu"``.  Tolerance: none — verdict fields and
match points must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ingress_plus_tpu.compiler.ruleset import CompiledRuleset as JaxRuleset
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu.utils.benign_fixtures import fixture_requests
from ingress_plus_tpu.utils.corpus import generate_corpus as jax_corpus
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.corpus import generate_corpus
from ingress_plus_tpu_torch.weights import BUNDLED_PACK, load_pack

SEED = 20260729
ACLS = {"main": {"deny": ["203.0.113.0/28"],
                 "allow": ["198.51.100.0/24"],
                 "greylist": ["192.0.2.0/24"]}}
IPS = ("203.0.113.5", "198.51.100.7", "192.0.2.9", "10.1.2.3", "")


def _jax_requests():
    reqs = [lr.request for lr in jax_corpus(n=96, seed=SEED, tenants=2)]
    reqs += fixture_requests()
    for i, r in enumerate(reqs):
        r.client_ip = IPS[i % len(IPS)]
        r.request_id = r.request_id or "fixture-%d" % i
    return reqs


def _port_request(r: JaxRequest) -> Request:
    return Request(**{f.name: getattr(r, f.name)
                      for f in dataclasses.fields(JaxRequest)})


@pytest.fixture(scope="module")
def pipelines():
    jcr = JaxRuleset.load(BUNDLED_PACK)
    cr = load_pack()
    # tenant 1 loses every sqli rule (an EP rule-subset mask)
    mask = np.ones((2, cr.n_rules), bool)
    mask[1] = cr.rule_class != 8
    kw = dict(fail_open=False, tenant_rule_mask=mask, default_acl="main")
    jpl = JaxPipeline(jcr, scan_impl="pair", **kw)
    tpl = DetectionPipeline(cr, device=torch.device("cpu"), **kw)
    jpl.acl_store.swap(ACLS)
    tpl.acl_store.swap(ACLS)
    return jpl, tpl


def _key(v):
    return (v.request_id, v.attack, v.blocked, sorted(v.rule_ids), v.score,
            v.classes, v.matches, v.fail_open, v.generation)


def test_port_corpus_equals_jax_corpus():
    got = generate_corpus(n=64, seed=SEED, tenants=2)
    want = jax_corpus(n=64, seed=SEED, tenants=2)
    for g, w in zip(got, want):
        assert (g.is_attack, g.attack_class) == (w.is_attack, w.attack_class)
        assert dataclasses.asdict(g.request) == dataclasses.asdict(w.request)


@pytest.mark.parametrize("mode", ["block", "monitoring"])
def test_verdicts_equal_jax(pipelines, mode):
    jpl, tpl = pipelines
    jpl.mode = tpl.mode = mode
    jreqs = _jax_requests()
    treqs = [_port_request(r) for r in jreqs]
    want, got = [], []
    for i in range(0, len(jreqs), 64):
        want += jpl.detect(jreqs[i:i + 64])
        got += tpl.detect(treqs[i:i + 64])
    assert [_key(v) for v in got] == [_key(v) for v in want]
    assert any(v.attack for v in got)
    assert any("acl" in v.classes for v in got)
    if mode == "block":
        assert any(v.blocked for v in got)
    else:
        assert not any(v.blocked for v in got)


def test_tenant_mask_changes_verdicts(pipelines):
    """The mask is live: an sqli attack on tenant 1 loses its sqli hits."""
    _, tpl = pipelines
    tpl.mode = "block"
    atk = Request(uri="/search?q=1'+UNION+SELECT+password+FROM+users--",
                  headers={"host": "a.example"}, request_id="sqli")
    v0 = tpl.detect([atk])[0]
    atk.tenant = 1
    v1 = tpl.detect([atk])[0]
    assert "sqli" in v0.classes and "sqli" not in v1.classes


def test_empty_and_fail_open(pipelines):
    _, tpl = pipelines
    assert tpl.detect([]) == []
    cr = tpl.ruleset
    broken = DetectionPipeline(cr, engine=tpl.engine, fail_open=True)
    broken.engine = None                      # any engine error fails open
    v = broken.detect([Request(request_id="x")])[0]
    assert v.fail_open and not v.blocked and broken.stats.fail_open == 1
