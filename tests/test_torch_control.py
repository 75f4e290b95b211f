"""The port's controller render layer against the JAX package's, on the CPU.

- The JAX package's own ``tests/test_control.py``, every test and every
  parametrised case, runs against the port (``tests/torch_ported_tests.py``
  rewrites the package name; nothing is left out).
- Config #4 of BASELINE.json (``chip_smoke.config4_manifests``: 256
  Ingresses in 64 namespaces, 16 with an ACL, and its ConfigMap) goes
  through both packages: the models are equal field for field, the tenant
  and ACL tables equal, the rendered nginx.conf equal byte for byte but
  for its generator line, the sync actions and the pinned push payloads
  equal over a reload → dynamic → noop sequence, admission reviews equal
  on a good and four broken candidates, and the tenant masks equal on
  each package's compile of ``rules/crs``.
- End to end: a port CPU server (``--platform cpu``, one torch thread,
  the three rules of ``test_control.py``) takes 16 Ingresses' tenant
  table and ACLs from the port's ``SyncController`` over HTTP; its wire
  verdicts equal the JAX ``DetectionPipeline``'s under the same masks and
  ACLs, before and after a ``dynamic`` re-sync.  A push to a dead port
  backs off as the JAX controller's does.
- The port renders only ``detect_tpu*`` directives the shared nginx
  module (``native/shim/ngx_http_detect_tpu_module.c``) defines.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.seclang import load_seclang_dir as jax_load_dir
from ingress_plus_tpu.compiler.seclang import parse_seclang as jax_parse
from ingress_plus_tpu.control import admission as jadm
from ingress_plus_tpu.control import model as jmodel
from ingress_plus_tpu.control import objects as jobj
from ingress_plus_tpu.control import sync as jsync
from ingress_plus_tpu.control import template as jtpl
from ingress_plus_tpu.control.config import GlobalConfig as JaxGlobalConfig
from ingress_plus_tpu.models.acl import AclStore as JaxAclStore
from ingress_plus_tpu.models.pipeline import DetectionPipeline as JaxPipeline
from ingress_plus_tpu.serve.normalize import Request as JaxRequest
from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir
from ingress_plus_tpu_torch.control import admission as tadm
from ingress_plus_tpu_torch.control import model as tmodel
from ingress_plus_tpu_torch.control import objects as tobj
from ingress_plus_tpu_torch.control import sync as tsync
from ingress_plus_tpu_torch.control import template as ttpl
from ingress_plus_tpu_torch.control.config import GlobalConfig
from ingress_plus_tpu_torch.serve.client import drive
from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.serve.protocol import encode_request

from torch_ported_tests import ported

REPO = Path(__file__).resolve().parent.parent
PREFIX = "nginx.ingress.kubernetes.io/"

globals().update(ported("test_control", exclude={}))


def _both(revision, sidecar="127.0.0.1:9901"):
    """Config #4 of one revision as each package's objects:
    {"port": (ingresses, configmap), "jax": (...)}."""
    items, cm = chip_smoke.config4_manifests(revision, sidecar)
    return {name: ([mod.Ingress.from_dict(d) for d in items],
                   mod.ConfigMap.from_dict(cm))
            for name, mod in (("port", tobj), ("jax", jobj))}


def _lines_but_first(text):
    return text.split("\n")[1:]


# ------------------------------------------------ config #4, both packages

@pytest.mark.parametrize("revision", [1, 2])
def test_config4_model_tables_and_render_equal(revision):
    both = _both(revision)
    g = GlobalConfig.from_configmap(both["port"][1])
    jg = JaxGlobalConfig.from_configmap(both["jax"][1])
    assert dataclasses.asdict(g) == dataclasses.asdict(jg)
    cfg = tmodel.build_configuration(both["port"][0], g)
    jcfg = jmodel.build_configuration(both["jax"][0], jg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(cfg.servers) == 256 and cfg.errors == []
    assert cfg.tenant_tags() == jcfg.tenant_tags()
    assert sorted(cfg.tenant_tags()) == list(range(1, 257))
    assert len(set(cfg.tenant_tags().values())) == 64
    assert cfg.tenant_acls() == jcfg.tenant_acls()
    assert len(cfg.tenant_acls()) == 16
    text, jtext = ttpl.render(cfg, g), jtpl.render(jcfg, jg)
    assert _lines_but_first(text) == _lines_but_first(jtext)
    assert text.split("\n")[0] == \
        "# generated by ingress_plus_tpu_torch.control — do not edit"
    assert jtext.split("\n")[0] == \
        "# generated by ingress_plus_tpu.control — do not edit"
    assert tadm.lint_rendered(text) == [] == jadm.lint_rendered(jtext)
    assert text.count("detect_tpu_tenant ") == sum(
        len(s.locations) for s in cfg.servers)


def test_config4_sync_actions_and_payloads_equal():
    """reload → dynamic → noop in both packages (push=False), then the
    same sequence with a recording ``_post``: equal actions, errors,
    POSTs and pinned channel payloads at every step."""
    seq = [_both(1), _both(2), _both(2)]
    sc, jsc = tsync.SyncController(), jsync.SyncController()
    actions = []
    for step in seq:
        r = sc.sync(*step["port"], push=False)
        jr = jsc.sync(*step["jax"], push=False)
        assert r.action == jr.action and r.errors == jr.errors == []
        assert r.rendered.split("\n")[1:] == jr.rendered.split("\n")[1:]
        actions.append(r.action)
    assert actions == ["reload", "dynamic", "noop"]

    sc, jsc = tsync.SyncController(), jsync.SyncController()
    posts, jposts = [], []
    sc._post = lambda path, obj: posts.append((path, obj)) or True
    jsc._post = lambda path, obj: jposts.append((path, obj)) or True
    for step in seq:
        r = sc.sync(*step["port"])
        jr = jsc.sync(*step["jax"])
        assert (r.action, r.pushed_tenants, r.pushed_acls, r.errors) == \
            (jr.action, jr.pushed_tenants, jr.pushed_acls, jr.errors)
        for name in ("tenants", "acl"):
            assert sc._channels[name].payload == jsc._channels[name].payload
        assert sc.retry_state() == jsc.retry_state()
    assert posts == jposts
    assert [p for p, _ in posts] == ["/configuration/tenants",
                                     "/configuration/acl"] * 2
    assert posts[1][1]["acls"] == chip_smoke.CONFIG4_ACLS[1]
    assert len(posts[1][1]["tenant_acl"]) == 16
    assert len(posts[2][1]) == 256


def _candidate(mod, annotations):
    """Config #4's first Ingress with ``annotations`` added."""
    d = json.loads(json.dumps(chip_smoke.config4_manifests(1)[0][0]))
    d["metadata"]["annotations"].update(
        {PREFIX + k: v for k, v in annotations.items()})
    return mod.Ingress.from_dict(d)


@pytest.mark.parametrize("annotations", [
    {},                                               # good
    {"wallarm-block-page": "/x;rm -rf"},              # blocklisted value
    {"detection-backend": "gpu"},                     # bad enum
    {"detection-paranoia-level": "five"},             # bad int
    {"wallarm-acl": "ghost"},                         # ACL with no content
], ids=["good", "blocklisted", "bad-enum", "bad-int", "conflicting-acl"])
def test_config4_admission_equal(annotations):
    """``validate`` of a candidate against the 256 existing Ingresses gives
    the same review in both packages.  The ACL case names an ACL the
    ConfigMap has no content for: neither package's admission checks ACL
    content (both admit it), and both syncs report it as a model error."""
    both = _both(1)
    cand = _candidate(tobj, annotations)
    jcand = _candidate(jobj, annotations)
    r = tadm.validate(cand, both["port"][0], both["port"][1])
    jr = jadm.validate(jcand, both["jax"][0], both["jax"][1])
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    assert r.allowed == (annotations in ({}, {"wallarm-acl": "ghost"}))
    if annotations.get("wallarm-acl") == "ghost":
        ings = [i for i in both["port"][0] if i.key != cand.key] + [cand]
        jings = [i for i in both["jax"][0] if i.key != jcand.key] + [jcand]
        got = tsync.SyncController().sync(ings, both["port"][1], push=False)
        want = jsync.SyncController().sync(jings, both["jax"][1],
                                           push=False)
        assert got.errors == want.errors
        assert any("ghost" in e for e in got.errors)


def test_config4_tenant_masks_equal_on_crs():
    cr = compile_ruleset(load_seclang_dir(
        REPO / "ingress_plus_tpu_torch" / "rules" / "crs"))
    jcr = jax_compile(jax_load_dir(REPO / "ingress_plus_tpu" / "rules" /
                                   "crs"))
    assert cr.n_rules == jcr.n_rules == 252
    for revision in (1, 2):
        both = _both(revision)
        tags = tmodel.build_configuration(
            both["port"][0],
            GlobalConfig.from_configmap(both["port"][1])).tenant_tags()
        masks = tsync.tenant_masks(cr, tags)
        assert masks.shape == (257, 252)
        assert np.array_equal(masks, jsync.tenant_masks(jcr, tags))
        assert masks[0].all() and not masks[1:].all()


# -------------------------------------------------------- end to end

RULES = """
SecRule ARGS "@rx (?i)union\\s+select" "id:1,phase:2,block,severity:CRITICAL,tag:'attack-sqli'"
SecRule ARGS "@rx (?i)<script" "id:2,phase:2,block,severity:CRITICAL,tag:'attack-xss'"
SecRule ARGS "@rx /etc/passwd" "id:3,phase:2,block,severity:CRITICAL,tag:'attack-lfi'"
"""
E2E_TAGS = ("attack-sqli", "attack-xss", "attack-lfi")


def _e2e_manifests(revision, sidecar):
    """16 Ingresses (4 namespaces x 4) with 1-2 of the three rules' tags
    per namespace, 4 with an ACL, and a ConfigMap with two ACLs; in
    revision 2 two namespaces swap tags and the deny range narrows."""
    ns_tags = [["attack-sqli"], ["attack-xss", "attack-lfi"],
               ["attack-lfi"], ["attack-sqli", "attack-xss"]]
    if revision == 2:
        ns_tags[0], ns_tags[2] = ["attack-xss"], ["attack-sqli"]
    items = []
    for i in range(16):
        ns, k = divmod(i, 4)
        ann = {PREFIX + "wallarm-mode": "block",
               PREFIX + "detection-backend": "tpu",
               PREFIX + "detection-rule-tags": ",".join(ns_tags[ns])}
        if k == 1:
            ann[PREFIX + "wallarm-acl"] = "edge" if ns % 2 else "partners"
        items.append({
            "metadata": {"name": "app-%d" % k, "namespace": "ns-%d" % ns,
                         "annotations": ann},
            "spec": {"rules": [{"host": "app%d.ns-%d.example.com" % (k, ns),
                                "http": {"paths": [{
                                    "path": "/", "pathType": "Prefix",
                                    "backend": {"service": {
                                        "name": "app", "port": {
                                            "number": 80}}}}]}}]}})
    acls = {"edge": {"deny": ["203.0.113.0/24" if revision == 1
                              else "203.0.113.0/25"]},
            "partners": {"allow": ["192.0.2.0/24"]}}
    return items, {"data": {"detection-backend": "tpu",
                            "enable-detection": "true",
                            "default-mode": "block",
                            "sidecar-http": sidecar,
                            "acls": json.dumps(acls, sort_keys=True)}}


def _e2e_requests():
    """Each of the three attacks and a benign request, for every tenant
    0..16 and from three sources (ACL deny range, allow range, other)."""
    payloads = ["1%27+union+select+password+from+users--",
                "%3Cscript%3Ealert(1)%3C/script%3E", "../../etc/passwd",
                "hello+world"]
    out = []
    for t in range(17):
        for j, p in enumerate(payloads):
            ip = ("203.0.113.%d" % (200 - t), "192.0.2.%d" % (t + 1),
                  "10.1.2.%d" % (t + 1))[(t + j) % 3]
            out.append(dict(uri="/search?q=%s&t=%d" % (p, t),
                            headers={"host": "app1.ns-1.example.com"},
                            tenant=t, client_ip=ip,
                            request_id="e2e-%d-%d" % (t, j)))
    return out


@pytest.fixture(scope="module")
def cpu_server(tmp_path_factory):
    """A port CPU server on the three rules, one torch thread."""
    tmp = tmp_path_factory.mktemp("ctl")
    rules = tmp / "rules"
    rules.mkdir()
    (rules / "rules.conf").write_text(RULES)
    sock, port = str(tmp / "serve.sock"), chip_smoke.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    log = open(tmp / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ingress_plus_tpu_torch.serve", "--socket",
         sock, "--http-port", str(port), "--platform", "cpu", "--scan-impl",
         "pair", "--rules-dir", str(rules), "--no-warmup",
         "--hard-deadline-ms", "30000"],
        cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 240
        while True:
            assert proc.poll() is None, (tmp / "serve.log").read_text()
            assert time.time() < deadline, (tmp / "serve.log").read_text()
            try:
                with urllib.request.urlopen(
                        "http://127.0.0.1:%d/readyz" % port,
                        timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.2)
        yield sock, port
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()


def _wire(sock, reqs):
    units = [(i + 1, [encode_request(Request(**r), i + 1, mode=2)])
             for i, r in enumerate(reqs)]
    out = drive(sock, units, 2, 8, timeout=120)
    return [json.dumps([out[i + 1][0][k] for k in ("attack", "blocked")]
                       + [sorted(out[i + 1][0]["rule_ids"]),
                          out[i + 1][0]["score"], out[i + 1][0]["classes"]])
            for i in range(len(reqs))]


def _jax_keys(jcr, reqs, tags, acl_payload):
    store = JaxAclStore()
    store.swap(acl_payload["acls"])
    pl = JaxPipeline(jcr, scan_impl="pair", fail_open=False,
                     tenant_rule_mask=jsync.tenant_masks(jcr, tags),
                     acl_store=store,
                     tenant_acl={int(t): n for t, n in
                                 acl_payload["tenant_acl"].items()})
    return [json.dumps([v.attack, v.blocked, sorted(v.rule_ids), v.score,
                        v.classes])
            for v in pl.detect([JaxRequest(**r) for r in reqs])]


def test_sync_over_http_gives_jax_verdicts(cpu_server):
    sock, port = cpu_server
    sidecar = "127.0.0.1:%d" % port
    jcr = jax_compile(jax_parse(RULES))
    reqs = _e2e_requests()
    sc = tsync.SyncController()
    got_keys = []
    for revision, action in ((1, "reload"), (2, "dynamic")):
        items, cm = _e2e_manifests(revision, sidecar)
        r = sc.sync([tobj.Ingress.from_dict(d) for d in items],
                    tobj.ConfigMap.from_dict(cm))
        assert r.action == action and r.errors == []
        assert r.pushed_tenants and r.pushed_acls
        with urllib.request.urlopen(
                "http://%s/configuration" % sidecar, timeout=30) as resp:
            conf = json.loads(resp.read())
        assert conf["tenants"] == 17 and conf["acls"] == ["edge", "partners"]
        tags = r.configuration.tenant_tags()
        got = _wire(sock, reqs)
        assert got == _jax_keys(jcr, reqs, tags, sc._channels["acl"].payload)
        got_keys.append(got)
    # the masks and ACLs decide: some attacks pass, an ACL blocks, and the
    # dynamic re-sync changes verdicts
    first = [json.loads(k) for k in got_keys[0]]
    assert any(k[1] for k in first) and any(not k[0] for k in first[::4])
    assert any("acl" in k[4] and k[1] for k in first)
    assert got_keys[0] != got_keys[1]
    assert sc.sync([tobj.Ingress.from_dict(d) for d in items],
                   tobj.ConfigMap.from_dict(cm)).action == "noop"


def test_dead_port_backs_off_as_jax():
    """Against a port nothing listens on, both controllers' real ``_post``
    fails; the retry ladder (RETRY_BASE_S doubling, capped at
    RETRY_MAX_S), the errors and the channels' state agree tick by
    tick."""
    assert (tsync.RETRY_BASE_S, tsync.RETRY_MAX_S) == \
        (jsync.RETRY_BASE_S, jsync.RETRY_MAX_S)
    dead = "127.0.0.1:%d" % chip_smoke.free_port()
    items, cm = _e2e_manifests(1, dead)
    sc, jsc = tsync.SyncController(), jsync.SyncController()
    clock = [100.0]
    sc._now = jsc._now = lambda: clock[0]
    waits = []
    for tick in range(9):
        r = sc.sync([tobj.Ingress.from_dict(d) for d in items],
                    tobj.ConfigMap.from_dict(cm))
        jr = jsc.sync([jobj.Ingress.from_dict(d) for d in items],
                      jobj.ConfigMap.from_dict(cm))
        assert (r.action, r.pushed_tenants, r.errors) == \
            (jr.action, jr.pushed_tenants, jr.errors)
        assert sc.retry_state() == jsc.retry_state()
        ch = sc._channels["tenants"]
        assert ch.dirty and ch.attempts == tick + 1
        waits.append(ch.next_retry - clock[0])
        clock[0] = ch.next_retry
    assert waits == [min(2.0 ** k, 60.0) for k in range(9)]


# ------------------------------------------------------- shim lockstep

def test_nginx_module_directives_match_port_template():
    """Every ``detect_tpu*`` directive the port renders (one location
    with every option set, and all of config #4) is in the shared nginx
    module's command table."""
    from ingress_plus_tpu_torch.control.annotations import DetectionConfig

    module_src = (REPO / "native" / "shim" /
                  "ngx_http_detect_tpu_module.c").read_text()
    det = DetectionConfig(detection_backend="tpu", mode="block", tenant=7,
                          acl="edge", block_page="/blocked.html",
                          parse_response=True, parse_websocket=True,
                          parser_disable=["xml"])
    conf = tmodel.Configuration(servers=[tmodel.Server(
        hostname="x.test", locations=[tmodel.Location(
            path="/", path_type="Prefix",
            backend=tobj.Backend(service="app", port=80),
            detection=det, ingress_key="default/app")])])
    both = _both(1)
    g = GlobalConfig.from_configmap(both["port"][1])
    texts = [ttpl.render(conf, GlobalConfig()),
             ttpl.render(tmodel.build_configuration(both["port"][0], g), g)]
    seen = set()
    for text in texts:
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("detect_tpu"):
                seen.add(line.split()[0].rstrip(";"))
    assert len(seen) >= 10
    for directive in sorted(seen):
        assert 'ngx_string("%s")' % directive in module_src, directive
