"""A second witness for the plain reference: the JAX package's own
pipeline and stream engine, on the CPU, on the same seeded requests and
uploads and the same committed pack.

The reference's host prep, stream normalization and confirm follow the
port's modules, so a fault the port carries in those layers would pass
the port-against-reference tests unseen; the JAX package, the design
the port was made from, is a witness that shares none of the port's
code.  It runs in a child process of its own: the benchmark's runs
refuse a process that has loaded JAX, and the harness's tests run here
in one process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from wafbench import gen
from wafbench.manifest import ROOT
from wafbench.reference.verdict import Reference
from wafbench.wire import decode_request

PACK = str(ROOT / "ingress_plus_tpu_torch" / "packs" / "crs_bundled")
SEED = 2**31 + 4409
N_WEB = 256
#: the stream mix at a test's size: one block of each body shape, one
#: upload of each with its planted attack, 8 KiB chunks as served
UPLOADS = dict(gen.load_mix("1mib.closed8"), body_bytes=24576, block=8,
               attack_fraction=0.5)
N_UPLOADS = 8

#: the JAX side: the same units, the package's own request type,
#: pipeline and stream engine; one JSON verdict list per kind
_WITNESS = textwrap.dedent("""
    import dataclasses, json, sys
    from ingress_plus_tpu.compiler.ruleset import CompiledRuleset
    from ingress_plus_tpu.models.pipeline import DetectionPipeline
    from ingress_plus_tpu.serve import normalize as jn
    from ingress_plus_tpu.serve.stream import StreamEngine
    from wafbench import gen
    from wafbench.wire import decode_request

    pack, seed, n_web, uploads, n_up = json.loads(sys.argv[1])

    def req(r):
        return jn.Request(**{f.name: getattr(r, f.name)
                             for f in dataclasses.fields(r)})

    def out(v):
        return {"attack": v.attack, "blocked": v.blocked,
                "fail_open": v.fail_open, "score": v.score,
                "classes": sorted(v.classes), "rule_ids": sorted(v.rule_ids)}

    pipe = DetectionPipeline(CompiledRuleset.load(pack))
    web = gen.Traffic(gen.load_mix("web-mix.closed32"), seed)
    reqs = [req(decode_request(web.unit(i).frames[0])[2])
            for i in range(n_web)]
    got_web = [out(v) for v in pipe.detect(reqs)]
    eng = StreamEngine(pipe)
    up = gen.Traffic(uploads, seed)
    got_up = []
    for i in range(n_up):
        u = up.unit(i)
        st = eng.begin(req(decode_request(u.frames[0])[2]))
        st.base_hits = pipe.prefilter([st.request])[0]
        for c in u.chunks:
            eng.scan(st.feed(c))
        eng.scan(st.flush())
        got_up.append(out(eng.finish(st)))
    print(json.dumps([got_web, got_up]))
""")


def _plain(v: dict) -> dict:
    return dict(v, classes=sorted(v["classes"]),
                rule_ids=sorted(v["rule_ids"]))


@pytest.fixture(scope="module")
def witness():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    arg = json.dumps([PACK, SEED, N_WEB, UPLOADS, N_UPLOADS])
    done = subprocess.run([sys.executable, "-c", _WITNESS, arg], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref():
    return Reference(PACK)


def test_reference_equals_the_jax_pipeline_on_web_requests(witness, ref):
    t = gen.Traffic(gen.load_mix("web-mix.closed32"), SEED)
    reqs = [decode_request(t.unit(i).frames[0])[2] for i in range(N_WEB)]
    want = [_plain(v) for v in ref.verdicts(reqs)]
    assert sum(v["attack"] for v in want) > 20
    assert want == witness[0]


def test_reference_equals_the_jax_stream_engine_on_uploads(witness, ref):
    t = gen.Traffic(UPLOADS, SEED)
    want = []
    for i in range(N_UPLOADS):
        u = t.unit(i)
        want.append(_plain(ref.upload_verdict(
            decode_request(u.frames[0])[2], u.chunks)))
    assert sum(v["attack"] for v in want) >= N_UPLOADS // 2
    assert want == witness[1]
