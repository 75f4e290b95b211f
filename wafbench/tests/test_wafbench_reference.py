"""The plain reference against the port's CPU pipeline, the traffic
copies against their originals, the roofline's work count, the control
and the import rules."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest

from wafbench import check, corpus, gen, stream_corpus
from wafbench.manifest import ROOT
from wafbench.reference.verdict import Reference, verdict_dict
from wafbench.wire import decode_request

PACK = str(ROOT / "ingress_plus_tpu_torch" / "packs" / "crs_bundled")
SEED = 2**31 + 977


def _port_request(req, pn):
    """The same request in the port's own type."""
    return pn.Request(**{f.name: getattr(req, f.name)
                         for f in dataclasses.fields(req)})


@pytest.fixture(scope="module")
def port():
    from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline

    return CompiledRuleset.load(PACK), DetectionPipeline


@pytest.fixture(scope="module")
def ref():
    return Reference(PACK)


def _web_units(n):
    t = gen.Traffic(gen.load_mix("web-mix.closed32"), SEED)
    return [t.unit(i) for i in range(n)]


def test_reference_equals_port_pipeline(port, ref):
    from ingress_plus_tpu_torch.serve import normalize as pn

    cr, Pipeline = port
    reqs = [decode_request(u.frames[0])[2] for u in _web_units(256)]
    want = ref.verdicts(reqs)
    got = Pipeline(cr, device="cpu").detect(
        [_port_request(r, pn) for r in reqs])
    assert sum(v["attack"] for v in want) > 20
    for w, g in zip(want, got):
        assert w == verdict_dict(g.attack, g.blocked, g.fail_open, g.score,
                                 g.classes, g.rule_ids)


def test_reference_uploads_equal_port_stream_engine(port, ref):
    from ingress_plus_tpu_torch.serve import normalize as pn
    from ingress_plus_tpu_torch.serve.stream import StreamEngine

    cr, Pipeline = port
    mix = dict(gen.load_mix("1mib.closed8"), body_bytes=24576,
               chunk_bytes=8192, attack_fraction=1.0)
    t = gen.Traffic(mix, SEED)
    units = [t.unit(i) for i in range(2)]
    eng = StreamEngine(Pipeline(cr, device="cpu"))
    for u in units:
        meta = decode_request(u.frames[0])[2]
        want = ref.upload_verdict(meta, u.chunks)
        st = eng.begin(_port_request(meta, pn))
        st.base_hits = eng.pipeline.prefilter([st.request])[0]
        for c in u.chunks:
            eng.scan(st.feed(c))
        eng.scan(st.flush())
        g = eng.finish(st)
        assert want["attack"]
        assert want == verdict_dict(g.attack, g.blocked, g.fail_open,
                                    g.score, g.classes, g.rule_ids)


def test_corpus_copy_gives_the_original_requests():
    from ingress_plus_tpu_torch.utils import corpus as orig

    a = corpus.generate_corpus(n=300, seed=SEED)
    b = orig.generate_corpus(n=300, seed=SEED)
    it = gen.iter_corpus(0.2, SEED)
    for x, y in zip(a, b):
        assert dataclasses.asdict(x.request) == dataclasses.asdict(y.request)
        assert dataclasses.asdict(next(it)) == dataclasses.asdict(x.request)


def test_stream_corpus_copy_gives_the_original_cases():
    from ingress_plus_tpu_torch.utils import stream_corpus as orig

    for x, y in zip(stream_corpus.stream_cases(20000, 4096, SEED),
                    orig.stream_cases(20000, 4096, SEED)):
        assert (x.name, x.body, x.attack) == (y.name, y.body, y.attack)
        assert dataclasses.asdict(x.meta) == dataclasses.asdict(y.meta)


def test_traffic_is_the_same_for_a_seed_and_never_repeats():
    a, b = _web_units(2000), _web_units(2000)
    assert [u.frames for u in a] == [u.frames for u in b]
    bodies = [u.frames[0][16:] for u in a]    # past magic, length, req_id
    assert len(set(bodies)) == len(bodies)


@pytest.mark.parametrize("impl", ["pair", "take"])
def test_roofline_work_is_the_programs_rows_for_each_impl(port, impl):
    """The work the roofline counts (the reference's unpadded rows) is
    what the program scans, whichever impl scans it."""
    from ingress_plus_tpu_torch.serve import normalize as pn

    cr, Pipeline = port
    units = _web_units(128)
    reqs = [decode_request(u.frames[0])[2] for u in units]
    _, work = check.reference_verdicts(
        gen.Traffic(gen.load_mix("web-mix.closed32"), SEED),
        [u.req_id for u in units], PACK)
    pl = Pipeline(cr, device="cpu", scan_impl=impl)
    pl.detect([_port_request(r, pn) for r in reqs])
    assert sum(w[1] for w in work.values()) == pl.stats.row_bytes
    assert sum(w[0] for w in work.values()) == pl.stats.rows


def test_control_is_not_correct(ref):
    """The control, the reference's prefilter candidates served as the
    verdict with no confirm (it breaks the configurations' guarantee of
    exact verdicts), fails the comparison at a test's size."""
    units = _web_units(256)
    traffic = gen.Traffic(gen.load_mix("web-mix.closed32"), SEED)
    ids = [u.req_id for u in units]
    control, _ = check.reference_verdicts(traffic, ids, PACK, confirm=False)
    j = check.judge(traffic, ids, control, PACK)
    assert not j.correct and j.numbers()["wrong"] > 0
    sound = check.judge(traffic, ids, j.want, PACK)
    assert sound.correct


def test_confirm_workers_agree_and_leave_no_process(leaves_no_process):
    """The reference's confirm in worker processes gives the verdicts it
    gives in this process, and every worker has ended when it returns."""
    traffic = gen.Traffic(gen.load_mix("web-mix.closed32"), SEED)
    ids = list(range(1, 41))
    inline, _ = check.reference_verdicts(traffic, ids, PACK)
    pooled, _ = check.reference_verdicts(traffic, ids, PACK, workers=3)
    assert pooled == inline and len(inline) == 40


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    tops = _modules_after(
        "import wafbench.run, wafbench.loadgen, wafbench.check, "
        "wafbench.devtrace, wafbench.control\n"
        "from wafbench import manifest\n"
        "man = manifest.load_manifest()\n"
        "for m in man['end_to_end'] + man['per_layer']:\n"
        "    manifest.reader(m['name'])")
    assert not tops & {"jax", "jaxlib", "flax", "ingress_plus_tpu"}


def test_the_reference_imports_nothing_of_the_port():
    tops = _modules_after(
        "import wafbench.reference.verdict, wafbench.reference.scan")
    assert not tops & {"jax", "jaxlib", "flax", "ingress_plus_tpu",
                       "ingress_plus_tpu_torch"}
