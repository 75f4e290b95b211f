"""The port's evadecheck and evasion corpus (``analysis/evadecheck.py``,
``utils/evasion.py``), held to the JAX package.

The JAX package's ``tests/test_evadecheck.py`` runs here against the
port, its pipeline a CPU one of the bundled pack.  The cases below hold
the port's report, corpora (by ``request_digest``) and mutation harness
to the JAX package's on the same seeds.
"""

import pytest
from torch_ported_tests import ported

from ingress_plus_tpu_torch.analysis import run_evadecheck
from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.utils import evasion

globals().update(ported("test_evadecheck", exclude={
    "test_native_twin_agrees_on_comment_glue":
        "(a) loads the JAX package's native/confirm build; the port's twin "
        "(csrc/libdetect.cc) is held by test_torch_native_confirm.py",
}))


@pytest.fixture(scope="module")
def pipeline():
    return DetectionPipeline(compile_ruleset(load_bundled_rules()),
                             mode="monitoring", device="cpu")


@pytest.fixture(scope="module")
def jax_pipeline():
    from ingress_plus_tpu.compiler.ruleset import (
        compile_ruleset as jax_compile,
    )
    from ingress_plus_tpu.compiler.sigpack import (
        load_bundled_rules as jax_rules,
    )
    from ingress_plus_tpu.models.pipeline import (
        DetectionPipeline as JaxPipeline,
    )

    return JaxPipeline(jax_compile(jax_rules()), mode="monitoring")


def _port_text(text: str) -> str:
    """A JAX report's text as the port's: its package's paths, and the
    chunk-window message without the JAX package's roadmap reference."""
    return text.replace("ingress_plus_tpu/", "ingress_plus_tpu_torch/") \
        .replace(" (ROADMAP item 3)", "")


def test_evadecheck_report_equals_the_jax_packages():
    from ingress_plus_tpu.analysis import run_evadecheck as jax_evadecheck

    for bl in ("auto", None):
        port, ref = run_evadecheck(baseline_path=bl), jax_evadecheck(
            baseline_path=bl)
        assert len(port.findings) >= 19
        assert port.to_json() == _port_text(ref.to_json())


@pytest.mark.parametrize("seed", [20260730, 7])
def test_evasion_corpus_equals_the_jax_packages(seed):
    from ingress_plus_tpu.utils import evasion as jax_evasion

    port = evasion.generate_evasion(seed=seed)
    ref = jax_evasion.generate_evasion(seed=seed)
    assert len(port) == len(ref) >= 400
    assert evasion.request_digest([s.labeled.request for s in port]) == \
        jax_evasion.request_digest([s.labeled.request for s in ref])
    assert [(s.base_name, s.transforms, s.labeled.attack_class)
            for s in port] == [(s.base_name, s.transforms,
                                s.labeled.attack_class) for s in ref]


@pytest.mark.parametrize("n,seed", [(10_000, 20260731), (500, 3)])
def test_benign_corpus_equals_the_jax_packages(n, seed):
    from ingress_plus_tpu.utils import evasion as jax_evasion

    port = [b.request for b in evasion.generate_benign(n=n, seed=seed)]
    ref = [b.request for b in jax_evasion.generate_benign(n=n, seed=seed)]
    assert len(port) == n
    assert evasion.request_digest(port) == jax_evasion.request_digest(ref)


@pytest.mark.parametrize("family", evasion.MUTATION_FAMILIES)
def test_mutated_corpus_equals_the_jax_packages(family):
    from ingress_plus_tpu.utils import evasion as jax_evasion
    from ingress_plus_tpu.utils.corpus import (
        generate_corpus as jax_corpus,
    )
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    port = generate_corpus(n=300, attack_fraction=0.4, seed=11,
                           payload_mutator=evasion.family_mutator(
                               [family], seed=5))
    ref = jax_corpus(n=300, attack_fraction=0.4, seed=11,
                     payload_mutator=jax_evasion.family_mutator(
                         [family], seed=5))
    assert evasion.request_digest([lr.request for lr in port]) == \
        jax_evasion.request_digest([lr.request for lr in ref])


def test_transforms_equal_the_jax_packages():
    import random

    from ingress_plus_tpu.utils import evasion as jax_evasion

    assert sorted(evasion.TRANSFORMS) == sorted(jax_evasion.TRANSFORMS)
    for name, fn in evasion.TRANSFORMS.items():
        for seed in range(4):
            p = "1' UNION SELECT a FROM b-- <script>alert(1)</script>"
            assert fn(p, random.Random(seed)) == \
                jax_evasion.TRANSFORMS[name](p, random.Random(seed)), name


def test_mutation_harness_equals_the_jax_packages(pipeline, jax_pipeline):
    from ingress_plus_tpu.utils import evasion as jax_evasion

    port = evasion.mutation_harness(pipeline, n=240)
    ref = jax_evasion.mutation_harness(jax_pipeline, n=240)
    assert port == ref
    assert port["corpus"]["attacks"] > 0
