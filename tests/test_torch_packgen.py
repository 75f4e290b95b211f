"""The port's ``compiler/packgen.py`` against the JAX package's, on the
CPU: the same ``(base, factor)`` gives the same rule list, field for
field, and the port's compile of it equals the JAX compile array for
array (``test_torch_compiler.assert_same_pack``).  Tolerance: none.
"""

import dataclasses

import pytest

from ingress_plus_tpu.compiler import packgen as jax_packgen
from ingress_plus_tpu.compiler.ruleset import compile_ruleset as jax_compile
from ingress_plus_tpu.compiler.sigpack import (
    load_bundled_rules as jax_bundled,
)
from ingress_plus_tpu_torch.compiler import compile_ruleset, packgen
from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
from test_torch_compiler import assert_same_pack


@pytest.fixture(scope="module")
def bases():
    return load_bundled_rules(), jax_bundled()


def _fields(rules):
    return [dataclasses.asdict(r) for r in rules]


@pytest.mark.parametrize("factor", [0.1, 0.5, 1.0, 1.25, 2.0, 3.0])
def test_same_rules_as_jax(bases, factor):
    base, jbase = bases
    got = packgen.scale_rules(base, factor)
    want = jax_packgen.scale_rules(jbase, factor)
    assert len(got) == len(want)
    assert _fields(got) == _fields(want)
    if factor > 1:
        assert len(got) == len(base) + round(
            sum(not packgen._is_config_rule(r) for r in base) * (factor - 1))


def test_config_rules_are_the_same(bases):
    base, jbase = bases
    got = [packgen._is_config_rule(r) for r in base]
    assert got == [jax_packgen._is_config_rule(r) for r in jbase]
    assert any(got)
    small = packgen.scale_rules(base, 0.1)
    assert sum(map(packgen._is_config_rule, small)) == sum(got)


@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_same_pack_as_jax(bases, factor):
    base, jbase = bases
    got = compile_ruleset(packgen.scale_rules(base, factor))
    want = jax_compile(jax_packgen.scale_rules(jbase, factor))
    assert_same_pack(got, want)
    if factor == 2.0:
        assert (got.n_rules, got.tables.n_words) == (4018, 285)


def test_factor_must_be_positive(bases):
    for f in (0, -1.0):
        with pytest.raises(ValueError, match="positive"):
            packgen.scale_rules(bases[0], f)
