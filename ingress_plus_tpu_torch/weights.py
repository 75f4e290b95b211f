"""Carrying the model across: packs, tables and scoring heads from the
JAX package.

A pack is the JAX package's checkpoint format (``<path>.npz`` +
``<path>.json``, written by its ``CompiledRuleset.save``, and by the
port's, which compiles the same pack).  The bundled OWASP-CRS-shaped pack
is committed in ``packs/crs_bundled``; regenerate it from the repository
root with the JAX package's compiler (the port's gives the same arrays):

    JAX_PLATFORMS=cpu python -c "from ingress_plus_tpu.compiler import compile_ruleset; from ingress_plus_tpu.compiler.sigpack import load_bundled_rules, RULES_DIR; compile_ruleset(load_bundled_rules(), base_path=RULES_DIR / 'crs').save('ingress_plus_tpu_torch/packs/crs_bundled')"

A learned scoring head is the other thing a deployment carries: the
port's ``ScoringHead.load`` reads the JAX package's artifact files, and
``scoring_head_from_jax`` builds one from a JAX head's fields in memory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.learn.head import ScoringHead
from ingress_plus_tpu_torch.models.engine import EngineTables

#: the committed bundled pack (path stem; .npz and .json beside it)
BUNDLED_PACK = Path(__file__).resolve().parent / "packs" / "crs_bundled"

#: build the port's EngineTables from the JAX EngineTables' leaves as
#: numpy arrays (names in EngineTables.LEAVES), so both sides compute from
#: identical tables
engine_tables_from_numpy = EngineTables.from_numpy


def load_pack(path: Union[str, Path] = BUNDLED_PACK) -> CompiledRuleset:
    """Load a pack written in the JAX package's checkpoint format."""
    return CompiledRuleset.load(path)


def scoring_head_from_jax(fields: dict) -> ScoringHead:
    """The port's ``ScoringHead`` from a JAX head's fields (``rule_ids``,
    ``weights`` as numpy arrays, ``bias``, ``threshold``, ``provenance``,
    ``version``), e.g. ``dataclasses.asdict`` of a JAX-trained head.  The
    content hash is checked: a head whose fields do not give the
    version's fingerprint raises ValueError."""
    head = ScoringHead(
        rule_ids=fields["rule_ids"], weights=fields["weights"],
        bias=float(fields["bias"]), threshold=float(fields["threshold"]),
        version=str(fields.get("version", "")),
        provenance=dict(fields.get("provenance", {})))
    head.validate()
    if head.version.startswith("lh-") and \
            head.version != head.fingerprint():
        raise ValueError("scoring-head fields do not match their version: "
                         "%s != %s" % (head.fingerprint(), head.version))
    return head
