"""Carrying the model across: packs and tables from the JAX package.

A pack is the JAX package's checkpoint format (``<path>.npz`` +
``<path>.json``, written by its ``CompiledRuleset.save``).  The bundled
OWASP-CRS-shaped pack is committed in ``packs/crs_bundled``; regenerate
it from the repository root with the JAX package's compiler:

    JAX_PLATFORMS=cpu python -c "from ingress_plus_tpu.compiler import compile_ruleset; from ingress_plus_tpu.compiler.sigpack import load_bundled_rules, RULES_DIR; compile_ruleset(load_bundled_rules(), base_path=RULES_DIR / 'crs').save('ingress_plus_tpu_torch/packs/crs_bundled')"
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
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
