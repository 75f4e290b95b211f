"""Ruleset compiler: SecLang/regex → bit-parallel NFA tables.

The port of ``ingress_plus_tpu/compiler`` (pure numpy, array for array
the same compile):

    SecLang rules (CRS v3 shaped) ──seclang.py──▶ Rule objects
    Rule regex ──regex_ast.py──▶ AST
    AST ──factors.py──▶ mandatory factor groups (class sequences)
    factors ──bitap.py──▶ packed shift-and tables (uint32 words)
    everything ──ruleset.py──▶ CompiledRuleset artifact (save/load: the
                               versioned, hot-swappable checkpoint)

The CUDA kernels (ops/) evaluate the bitap prefilter exactly; full-PCRE
semantics (backrefs, lookaround, anchors) are recovered by the CPU
confirm stage (models/confirm.py) that runs only on prefilter hits.
"""

from ingress_plus_tpu_torch.compiler.regex_ast import (  # noqa: F401
    RegexUnsupported,
    parse_regex,
)
from ingress_plus_tpu_torch.compiler.ruleset import (  # noqa: F401
    CompiledRuleset,
    compile_ruleset,
)
