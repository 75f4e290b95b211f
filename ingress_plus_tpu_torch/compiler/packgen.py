"""Synthetic pack scaling: rulesets at a chosen multiple of a base pack.

The port of ``ingress_plus_tpu/compiler/packgen.py`` (the JAX bench's
PACKSCALE rule generator): the same ``(base, factor)`` gives the same
rule list, and so the same compiled pack.  ``chip_smoke.py`` compiles
``scale_rules(load_bundled_rules(), 2.0)`` (4018 rules, W=285 words
against the bundled pack's 2009 rules and W=225) to run both scan
kernels on a wider class table.

Growth model (how production packs actually grow, not random noise):

  * half the added rules are CLONES of existing detection rules under
    fresh ids — the CRS pattern of re-issuing a signature for a new
    paranoia level / target combination.  Exact factor interning must
    absorb these completely.
  * half are keyword VARIANTS built from the bundled signature-pack
    templates (compiler/sigpack.py) over perturbed keywords — near-
    duplicate patterns whose factors are close to, but not identical
    to, existing ones.  These exercise the approximate merges.

Everything is deterministic (seeded keyword perturbation, stable
ordering): the same scale always compiles the same pack.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ingress_plus_tpu_torch.compiler.seclang import Rule

#: id namespace for generated rules — far above CRS and sigpack ranges
_SCALE_ID_BASE = 7_000_000

#: deterministic keyword perturbations for the variant half: mimic the
#: obfuscation/dialect variants real signature feeds add over time
_VARIANT_DECOS = ("%s2", "x%s", "%s_", "%s64", "un%s")


def _is_config_rule(r: Rule) -> bool:
    """SecAction-style config carriers must survive subsetting, or the
    scaled pack loses its anomaly thresholds and TX defaults."""
    return r.operator == "unconditionalMatch" and not r.raw_targets


def scale_rules(base: List[Rule], factor: float) -> List[Rule]:
    """Return a ruleset ``factor`` times the size of ``base``.

    factor < 1 keeps every config rule plus an evenly-strided subset of
    the detection rules; factor > 1 appends clones and keyword variants
    as described in the module docstring."""
    config = [r for r in base if _is_config_rule(r)]
    detect = [r for r in base if not _is_config_rule(r)]
    if factor <= 0:
        raise ValueError("factor must be positive")
    if factor < 1.0:
        want = max(1, int(round(len(detect) * factor)))
        stride = len(detect) / want
        picked = [detect[min(int(i * stride), len(detect) - 1)]
                  for i in range(want)]
        return config + picked
    extra_n = int(round(len(detect) * (factor - 1.0)))
    if extra_n == 0:
        return list(base)

    extra: List[Rule] = []
    # clones: stride across the detection rules so every family grows
    n_clones = extra_n // 2
    for i in range(n_clones):
        src = detect[int(i * len(detect) / max(1, n_clones)) % len(detect)]
        extra.append(dataclasses.replace(
            src, rule_id=_SCALE_ID_BASE + i, chain=src.chain,
            msg=(src.msg + " [scale-clone]").strip()))
    # variants: sigpack templates over perturbed keywords
    from ingress_plus_tpu_torch.compiler.sigpack import (
        _PACK_KEYWORDS,
        _PACK_TEMPLATES,
    )

    combos = []
    for cls, _base_id, severity, targets, templates in _PACK_TEMPLATES:
        for t_idx, template in enumerate(templates):
            for w in _PACK_KEYWORDS[cls]:
                combos.append((cls, severity, targets, t_idx, template, w))
    rid = _SCALE_ID_BASE + 1_000_000
    i = 0
    while len(extra) < extra_n and combos:
        cls, severity, targets, t_idx, template, w = combos[i % len(combos)]
        deco = _VARIANT_DECOS[(i // len(combos)) % len(_VARIANT_DECOS)]
        kw = deco % w
        extra.append(Rule(
            rule_id=rid,
            operator="rx",
            argument=template.replace("{w}", kw),
            targets=list(targets),
            transforms=["urlDecodeUni", "lowercase"],
            action="block",
            severity=severity,
            msg="packgen:%s template %d keyword %r" % (cls, t_idx, kw),
            tags=["attack-%s" % cls.split("_")[0].rstrip("0123456789"),
                  "paranoia-level/2", "packgen"],
            paranoia=2,
        ))
        rid += 1
        i += 1
    return list(base) + extra
