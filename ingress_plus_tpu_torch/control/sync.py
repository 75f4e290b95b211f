"""Tenant rule-tag tables for EP routing: the push payload's validator
and the (T, R) per-tenant rule masks derived from it.

The serve-plane subset of ``ingress_plus_tpu/control/sync.py``; the
ingress sync controller itself is not part of this package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset

MAX_TENANTS = 4096  # bounds the (T, R) mask allocation (config #4 is 256)


def validate_tenant_tags(raw) -> Dict[int, Tuple[str, ...]]:
    """Validate a tenant→rule-tags push payload (the
    ``/configuration/tenants`` body) into a canonical table — a
    structured reject instead of a silent truncation:

    - the payload must be a JSON object with at most ``MAX_TENANTS``
      entries (``tenant_masks`` silently drops ids past the bound, so
      an oversized push would install a partial table);
    - keys must be canonical base-10 tenant ids — ``"01"`` and ``"1"``
      would silently collapse into one mask row, last writer wins;
    - ids must sit in ``[0, MAX_TENANTS)``;
    - tag values must be lists of strings (a bare string iterates
      per-character into tags matching no rule → all-False mask →
      scan bypass)."""
    if not isinstance(raw, dict):
        raise ValueError("payload must be a JSON object")
    if len(raw) > MAX_TENANTS:
        raise ValueError(
            "too many tenants: %d entries > MAX_TENANTS=%d (the mask "
            "table would silently truncate)" % (len(raw), MAX_TENANTS))
    tags: Dict[int, Tuple[str, ...]] = {}
    for k, v in raw.items():
        if not isinstance(v, (list, tuple)) or not all(
                isinstance(t, str) for t in v):
            raise ValueError(
                "tenant %r: tag values must be lists of strings" % (k,))
        ks = k if isinstance(k, str) else str(k)
        try:
            t = int(ks)
        except (ValueError, TypeError):
            raise ValueError("tenant key %r is not an integer id" % (k,))
        if str(t) != ks:
            raise ValueError(
                "tenant key %r is not canonical (use %r — non-canonical "
                "keys silently collapse into one mask row)" % (k, str(t)))
        if not 0 <= t < MAX_TENANTS:
            raise ValueError("tenant ids must be in [0, %d)" % MAX_TENANTS)
        if t in tags:
            raise ValueError("duplicate tenant id %d" % t)
        tags[t] = tuple(v)
    return tags


def tenant_masks(cr: CompiledRuleset,
                 tenant_tags: Dict[int, Tuple[str, ...]]) -> np.ndarray:
    """(T, R) bool — row 0 = full ruleset (reserved, cannot be overridden);
    a tenant id NOT in the table also runs the full ruleset (all-True
    default): an unlisted tenant must never mean "scan nothing"."""
    ids = [t for t in tenant_tags if 0 < t < MAX_TENANTS]
    T = (max(ids) + 1) if ids else 1
    masks = np.ones((T, cr.n_rules), dtype=bool)
    rule_tags = [frozenset(m.rule.tags) for m in cr.rules]
    for t in ids:
        want = frozenset(tenant_tags[t])
        masks[t] = np.fromiter(
            (bool(want & rt) for rt in rule_tags), bool, cr.n_rules)
    return masks
