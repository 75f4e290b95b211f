"""Admission validation: reject broken Ingress objects before they sync.

Reference: `internal/admission/controller/`† — the validating webhook
extracts annotations **strict**, merges the candidate Ingress into the
current model, renders, and runs `nginx -t` on the result; any failure
rejects the object so a typo can't take down the data plane.

The `nginx -t` analog here is a structural lint of the rendered text
(balanced braces, every directive line terminated, no unrendered
placeholders) plus the strict annotation pass — the same code path the
runtime uses lenient.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ingress_plus_tpu_torch.control.annotations import AnnotationError, Extractor
from ingress_plus_tpu_torch.control.config import GlobalConfig
from ingress_plus_tpu_torch.control.model import build_configuration
from ingress_plus_tpu_torch.control.objects import ConfigMap, Ingress
from ingress_plus_tpu_torch.control.template import render


@dataclass
class Review:
    allowed: bool
    messages: List[str] = field(default_factory=list)


def lint_rendered(text: str) -> List[str]:
    """The `nginx -t` stand-in: structural checks on rendered config."""
    problems = []
    depth = 0
    for n, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        depth += s.count("{") - s.count("}")
        if depth < 0:
            problems.append("line %d: unbalanced '}'" % n)
            depth = 0
        if (s and not s.startswith("#") and not s.endswith(("{", "}"))
                and not s.endswith(";")):
            problems.append("line %d: unterminated directive: %r" % (n, s))
    if depth != 0:
        problems.append("unbalanced '{' (%d unclosed)" % depth)
    return problems


def validate(candidate: Ingress,
             existing: Optional[List[Ingress]] = None,
             configmap: Optional[ConfigMap] = None) -> Review:
    g = (GlobalConfig.from_configmap(configmap) if configmap
         else GlobalConfig())
    # 1. strict annotation extraction — first bad value rejects
    try:
        Extractor(strict=True).extract(candidate)
    except AnnotationError as e:
        return Review(allowed=False, messages=[str(e)])

    # 2. dry-run render of the would-be full model
    merged = [i for i in (existing or []) if i.key != candidate.key]
    merged.append(candidate)
    cfg = build_configuration(merged, g)
    text = render(cfg, g)
    problems = lint_rendered(text)
    # Only errors attributable to the CANDIDATE reject it: a pre-existing
    # Ingress with a bad annotation (created before the webhook, or while
    # it was down) must not deadlock admission of every other object.
    # Extractor errors are prefixed with the owning ingress key.
    problems.extend(e for e in cfg.errors
                    if e.startswith(candidate.key + ":"))
    if problems:
        return Review(allowed=False, messages=problems)
    return Review(allowed=True)
