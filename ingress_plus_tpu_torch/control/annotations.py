"""Annotation parsing framework + the WAF annotation set.

Reference: `internal/ingress/annotations/`† — ~60 per-annotation parser
packages behind an `Extractor`, each reading `nginx.ingress.kubernetes.io/
<name>` with typed parsing + validation, and
`internal/ingress/annotations/wallarm/`† for the wallarm set.  The north
star adds `detection-backend: tpu` at exactly this boundary
(BASELINE.json).

Validation mirrors the reference's `annotation-value-word-blocklist`
defense: annotation values land in rendered nginx config, so values that
could break out of the rendered context are rejected at extraction time
(the admission webhook calls the same code strict).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional

from ingress_plus_tpu_torch.control.objects import Ingress

PREFIX = "nginx.ingress.kubernetes.io/"

# characters that could escape an nginx directive / template context
_BLOCKLIST_RE = re.compile(r'[{}$;\n\r"\'\\]|\.\./')

MODES = ("off", "monitoring", "safe_blocking", "block")
BACKENDS = ("cpu", "tpu")


class AnnotationError(ValueError):
    """Raised in strict mode (admission); lenient extraction logs-and-
    defaults instead, matching the controller's runtime behavior."""


def _check_value(name: str, raw: str) -> str:
    if _BLOCKLIST_RE.search(raw):
        raise AnnotationError(
            "annotation %s value %r contains blocklisted characters"
            % (name, raw))
    return raw


@dataclass
class Spec:
    """One annotation: its name, parse/validate function, and default."""

    name: str
    parse: Callable[[str], object]
    default: object
    target: str  # field on DetectionConfig


def _enum(options) -> Callable[[str], str]:
    def p(raw: str) -> str:
        v = raw.strip().lower()
        if v not in options:
            raise AnnotationError("expected one of %s, got %r"
                                  % (",".join(options), raw))
        return v
    return p


def _bool(raw: str) -> bool:
    v = raw.strip().lower()
    if v in ("true", "on", "1", "yes"):
        return True
    if v in ("false", "off", "0", "no"):
        return False
    raise AnnotationError("expected boolean, got %r" % raw)


def _int(lo: int, hi: int) -> Callable[[str], int]:
    def p(raw: str) -> int:
        try:
            v = int(raw.strip())
        except ValueError:
            raise AnnotationError("expected integer, got %r" % raw)
        if not lo <= v <= hi:
            raise AnnotationError("expected %d..%d, got %d" % (lo, hi, v))
        return v
    return p


def _str(raw: str) -> str:
    return raw.strip()


def _csv(raw: str) -> List[str]:
    return [x.strip() for x in raw.split(",") if x.strip()]


@dataclass
class DetectionConfig:
    """Per-Ingress WAF config — the wallarm `Config`† struct analog, plus
    the TPU-backend extension.  One of these hangs off every Location in
    the model (model.py)."""

    # wallarm annotation set (reference parity)
    mode: str = "off"                   # wallarm-mode
    mode_allow_override: str = "on"     # wallarm-mode-allow-override:
                                        #   on | off | strict
    fallback: bool = True               # wallarm-fallback (fail-open)
    instance: str = ""                  # wallarm-instance / application
    block_page: str = ""                # wallarm-block-page
    acl: str = ""                       # wallarm-acl
    enable_libdetection: bool = True    # wallarm-enable-libdetection
    parse_response: bool = False        # wallarm-parse-response
    parse_websocket: bool = False       # wallarm-parse-websocket
    unpack_response: bool = False       # wallarm-unpack-response
    parser_disable: List[str] = field(default_factory=list)

    # the north-star extension (BASELINE.json)
    detection_backend: str = "cpu"      # detection-backend: cpu | tpu
    anomaly_threshold: int = 0          # 0 = inherit global
    paranoia_level: int = 0             # 0 = inherit global
    rule_subset: List[str] = field(default_factory=list)
                                        # detection-rule-tags: EP tenant
                                        # rule-subset selection

    # filled by the model builder (EP routing), not by annotations
    tenant: int = 0
    # which fields were explicitly set by annotations (vs defaults) — the
    # global-merge tier needs the difference: an explicit
    # `wallarm-mode: off` is an opt-out and must never be promoted to the
    # cluster default, while an absent annotation must be
    explicit: frozenset = frozenset()

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


SPECS: List[Spec] = [
    Spec("wallarm-mode", _enum(MODES), "off", "mode"),
    Spec("wallarm-mode-allow-override", _enum(("on", "off", "strict")),
         "on", "mode_allow_override"),
    Spec("wallarm-fallback", _bool, True, "fallback"),
    Spec("wallarm-instance", _str, "", "instance"),
    Spec("wallarm-application", _str, "", "instance"),  # newer alias wins
    Spec("wallarm-block-page", _str, "", "block_page"),
    Spec("wallarm-acl", _str, "", "acl"),
    Spec("wallarm-enable-libdetection", _bool, True, "enable_libdetection"),
    Spec("wallarm-parse-response", _bool, False, "parse_response"),
    Spec("wallarm-parse-websocket", _bool, False, "parse_websocket"),
    Spec("wallarm-unpack-response", _bool, False, "unpack_response"),
    Spec("wallarm-parser-disable", _csv, [], "parser_disable"),
    Spec("detection-backend", _enum(BACKENDS), "cpu", "detection_backend"),
    Spec("detection-anomaly-threshold", _int(0, 1000), 0,
         "anomaly_threshold"),
    Spec("detection-paranoia-level", _int(0, 4), 0, "paranoia_level"),
    Spec("detection-rule-tags", _csv, [], "rule_subset"),
]

_BY_NAME: Dict[str, Spec] = {s.name: s for s in SPECS}


class Extractor:
    """`annotations.Extractor.Extract`† analog.

    lenient (controller runtime): bad values fall back to the default so
    one broken Ingress can't take down the sync loop; errors are
    collected for metrics/events.
    strict (admission webhook): first bad value raises AnnotationError.
    """

    def __init__(self, strict: bool = False):
        self.strict = strict
        self.errors: List[str] = []

    def extract(self, ing: Ingress) -> DetectionConfig:
        cfg = DetectionConfig()
        explicit = set()
        # iterate in SPECS order (not annotation-name order) so declared
        # precedence holds: e.g. wallarm-application overrides its legacy
        # alias wallarm-instance when both are present
        for spec in SPECS:
            raw = ing.annotations.get(PREFIX + spec.name)
            if raw is None:
                continue
            try:
                value = spec.parse(_check_value(spec.name, raw))
            except AnnotationError as e:
                if self.strict:
                    raise AnnotationError("%s: %s" % (ing.key, e)) from e
                self.errors.append("%s: %s" % (ing.key, e))
                continue
            setattr(cfg, spec.target, value)
            explicit.add(spec.target)
        cfg.explicit = frozenset(explicit)
        return cfg


def known_annotations() -> List[str]:
    return [PREFIX + s.name for s in SPECS]
