"""SecLang rule model: the attack classes, scan streams and ``Rule``.

The subset of ``ingress_plus_tpu/compiler/seclang.py`` that the runtime
needs to load a compiled pack and fold verdicts.  The SecLang parser
itself stays with the compiler, which this package does not carry.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

# CRS-style rule-id range → attack class (verdict head).
CLASS_RANGES = [
    (911000, 911999, "protocol"),
    (913000, 913999, "scanner"),
    (920000, 920999, "protocol"),
    (921000, 921999, "protocol"),
    (922000, 922999, "protocol"),
    (930000, 930999, "lfi"),
    (931000, 931999, "rfi"),
    (932000, 932999, "rce"),
    (933000, 933999, "php"),
    (934000, 934999, "nodejs"),
    (941000, 941999, "xss"),
    (942000, 942999, "sqli"),
    (943000, 943999, "session"),
    (944000, 944999, "java"),
    # response-side data-leakage families (CRS RESPONSE-95x): fired by
    # the response scan path (serve-side PTPI frames), phase 4
    (950000, 954999, "leak"),
]

# "leak"/"acl" are appended LAST: class ids ride the wire as u8 indexes
# (protocol.py / protocol.hpp) — existing ids must stay stable.  "acl"
# is the enforcement pseudo-class for wallarm-acl deny verdicts
# (models/pipeline.py finalize), not a detection family.
CLASSES = [
    "protocol", "scanner", "lfi", "rfi", "rce", "php", "nodejs",
    "xss", "sqli", "session", "java", "generic", "leak", "acl",
]
CLASS_INDEX = {c: i for i, c in enumerate(CLASSES)}

STREAMS = ("uri", "args", "headers", "body", "resp_headers", "resp_body")
STREAM_INDEX = {s: i for i, s in enumerate(STREAMS)}


@dataclass
class Rule:
    """One detection rule, format-neutral."""

    rule_id: int
    operator: str                     # rx | pm | contains | streq | beginsWith |
                                      # endsWith | within | detectSQLi |
                                      # detectXSS | eq/ge/gt/le/lt |
                                      # validateByteRange | ... (non-scan
                                      # operators compile confirm-only)
    argument: str                     # regex text / word list / literal
    targets: List[str] = field(default_factory=lambda: ["args"])  # stream names
    #: original pipe-split variable tokens ("REQUEST_HEADERS:Content-Length",
    #: "&ARGS", "!ARGS:z", ...) — the confirm stage resolves subfield
    #: selectors / counts / exclusions from these EXACTLY, instead of
    #: evaluating against the whole coarse stream (a negated op on a
    #: discarded selector would fire on every request)
    raw_targets: List[str] = field(default_factory=list)
    transforms: List[str] = field(default_factory=list)
    action: str = "block"             # block | deny | pass (monitoring)
    severity: str = "WARNING"
    msg: str = ""
    tags: List[str] = field(default_factory=list)
    chain: Optional["Rule"] = None    # AND-linked next rule
    paranoia: int = 1
    phase: int = 2
    negate: bool = False              # "!@op": match inverted (confirm-only
                                      # by construction — absence cannot be
                                      # prefiltered by factors)
    #: raw setvar action values ("tx.anomaly_score_pl1=+%{tx.critical_
    #: anomaly_score}") — the compiler resolves the CRS anomaly-scoring
    #: pattern from these statically (compile-time macro resolution keeps
    #: the runtime fully batched: anomaly accumulation IS the engine's
    #: score matmul)
    setvars: List[str] = field(default_factory=list)
    #: raw ctl action values ("ruleRemoveById=942100",
    #: "ruleRemoveTargetById=942100;ARGS:password") — runtime rule
    #: exclusions conditioned on THIS rule matching (the CRS exclusion-
    #: package shape: SecRule REQUEST_URI "@beginsWith /api" "...,pass,
    #: nolog,ctl:...").  Resolved to static masks at compile time
    #: (compiler/ruleset.py) and applied per request in the confirm
    #: stage (models/pipeline.py).
    ctls: List[str] = field(default_factory=list)

    @property
    def attack_class(self) -> str:
        for lo, hi, name in CLASS_RANGES:
            if lo <= self.rule_id <= hi:
                return name
        for t in self.tags:
            m = re.search(r"attack-(\w+)", t)
            if m and m.group(1) in CLASS_INDEX:
                return m.group(1)
        return "generic"

