"""The static analyzers the guarded rollout's admission gate runs on a
compiled pack (control/rollout.py ``_static_gate``): the prefilter
soundness audit (prefilter_audit.py), regex hazards (redos.py) and
transform-lane consistency (lanecheck.py), with baseline suppression
(findings.py).  Ported from ``ingress_plus_tpu/analysis``; the SecLang
tree analyzers and ``run_rulecheck`` are not ported.
"""

from __future__ import annotations

from pathlib import Path

from ingress_plus_tpu_torch.analysis.findings import (  # noqa: F401
    Baseline,
    BaselineError,
    Finding,
    Report,
    SEVERITIES,
)
from ingress_plus_tpu_torch.analysis.lanecheck import check_lanes  # noqa: F401
from ingress_plus_tpu_torch.analysis.prefilter_audit import (  # noqa: F401
    audit_prefilter,
)
from ingress_plus_tpu_torch.analysis.redos import (  # noqa: F401
    check_regex_hazards,
)

#: the bundled CRS-shaped tree; its accepted-findings baseline ships next
#: to it as rulecheck-baseline.json
BUNDLED_RULES = Path(__file__).resolve().parent.parent / "rules" / "crs"
