"""Model builder: Ingress objects → `Configuration` → (template.py).

Reference: `getConfiguration`/`getBackendServers` in
`internal/ingress/controller/controller.go`† producing
`Configuration{Backends, Servers, Locations}` (`pkg/apis/ingress/
types.go`†).  Additions for the TPU backend:

- every Location carries its extracted DetectionConfig;
- Ingresses are assigned stable **tenant ids** (EP routing, SURVEY.md
  §2.4): the per-namespace rule-subset table that the serve loop's
  tenant masks consume (benchmark config #4, 256 Ingress objects).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ingress_plus_tpu_torch.control.annotations import DetectionConfig, Extractor
from ingress_plus_tpu_torch.control.config import GlobalConfig
from ingress_plus_tpu_torch.control.objects import Backend, Ingress


@dataclass
class Location:
    path: str
    path_type: str
    backend: Backend
    detection: DetectionConfig
    ingress_key: str


@dataclass
class Server:
    hostname: str
    locations: List[Location] = field(default_factory=list)


@dataclass
class Configuration:
    servers: List[Server] = field(default_factory=list)
    # EP routing table: tenant id → (ingress key, rule-subset tags).
    # Tenant 0 is reserved for "full ruleset".
    tenants: Dict[int, Tuple[str, Tuple[str, ...]]] = field(
        default_factory=dict)
    errors: List[str] = field(default_factory=list)

    def tenant_tags(self) -> Dict[int, Tuple[str, ...]]:
        return {t: tags for t, (_, tags) in self.tenants.items()}

    def tenant_acls(self) -> Dict[int, str]:
        """tenant id → wallarm-acl name (the per-Ingress annotation
        carried to the serve loop's ACL binding — models/acl.py).  An
        Ingress's locations share its tenant id, so the first non-empty
        acl per tenant wins; conflicting names are a model error."""
        out: Dict[int, str] = {}
        errs = set()
        for server in self.servers:
            for loc in server.locations:
                det = loc.detection
                t = det.tenant
                if not det.acl:
                    continue
                if t in out and out[t] != det.acl:
                    key = (t, out[t], det.acl)
                    if key not in errs:
                        errs.add(key)
                        self.errors.append(
                            "tenant %d: conflicting wallarm-acl %r vs %r"
                            % (t, out[t], det.acl))
                    continue
                out[t] = det.acl
        return out


def _apply_globals(cfg: DetectionConfig, g: GlobalConfig) -> DetectionConfig:
    """Tier merge: ConfigMap sets the defaults annotations did not touch,
    and the override policy gates mode strengthening (the reference's
    wallarm-mode-allow-override semantics).  ``cfg.explicit`` separates an
    explicit `wallarm-mode: off` opt-out (honored) from the absent-
    annotation default (promoted to the cluster default)."""
    if (g.enable_detection and cfg.mode == "off"
            and "mode" not in cfg.explicit):
        cfg.mode = g.default_mode
    order = ("off", "monitoring", "safe_blocking", "block")
    if g.mode_allow_override == "off":
        cfg.mode = g.default_mode if g.enable_detection else "off"
    elif g.mode_allow_override == "strict":
        # annotations may only weaken, never strengthen
        if order.index(cfg.mode) > order.index(g.default_mode):
            cfg.mode = g.default_mode
    if ("detection_backend" not in cfg.explicit
            and g.detection_backend == "tpu"):
        cfg.detection_backend = "tpu"
    if cfg.anomaly_threshold == 0:
        cfg.anomaly_threshold = g.anomaly_threshold
    if cfg.paranoia_level == 0:
        cfg.paranoia_level = g.paranoia_level
    if not g.fail_open:
        cfg.fallback = False
    return cfg


def build_configuration(
    ingresses: List[Ingress],
    global_config: Optional[GlobalConfig] = None,
) -> Configuration:
    g = global_config or GlobalConfig()
    ex = Extractor(strict=False)
    out = Configuration()
    servers: Dict[str, Server] = {}

    # one extract per Ingress (extraction is not idempotent on ex.errors,
    # and the 256-Ingress config shouldn't pay double parse work)
    extracted = {ing.key: ex.extract(ing) for ing in ingresses}

    # stable tenant ids: sorted ingress keys, 1-based (0 = full ruleset)
    with_subset = sorted(
        key for key, det in extracted.items() if det.rule_subset)
    tenant_of = {key: i + 1 for i, key in enumerate(with_subset)}

    for ing in sorted(ingresses, key=lambda i: i.key):
        det = _apply_globals(extracted[ing.key], g)
        det.tenant = tenant_of.get(ing.key, 0)
        if det.tenant:
            out.tenants[det.tenant] = (ing.key, tuple(det.rule_subset))
        for rule in ing.rules:
            srv = servers.setdefault(rule.host, Server(hostname=rule.host))
            for p in rule.paths:
                srv.locations.append(Location(
                    path=p.path, path_type=p.path_type, backend=p.backend,
                    detection=det, ingress_key=ing.key))

    # deterministic output: hosts sorted, catch-all last; longest path
    # first within a server (nginx location-match order)
    for srv in servers.values():
        srv.locations.sort(key=lambda l: (-len(l.path), l.path))
    out.servers = sorted(
        servers.values(),
        key=lambda s: (s.hostname == "_", s.hostname))
    out.errors = ex.errors
    return out
