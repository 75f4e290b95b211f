"""Minimal object model for the control plane.

The reference consumes `networking.k8s.io/v1 Ingress` objects through
client-go informers and carries them as `pkg/apis/ingress/types.go†`
structs.  Here the same shapes as plain dataclasses, constructible from
k8s-style dicts (`Ingress.from_dict(yaml.safe_load(...))`) so tests and the
admission path can feed real manifests without a cluster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Backend:
    """spec.rules[].http.paths[].backend.service analog."""

    service: str = ""
    port: int = 80

    @classmethod
    def from_dict(cls, d: dict) -> "Backend":
        svc = d.get("service", {})
        port = svc.get("port", {})
        return cls(service=svc.get("name", ""),
                   port=int(port.get("number", port.get("name", 0) or 0)))


@dataclass
class PathRule:
    path: str = "/"
    path_type: str = "Prefix"
    backend: Backend = field(default_factory=Backend)

    @classmethod
    def from_dict(cls, d: dict) -> "PathRule":
        return cls(path=d.get("path", "/"),
                   path_type=d.get("pathType", "Prefix"),
                   backend=Backend.from_dict(d.get("backend", {})))


@dataclass
class IngressRule:
    host: str = "_"
    paths: List[PathRule] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "IngressRule":
        http = d.get("http", {}) or {}
        return cls(host=d.get("host", "_") or "_",
                   paths=[PathRule.from_dict(p)
                          for p in http.get("paths", [])])


@dataclass
class Ingress:
    name: str = ""
    namespace: str = "default"
    annotations: Dict[str, str] = field(default_factory=dict)
    rules: List[IngressRule] = field(default_factory=list)
    ingress_class: Optional[str] = None

    @property
    def key(self) -> str:
        return "%s/%s" % (self.namespace, self.name)

    @classmethod
    def from_dict(cls, d: dict) -> "Ingress":
        meta = d.get("metadata", {})
        spec = d.get("spec", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            annotations=dict(meta.get("annotations", {}) or {}),
            rules=[IngressRule.from_dict(r) for r in spec.get("rules", [])],
            ingress_class=spec.get("ingressClassName"),
        )


@dataclass
class ConfigMap:
    """The controller's global ConfigMap (data: str→str)."""

    data: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigMap":
        return cls(data={k: str(v) for k, v in
                         (d.get("data", {}) or {}).items()})
