"""Global configuration — the ConfigMap tier.

Reference: `internal/ingress/controller/config/config.go`† (~200 typed
keys parsed from the controller ConfigMap by `ReadConfig`, defaults from
`NewDefault`).  This file carries the keys the detection framework owns:
the wallarm-style globals plus the TPU-backend globals the north star
adds (sidecar address, batch window, fail-open policy — SURVEY.md §5
config tiers).  Three-tier precedence, as in the reference:

    CLI flags  >  ConfigMap (this file)  >  per-Ingress annotations
    (annotations override the *defaults*, the ConfigMap sets them)
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List

from ingress_plus_tpu_torch.control.objects import ConfigMap


def _parse_bool(v: str) -> bool:
    """Strict: unrecognized spellings raise so from_configmap keeps the
    default and REPORTS (a typo in `fail-open` must not silently flip
    fail-open→fail-closed)."""
    s = v.strip().lower()
    if s in ("true", "on", "1", "yes"):
        return True
    if s in ("false", "off", "0", "no"):
        return False
    raise ValueError("not a boolean: %r" % v)


@dataclass
class GlobalConfig:
    # ---- wallarm-style global enablement (`enable-wallarm`† analog)
    enable_detection: bool = False
    default_mode: str = "monitoring"     # cluster-wide default wallarm-mode
    mode_allow_override: str = "on"      # can Ingresses strengthen mode?

    # ---- TPU backend globals (north-star additions)
    detection_backend: str = "cpu"       # cluster default: cpu | tpu
    sidecar_socket: str = "/run/ipt/detect.sock"
    sidecar_http: str = "127.0.0.1:9901"
    batch_window_us: int = 500           # deadline batcher window
    max_batch: int = 256
    fail_open: bool = True               # wallarm-fallback default
    detect_timeout_ms: int = 30          # nginx-side verdict budget
    anomaly_threshold: int = 5
    paranoia_level: int = 2
    ruleset_path: str = ""               # compiled-ruleset artifact dir
    ruleset_sync_interval_s: int = 120   # sync-node† pull cadence
    #: wallarm-acl CONTENT (the reference syncs lists from its cloud; the
    #: open analog is the ConfigMap): JSON string
    #: {"name": {"allow": [cidr], "deny": [...], "greylist": [...]}}
    acls: str = ""

    # ---- representative core keys the template consumes
    server_tokens: bool = False
    client_body_buffer_size: str = "16k"
    proxy_body_size: str = "1m"
    log_format_upstream: str = (
        '$remote_addr - $request "$status" $detect_verdict')

    errors: List[str] = field(default_factory=list)

    @classmethod
    def from_configmap(cls, cm: ConfigMap) -> "GlobalConfig":
        """ReadConfig† analog: kebab-case keys, bad values keep defaults
        and are reported (never crash the sync loop)."""
        cfg = cls()
        typed = {f.name.replace("_", "-"): f for f in fields(cls)
                 if f.name != "errors"}
        for key, raw in sorted(cm.data.items()):
            f = typed.get(key)
            if f is None:
                continue  # core controller owns hundreds more keys
            try:
                if f.type in ("bool", bool):
                    value = _parse_bool(raw)
                elif f.type in ("int", int):
                    value = int(raw)
                else:
                    value = raw.strip()
                setattr(cfg, f.name, value)
            except (ValueError, TypeError) as e:
                cfg.errors.append("%s: %s" % (key, e))
        if cfg.default_mode not in ("off", "monitoring", "safe_blocking",
                                    "block"):
            cfg.errors.append("default-mode: %r invalid" % cfg.default_mode)
            cfg.default_mode = "monitoring"
        if cfg.detection_backend not in ("cpu", "tpu"):
            cfg.errors.append("detection-backend: %r invalid"
                              % cfg.detection_backend)
            cfg.detection_backend = "cpu"
        return cfg
