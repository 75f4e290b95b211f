"""Template engine: Configuration model → nginx.conf text.

Reference: `internal/ingress/controller/template/template.go`† +
`rootfs/etc/nginx/template/nginx.tmpl`† — a Go template with a large
funcMap renders the model into nginx.conf; wallarm annotations become
`wallarm_*` directives inside the matched `location` blocks.

This renderer emits the same shape.  The north-star boundary
(BASELINE.json): when a location's `detection-backend` is `tpu`, instead
of the in-process engine directives it renders the **sidecar routing
directives** consumed by the C++ nginx shim module (native/README):
capture the request, ship it over the batcher UDS, enforce the verdict,
fail open on deadline.  `detection-backend: cpu` renders classic
`wallarm_*` directives — byte-compatible intent with the reference path.

Tested golden-file style like `template_test.go`† (tests/test_control.py).
"""

from __future__ import annotations

from typing import List

from ingress_plus_tpu_torch.control.annotations import DetectionConfig
from ingress_plus_tpu_torch.control.config import GlobalConfig
from ingress_plus_tpu_torch.control.model import Configuration, Location, Server

_MODE_DIRECTIVE = {
    "off": "off",
    "monitoring": "monitoring",
    "safe_blocking": "safe_blocking",
    "block": "block",
}


def _detection_directives(det: DetectionConfig, g: GlobalConfig,
                          pad: str) -> List[str]:
    out: List[str] = []
    if not det.enabled:
        return out
    if det.detection_backend == "tpu":
        # ---- TPU sidecar routing (the new boundary) ----
        out.append(pad + "detect_tpu on;")
        out.append(pad + "detect_tpu_socket %s;" % g.sidecar_socket)
        out.append(pad + "detect_tpu_mode %s;" % _MODE_DIRECTIVE[det.mode])
        out.append(pad + "detect_tpu_timeout_ms %d;" % g.detect_timeout_ms)
        out.append(pad + "detect_tpu_fail_open %s;"
                   % ("on" if det.fallback else "off"))
        if det.tenant:
            out.append(pad + "detect_tpu_tenant %d;" % det.tenant)
        if det.acl:
            # informational at the data plane (enforcement runs in the
            # serve pipeline via the tenant→acl binding the sync loop
            # pushes to /configuration/acl); rendered for config parity
            # with wallarm_acl and validated by the shim directive table
            out.append(pad + "detect_tpu_acl %s;" % det.acl)
        if det.block_page:
            out.append(pad + "detect_tpu_block_page %s;" % det.block_page)
        if det.parse_response:
            out.append(pad + "detect_tpu_parse_response on;")
        if det.parse_websocket:
            out.append(pad + "detect_tpu_parse_websocket on;")
        for p in det.parser_disable:
            out.append(pad + "detect_tpu_parser_disable %s;" % p)
    else:
        # ---- classic in-process engine (reference parity) ----
        out.append(pad + "wallarm_mode %s;" % _MODE_DIRECTIVE[det.mode])
        if det.mode_allow_override != "on":
            out.append(pad + "wallarm_mode_allow_override %s;"
                       % det.mode_allow_override)
        if det.fallback:
            out.append(pad + "wallarm_fallback on;")
        if det.instance:
            out.append(pad + "wallarm_application %s;" % det.instance)
        if det.block_page:
            out.append(pad + "wallarm_block_page %s;" % det.block_page)
        if det.acl:
            out.append(pad + "wallarm_acl %s;" % det.acl)
        if det.enable_libdetection:
            out.append(pad + "wallarm_enable_libdetection on;")
        if det.parse_response:
            out.append(pad + "wallarm_parse_response on;")
        if det.parse_websocket:
            out.append(pad + "wallarm_parse_websocket on;")
        if det.unpack_response:
            out.append(pad + "wallarm_unpack_response on;")
        for p in det.parser_disable:
            out.append(pad + "wallarm_parser_disable %s;" % p)
    return out


def _location(loc: Location, g: GlobalConfig) -> List[str]:
    mod = "= " if loc.path_type == "Exact" else ""
    out = ["    location %s%s {" % (mod, loc.path)]
    out.append("        # ingress: %s" % loc.ingress_key)
    out.extend(_detection_directives(loc.detection, g, "        "))
    out.append("        proxy_set_header X-Request-ID $request_id;")
    out.append("        client_max_body_size %s;" % g.proxy_body_size)
    out.append("        proxy_pass http://upstream_%s_%d;"
               % (loc.backend.service or "default", loc.backend.port))
    out.append("    }")
    return out


def render(cfg: Configuration, g: GlobalConfig) -> str:
    """Deterministic: same model + globals → identical text, so the sync
    loop's reload decision can be a string comparison (nginx.go† diffs the
    rendered file the same way)."""
    out: List[str] = [
        "# generated by ingress_plus_tpu_torch.control — do not edit",
        "http {",
        "    server_tokens %s;" % ("on" if g.server_tokens else "off"),
        "    client_body_buffer_size %s;" % g.client_body_buffer_size,
        "    log_format upstream_info '%s';" % g.log_format_upstream,
    ]
    if any(loc.detection.enabled and loc.detection.detection_backend == "tpu"
           for srv in cfg.servers for loc in srv.locations):
        out.append("    detect_tpu_metrics %s;" % g.sidecar_http)
    for srv in cfg.servers:
        out.append("")
        out.append("    server {")
        out.append("        server_name %s;" % srv.hostname)
        for loc in srv.locations:
            out.extend("    " + line for line in _location(loc, g))
        out.append("    }")
    out.append("}")
    return "\n".join(out) + "\n"
