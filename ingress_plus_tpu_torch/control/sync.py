"""Sync controller: the `syncIngress` loop analog.

Reference flow (`internal/ingress/controller/nginx.go`†, SURVEY.md §3.2):

    informer event → build model → render template →
      IF only dynamic state changed: POST to the Lua endpoint (no reload)
      ELSE: nginx -t, diff, SIGHUP reload

Here the same decision, re-targeted:

- **render diff** → "reload" (the nginx shim must re-read directives);
- **tenant table change only** → "dynamic": POST the EP tenant rule-mask
  table to the serve loop's /configuration/tenants endpoint (the
  configuration.lua† unix-socket channel analog) — no reload, no serve
  gap;
- wallarm-acl content (ConfigMap) or binding (annotations) change →
  "dynamic" too: POST to the serve loop's /configuration/acl;
- no change → "noop".

A push that fails stays pinned on its channel (``_PushChannel``) and is
retried on later ticks with bounded exponential backoff
(``RETRY_BASE_S`` doubling up to ``RETRY_MAX_S``), always with the latest
payload.  The serve loop (``serve/server.py``) validates the tenants
payload with ``validate_tenant_tags`` and derives the (T, R) masks with
``tenant_masks``.

`tenant_masks` maps the model's tenant→rule-tags table onto the compiled
ruleset: tenant 0 always runs the full (paranoia-filtered) set; a tenant
with tags runs exactly the rules carrying ≥1 of its tags (per-tenant
verdict masks over one shared NFA — SURVEY.md §7 hard part #6: no
per-tenant recompilation).
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.control.config import GlobalConfig
from ingress_plus_tpu_torch.control.model import (
    Configuration,
    build_configuration,
)
from ingress_plus_tpu_torch.control.objects import ConfigMap, Ingress
from ingress_plus_tpu_torch.control.template import render


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


@dataclass
class SyncResult:
    action: str                  # "reload" | "dynamic" | "noop"
    rendered: str
    configuration: Configuration
    pushed_tenants: bool = False
    pushed_acls: bool = False
    errors: List[str] = field(default_factory=list)


#: dynamic-push retry policy: bounded exponential backoff per channel
RETRY_BASE_S = 1.0
RETRY_MAX_S = 60.0


@dataclass
class _PushChannel:
    """Dirty-state tracking for one dynamic-push channel.

    A failed push used to leave ``last_*`` stale and hope a later sync
    re-diffed it — a push that kept failing was retried on EVERY tick
    (no backoff against a struggling serve loop), and a push=False tick
    in between silently marked it clean (the update was dropped until
    the next unrelated diff).  Now the desired payload is pinned here
    until it lands: every sync tick retries dirty channels whose backoff
    has elapsed, with the LATEST payload, converging regardless of what
    else changed in between."""

    path: str
    payload: object = None
    dirty: bool = False
    attempts: int = 0
    next_retry: float = 0.0    # monotonic deadline for the next attempt

    def mark(self, payload) -> None:
        if self.dirty and payload != self.payload:
            # intent changed mid-retry: push the NEW payload promptly —
            # the old backoff was earned by a stale body
            self.attempts = 0
            self.next_retry = 0.0
        self.payload = payload
        self.dirty = True


class SyncController:
    def __init__(self, global_config: Optional[GlobalConfig] = None,
                 serve_http: Optional[str] = None):
        self.global_config = global_config or GlobalConfig()
        self.serve_http = serve_http or self.global_config.sidecar_http
        self.last_rendered: Optional[str] = None
        self.last_tenants: Optional[Dict[int, Tuple[str, ...]]] = None
        self.last_acls: Optional[dict] = None
        self._channels: Dict[str, _PushChannel] = {
            "tenants": _PushChannel("/configuration/tenants"),
            "acl": _PushChannel("/configuration/acl"),
        }
        self._now = time.monotonic   # injectable clock (tests)

    def _post(self, path: str, obj) -> bool:
        url = "http://%s%s" % (self.serve_http, path)
        try:
            req = urllib.request.Request(
                url, data=json.dumps(obj).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as resp:
                return 200 <= resp.status < 300
        except OSError:
            return False

    def _acl_payload(self, cfg: Configuration) -> dict:
        """wallarm-acl push body: ACL content from the ConfigMap tier
        (GlobalConfig.acls JSON), bindings from per-Ingress annotations.
        Bindings naming an ACL with no content are dropped with a model
        error (the serve endpoint would reject the whole push)."""
        try:
            specs = json.loads(self.global_config.acls) \
                if self.global_config.acls else {}
            if not isinstance(specs, dict):
                raise ValueError("acls must be a JSON object")
        except (ValueError, TypeError) as e:
            cfg.errors.append("acls configmap value: %s" % e)
            specs = {}
        binding = {}
        for t, name in sorted(cfg.tenant_acls().items()):
            if name in specs:
                binding[str(t)] = name
            else:
                cfg.errors.append(
                    "tenant %d: wallarm-acl %r has no list content" % (t, name))
        return {"acls": specs, "tenant_acl": binding}

    def flush_pending(self) -> Dict[str, bool]:
        """Attempt every dirty channel whose backoff has elapsed; the
        retry half of the sync tick (also callable from a bare timer).
        Returns {channel: landed} for the channels actually attempted."""
        out: Dict[str, bool] = {}
        now = self._now()
        for name, ch in self._channels.items():
            if not ch.dirty or now < ch.next_retry:
                continue
            ok = self._post(ch.path, ch.payload)
            out[name] = ok
            if ok:
                ch.dirty = False
                ch.attempts = 0
                ch.next_retry = 0.0
            else:
                ch.attempts += 1
                ch.next_retry = now + min(
                    RETRY_BASE_S * (2 ** (ch.attempts - 1)), RETRY_MAX_S)
        return out

    def retry_state(self) -> Dict[str, dict]:
        """Dirty/backoff snapshot per channel (status & tests)."""
        now = self._now()
        return {name: {"dirty": ch.dirty, "attempts": ch.attempts,
                       "retry_in_s": round(max(ch.next_retry - now, 0.0), 3)
                       if ch.dirty else 0.0}
                for name, ch in self._channels.items()}

    def sync(self, ingresses: List[Ingress],
             configmap: Optional[ConfigMap] = None,
             push: bool = True) -> SyncResult:
        if configmap is not None:
            self.global_config = GlobalConfig.from_configmap(configmap)
            self.serve_http = self.global_config.sidecar_http
        cfg = build_configuration(ingresses, self.global_config)
        text = render(cfg, self.global_config)
        tags = cfg.tenant_tags()
        acls = self._acl_payload(cfg)

        if text != self.last_rendered:
            action = "reload"
        elif tags != self.last_tenants or acls != self.last_acls:
            action = "dynamic"
        else:
            action = "noop"

        # diff → dirty channel (the desired payload is pinned on the
        # channel until it LANDS, so a failed push keeps converging on
        # subsequent ticks with bounded exponential backoff instead of
        # waiting for the next unrelated diff)
        if push:
            if tags != self.last_tenants:
                self._channels["tenants"].mark(
                    {str(t): list(v) for t, v in tags.items()})
            if acls != self.last_acls:
                self._channels["acl"].mark(acls)
        self.last_rendered = text
        self.last_tenants = tags
        self.last_acls = acls

        pushed = pushed_acls = False
        errors = []
        if push:
            attempted = self.flush_pending()
            pushed = attempted.get("tenants", False)
            pushed_acls = attempted.get("acl", False)
            for name, ok in attempted.items():
                if not ok:
                    ch = self._channels[name]
                    errors.append(
                        "%s push to %s failed (attempt %d, retry in %.0fs)"
                        % (name, self.serve_http, ch.attempts,
                           max(ch.next_retry - self._now(), 0.0)))
        return SyncResult(action=action, rendered=text, configuration=cfg,
                          pushed_tenants=pushed, pushed_acls=pushed_acls,
                          errors=list(cfg.errors)
                          + list(self.global_config.errors) + errors)
