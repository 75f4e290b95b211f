"""IP access-control lists — the ``wallarm-acl`` enforcement engine.

The reference's ACL blocks/allows requests by source-IP lists managed in
the Wallarm cloud and referenced per-Ingress via the ``wallarm-acl``
annotation (SURVEY.md §2.1 wallarm annotations).  This module is the
runtime that evaluates it:

* ``Acl`` — named list of allow / deny / greylist CIDR entries with
  longest-prefix-match semantics (a /32 deny inside a /8 allow wins).
* ``AclStore`` — hot-swappable registry: the serve loop swaps it from
  ``POST /configuration/acl`` (the no-reload dynamic-config lane, like
  tenants/ruleset), and the pipeline consults it per request.

Greylist ties into ``safe_blocking`` mode: in that mode only attacks
from greylisted sources block; everything else is monitored
(``models/pipeline.py`` finalize).
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, List, Optional, Tuple

#: Request header carrying the client IP on the TRUSTED plane: injected
#: by the nginx shim / sidecar from the connection address (never
#: forwarded from the client — the shim overwrites any inbound copy,
#: exactly like the reference's realip handling).  Excluded from scanned
#: header rows (serve/normalize.py) so it can't perturb detection.
CLIENT_IP_HEADER = "x-detect-tpu-client-ip"

_ACTIONS = ("allow", "deny", "greylist")


class AclError(ValueError):
    pass


class Acl:
    """One compiled ACL: action lists of CIDR networks.

    Decision: longest matching prefix across all lists wins; ties break
    deny > greylist > allow (fail-closed for equal specificity).
    """

    def __init__(self, name: str,
                 allow: Optional[List[str]] = None,
                 deny: Optional[List[str]] = None,
                 greylist: Optional[List[str]] = None):
        self.name = name
        self._nets: List[Tuple[ipaddress._BaseNetwork, str]] = []
        for action, cidrs in (("allow", allow), ("deny", deny),
                              ("greylist", greylist)):
            for cidr in cidrs or []:
                try:
                    net = ipaddress.ip_network(cidr, strict=False)
                except ValueError as e:
                    raise AclError("acl %r: bad cidr %r: %s"
                                   % (name, cidr, e))
                self._nets.append((net, action))

    @classmethod
    def from_dict(cls, name: str, spec: dict) -> "Acl":
        unknown = set(spec) - set(_ACTIONS)
        if unknown:
            raise AclError("acl %r: unknown keys %s" % (name, sorted(unknown)))
        return cls(name, allow=spec.get("allow"), deny=spec.get("deny"),
                   greylist=spec.get("greylist"))

    def match(self, ip: str) -> Optional[str]:
        """'allow' | 'deny' | 'greylist' | None for an IP string."""
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return None
        best: Optional[Tuple[int, int, str]] = None
        rank = {"deny": 2, "greylist": 1, "allow": 0}
        for net, action in self._nets:
            if addr.version != net.version or addr not in net:
                continue
            key = (net.prefixlen, rank[action], action)
            if best is None or key[:2] > best[:2]:
                best = key
        return best[2] if best else None

    def __len__(self) -> int:
        return len(self._nets)


class AclStore:
    """Hot-swappable named-ACL registry (thread-safe swap, lock-free
    read of an immutable snapshot)."""

    def __init__(self):
        self._acls: Dict[str, Acl] = {}
        self._lock = threading.Lock()

    def swap(self, specs: Dict[str, dict]) -> List[str]:
        """Replace the whole registry atomically; returns loaded names.
        All specs are validated BEFORE the swap — a bad spec leaves the
        previous registry untouched."""
        acls = {name: Acl.from_dict(name, spec)
                for name, spec in specs.items()}
        with self._lock:
            self._acls = acls
        return sorted(acls)

    def get(self, name: str) -> Optional[Acl]:
        return self._acls.get(name)

    def names(self) -> List[str]:
        return sorted(self._acls)

    def evaluate(self, name: str, ip: Optional[str]) -> Optional[str]:
        """Decision for a request: None when the ACL or IP is unknown
        (fail-open — an unresolvable ACL must not outage traffic,
        mirroring wallarm-fallback)."""
        if not name or not ip:
            return None
        acl = self._acls.get(name)
        return acl.match(ip) if acl is not None else None
