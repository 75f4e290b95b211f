"""Brute-force / enumeration rate detection — the wruby `brute-detect`†
script analog (SURVEY.md §2.3).

The reference's cron script scans the postanalytics DB for high-rate
request streams against auth-ish endpoints and raises "brute" attacks;
its sibling heuristic raises "dirbust" (forced browsing) when one
source fans out over many distinct paths.  Here both detectors run
inside the exporter drain (same cadence position: off the hot path,
over queued hits) using sliding windows keyed per application (tenant)
and source:

* ``brute``  — per (tenant, client, path): ≥ threshold requests to one
  auth-shaped path inside the window.  Consumes ALL hits (attack or
  not — credential stuffing is mostly *clean* requests at high rate),
  which is why Hit records are enqueued for every request when a
  PostChannel is active, not only for attacks.
* ``dirbust`` — per (tenant, client): ≥ threshold DISTINCT paths inside
  the window (scanner/wordlist sweeps; auth-shaped or not).

Emitted attacks carry evidence in ``sample_points`` (the matched-points
analog for rate detections: the window, the count, the path) so the
attack export tells the operator exactly what tripped, like a rule hit
does.  Thresholds are deployment-configurable (serve CLI:
``--brute-threshold``/``--brute-window-s``/``--dirbust-threshold``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Sequence, Tuple

from ingress_plus_tpu_torch.post.queue import Hit
from ingress_plus_tpu_torch.post.aggregate import Attack

# path substrings that mark an auth-shaped target (the reference keys on
# configured "protected" endpoints; this default list mirrors its docs)
AUTH_MARKERS = ("login", "signin", "sign-in", "auth", "password", "passwd",
                "session", "token", "register", "wp-login")


def _path_key(uri: str) -> str:
    path = uri.split("?", 1)[0].lower()
    return path[:128]


def is_auth_path(uri: str) -> bool:
    p = _path_key(uri)
    return any(m in p for m in AUTH_MARKERS)


@dataclass
class BruteConfig:
    window_s: float = 60.0
    threshold: int = 25        # requests per window per (tenant,client,path)
    auth_only: bool = True     # rate-watch only auth-shaped paths
    #: forced-browsing sweep: distinct paths per (tenant, client) window;
    #: 0 disables the dirbust detector
    dirbust_threshold: int = 50
    dirbust_window_s: float = 60.0


class BruteDetector:
    def __init__(self, config: BruteConfig | None = None):
        self.config = config or BruteConfig()
        self._windows: Dict[Tuple[int, str, str], Deque[float]] = {}
        #: dirbust state: per (tenant, client) deque of (ts, path) plus
        #: an incremental path→count map so the distinct-path count is
        #: O(1) per hit (rebuilding the set per hit made
        #: the exporter drain O(n²) against a single chatty client)
        self._sweeps: Dict[Tuple[int, str], Deque[Tuple[float, str]]] = {}
        self._sweep_counts: Dict[Tuple[int, str], Dict[str, int]] = {}
        # keys already reported this window, so one burst → one attack
        self._reported: Dict[tuple, float] = {}

    def observe(self, hits: Sequence[Hit]) -> List[Attack]:
        """Feed a drained batch of hits; returns newly detected brute /
        dirbust attacks (one per offending key per window)."""
        cfg = self.config
        out: List[Attack] = []
        for hit in hits:
            out.extend(self._observe_brute(hit, cfg))
            if cfg.dirbust_threshold > 0:
                out.extend(self._observe_dirbust(hit, cfg))
        self._gc(time.time())
        return out

    def _observe_brute(self, hit: Hit, cfg: BruteConfig) -> List[Attack]:
        if cfg.auth_only and not is_auth_path(hit.uri):
            return []
        path = _path_key(hit.uri)
        key = (hit.tenant, hit.client, path)
        dq = self._windows.setdefault(key, deque())
        dq.append(hit.ts)
        while dq and hit.ts - dq[0] > cfg.window_s:
            dq.popleft()
        if len(dq) < cfg.threshold:
            return []
        last = self._reported.get(("b",) + key, -1e18)
        if hit.ts - last <= cfg.window_s:
            return []
        self._reported[("b",) + key] = hit.ts
        atk = Attack(tenant=hit.tenant, client=hit.client,
                     attack_class="brute", first_ts=dq[0], last_ts=hit.ts)
        atk.count = len(dq)
        atk.sample_uris = [hit.uri[:256]]
        atk.sample_request_ids = [hit.request_id]
        # rate evidence in the matched-points shape the export already
        # carries for rule hits (rule_id 0 = heuristic, not a rule)
        atk.sample_points = [{
            "rule_id": 0, "var": "RATE:%s" % path,
            "value": "%d requests in %.0fs from %s"
                     % (len(dq), cfg.window_s, hit.client)}]
        return [atk]

    def _observe_dirbust(self, hit: Hit, cfg: BruteConfig) -> List[Attack]:
        key = (hit.tenant, hit.client)
        dq = self._sweeps.setdefault(key, deque())
        counts = self._sweep_counts.setdefault(key, {})
        path = _path_key(hit.uri)
        dq.append((hit.ts, path))
        counts[path] = counts.get(path, 0) + 1
        while dq and hit.ts - dq[0][0] > cfg.dirbust_window_s:
            _ts, old = dq.popleft()
            c = counts.get(old, 0) - 1
            if c <= 0:
                counts.pop(old, None)
            else:
                counts[old] = c
        distinct = len(counts)
        if distinct < cfg.dirbust_threshold:
            return []
        last = self._reported.get(("d",) + key, -1e18)
        if hit.ts - last <= cfg.dirbust_window_s:
            return []
        self._reported[("d",) + key] = hit.ts
        atk = Attack(tenant=hit.tenant, client=hit.client,
                     attack_class="dirbust", first_ts=dq[0][0],
                     last_ts=hit.ts)
        # count = DISTINCT paths (what crossed dirbust_threshold), not
        # total window hits — a chatty client re-fetching each path
        # would otherwise export an inflated sweep size (ADVICE r05)
        atk.count = distinct
        atk.sample_uris = sorted(counts)[:Attack.MAX_SAMPLES]
        atk.sample_request_ids = [hit.request_id]
        atk.sample_points = [{
            "rule_id": 0, "var": "SWEEP",
            "value": "%d distinct paths in %.0fs from %s"
                     % (distinct, cfg.dirbust_window_s, hit.client)}]
        return [atk]

    def _gc(self, now: float) -> None:
        """Bound memory: drop idle windows (no hit for 2 windows)."""
        dead = [k for k, dq in self._windows.items()
                if not dq or now - dq[-1] > 2 * self.config.window_s]
        for k in dead:
            self._windows.pop(k, None)
            self._reported.pop(("b",) + k, None)
        dead2 = [k for k, dq in self._sweeps.items()
                 if not dq or now - dq[-1][0]
                 > 2 * self.config.dirbust_window_s]
        for k in dead2:
            self._sweeps.pop(k, None)
            self._sweep_counts.pop(k, None)
            self._reported.pop(("d",) + k, None)
