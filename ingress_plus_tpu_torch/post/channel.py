"""PostChannel — the serve loop's write side of postanalytics.

The reference's wallarm module serializes each request's outcome to
Tarantool in the nginx log phase, AFTER the response is on the wire
(SURVEY.md §3.3 "log phase: async serialize ... off hot path").  The
serve loop calls ``record`` after the verdict future resolves and the
response frame is queued — an O(1) counter update + deque append; the
exporter thread does everything heavy later.
"""

from __future__ import annotations

import time
from typing import Optional

from ingress_plus_tpu_torch.post.brute import BruteConfig, BruteDetector
from ingress_plus_tpu_torch.post.counters import NodeCounters
from ingress_plus_tpu_torch.post.export import Exporter
from ingress_plus_tpu_torch.post.queue import Hit, HitQueue
from ingress_plus_tpu_torch.post.topk import SpaceSaving
from ingress_plus_tpu_torch.serve.normalize import Request

_CLIENT_HEADERS = ("x-real-ip", "x-forwarded-for", "x-client-ip")


def client_key(request: Request) -> str:
    """Client identity for aggregation: proxy-provided real IP when the
    nginx shim forwards it, else a stable per-connection fallback."""
    lowered = {k.lower(): v for k, v in request.headers.items()}
    for h in _CLIENT_HEADERS:
        v = lowered.get(h)
        if v:
            return v.split(",")[0].strip()[:64]
    return "-"


class PostChannel:
    def __init__(self, spool_dir: Optional[str] = None,
                 http_url: Optional[str] = None,
                 interval_s: float = 5.0,
                 queue_len: int = 65536,
                 brute: bool = True,
                 brute_config: Optional[BruteConfig] = None):
        self.queue = HitQueue(maxlen=queue_len)
        self.counters = NodeCounters()
        # top-K attacked paths / tenants (bounded space-saving sketch,
        # post/topk.py) — heavy-hitter visibility without a counter per
        # distinct URI (a scanner sweep has unbounded distinct paths)
        self.top_paths = SpaceSaving(capacity=32)
        self.top_tenants = SpaceSaving(capacity=32)
        # admission-level abuse: which tenants draw the
        # shed/degraded verdicts — the tenant-guard's quarantine and
        # fair-admission decisions, visible to postanalytics
        self.top_shed_tenants = SpaceSaving(capacity=32)
        self.exporter = Exporter(
            self.queue, spool_dir=spool_dir, http_url=http_url,
            interval_s=interval_s,
            brute=BruteDetector(brute_config) if brute else None,
            # exported events (incl. brute/dirbust) feed the
            # per-application counters the status plane serves
            on_export=self.counters.record_export_events)

    def record(self, request: Request, verdict) -> None:
        degraded = bool(getattr(verdict, "degraded", False))
        self.counters.record(
            attack=verdict.attack, blocked=verdict.blocked,
            fail_open=verdict.fail_open, classes=verdict.classes,
            tenant=request.tenant, mode=request.mode,
            degraded=degraded)
        if verdict.attack:
            self.top_paths.offer(request.uri.split("?", 1)[0][:128])
            self.top_tenants.offer(str(request.tenant))
        if verdict.fail_open or degraded:
            self.top_shed_tenants.offer(str(request.tenant))
        # every request is queued (brute-detect needs clean-request rates);
        # the aggregator ignores non-attacks for attack export
        self.queue.put(Hit(
            ts=time.time(), request_id=request.request_id,
            tenant=request.tenant, client=client_key(request),
            method=request.method, uri=request.uri[:512],
            classes=tuple(verdict.classes),
            rule_ids=tuple(verdict.rule_ids),
            score=verdict.score, blocked=verdict.blocked,
            attack=verdict.attack, fail_open=verdict.fail_open,
            mode=request.mode,
            # verdict is duck-typed (ws/stream paths and tests pass
            # lightweight stubs) — matches/elapsed are optional there
            elapsed_us=int(getattr(verdict, "elapsed_us", 0)),
            matches=tuple(getattr(verdict, "matches", ()))))

    def start(self) -> None:
        self.exporter.start()

    def close(self) -> None:
        self.exporter.close()

    def status(self) -> dict:
        d = self.counters.snapshot()
        d["queue"] = {"depth": len(self.queue), "dropped": self.queue.dropped,
                      "total": self.queue.total}
        d["export"] = {"attacks": self.exporter.exported_attacks,
                       "errors": self.exporter.export_errors,
                       "consecutive_failures":
                           self.exporter.consecutive_failures,
                       "backoff_s": round(self.exporter.backoff_s, 3),
                       "spool_dropped_files":
                           self.exporter.spool_dropped_files,
                       "spool_dropped_bytes":
                           self.exporter.spool_dropped_bytes}
        d["top_attacked"] = {
            "paths": self.top_paths.items(10),
            "tenants": self.top_tenants.items(10),
            # admission-level abuse: shed/degraded verdict
            # heavy hitters — the serve plane's tenant-isolation
            # decisions, aggregated under the same sketch bound
            "shed_tenants": self.top_shed_tenants.items(10),
            "note": "space-saving sketch: count may over-estimate by "
                    "up to max_error",
        }
        return d
