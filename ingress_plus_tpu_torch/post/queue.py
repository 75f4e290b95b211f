"""Hit queue — the Tarantool postanalytics queue analog (SURVEY.md §3.4).

Contract carried over from the reference: writes happen asynchronously
after the verdict is already delivered, and the queue being full or the
consumer being dead NEVER blocks or fails a request — postanalytics is
strictly off-path.  Hence: bounded deque, drop-oldest under pressure,
a drop counter for observability, and O(1) lock-held sections only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Tuple


@dataclass
class Hit:
    """One detection event (the module→Tarantool serialized record analog).

    The reference ships the whole serialized request; we ship the verdict
    facts plus enough request identity to aggregate (uri, client, tenant)
    — raw bodies stay out of the queue by default (bounded memory)."""

    ts: float
    request_id: str
    tenant: int
    client: str            # client identity: X-Real-IP / X-Forwarded-For
    method: str
    uri: str
    classes: Tuple[str, ...]
    rule_ids: Tuple[int, ...]
    score: int
    blocked: bool
    attack: bool
    fail_open: bool = False
    mode: int = 2
    #: detection latency (µs) the verdict carried — lets the export /
    #: spool side correlate slow verdicts with the serve plane's
    #: /traces/request?id= spans by request_id
    elapsed_us: int = 0
    #: matched points ({rule_id, var, value-snippet}) — the reference
    #: ships the serialized request and the cloud re-derives points; we
    #: ship the points themselves (bounded, raw bodies stay out)
    matches: Tuple[dict, ...] = ()

    def to_dict(self) -> dict:
        d = asdict(self)
        d["classes"] = list(self.classes)
        d["rule_ids"] = list(self.rule_ids)
        d["matches"] = list(d["matches"])  # keep asdict's deep copies
        return d


class HitQueue:
    """Bounded MPSC-ish queue: many serve-loop producers, one exporter
    consumer.  `put` never blocks; overflow drops the OLDEST record
    (freshest data wins, like a ring buffer) and counts the drop."""

    def __init__(self, maxlen: int = 65536):
        self._dq: deque[Hit] = deque()
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self.dropped = 0
        self.total = 0

    def put(self, hit: Hit) -> None:
        with self._lock:
            self.total += 1
            if len(self._dq) >= self.maxlen:
                self._dq.popleft()
                self.dropped += 1
            self._dq.append(hit)

    def drain(self, max_items: Optional[int] = None) -> List[Hit]:
        """Remove and return up to max_items oldest hits (all by default)."""
        out: List[Hit] = []
        with self._lock:
            n = len(self._dq) if max_items is None else min(
                max_items, len(self._dq))
            for _ in range(n):
                out.append(self._dq.popleft())
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)
