"""Top-K heavy hitters — the space-saving sketch (Metwally et al.,
"Efficient computation of frequent and top-k elements in data streams").

The postanalytics plane wants "which paths / tenants are drawing the
attacks" without keeping a counter per distinct key — a scanner sweep
generates unbounded distinct URIs, so an exact dict is exactly the
unbounded-cardinality hazard the NodeCounters caps exist to prevent.
The sketch keeps at most ``capacity`` tracked keys: an untracked key
evicts the current minimum and INHERITS its count (the classic
over-estimate; the inherited amount is kept per entry as ``max_error``
so consumers see the bound, not a false precision).

Guarantees (from the paper): any key with true frequency greater than
the minimum tracked count is in the sketch, and every reported count
over-estimates by at most that entry's ``max_error``.

Served under ``/wallarm-status`` as ``top_attacked`` (post/channel.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ingress_plus_tpu_torch.utils.trace import named_lock


class SpaceSaving:
    """Bounded top-K counter sketch.  O(capacity) eviction scan on a
    miss-while-full — capacity is small (default 32), and offers happen
    once per attack verdict, not per request."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._counts: Dict[str, int] = {}
        self._error: Dict[str, int] = {}
        self._lock = named_lock("SpaceSaving._lock")

    def __len__(self) -> int:
        return len(self._counts)

    def offer(self, key: str, inc: int = 1) -> None:
        with self._lock:
            if key in self._counts:
                self._counts[key] += inc
                return
            if len(self._counts) < self.capacity:
                self._counts[key] = inc
                self._error[key] = 0
                return
            victim = min(self._counts, key=self._counts.__getitem__)
            floor = self._counts.pop(victim)
            self._error.pop(victim, None)
            # the newcomer inherits the evicted minimum: its true count
            # is somewhere in (inc, floor + inc] — floor is the error
            self._counts[key] = floor + inc
            self._error[key] = floor

    def summary(self) -> dict:
        """Sketch occupancy metadata — capacity vs tracked keys and the
        total tracked mass — so status views (``/tenants``,
        ``/wallarm-status``) can render ``items()`` next to the bound
        they were computed under instead of implying exactness."""
        with self._lock:
            return {"capacity": self.capacity,
                    "tracked": len(self._counts),
                    "total": sum(self._counts.values())}

    def items(self, n: Optional[int] = None) -> List[dict]:
        """Tracked keys, count-descending: ``{key, count, max_error}``
        — ``count`` may over-estimate by up to ``max_error``."""
        with self._lock:
            rows = sorted(self._counts.items(),
                          key=lambda kv: (-kv[1], kv[0]))
            return [{"key": k, "count": c,
                     "max_error": self._error.get(k, 0)}
                    for k, c in (rows[:n] if n else rows)]
