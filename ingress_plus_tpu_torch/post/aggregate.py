"""Hits → attacks aggregation — the wruby `export-attacks`† analog
(SURVEY.md §2.3, §3.4).

The reference's cron scripts read raw hits from Tarantool and fold them
into "attacks": one logical attack = a stream of hits from the same
source against the same target with the same attack class, within a time
window.  The cloud receives attacks, not raw hits.  Same fold here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ingress_plus_tpu_torch.post.queue import Hit


@dataclass
class Attack:
    tenant: int
    client: str
    attack_class: str
    first_ts: float
    last_ts: float
    count: int = 0
    blocked: int = 0
    max_score: int = 0
    # bounded samples so a flood can't balloon the export record
    sample_uris: List[str] = field(default_factory=list)
    sample_rule_ids: List[int] = field(default_factory=list)
    sample_request_ids: List[str] = field(default_factory=list)
    sample_points: List[dict] = field(default_factory=list)
    # companion set for sample_rule_ids dedup: O(1) membership on the
    # verdict-record path instead of list scans; the exported to_dict
    # stays the capped, insertion-ordered LIST above
    _rid_seen: set = field(default_factory=set, repr=False, compare=False)

    MAX_SAMPLES = 8

    def add(self, hit: Hit) -> None:
        self.count += 1
        self.blocked += int(hit.blocked)
        self.max_score = max(self.max_score, hit.score)
        self.first_ts = min(self.first_ts, hit.ts)
        self.last_ts = max(self.last_ts, hit.ts)
        if len(self.sample_uris) < self.MAX_SAMPLES:
            self.sample_uris.append(hit.uri[:256])
            self.sample_request_ids.append(hit.request_id)
        for r in hit.rule_ids:
            if len(self.sample_rule_ids) >= self.MAX_SAMPLES:
                break
            if r not in self._rid_seen:
                self._rid_seen.add(r)
                self.sample_rule_ids.append(r)
        for p in hit.matches:
            if len(self.sample_points) >= self.MAX_SAMPLES:
                break
            if p not in self.sample_points:   # distinct points only
                self.sample_points.append(p)

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant, "client": self.client,
            "class": self.attack_class, "first_ts": self.first_ts,
            "last_ts": self.last_ts, "count": self.count,
            "blocked": self.blocked, "max_score": self.max_score,
            "sample_uris": self.sample_uris,
            "sample_rule_ids": self.sample_rule_ids,
            "sample_request_ids": self.sample_request_ids,
            "sample_points": self.sample_points,
        }


def aggregate_attacks(hits: Sequence[Hit],
                      gap_s: float = 60.0) -> List[Attack]:
    """Fold hits into attacks.

    Key = (tenant, client, attack_class); a hit more than ``gap_s`` after
    the key's last hit starts a NEW attack (session-window semantics —
    the same shape the reference's exporter uses so repeat offenders over
    hours show as separate attacks, not one eternal record).  Hits with
    no classes (fail-open flags, clean-but-logged) are skipped.
    """
    open_attacks: Dict[Tuple[int, str, str], Attack] = {}
    done: List[Attack] = []
    for hit in sorted(hits, key=lambda h: h.ts):
        if not hit.attack:
            continue
        for cls in hit.classes or ("unclassified",):
            key = (hit.tenant, hit.client, cls)
            cur = open_attacks.get(key)
            if cur is not None and hit.ts - cur.last_ts > gap_s:
                done.append(cur)
                cur = None
            if cur is None:
                cur = Attack(tenant=hit.tenant, client=hit.client,
                             attack_class=cls, first_ts=hit.ts,
                             last_ts=hit.ts)
                open_attacks[key] = cur
            cur.add(hit)
    done.extend(open_attacks.values())
    return done
