"""Postanalytics subsystem: the off-path half of the ingress (SURVEY.md
§1, §3.4).

Each verdict's hits go to a bounded in-memory queue; a background
exporter folds them into attacks and delivers them to a spool or an HTTP
collector, brute/dirbust detection scans request rates, the
``/wallarm-status`` counters are kept per node, and a watcher pulls fresh
compiled rulesets (the sync-node pull) and stages them through the serve
loop.  None of it is on the request hot path: the queue being down never
blocks traffic.

    HitQueue        — bounded in-memory queue; lossy under pressure
                      (drop-oldest + counter), never blocks
    aggregate_*     — hits → attacks windowed aggregation
    NodeCounters    — /wallarm-status counters
    BruteDetector   — request-rate detection (brute and dirbust)
    Exporter        — periodic drain → spool/POST
    RulesetWatcher  — watches for new compiled-ruleset artifacts and
                      posts them to the serve loop's staged swap
"""

from ingress_plus_tpu_torch.post.queue import Hit, HitQueue
from ingress_plus_tpu_torch.post.aggregate import Attack, aggregate_attacks
from ingress_plus_tpu_torch.post.counters import NodeCounters
from ingress_plus_tpu_torch.post.brute import BruteDetector
from ingress_plus_tpu_torch.post.export import Exporter, RulesetWatcher
from ingress_plus_tpu_torch.post.channel import PostChannel
from ingress_plus_tpu_torch.post.topk import SpaceSaving

__all__ = [
    "Hit", "HitQueue", "Attack", "aggregate_attacks", "NodeCounters",
    "BruteDetector", "Exporter", "RulesetWatcher", "PostChannel",
    "SpaceSaving",
]
