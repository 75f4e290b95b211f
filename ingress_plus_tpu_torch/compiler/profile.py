"""MeasuredProfile — the telemetry→compiler feedback artifact.

The approximate reduction (compiler/reduce.py) prices its candidate-
inflation budget against a *static* byte-frequency model, because a
compile must be deterministic and a fresh deployment has no traffic to
measure.  But a RUNNING node does: models/rule_stats.py counts per-rule
prefilter candidates, confirm cost, and quick-reject coverage, and the
pipeline's host-prep sees every scanned byte.  This module freezes that
telemetry into a versioned, content-hashed artifact the compiler can
load — closing the loop the approximate-NFA line (PAPERS.md,
arXiv:1710.08647) leaves open: spend the inflation budget where the
OBSERVED traffic says extra candidates are cheap, keep the factors of
rules the traffic actually candidates exact.

The profile is a *pricing input*, never a soundness input: a stale,
skewed, or adversarial profile can only make the compiled pack slower,
not unsound — every reduction op remains strictly over-approximating
and ``measure_inflation`` (lost_candidates == 0) gates the result
regardless of what the profile claims.  Determinism contract: the same
profile bytes + the same rules compile to the same pack fingerprint
(the retunegate CI gate retrains twice and asserts it).

Schema (docs/RETUNE.md):

  version        int — schema version (PROFILE_VERSION)
  source         str — ruleset version the counters were keyed by
  requests       int — requests the counters cover
  rules          {rule_id: {candidate_rate, confirmed_rate,
                            confirm_us_per_candidate, qr_skip_rate}}
  byte_freq      [256] floats — observed scanned-byte distribution
                 (normalized; zeros when the node never sampled bytes)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from hashlib import sha256
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MeasuredProfile", "ProfileVersionError", "PROFILE_VERSION"]

PROFILE_VERSION = 1


class ProfileVersionError(ValueError):
    """Structured merge rejection: profiles from different schema
    versions measure different things, so a cross-version merge is a
    hard error (never a silent best-effort).  Carries the conflicting
    version set so the fleet plane can report which node is behind."""

    def __init__(self, versions):
        self.versions = tuple(sorted(set(int(v) for v in versions)))
        super().__init__(
            "cannot merge MeasuredProfiles across schema versions %s "
            "(this compiler speaks v%d)"
            % (list(self.versions), PROFILE_VERSION))

#: blend weight of the observed byte distribution against the static
#: prior when building the pricing vector: the prior keeps every byte's
#: mass nonzero (a byte the sample never saw still occurs in traffic)
#: and damps small-sample noise — the same reason ``byte_model`` floors
#: control bytes instead of zeroing them
_PRIOR_BLEND = 0.15


@dataclass
class MeasuredProfile:
    """One node's measured detection profile, keyed by CRS rule id
    (sigpack row order changes across compiles; the ids do not)."""

    version: int = PROFILE_VERSION
    source: str = ""
    requests: int = 0
    #: rule_id → {candidate_rate, confirmed_rate,
    #:            confirm_us_per_candidate, qr_skip_rate}
    rules: Dict[int, Dict[str, float]] = field(default_factory=dict)
    #: observed scanned-byte distribution (256 floats, sums to 1.0, or
    #: all zeros when byte sampling never ran on the source node)
    byte_freq: List[float] = field(default_factory=list)

    # ------------------------------------------------------- construction

    @classmethod
    def from_rule_stats(cls, rs, byte_hist=None) -> "MeasuredProfile":
        """Freeze a RuleStats generation into a profile.  ``byte_hist``
        overrides the stats object's own sampled histogram (the export
        tool passes a corpus-derived one when the node never sampled)."""
        requests, cand, conf, _err, _sc, _bl = rs._snap()
        ns, skips, evals = rs._snap_confirm()
        n = max(requests, 1)
        rules: Dict[int, Dict[str, float]] = {}
        for i, rid in enumerate(rs.rule_ids):
            c = int(cand[i])
            if c == 0 and int(conf[i]) == 0:
                continue          # silent rules carry no signal
            checked = int(skips[i]) + int(evals[i])
            rules[int(rid)] = {
                "candidate_rate": round(c / n, 6),
                "confirmed_rate": round(int(conf[i]) / n, 6),
                "confirm_us_per_candidate":
                    round(int(ns[i]) / 1000.0 / c, 3) if c else 0.0,
                "qr_skip_rate":
                    round(int(skips[i]) / checked, 4) if checked else 0.0,
            }
        if byte_hist is None:
            byte_hist = getattr(rs, "byte_hist", None)
        freq: List[float] = []
        if byte_hist is not None:
            h = np.asarray(byte_hist, dtype=np.float64)
            if h.shape == (256,) and h.sum() > 0:
                freq = [round(float(x), 9) for x in (h / h.sum())]
        return cls(source=rs.version, requests=requests, rules=rules,
                   byte_freq=freq)

    @classmethod
    def from_corpus_rows(cls, rows, source: str = "corpus",
                         rules: Optional[Dict] = None) -> "MeasuredProfile":
        """Profile with only the byte-frequency axis, derived from raw
        request rows (the bootstrap path when no node telemetry exists
        yet — tools/retune.py --corpus)."""
        h = np.zeros(256, dtype=np.int64)
        for r in rows:
            h += np.bincount(np.frombuffer(r, dtype=np.uint8),
                             minlength=256)
        freq = ([round(float(x), 9) for x in (h / h.sum())]
                if h.sum() > 0 else [])
        return cls(source=source, requests=len(rows),
                   rules=dict(rules or {}), byte_freq=freq)

    @classmethod
    def merge(cls, profiles, weights=None) -> "MeasuredProfile":
        """Traffic-weighted merge of per-node profiles into one fleet
        profile (the artifact ROADMAP item 4's continuous-retune daemon
        consumes).

        Weights default to each profile's ``requests`` field — the
        per-generation traffic weight exported in the canonical bytes —
        so a node that served 10x the traffic moves the merged rates
        10x as much.  Semantics per field:

        * per-request rates (``candidate_rate``, ``confirmed_rate``)
          average over ALL weight (a rule absent from a node's profile
          contributed zero candidates on that node's traffic);
        * ``confirm_us_per_candidate`` is a per-*candidate* quantity,
          so it averages weighted by each node's candidate volume
          (weight x candidate_rate);
        * ``qr_skip_rate`` averages over the nodes that observed the
          rule at all;
        * ``byte_freq`` is the weighted average distribution,
          renormalized; ``requests`` sum.

        Determinism contract: inputs are canonicalized by sorting on
        content hash before any float accumulates, and the merged
        fields round exactly like ``from_rule_stats`` — the same input
        set produces the same canonical bytes and the same
        ``content_hash`` regardless of argument order (fleetgate
        asserts it).  Mixed ``version`` values raise
        :class:`ProfileVersionError`."""
        profiles = list(profiles)
        if not profiles:
            raise ValueError("merge() of zero profiles")
        if len({p.version for p in profiles}) > 1:
            raise ProfileVersionError([p.version for p in profiles])
        if weights is None:
            weights = [float(max(p.requests, 0)) for p in profiles]
        else:
            weights = [float(w) for w in weights]
            if len(weights) != len(profiles):
                raise ValueError("merge(): %d weights for %d profiles"
                                 % (len(weights), len(profiles)))
            if any(w < 0 for w in weights):
                raise ValueError("merge(): negative weight")
        # canonical accumulation order: float sums must not depend on
        # the caller's argument order
        order = sorted(range(len(profiles)),
                       key=lambda i: (profiles[i].content_hash(), i))
        profiles = [profiles[i] for i in order]
        weights = [weights[i] for i in order]
        wsum = sum(weights)
        if wsum <= 0:                 # all-idle fleet: unweighted mean
            weights = [1.0] * len(profiles)
            wsum = float(len(profiles))

        rules: Dict[int, Dict[str, float]] = {}
        for rid in sorted({r for p in profiles for r in p.rules}):
            cand = conf = 0.0
            cost_num = cost_den = 0.0
            qr_num = qr_den = 0.0
            for p, w in zip(profiles, weights):
                rec = p.rules.get(rid)
                if rec is None:
                    continue          # zero candidates on that node
                cr = float(rec.get("candidate_rate", 0.0))
                cand += w * cr
                conf += w * float(rec.get("confirmed_rate", 0.0))
                cost_num += w * cr * float(
                    rec.get("confirm_us_per_candidate", 0.0))
                cost_den += w * cr
                qr_num += w * float(rec.get("qr_skip_rate", 0.0))
                qr_den += w
            rules[rid] = {
                "candidate_rate": round(cand / wsum, 6),
                "confirmed_rate": round(conf / wsum, 6),
                "confirm_us_per_candidate":
                    round(cost_num / cost_den, 3) if cost_den > 0
                    else 0.0,
                "qr_skip_rate":
                    round(qr_num / qr_den, 4) if qr_den > 0 else 0.0,
            }

        acc = np.zeros(256, dtype=np.float64)
        freq_w = 0.0
        for p, w in zip(profiles, weights):
            if len(p.byte_freq) == 256 and w > 0:
                acc += w * np.asarray(p.byte_freq, dtype=np.float64)
                freq_w += w
        freq: List[float] = []
        if freq_w > 0 and acc.sum() > 0:
            freq = [round(float(x), 9) for x in (acc / acc.sum())]

        src = "+".join(sorted({p.source for p in profiles if p.source}))
        if not src or len(src) > 96:
            src = "merge-of-%d" % len(profiles)
        return cls(version=profiles[0].version, source=src,
                   requests=sum(int(p.requests) for p in profiles),
                   rules=rules, byte_freq=freq)

    # -------------------------------------------------------- serialize

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "source": self.source,
            "requests": self.requests,
            "rules": {str(k): v for k, v in sorted(self.rules.items())},
            "byte_freq": list(self.byte_freq),
        }

    def to_json(self) -> str:
        # canonical form (sorted keys, no whitespace variance): the
        # content hash is over these exact bytes
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Dict) -> "MeasuredProfile":
        v = int(d.get("version", PROFILE_VERSION))
        if v > PROFILE_VERSION:
            # structured (carries .versions) so the fleet plane can
            # report WHICH node is ahead instead of a bare string
            raise ProfileVersionError([v, PROFILE_VERSION])
        return cls(
            version=v,
            source=str(d.get("source", "")),
            requests=int(d.get("requests", 0)),
            rules={int(k): dict(val)
                   for k, val in (d.get("rules") or {}).items()},
            byte_freq=[float(x) for x in (d.get("byte_freq") or [])],
        )

    @classmethod
    def from_json(cls, text: str) -> "MeasuredProfile":
        return cls.from_dict(json.loads(text))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "MeasuredProfile":
        return cls.from_json(Path(path).read_text())

    def content_hash(self) -> str:
        """16-hex content hash over the canonical json — recorded in the
        compiled pack's reduction provenance so an artifact always says
        which profile priced it."""
        return sha256(self.to_json().encode()).hexdigest()[:16]

    # ---------------------------------------------------- pricing views

    def byte_mu(self) -> Optional[np.ndarray]:
        """(256,) pricing vector: the observed distribution blended with
        the static prior (compiler/reduce.py byte_model) so unseen bytes
        keep nonzero mass.  None when the profile carries no byte axis —
        the caller falls back to the static model."""
        if len(self.byte_freq) != 256:
            return None
        obs = np.asarray(self.byte_freq, dtype=np.float64)
        s = obs.sum()
        if s <= 0:
            return None
        from ingress_plus_tpu_torch.compiler.reduce import byte_model

        mu = (1.0 - _PRIOR_BLEND) * (obs / s) + _PRIOR_BLEND * byte_model()
        return mu / mu.sum()

    def rule_weights(self, rule_ids, floor: float = 0.25,
                     ceil: float = 8.0) -> np.ndarray:
        """(R,) float pricing weights aligned to a pack's rule axis:
        each rule's observed candidate rate relative to the profile's
        median active rate, clipped to [floor, ceil].  A hot rule's
        factors become expensive to widen (its extra candidates are
        real wasted confirms); a cold rule's factors absorb the budget.
        Rules the profile never saw price at 1.0 — the static behavior.
        """
        rates = [r["candidate_rate"] for r in self.rules.values()
                 if r.get("candidate_rate", 0) > 0]
        med = float(np.median(rates)) if rates else 0.0
        out = np.ones(len(rule_ids), dtype=np.float64)
        if med <= 0:
            return out
        for i, rid in enumerate(rule_ids):
            rec = self.rules.get(int(rid))
            if rec is None:
                continue
            rate = rec.get("candidate_rate", 0.0)
            out[i] = min(max(rate / med, floor), ceil)
        return out

    def hot_rule_ids(self, frac: float = 0.1) -> set:
        """Rule ids in the top ``frac`` of observed candidate rate —
        the rules whose factors keep their exact windows (re-tiering:
        a hot rule's prefilter precision is worth device words)."""
        active = [(r["candidate_rate"], rid)
                  for rid, r in self.rules.items()
                  if r.get("candidate_rate", 0) > 0]
        if not active:
            return set()
        active.sort(reverse=True)
        k = max(1, int(len(active) * frac))
        return {rid for _rate, rid in active[:k]}

    def top_expensive_confirms(self, n: int = 16) -> List[int]:
        """Rule ids ranked by observed us-per-candidate confirm cost —
        the quick-reject relaxation targets (deterministic given the
        profile: rule id breaks ties)."""
        ranked = sorted(
            ((r.get("confirm_us_per_candidate", 0.0), rid)
             for rid, r in self.rules.items()
             if r.get("confirm_us_per_candidate", 0.0) > 0),
            key=lambda t: (-t[0], t[1]))
        return [rid for _cost, rid in ranked[:n]]
