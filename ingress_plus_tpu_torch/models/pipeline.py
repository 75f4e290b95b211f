"""DetectionPipeline — requests in, verdicts out.

The port of ``ingress_plus_tpu/models/pipeline.py``'s request→verdict
path:

    requests ─normalize─▶ scan rows ─L-buckets─▶ device scan + mapping
             ─▶ prefilter hits ─tenant/paranoia mask─▶ CPU confirm
             ─▶ anomaly scoring, ACL, mode ─▶ Verdict per request

Modes mirror the reference's ``wallarm_mode``: "off", "monitoring"
(detect, never block), "safe_blocking", "block".  ``fail_open`` mirrors
``wallarm-fallback``: any engine error yields pass-and-flag verdicts.

Not ported here: the brownout ladder, serve lanes, the learned scoring
head, RuleStats telemetry, the cross-cycle verdict cache, the pooled
confirm workers and fault-injection sites.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ingress_plus_tpu_torch.compiler.ruleset import (
    CompiledRuleset,
    N_HEAD_SV,
    VARIANTS,
)
from ingress_plus_tpu_torch.compiler.seclang import CLASSES, STREAMS
from ingress_plus_tpu_torch.models.acl import AclStore
from ingress_plus_tpu_torch.models.confirm import (
    ConfirmRule,
    parse_exclusion_token,
)
from ingress_plus_tpu_torch.models.confirm_plane import (
    join_confirm,
    launch_confirm,
)
from ingress_plus_tpu_torch.models.engine import DetectionEngine
from ingress_plus_tpu_torch.ops.scan import pad_rows
from ingress_plus_tpu_torch.serve.normalize import (
    Request,
    merged_rows_for_requests,
    needed_variants_by_stream,
)
from ingress_plus_tpu_torch.utils.device import DeviceLike

#: wallarm_mode precedence (weakest → strongest).  Wire values (frame
#: mode bits 0-1) are historical — safe_blocking is value 3, BETWEEN
#: monitoring and block in strength — so strength is a lookup.
MODE_STRENGTH = {0: 0, 1: 1, 3: 2, 2: 3}   # off, monitoring, safe_blocking, block
MODE_NAME_STRENGTH = {"off": 0, "monitoring": 1, "safe_blocking": 2,
                      "block": 3}


@dataclass
class Verdict:
    request_id: str
    blocked: bool
    attack: bool
    classes: List[str]
    rule_ids: List[int]
    score: int
    fail_open: bool = False
    #: ruleset version that produced this verdict; empty on fail-open
    generation: str = ""
    elapsed_us: int = 0
    #: matched points for the attack export: up to 8 dicts {rule_id,
    #: var, value}
    matches: List[dict] = field(default_factory=list)


@dataclass
class PipelineStats:
    requests: int = 0
    batches: int = 0
    truncated_rows: int = 0
    prefilter_rule_hits: int = 0
    confirmed_rule_hits: int = 0
    fail_open: int = 0
    #: host prep (normalize/merge), device stage (pad/pack + scan +
    #: mapping, synchronized by the copy back), confirm + fold
    prep_us: int = 0
    engine_us: int = 0
    confirm_us: int = 0
    #: live rows per L tier
    bucket_rows: Dict[int, int] = field(default_factory=dict)
    confirm_memo_hits: int = 0
    confirm_memo_misses: int = 0

    def count_fail_open(self, n: int = 1) -> None:
        self.fail_open += n


class DetectionPipeline:
    # Fixed length tiers; rows longer than the last tier are TRUNCATED at
    # 16KB in this batched path (stats.truncated_rows counts them).
    L_BUCKETS = (64, 128, 256, 512, 2048, 16384)

    @staticmethod
    def _pad_q(n: int, floor: int = 4) -> int:
        p = floor
        while p < n:
            p *= 2
        return p

    def __init__(
        self,
        ruleset: CompiledRuleset,
        mode: str = "block",
        anomaly_threshold: Optional[int] = None,
        fail_open: bool = True,
        paranoia_level: Optional[int] = None,
        tenant_rule_mask: Optional[np.ndarray] = None,  # (T, R) bool
        scan_impl: Optional[str] = None,
        acl_store: Optional[AclStore] = None,
        tenant_acl: Optional[Dict[int, str]] = None,
        default_acl: str = "",
        engine: Optional[DetectionEngine] = None,
        confirm_memo_entries: int = 4096,
        device: DeviceLike = None,
    ):
        # ``device`` None = the CUDA card; ``scan_impl`` None = the
        # device's default (pallas3 on cuda, pair on cpu)
        self.engine = (engine if engine is not None
                       else DetectionEngine(ruleset, scan_impl=scan_impl,
                                            device=device))
        self.mode = mode
        self.acl_store = acl_store if acl_store is not None else AclStore()
        self.tenant_acl: Dict[int, str] = dict(tenant_acl or {})
        self.default_acl = default_acl
        # precedence for both knobs: explicit arg > the pack's compiled
        # CRS config > classic defaults (threshold 5, PL2)
        if anomaly_threshold is None:
            anomaly_threshold = getattr(ruleset, "anomaly_threshold",
                                        None) or 5
        self.anomaly_threshold = anomaly_threshold
        if paranoia_level is None:
            paranoia_level = getattr(ruleset, "paranoia_hint", None) or 2
        self.fail_open = fail_open
        self.stats = PipelineStats()
        #: per-cycle flood-memo capacity; 0 disables memoization
        self.confirm_memo_entries = int(confirm_memo_entries)
        self.tenant_rule_mask = tenant_rule_mask
        self._install(ruleset, paranoia_level)

    # ------------------------------------------------------------- setup

    def _install(self, ruleset: CompiledRuleset, paranoia_level: int) -> None:
        self.ruleset = ruleset
        self.generation_tag = ruleset.version
        self.confirms = [ConfirmRule(m.confirm) for m in ruleset.rules]
        self.paranoia_mask = ruleset.rule_paranoia <= paranoia_level
        self.needed_sv = set(
            int(sv) for sv in np.nonzero(ruleset.rule_sv_mask.any(axis=0))[0])
        self._variants_for = needed_variants_by_stream(self.needed_sv)
        # rows whose stream-variant ids all sit below this are
        # uri/args/headers rows and may scan the sliced head words
        self._n_head_sv = N_HEAD_SV
        # runtime ctl exclusions: resolve the compile-time specs to index
        # masks once per install — finalize applies plain boolean ops
        self.ctl_rules = []
        self._ctl_pass_idx = set()
        for ci, spec in sorted(getattr(ruleset, "ctl_specs", {}).items()):
            remove_mask = np.isin(
                ruleset.rule_ids, np.asarray(spec.get("remove_ids", []),
                                             dtype=np.int64))
            target_excl: dict = {}
            for rid_str, toks in spec.get("target_excl", {}).items():
                excl_map: dict = {}
                for tok in toks:
                    parsed = parse_exclusion_token(tok)
                    if parsed is None:
                        continue
                    kinds, sel = parsed
                    for kind in kinds:
                        excl_map.setdefault(kind, set()).add(sel)
                if not excl_map:
                    continue
                for idx in np.nonzero(
                        ruleset.rule_ids == int(rid_str))[0]:
                    merged = target_excl.setdefault(int(idx), {})
                    for kind, sels in excl_map.items():
                        merged.setdefault(kind, set()).update(sels)
            engine = spec.get("engine")
            if engine is None and spec.get("engine_off"):
                engine = "off"                 # legacy checkpoint key
            self.ctl_rules.append(
                (int(ci), remove_mask, target_excl, engine))
            if ruleset.rule_action[ci] == 0:   # pass-action config rule:
                self._ctl_pass_idx.add(int(ci))  # never a detection hit

    def swap_ruleset(self, ruleset: CompiledRuleset,
                     paranoia_level: Optional[int] = None) -> None:
        """Install a new pack generation."""
        self.engine.swap_ruleset(ruleset)
        if paranoia_level is None:   # same precedence as __init__
            paranoia_level = getattr(ruleset, "paranoia_hint", None) or 2
        self._install(ruleset, paranoia_level)

    # ------------------------------------------------------------ detect

    def detect(self, requests: Sequence[Request]) -> List[Verdict]:
        t0 = time.perf_counter()
        requests = list(requests)
        if not requests:
            return []
        try:
            return self._detect_inner(requests, t0)
        except Exception:
            if not self.fail_open:
                raise
            # fail-open contract (wallarm-fallback): pass + flag
            self.stats.fail_open += len(requests)
            return [
                Verdict(request_id=r.request_id, blocked=False, attack=False,
                        classes=[], rule_ids=[], score=0, fail_open=True)
                for r in requests
            ]

    def _detect_inner(self, requests: List[Request],
                      t0: float) -> List[Verdict]:
        self.stats.requests += len(requests)
        self.stats.batches += 1
        return self.finalize(requests, self.prefilter(requests), t0)

    def _build_scan_buckets(self, requests: List[Request]):
        """Host prep: normalize rows, merge, L-tier bucket/pad/pack.
        Returns ``(buckets, head_ok)``; ``buckets`` is empty when no
        request carries scannable bytes."""
        tp0 = time.perf_counter()
        data_list, req_list, sv_list = merged_rows_for_requests(
            requests, variants_for=self._variants_for)
        Q = len(requests)
        stats = self.stats
        stats.prep_us += int((time.perf_counter() - tp0) * 1e6)
        if not data_list:
            return [], False
        n_sv = len(STREAMS) * len(VARIANTS)
        # rows bucket into fixed L tiers, row counts pad to powers of two
        by_bucket: Dict[int, List[int]] = {}
        for i, d in enumerate(data_list):
            for L in self.L_BUCKETS:
                if len(d) <= L or L == self.L_BUCKETS[-1]:
                    by_bucket.setdefault(L, []).append(i)
                    break
        # head_ok: no row carries a body/response stream-variant ⇒ the
        # sliced head words suffice
        head_ok = (self.engine.head_slicing_active()
                   and all(s < self._n_head_sv
                           for sv in sv_list for s in sv))
        buckets = []
        for L, idxs in sorted(by_bucket.items()):
            B_pad = self._pad_q(len(idxs), floor=8)
            stats.truncated_rows += sum(
                1 for i in idxs if len(data_list[i]) > L)
            rows_b = [data_list[i][:L] for i in idxs]
            rows_b += [b""] * (B_pad - len(idxs))
            tokens, lengths = pad_rows(rows_b, max_len=L, round_to=L)
            row_req = np.zeros((B_pad,), np.int32)
            row_req[: len(idxs)] = [req_list[i] for i in idxs]
            row_req[len(idxs):] = self._pad_q(Q) - 1
            row_sv = np.zeros((B_pad, n_sv), dtype=np.int8)
            for j, i in enumerate(idxs):
                row_sv[j, sv_list[i]] = 1
            buckets.append((tokens, lengths, row_req, row_sv))
            stats.bucket_rows[L] = stats.bucket_rows.get(L, 0) + len(idxs)
        return buckets, head_ok

    def prefilter(self, requests: List[Request]) -> np.ndarray:
        """Scan stage: requests → masked (Q, R) prefilter rule hits."""
        Q = len(requests)
        # engine_us = this call's wall minus the normalize/merge share
        # that _build_scan_buckets books as prep_us
        prep0 = self.stats.prep_us
        te0 = time.perf_counter()
        buckets, head_ok = self._build_scan_buckets(requests)
        rule_hits = np.zeros((self._pad_q(Q), self.ruleset.n_rules),
                             dtype=bool)
        if buckets:
            rule_hits |= self.engine.detect_device_multi(
                tuple(buckets), self._pad_q(Q), head_only=head_ok)
        self.stats.engine_us += (int((time.perf_counter() - te0) * 1e6)
                                 - (self.stats.prep_us - prep0))
        rule_hits = self.mask_hits(requests, rule_hits[:Q])
        self.stats.prefilter_rule_hits += int(rule_hits.sum())
        return rule_hits

    def mask_hits(self, requests: List[Request],
                  rule_hits: np.ndarray) -> np.ndarray:
        """Tenant (EP) + paranoia masking, idempotent.  Tenant ids
        outside the table fall back to row 0 = full ruleset (a wrap onto
        another tenant's restricted mask would be a scan bypass)."""
        if self.tenant_rule_mask is not None:
            tenants = np.asarray([r.tenant for r in requests], dtype=np.int32)
            T = self.tenant_rule_mask.shape[0]
            tenants = np.where((tenants >= 0) & (tenants < T), tenants, 0)
            rule_hits = rule_hits & self.tenant_rule_mask[tenants]
        return rule_hits & self.paranoia_mask[None, :]

    def finalize_launch(self, requests: List[Request],
                        rule_hits: np.ndarray):
        """Start the confirm phase for already-masked prefilter hits
        (the inline serial walk); returns the job for finalize_join."""
        return launch_confirm(self, requests, rule_hits)

    def finalize(self, requests: List[Request], rule_hits: np.ndarray,
                 t0: float) -> List[Verdict]:
        """Confirm + scoring stage on already-masked prefilter hits."""
        return self.finalize_join(self.finalize_launch(requests, rule_hits),
                                  t0)

    def finalize_join(self, cjob, t0: float) -> List[Verdict]:
        """Join the confirm walk, then fold: scoring, ACL, mode, Verdict
        assembly."""
        stats = self.stats
        tc0 = time.perf_counter()
        results = join_confirm(self, cjob)
        requests = cjob.requests
        verdicts: List[Verdict] = []
        rs = self.ruleset
        for qi, req in enumerate(requests):
            res = results[qi]
            confirmed = res.confirmed
            score = int(rs.rule_score[confirmed].sum()) if confirmed else 0
            classes = sorted(
                {CLASSES[rs.rule_class[r]] for r in confirmed})
            attack = bool(confirmed) and score >= self.anomaly_threshold
            deny = any(rs.rule_action[r] == 2 for r in confirmed)
            # ACL (wallarm-acl): longest-prefix decision over the
            # tenant-bound (or default) list.  deny blocks outright
            # (subject to mode), allow exempts the source from detection
            # blocking, greylist feeds safe_blocking.  Unknown ACL/IP →
            # None → no effect (fail-open).
            acl_name = self.tenant_acl.get(
                getattr(req, "tenant", 0), self.default_acl)
            decision = self.acl_store.evaluate(
                acl_name, getattr(req, "client_ip", ""))
            greylisted = getattr(req, "greylisted", False) or \
                decision == "greylist"
            # per-request mode can only weaken the global mode;
            # safe_blocking (strength 2) blocks only greylisted sources
            eff = min(MODE_NAME_STRENGTH.get(self.mode, 3),
                      MODE_STRENGTH.get(getattr(req, "mode", 2), 3))
            mode_blocks = eff >= 3 or (eff == 2 and greylisted)
            blocked = (mode_blocks and (attack or deny)
                       and not res.detection_only and decision != "allow")
            if decision == "deny" and eff >= 1:
                # ACL denies are enforcement, not detection: any non-off
                # mode flags them, blocking modes block them
                classes = sorted(set(classes) | {"acl"})
                blocked = blocked or eff >= 2
                attack = True
            verdicts.append(Verdict(
                request_id=req.request_id,
                blocked=blocked,
                attack=attack,
                classes=classes,
                rule_ids=[int(rs.rule_ids[r]) for r in confirmed],
                score=score,
                matches=res.points,
            ))
        if cjob.memo is not None:
            stats.confirm_memo_hits += cjob.memo.hits
            stats.confirm_memo_misses += cjob.memo.misses
        stats.confirm_us += cjob.launch_us + int(
            (time.perf_counter() - tc0) * 1e6)
        stats.confirmed_rule_hits += sum(len(v.rule_ids) for v in verdicts)
        elapsed = int((time.perf_counter() - t0) * 1e6)
        for v in verdicts:
            v.elapsed_us = elapsed
            v.generation = self.generation_tag
        return verdicts
