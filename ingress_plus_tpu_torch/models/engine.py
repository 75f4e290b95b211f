"""DetectionEngine — batched scan + the factor→rule mapping.

The port of ``ingress_plus_tpu/models/engine.py``.  A padded batch of
normalized scan rows goes through the bitap scan (ops/scan.py plain, or
a CUDA kernel: ops/pair_scan.py or ops/step_scan.py), then one mapping
pass turns
factor bits into request×rule prefilter hits, classes and scores.

Shapes (per length bucket):
    tokens   (B, L)     uint8        — normalized row bytes
    lengths  (B,)       int32
    row_req  (B,)       int32        — owning request index in [0, Q)
    row_sv   (B, N_SV)  int8         — multi-hot stream-variant ids of row
Returns:
    rule_hits  (Q, R) bool — prefilter hits per request (pre-confirm)
    class_hits (Q, C) bool — any hit rule of that attack class
    scores     (Q,)  int32 — anomaly score (sum of hit rules' severities)

Every result leaves the engine as a numpy array: ``np.asarray`` on a CUDA
tensor fails, so the engine copies to the host itself.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.compiler.seclang import CLASSES
from ingress_plus_tpu_torch.ops.pair_scan import ByteScanner, PairScanner
from ingress_plus_tpu_torch.ops.step_scan import StepScanner
from ingress_plus_tpu_torch.ops.scan import (
    ScanTables,
    from_numpy_u32,
    scan_pairs,
    to_numpy_u32,
)
from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device


class EngineTables:
    """All device tables of one pack (one ruleset generation).

    ``factor_rule`` runs over PREFILTER GROUPS: rules with identical
    (factor set, stream-variant mask, no-prefilter flag) produce
    identical candidate columns, so the mapping product runs over G ≤ R
    groups and ``rule_group`` expands groups back to rules."""

    #: numpy leaf names, in the JAX EngineTables' flatten order
    LEAVES = ("byte_table", "init_mask", "final_mask", "byte_class",
              "class_table", "pair_reach", "pair_final", "factor_word",
              "factor_bit", "factor_rule", "rule_sv", "rule_score",
              "rule_class", "rule_no_prefilter", "rule_group")

    def __init__(self, scan: ScanTables, factor_word: torch.Tensor,
                 factor_bit: torch.Tensor, factor_rule: torch.Tensor,
                 rule_sv: torch.Tensor, rule_score: torch.Tensor,
                 rule_class: torch.Tensor, rule_no_prefilter: torch.Tensor,
                 rule_group: torch.Tensor):
        self.scan = scan
        self.factor_word = factor_word              # (F,) int64
        self.factor_bit = factor_bit                # (F,) int32
        self.factor_rule = factor_rule              # (F, G) float32
        self.rule_sv = rule_sv                      # (G, N_SV) float32
        self.rule_score = rule_score                # (R,) int32
        self.rule_class = rule_class                # (R, C) float32
        self.rule_no_prefilter = rule_no_prefilter  # (G,) bool
        self.rule_group = rule_group                # (R,) int64

    @property
    def device(self) -> torch.device:
        return self.factor_rule.device

    @classmethod
    def from_ruleset(cls, cr: CompiledRuleset, head_only: bool = False,
                     device: DeviceLike = None) -> "EngineTables":
        """Build device tables; ``head_only=True`` slices the word axis
        to ``BitapTables.n_head_words`` and keeps only the factors living
        there.  Sound for dispatches whose rows all carry uri/args/headers
        stream-variants: every factor beyond the boundary is owned by
        body/response-only rules, which never apply to such rows."""
        t = cr.tables
        Wh = t.n_head_words
        if head_only and Wh < t.n_words:
            keep = np.nonzero(t.factor_word < Wh)[0]
            bt = type(t)(
                byte_table=t.byte_table[:, :Wh],
                init_mask=t.init_mask[:Wh],
                final_mask=t.final_mask[:Wh],
                factor_word=t.factor_word[keep],
                factor_bit=t.factor_bit[keep],
                factor_rule_indptr=t.factor_rule_indptr,
                factor_rule_ids=t.factor_rule_ids,
                rule_nfactors=t.rule_nfactors,  # FULL-pack counts: a
                # body-only rule with factors is not "no prefilter"
                factor_len=t.factor_len[keep],
                n_head_words=Wh,
            )
            factor_sel = keep
        else:
            bt = t
            factor_sel = None
        F, R = bt.factor_word.shape[0], cr.n_rules
        # per-rule factor memberships (within THIS table's factor
        # subset), for the prefilter-group dedup
        rule_factors: list = [[] for _ in range(R)]
        for fi in range(F):
            f = int(factor_sel[fi]) if factor_sel is not None else fi
            lo, hi = t.factor_rule_indptr[f], t.factor_rule_indptr[f + 1]
            for r in t.factor_rule_ids[lo:hi]:
                rule_factors[int(r)].append(fi)
        nopf_rule = t.rule_nfactors == 0
        groups: dict = {}
        rule_group = np.zeros((max(R, 1),), np.int32)
        for r in range(R):
            key = (tuple(rule_factors[r]),
                   cr.rule_sv_mask[r].tobytes(), bool(nopf_rule[r]))
            rule_group[r] = groups.setdefault(key, len(groups))
        G = max(len(groups), 1)
        fr = np.zeros((max(F, 1), G), dtype=np.float32)
        rule_sv_g = np.zeros((G, cr.rule_sv_mask.shape[1]), np.float32)
        nopf_g = np.zeros((G,), bool)
        for (fids, sv_bytes, nopf), g in groups.items():
            fr[list(fids), g] = 1.0
            rule_sv_g[g] = np.frombuffer(
                sv_bytes, dtype=bool).astype(np.float32)
            nopf_g[g] = nopf
        onehot = np.zeros((max(R, 1), len(CLASSES)), dtype=np.float32)
        if R:
            onehot[np.arange(R), cr.rule_class] = 1.0
        # F == 0 (every rule confirm-only): factor_word/bit pad like
        # factor_rule's dummy row, which maps to no group
        factor_word = bt.factor_word if F else np.zeros((1,), np.int32)
        factor_bit = bt.factor_bit if F else np.zeros((1,), np.int32)
        dev = resolve_device(device)
        scan = ScanTables.from_bitap(bt, dev)
        return cls._from_arrays(scan, {
            "factor_word": factor_word, "factor_bit": factor_bit,
            "factor_rule": fr, "rule_sv": rule_sv_g,
            "rule_score": cr.rule_score, "rule_class": onehot,
            "rule_no_prefilter": nopf_g, "rule_group": rule_group}, dev)

    @classmethod
    def _from_arrays(cls, scan: ScanTables, a: Dict[str, np.ndarray],
                     dev: torch.device) -> "EngineTables":
        def t(x, dtype):
            return torch.from_numpy(np.array(x)).to(dev, dtype)

        return cls(
            scan=scan,
            factor_word=t(np.asarray(a["factor_word"], np.int64), torch.int64),
            # bit indices are 0..31: the uint32 view is the same number
            factor_bit=t(np.asarray(a["factor_bit"]).astype(np.int32),
                         torch.int32),
            factor_rule=t(np.asarray(a["factor_rule"], np.float32),
                          torch.float32),
            rule_sv=t(np.asarray(a["rule_sv"], np.float32), torch.float32),
            rule_score=t(np.asarray(a["rule_score"], np.int32), torch.int32),
            rule_class=t(np.asarray(a["rule_class"], np.float32),
                         torch.float32),
            rule_no_prefilter=t(np.asarray(a["rule_no_prefilter"], bool),
                                torch.bool),
            rule_group=t(np.asarray(a["rule_group"], np.int64), torch.int64),
        )

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   device: DeviceLike = None) -> "EngineTables":
        """Build from numpy leaves named as in :data:`LEAVES` (uint32
        words as uint32) — the JAX EngineTables' leaves, so a test can
        run both engines on identical tables."""
        dev = resolve_device(device)
        scan = ScanTables(
            byte_table=from_numpy_u32(arrays["byte_table"], dev),
            init_mask=from_numpy_u32(arrays["init_mask"], dev),
            final_mask=from_numpy_u32(arrays["final_mask"], dev),
            byte_class=torch.from_numpy(
                np.asarray(arrays["byte_class"], np.int64)).to(dev),
            class_table=from_numpy_u32(arrays["class_table"], dev),
            pair_reach=from_numpy_u32(arrays["pair_reach"], dev),
            pair_final=from_numpy_u32(arrays["pair_final"], dev),
        )
        return cls._from_arrays(scan, arrays, dev)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The leaves as numpy, in the JAX package's dtypes (words
        uint32, factor_word/rule_group int32)."""
        s = self.scan
        out = {k: to_numpy_u32(getattr(s, k))
               for k in ("byte_table", "init_mask", "final_mask",
                         "class_table", "pair_reach", "pair_final")}
        out["byte_class"] = s.byte_class.cpu().numpy().astype(np.int32)
        out["factor_word"] = self.factor_word.cpu().numpy().astype(np.int32)
        out["factor_bit"] = self.factor_bit.cpu().numpy().astype(np.uint32)
        out["rule_group"] = self.rule_group.cpu().numpy().astype(np.int32)
        for k in ("factor_rule", "rule_sv", "rule_score", "rule_class",
                  "rule_no_prefilter"):
            out[k] = getattr(self, k).cpu().numpy()
        return out


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max of non-negative rows; empty segments read 0.
    (The JAX reference fills them with -inf, which every later ``> 0``
    test treats the same as 0.)"""
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    idx = seg.to(torch.int64)[:, None].expand(-1, x.shape[1])
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)


def map_match_words(
    tables: EngineTables,
    match_words: torch.Tensor,   # (B, W) int32 — sticky match per row
    row_req: torch.Tensor,       # (B,) int
    row_sv: torch.Tensor,        # (B, N_SV) int8
    num_requests: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match words → (rule_hits, class_hits, scores).

    Rows fold to REQUESTS before the factor→rule expansion, so the
    rule-count-scaling product runs on Q request rows.  The
    stream-variant gate is therefore applied per request: a strict
    over-approximation of a row-level gate (candidates only added — the
    exact confirm stage decides verdicts).  The three products are
    float32 ``torch.matmul`` over 0/1 and small-integer operands, exact
    in float32 (the engine keeps TF32 off on the card)."""
    mw = match_words.index_select(1, tables.factor_word)          # (B, F)
    fh = ((mw >> tables.factor_bit) & 1).to(torch.float32)
    req_fh = _segment_max(fh, row_req, num_requests)              # (Q, F)
    req_sv = _segment_max(row_sv.to(torch.float32), row_req,
                          num_requests)                           # (Q, SV)
    req_group = torch.matmul(req_fh, tables.factor_rule) > 0      # (Q, G)
    applies = torch.matmul(req_sv, tables.rule_sv.t()) > 0        # (Q, G)
    group_hits = ((req_group | tables.rule_no_prefilter[None, :])
                  & applies)
    rule_hits = group_hits.index_select(1, tables.rule_group)     # (Q, R)
    hits_f = rule_hits.to(torch.float32)
    class_hits = torch.matmul(hits_f, tables.rule_class) > 0
    scores = torch.matmul(
        hits_f, tables.rule_score.to(torch.float32)).to(torch.int32)
    return rule_hits, class_hits, scores


def map_pad_total(total: int) -> int:
    """Power-of-two row padding for the single mapping pass."""
    pad = 8
    while pad < total:
        pad *= 2
    return pad


class DetectionEngine:
    """Host-facing wrapper: tables on the device once, detect per batch.

    Scan implementations keep the JAX package's names so each maps to its
    counterpart; here they name THIS package's code:

    * ``"pair"`` — the plain PyTorch ``scan_pairs``; CPU devices only;
    * ``"pallas3"`` — the CUDA pair-scan kernel, raw-byte configuration
      (the default on ``cuda``);
    * ``"pallas2"`` — the same kernel, class-id configuration;
    * ``"pallas"`` — the CUDA per-byte step-scan kernel (one step per
      byte, exact state), the stream lane's scan.

    A kernel implementation on a CPU device raises, as does ``"pair"``
    on a CUDA device."""

    SCAN_IMPLS = ("pair", "pallas", "pallas2", "pallas3")

    def __init__(self, cr: CompiledRuleset, scan_impl: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if scan_impl is None:
            scan_impl = "pallas3" if self.device.type == "cuda" else "pair"
        if scan_impl not in self.SCAN_IMPLS:
            raise ValueError("unknown scan_impl %r (one of %s)"
                             % (scan_impl, ", ".join(self.SCAN_IMPLS)))
        if (scan_impl == "pair") != (self.device.type == "cpu"):
            raise ValueError(
                "scan_impl %r cannot run on a %s device: the kernel "
                "implementations (pallas, pallas2, pallas3) need CUDA, the "
                "plain 'pair' scan is the CPU path"
                % (scan_impl, self.device.type))
        if self.device.type == "cuda":
            # the mapping products must be exact float32, never TF32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.scan_impl = scan_impl
        self._install(cr)

    def _install(self, cr: CompiledRuleset) -> None:
        self.ruleset = cr
        self.tables = EngineTables.from_ruleset(cr, device=self.device)
        # head-sliced twin: word prefix + the factors living there, for
        # dispatches with no body/response rows; None when the pack has
        # no word tiering or every factor is tail-tier
        self.head_tables = (
            EngineTables.from_ruleset(cr, head_only=True, device=self.device)
            if 0 < cr.tables.n_head_words < cr.tables.n_words else None)
        self._scanner = None
        if self.scan_impl == "pallas3":
            self._scanner = ByteScanner(self.tables.scan)
        elif self.scan_impl == "pallas2":
            self._scanner = PairScanner(self.tables.scan)
        elif self.scan_impl == "pallas":
            self._scanner = StepScanner(self.tables.scan)

    def swap_ruleset(self, cr: CompiledRuleset) -> None:
        """Install a new pack generation on the same device and impl."""
        self._install(cr)

    def device_info(self) -> dict:
        """Geometry + impl of the live device tables."""
        t = self.ruleset.tables
        return {
            "scan_impl": self.scan_impl,
            "scan_contract": ("raw-bytes" if self.scan_impl == "pallas3"
                              else "prepped-rows"),
            "device": str(self.device),
            "n_rules": int(self.ruleset.n_rules),
            "n_factors": int(t.n_factors),
            "n_words": int(t.n_words),
            "n_head_words": int(t.n_head_words),
            "n_classes": int(self.tables.scan.n_classes),
            "n_prefix_shared": int(t.n_prefix_shared),
            "max_factor_len": int(t.max_factor_len),
            "reduction": getattr(self.ruleset, "reduction", None),
        }

    def head_slicing_active(self) -> bool:
        """True iff a head-only dispatch would use the sliced tables: the
        pack is word-tiered AND the impl honors the slice (the kernel
        impls scan the full tables)."""
        return self.head_tables is not None and self.scan_impl == "pair"

    def _scan(self, tabs: EngineTables, tok: torch.Tensor,
              ln: torch.Tensor) -> torch.Tensor:
        if self._scanner is not None:
            m, _ = self._scanner(tok, ln)
        else:
            m, _ = scan_pairs(tabs.scan, tok, ln)
        return m

    def _to_dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def detect(self, tokens, lengths, row_req, row_sv, num_requests: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One bucket: (rule_hits, class_hits, scores) as numpy."""
        m = self._scan(self.tables, self._to_dev(tokens),
                       self._to_dev(lengths))
        out = map_match_words(self.tables, m, self._to_dev(row_req),
                              self._to_dev(row_sv), num_requests)
        return tuple(x.cpu().numpy() for x in out)

    def detect_device_multi(self, buckets: Sequence, num_requests: int,
                            head_only: bool = False) -> np.ndarray:
        """Multi-bucket dispatch with ONE mapping pass: each length bucket
        scans on its own, then the factor→rule mapping runs once on the
        concatenated match words, padded to a power-of-two row count.

        ``head_only=True`` (caller asserts no row carries a body/response
        stream-variant) scans the sliced head tables where the impl
        honors them.  Returns the (Q, R) rule hits as numpy."""
        tabs = (self.head_tables
                if head_only and self.head_slicing_active()
                else self.tables)
        if not buckets:
            return np.zeros((num_requests, max(self.ruleset.n_rules, 1)),
                            bool)
        ms, rrs, rss = [], [], []
        total = 0
        for tok, ln, rr, rs in buckets:
            ms.append(self._scan(tabs, self._to_dev(tok), self._to_dev(ln)))
            rrs.append(np.asarray(rr, np.int32))
            rss.append(np.asarray(rs, np.int8))
            total += int(np.asarray(tok).shape[0])
        pad_total = map_pad_total(total)
        W = tabs.scan.n_words
        if pad_total > total:
            ms.append(torch.zeros((pad_total - total, W), dtype=torch.int32,
                                  device=self.device))
            rrs.append(np.full((pad_total - total,), num_requests - 1,
                               np.int32))
            rss.append(np.zeros((pad_total - total, rss[0].shape[1]),
                                np.int8))
        rule_hits, _, _ = map_match_words(
            tabs, torch.cat(ms, dim=0),
            self._to_dev(np.concatenate(rrs)),
            self._to_dev(np.concatenate(rss)), num_requests)
        return rule_hits.cpu().numpy()
