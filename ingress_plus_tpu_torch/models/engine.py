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
tensor fails, so the engine copies to the host itself, on the calling
thread (a serve lane's worker: the dispatch thread never waits on the
card).

On a CUDA device both kernels (``csrc/pair_scan.cu``, ``csrc/step_scan.cu``)
are built and loaded on that card when the engine is constructed, so no
``nvcc`` run and no first load ever happens inside a serving cycle; a
build or load failure raises from the constructor.
"""

from __future__ import annotations

import statistics
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.compiler.seclang import CLASSES
from ingress_plus_tpu_torch.ops.cuda_build import (
    AUTOSELECT_SCOPE,
    launch_scope,
)
from ingress_plus_tpu_torch.ops.pair_scan import (
    PAIR_SCAN,
    ByteScanner,
    PairScanner,
)
from ingress_plus_tpu_torch.ops.step_scan import STEP_SCAN, StepScanner
from ingress_plus_tpu_torch.ops.scan import (
    ScanTables,
    from_numpy_u32,
    scan_bytes,
    scan_pairs,
    to_numpy_u32,
)
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device
from ingress_plus_tpu_torch.utils.trace import EV_ENGINE_SYNC, flight


def copy_back(t: torch.Tensor,
              sync_ns: Optional[List[int]] = None) -> np.ndarray:
    """``t`` as numpy, inside an ``engine_sync`` span: the engine's one
    wait on the card.  ``sync_ns``, when given, gets the copy's wall ns
    and the thread CPU ns it burned (a CUDA wait may spin) added to its
    two items, so a caller can tell its own CPU time from the wait."""
    flight.begin(EV_ENGINE_SYNC)
    t0 = time.perf_counter_ns()
    c0 = time.thread_time_ns()
    try:
        return t.cpu().numpy()
    finally:
        if sync_ns is not None:
            sync_ns[1] += time.thread_time_ns() - c0
            sync_ns[0] += time.perf_counter_ns() - t0
        flight.end(EV_ENGINE_SYNC)


#: serving name -> scanner class of the kernel implementations
KERNEL_SCANNERS = {"pallas3": ByteScanner, "pallas2": PairScanner,
                   "pallas": StepScanner}


def load_kernels(device: torch.device) -> None:
    """Build (once per process) and load both scan kernels on ``device``,
    running each one's per-card setup.  Raises on any build or load
    error: a serving process must not start without its kernels."""
    for kernel in (PAIR_SCAN, STEP_SCAN):
        kernel.library(device)


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

    def to(self, device: torch.device) -> "EngineTables":
        """A copy of every table on ``device`` (a serve lane's card)."""
        s = self.scan
        scan = ScanTables(**{k: getattr(s, k).to(device) for k in (
            "byte_table", "init_mask", "final_mask", "byte_class",
            "class_table", "pair_reach", "pair_final")})
        return type(self)(scan, *(getattr(self, k).to(device) for k in (
            "factor_word", "factor_bit", "factor_rule", "rule_sv",
            "rule_score", "rule_class", "rule_no_prefilter",
            "rule_group")))

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


#: rounds of a startup bake-off on a card; the median round is kept
CARD_ROUNDS = 5


def bake_off_rounds(device: torch.device) -> int:
    """Rounds of a startup bake-off: :data:`CARD_ROUNDS` on a card, one
    on a CPU device (a round of the plain scans takes seconds there)."""
    return CARD_ROUNDS if device.type == "cuda" else 1


@contextmanager
def bake_off_threads(device: torch.device) -> Iterator[None]:
    """The intra-op threads of a startup bake-off: one on a CPU device
    (restored after), the card's own otherwise.  Several processes that
    each time the plain scans at B=512 on every core of a shared host
    stall one another for minutes (torch's thread pool meets a barrier
    at every op of the 256 scan steps), while on one thread the plain
    scans rank as they do on many (``pair`` ahead of ``take``)."""
    if device.type != "cpu":
        yield
        return
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


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
      byte, exact state), the stream lane's scan;
    * ``"take"`` — the per-byte scan on either device: the plain
      PyTorch ``scan_bytes`` on a CPU device, the step-scan kernel on a
      CUDA device (as ``"pair"`` and ``"pallas3"`` pair up).

    A kernel implementation on a CPU device raises, as does ``"pair"``
    on a CUDA device.  ``scan_impl`` may be reassigned (the serve CLI's
    ``--scan-impl`` does); the same rule is checked then."""

    SCAN_IMPLS = ("pair", "take", "pallas", "pallas2", "pallas3")

    def __init__(self, cr: CompiledRuleset, scan_impl: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # one name per card: lanes, replicas and the recompile gauge
            # compare devices, and "cuda" != "cuda:0"
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scan_impl is None:
            scan_impl = "pallas3" if self.device.type == "cuda" else "pair"
        self.scan_impl = scan_impl
        if self.device.type == "cuda":
            # the mapping products must be exact float32, never TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            load_kernels(self.device)
        self._install(cr)

    @property
    def scan_impl(self) -> str:
        return self._scan_impl

    @scan_impl.setter
    def scan_impl(self, impl: str) -> None:
        self.check_impl(impl, self.device)
        self._scan_impl = impl

    @classmethod
    def check_impl(cls, impl: str, device: torch.device) -> None:
        """Raise ValueError unless ``impl`` can run on ``device``."""
        if impl not in cls.SCAN_IMPLS:
            raise ValueError("unknown scan_impl %r (one of %s)"
                             % (impl, ", ".join(cls.SCAN_IMPLS)))
        if impl == "take":
            return
        if (impl == "pair") != (device.type == "cpu"):
            raise ValueError(
                "scan_impl %r cannot run on a %s device: the kernel "
                "implementations (pallas, pallas2, pallas3) need CUDA, the "
                "plain 'pair' scan is the CPU path" % (impl, device.type))

    def _install(self, cr: CompiledRuleset) -> None:
        self.ruleset = cr
        self.tables = EngineTables.from_ruleset(cr, device=self.device)
        # head-sliced twin: word prefix + the factors living there, for
        # dispatches with no body/response rows; None when the pack has
        # no word tiering or every factor is tail-tier
        self.head_tables = (
            EngineTables.from_ruleset(cr, head_only=True, device=self.device)
            if 0 < cr.tables.n_head_words < cr.tables.n_words else None)
        # {(impl, device): scanner} and {device: (tables, head_tables)}
        # replicas for serve lanes on other cards, built at first use
        self._scanners: Dict[tuple, object] = {}
        self._device_tables: Dict[torch.device, tuple] = {}

    def rebuilt(self, cr: CompiledRuleset) -> "DetectionEngine":
        """Fresh engine of the same kind, impl and device on a new
        ruleset (the batcher's hot swap)."""
        return type(self)(cr, scan_impl=self.scan_impl, device=self.device)

    def swap_ruleset(self, cr: CompiledRuleset) -> None:
        """Install a new pack generation on the same device and impl."""
        self._install(cr)

    def tables_for(self, device: Optional[torch.device] = None):
        """The (tables, head_tables) pair on ``device`` — copied once per
        card per generation for a serve lane on another card; ``None``
        or the engine's own device is the engine's own pair."""
        if device is None or torch.device(device) == self.device:
            return self.tables, self.head_tables
        device = torch.device(device)
        pair = self._device_tables.get(device)
        if pair is None:
            pair = (self.tables.to(device),
                    (self.head_tables.to(device)
                     if self.head_tables is not None else None))
            self._device_tables[device] = pair
        return pair

    def _kernel_scanner_cls(self, impl: Optional[str] = None):
        """The kernel scanner class of ``impl`` (default: the live
        impl); None for a plain scan (``pair``, and ``take`` on a CPU
        device)."""
        impl = self.scan_impl if impl is None else impl
        if impl == "take":
            return StepScanner if self.device.type == "cuda" else None
        return KERNEL_SCANNERS.get(impl)

    def scanner_for(self, device: Optional[torch.device] = None,
                    impl: Optional[str] = None):
        """The kernel scanner of ``impl`` (default: the live impl) on
        ``device`` (built once per impl, card and generation); None for
        a plain scan."""
        impl = self.scan_impl if impl is None else impl
        cls = self._kernel_scanner_cls(impl)
        if cls is None:
            return None
        dev = self.device if device is None else torch.device(device)
        key = (impl, dev)
        sc = self._scanners.get(key)
        if sc is None:
            sc = self._scanners[key] = cls(self.tables_for(dev)[0].scan)
        return sc

    def exec_keys(self, device: Optional[torch.device] = None) -> tuple:
        """What a dispatch on ``device`` would load for the first time:
        the kernel of the live impl on that card (none for ``pair``) and
        the table replica of that card.  The pipeline's recompile gauge
        counts the keys it has not seen; kernels have no per-shape
        executables, so shapes are not part of a key."""
        dev = str(self.device if device is None else torch.device(device))
        keys = (("tables", dev),)
        if self._kernel_scanner_cls() is not None:
            keys += (("kernel", self.scan_impl, dev),)
        return keys

    def scan_exec_shape(self, B: int, L: int):
        """Executable-keying shape of one (B, L) scan dispatch: each
        kernel is one build that takes every shape, so the bucket shape
        itself (kept for callers of the JAX engine's API)."""
        return (B, L)

    def drop_compiled(self) -> None:
        """Forget the scanners and the per-device table replicas (the
        ``recompile_storm`` fault site): later dispatches rebuild them.
        The kernels' shared libraries stay loaded — an ``nvcc`` run at
        serve time would overrun the hang budget."""
        self._scanners = {}
        self._device_tables = {}

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
        return (self.head_tables is not None
                and self._kernel_scanner_cls() is None)

    def _scan(self, tabs: EngineTables, tok: torch.Tensor,
              ln: torch.Tensor, device: Optional[torch.device] = None
              ) -> torch.Tensor:
        """Match words of one bucket: ``tok`` on the scan's device,
        ``ln`` on the host (a kernel copies its lengths to the card and
        tallies the work they ask for)."""
        scanner = self.scanner_for(device)
        if scanner is not None:
            m, _ = scanner(tok, ln)
        elif self.scan_impl == "take":
            m, _ = scan_bytes(tabs.scan, tok, ln.to(tok.device))
        else:
            m, _ = scan_pairs(tabs.scan, tok, ln.to(tok.device))
        return m

    def _to_dev(self, x, device: Optional[torch.device] = None
                ) -> torch.Tensor:
        dev = self.device if device is None else device
        return torch.as_tensor(np.asarray(x)).to(dev)

    def detect(self, tokens, lengths, row_req, row_sv, num_requests: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One bucket: (rule_hits, class_hits, scores) as numpy."""
        # fault-injection sites (utils/faults.py): a wedged device is a
        # sleep here (the batcher's dispatch watchdog must catch it), a
        # crashed dispatch is a raise (the breaker must count it)
        faults.sleep_if("dispatch_hang")
        faults.raise_if("dispatch_raise")
        m = self._scan(self.tables, self._to_dev(tokens),
                       torch.as_tensor(np.asarray(lengths)))
        out = map_match_words(self.tables, m, self._to_dev(row_req),
                              self._to_dev(row_sv), num_requests)
        return tuple(x.cpu().numpy() for x in out)

    def detect_device(self, tokens, lengths, row_req, row_sv,
                      num_requests: int) -> np.ndarray:
        """One bucket's (Q, R) rule hits as numpy."""
        return self.detect(tokens, lengths, row_req, row_sv,
                           num_requests)[0]

    def detect_device_multi(self, buckets: Sequence, num_requests: int,
                            head_only: bool = False,
                            device: Optional[torch.device] = None,
                            sync_ns: Optional[List[int]] = None
                            ) -> np.ndarray:
        """Multi-bucket dispatch with ONE mapping pass: each length bucket
        scans on its own, then the factor→rule mapping runs once on the
        concatenated match words, padded to a power-of-two row count.

        ``head_only=True`` (caller asserts no row carries a body/response
        stream-variant) scans the sliced head tables where the impl
        honors them.  ``device`` pins the dispatch to one serve lane's
        card: inputs go there and the scan runs against that card's
        table replica (``tables_for``), on the calling thread's current
        stream.  Returns the (Q, R) rule hits as numpy; the copy back's
        time goes to ``sync_ns`` (:func:`copy_back`)."""
        faults.sleep_if("dispatch_hang")
        faults.raise_if("dispatch_raise")
        dev = self.device if device is None else torch.device(device)
        full_tabs, head_tabs = self.tables_for(dev)
        tabs = (head_tabs
                if head_only and self.head_slicing_active()
                else full_tabs)
        if not buckets:
            return np.zeros((num_requests, max(self.ruleset.n_rules, 1)),
                            bool)
        ms, rrs, rss = [], [], []
        total = 0
        for tok, ln, rr, rs in buckets:
            ms.append(self._scan(tabs, self._to_dev(tok, dev),
                                 torch.as_tensor(np.asarray(ln)), dev))
            rrs.append(np.asarray(rr, np.int32))
            rss.append(np.asarray(rs, np.int8))
            total += int(np.asarray(tok).shape[0])
        pad_total = map_pad_total(total)
        W = tabs.scan.n_words
        if pad_total > total:
            ms.append(torch.zeros((pad_total - total, W), dtype=torch.int32,
                                  device=dev))
            rrs.append(np.full((pad_total - total,), num_requests - 1,
                               np.int32))
            rss.append(np.zeros((pad_total - total, rss[0].shape[1]),
                                np.int8))
        rule_hits, _, _ = map_match_words(
            tabs, torch.cat(ms, dim=0),
            self._to_dev(np.concatenate(rrs), dev),
            self._to_dev(np.concatenate(rss), dev), num_requests)
        return copy_back(rule_hits, sync_ns)

    # ------------------------------------------------- impl auto-select

    def autoselect_scan_impl(self, B: int = 512, L: int = 256, k: int = 17,
                             n: int = 2) -> Dict[str, float]:
        """Time each scan implementation that can run on this engine's
        device at one representative shape, install the fastest, and
        return ``{impl: seconds per pass}`` (``--scan-impl auto``: the
        server's startup bake-off).  Detection output is the same under
        every impl, so the choice is about speed alone.

        Candidates: ``pair`` and ``take`` on a CPU device; ``take``,
        ``pallas``, ``pallas2`` and ``pallas3`` on a card (every impl
        :meth:`check_impl` lets run there).  Inputs: ``B`` rows of ``L``
        seeded printable bytes (``default_rng(7)``), every row full, row
        ``i`` owned by request ``i % 8``, every stream-variant set.  Each
        candidate chains ``k`` passes of its scan (through
        :meth:`scanner_for` or the plain scan) and
        :func:`map_match_words`: the sticky match carries from pass to
        pass, and the state too for the per-byte impls (``pallas``,
        ``take``).  Every impl takes the same uint8 rows: seeded printable
        bytes are a raw request row (``pallas3``'s contract) as well as a
        prepared one.  Timing: ``utils/microbench.k_diff_time``, the
        steady cost of one pass.  On a card each chain is one CUDA graph
        (``utils/microbench.graphed``) timed by CUDA events, so the time
        is the card's work alone, as the JAX package's one jitted chain
        is (eager dispatch would time the host's gaps, which vary more
        from start to start than the impls differ), and each candidate's
        time is the median of :data:`CARD_ROUNDS` rounds that each time
        every candidate once in turn (the card's clock moves by more
        than the kernels differ, now and then for a round).  On a CPU
        device the chain runs eagerly on one torch thread
        (:func:`bake_off_threads`), one round.  A time <= 0 is no signal
        and reads ``inf``; when every candidate reads ``inf`` the
        configured impl stays.  The kernels' launches are tallied under
        ``launch_scope(AUTOSELECT_SCOPE)``, so the serving cycles'
        per-shape tally stays their own.

        One departure from the JAX package: a candidate that raises is
        not turned into ``inf``.  On a card that would serve another impl
        when a kernel fails to build or launch, so the error propagates
        (the server then does not start), as in :func:`load_kernels`."""
        from ingress_plus_tpu_torch.utils.microbench import (
            graphed,
            k_diff_time,
        )

        dev, tables = self.device, self.tables
        candidates = (["pair", "take"] if dev.type == "cpu"
                      else ["take", "pallas", "pallas2", "pallas3"])
        rng = np.random.default_rng(7)
        tokens = torch.from_numpy(
            rng.integers(32, 127, (B, L)).astype(np.uint8)).to(dev)
        lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
        row_req = torch.from_numpy(
            (np.arange(B) % 8).astype(np.int32)).to(dev)
        row_sv = torch.ones((B, tables.rule_sv.shape[1]), dtype=torch.int8,
                            device=dev)
        W = tables.scan.n_words

        def chain(impl: str):
            scanner = self.scanner_for(impl=impl)
            carry_state = impl in ("pallas", "take")

            def scan(state, match):
                if scanner is not None:
                    return scanner(tokens, lengths,
                                   state if carry_state else None, match)
                if impl == "take":
                    return scan_bytes(tables.scan, tokens, lengths, state,
                                      match)
                return scan_pairs(tables.scan, tokens, lengths, None, match)

            def call(kk: int, rep: int) -> torch.Tensor:
                acc = torch.zeros((), dtype=torch.int64, device=dev)
                state = match = torch.zeros((B, W), dtype=torch.int32,
                                            device=dev)
                for _ in range(kk):
                    match, new_state = scan(state, match)
                    if carry_state:
                        state = new_state
                    rule_hits, _, _ = map_match_words(tables, match, row_req,
                                                      row_sv, 8)
                    acc = acc + match.sum() + rule_hits.sum()
                return acc
            return graphed(call, dev)

        rounds = {impl: [] for impl in candidates}
        with launch_scope(AUTOSELECT_SCOPE), bake_off_threads(dev):
            calls = {impl: chain(impl) for impl in candidates}
            for _ in range(bake_off_rounds(dev)):
                for impl in candidates:
                    dt = k_diff_time(calls[impl], k, n=n, device=dev)
                    rounds[impl].append(dt if dt > 0 else float("inf"))
        timings = {impl: statistics.median(ts) for impl, ts in rounds.items()}
        best = min(timings, key=timings.get)
        if timings[best] < float("inf"):
            self.scan_impl = best
        return timings
