"""Tensor-parallel (ruleset-sharded) detection over a device mesh.

The port of ``ingress_plus_tpu/parallel/shard.py``.  The bitap scan is
*word-local*: no cross-word carries exist (compiler/bitap.py), so
sharding the word axis across the ``model`` mesh axis costs no
communication in the hot loop.  Each shard scans the same bytes against
its slice of the tables, extracts its own factors' hits and votes
partial rule hits; the votes merge with one sum over ``model``.  Batch
rows ride the ``data`` axis (DP); tenant (EP) masks apply to the merged
votes.

PyTorch has no ``shard_map``, so the step is an explicit loop over the
mesh (mesh.py): each (data row, model shard) entry scans on its own
device and, on a card, its own CUDA stream; the JAX ``psum`` over
``model`` becomes the sum of the shards' partial votes on the data
row's first device, and the global-rows ``psum`` over ``data`` the sum
of the rows' clamped 0/1 partials on the mesh's first device
(``dist.all_reduce`` when the mesh spans processes, dcn.py).

Scanners per device, the rule of ``DetectionEngine.check_impl``: on
``cuda`` ``pallas2`` is the pair kernel on each shard's class-id tables
(``ops/pair_scan.py PairScanner``) and ``take`` the step kernel
(``StepScanner``); on ``cpu`` ``pair`` is the plain ``scan_pairs`` and
``take`` the plain ``scan_bytes``.  ``pair`` on a card, or ``pallas2``
on the CPU, raises.  A shard whose kernel fails raises out of the step:
no shard carries on with a plain scan.

Offline, :func:`shard_ruleset_tables` re-packs a CompiledRuleset into
shard-major numpy arrays, padded to uniform per-shard factor and class
counts, equal to the JAX package's array for array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.compiler.seclang import CLASSES
from ingress_plus_tpu_torch.ops.cuda_build import (
    AUTOSELECT_SCOPE,
    SERVE_SCOPE,
    current_scope,
    launch_scope,
)
from ingress_plus_tpu_torch.models.engine import (
    _segment_max,
    bake_off_rounds,
    bake_off_threads,
    load_kernels,
)
from ingress_plus_tpu_torch.ops.pair_scan import PairScanner
from ingress_plus_tpu_torch.ops.scan import (
    ScanTables,
    build_class_pair_tables,
    from_numpy_u32,
    scan_bytes,
    scan_pairs,
)
from ingress_plus_tpu_torch.ops.step_scan import StepScanner
from ingress_plus_tpu_torch.parallel.dcn import (
    all_reduce_sum,
    gather_global,
    process_count,
)
from ingress_plus_tpu_torch.parallel.mesh import Mesh
from ingress_plus_tpu_torch.utils.device import resolve_device


@dataclass
class ShardedTables:
    """Numpy arrays laid out shard-major for an n_model-way TP split."""

    n_model: int
    w_shard: int              # words per shard (padded)
    byte_table: np.ndarray    # (256, n_model * w_shard) uint32
    init_mask: np.ndarray     # (n_model * w_shard,) uint32
    final_mask: np.ndarray    # (n_model * w_shard,) uint32
    factor_word: np.ndarray   # (n_model, f_max) int32 — shard-relative
    factor_bit: np.ndarray    # (n_model, f_max) uint32
    factor_rule: np.ndarray   # (n_model, f_max, R) float32 (0-padded)
    rule_sv: np.ndarray       # (R, N_SV) float32 (replicated)
    rule_score: np.ndarray    # (R,) float32
    rule_class: np.ndarray    # (R, C) float32
    rule_no_prefilter: np.ndarray  # (R,) bool
    # per-shard class-pair tables: byte classes are computed PER SHARD
    # from that shard's byte-table slice, and every shard pads to k_max
    # with the dead class LAST at index k_max (uniform shapes)
    k_max: int = 0
    byte_class: np.ndarray = None    # (n_model, 257) int32; [256]=k_max
    class_table: np.ndarray = None   # (n_model, k_max+1, w_shard) uint32
    pair_reach: np.ndarray = None    # (n_model, (k_max+1)^2, w_shard)
    pair_final: np.ndarray = None    # (n_model, k_max+1, w_shard)

    def shard_scan_tables(self, s: int, device: torch.device) -> ScanTables:
        """Shard ``s``'s scan tables on ``device``, as the port's
        :class:`ScanTables` (int32 word bit patterns)."""
        sl = slice(s * self.w_shard, (s + 1) * self.w_shard)
        return ScanTables(
            byte_table=from_numpy_u32(
                np.ascontiguousarray(self.byte_table[:, sl]), device),
            init_mask=from_numpy_u32(self.init_mask[sl], device),
            final_mask=from_numpy_u32(self.final_mask[sl], device),
            byte_class=torch.from_numpy(
                self.byte_class[s].astype(np.int64)).to(device),
            class_table=from_numpy_u32(self.class_table[s], device),
            pair_reach=from_numpy_u32(self.pair_reach[s], device),
            pair_final=from_numpy_u32(self.pair_final[s], device))


def shard_ruleset_tables(cr: CompiledRuleset, n_model: int,
                         lane_multiple: int = 8) -> ShardedTables:
    t = cr.tables
    W, F, R = t.n_words, t.n_factors, cr.n_rules
    w_shard = -(-W // n_model)
    w_shard = -(-w_shard // lane_multiple) * lane_multiple
    W_pad = w_shard * n_model

    bt = np.zeros((256, W_pad), np.uint32)
    bt[:, :W] = t.byte_table
    init = np.zeros((W_pad,), np.uint32)
    init[:W] = t.init_mask
    final = np.zeros((W_pad,), np.uint32)
    final[:W] = t.final_mask

    # factor → owning shard
    shard_of = t.factor_word // w_shard
    f_max = max(1, int(np.bincount(shard_of, minlength=n_model).max()))
    factor_word = np.zeros((n_model, f_max), np.int32)
    factor_bit = np.zeros((n_model, f_max), np.uint32)
    factor_rule = np.zeros((n_model, f_max, max(R, 1)), np.float32)
    fill = np.zeros((n_model,), np.int64)
    for f in range(F):
        s = int(shard_of[f])
        j = int(fill[s])
        factor_word[s, j] = t.factor_word[f] - s * w_shard
        factor_bit[s, j] = t.factor_bit[f]
        lo, hi = t.factor_rule_indptr[f], t.factor_rule_indptr[f + 1]
        factor_rule[s, j, t.factor_rule_ids[lo:hi]] = 1.0
        fill[s] += 1
    # padded factor slots keep word 0 / bit 0 but an all-zero rule map, so
    # whatever bit they read contributes nothing to the vote.

    onehot = np.zeros((max(R, 1), len(CLASSES)), np.float32)
    if R:
        onehot[np.arange(R), cr.rule_class] = 1.0

    # per-shard pair-stride tables via the shared construction, padded to
    # a uniform k_max
    k_max = 1
    for s in range(n_model):
        bt_s = bt[:, s * w_shard:(s + 1) * w_shard]
        k_max = max(k_max, int(np.unique(bt_s, axis=0).shape[0]))
    byte_class = np.zeros((n_model, 257), np.int32)
    class_table = np.zeros((n_model, k_max + 1, w_shard), np.uint32)
    pair_reach = np.zeros((n_model, (k_max + 1) ** 2, w_shard), np.uint32)
    pair_final = np.zeros((n_model, k_max + 1, w_shard), np.uint32)
    for s in range(n_model):
        sl = slice(s * w_shard, (s + 1) * w_shard)
        bc, T, pr, pf, _k = build_class_pair_tables(
            bt[:, sl], init[sl], final[sl], k_pad=k_max)
        byte_class[s] = bc
        class_table[s] = T
        pair_reach[s] = pr
        pair_final[s] = pf

    return ShardedTables(
        n_model=n_model, w_shard=w_shard, byte_table=bt, init_mask=init,
        final_mask=final, factor_word=factor_word, factor_bit=factor_bit,
        factor_rule=factor_rule,
        rule_sv=cr.rule_sv_mask.astype(np.float32),
        rule_score=cr.rule_score.astype(np.float32),
        rule_class=onehot,
        rule_no_prefilter=(t.rule_nfactors == 0),
        k_max=k_max, byte_class=byte_class, class_table=class_table,
        pair_reach=pair_reach, pair_final=pair_final,
    )


class _ShardTables:
    """One model shard's tables on one device."""

    def __init__(self, st: ShardedTables, s: int, device: torch.device):
        self.scan = st.shard_scan_tables(s, device)
        self.factor_word = torch.from_numpy(
            st.factor_word[s].astype(np.int64)).to(device)
        # bit indices are 0..31: the uint32 view is the same number
        self.factor_bit = torch.from_numpy(
            st.factor_bit[s].astype(np.int32)).to(device)
        self.factor_rule = torch.from_numpy(st.factor_rule[s]).to(device)


class _Replicated:
    """The tables every data row's first device holds whole."""

    def __init__(self, st: ShardedTables, tenant_mask: np.ndarray,
                 device: torch.device):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        self.rule_sv_t = t(st.rule_sv.T)                 # (N_SV, R)
        self.score = t(st.rule_score)                    # (R,)
        self.rule_class = t(st.rule_class)               # (R, C)
        self.nopf = t(st.rule_no_prefilter)              # (R,) bool
        self.tenant = t(tenant_mask) > 0                 # (T, R) bool


def default_impl(device_type: str) -> str:
    """The impl of a mesh built with ``scan_impl=None``: ``pallas2`` on
    ``cuda``, ``pair`` on ``cpu`` (the server's ``--scan-impl auto``
    then measures, :meth:`ShardedEngine.autoselect_scan_impl`)."""
    return "pallas2" if device_type == "cuda" else "pair"


class ShardedEngine:
    """DP×TP detection step over a :class:`Mesh`.

    EP: ``tenant_rule_mask`` (T, R) bool — per-tenant rule subsets over
    the shared superset NFA.  ``scan_impl`` None is :func:`default_impl`
    of the mesh's device type."""

    #: "pair"    = the plain class-pair scan (cpu)
    #: "take"    = the per-byte scan: plain scan_bytes on cpu, the step
    #:             kernel on cuda
    #: "pallas2" = the class-pair kernel on each shard's class-id tables
    #:             (cuda)
    SCAN_IMPLS = ("pair", "take", "pallas2")

    def __init__(self, cr: CompiledRuleset, mesh: Mesh,
                 tenant_rule_mask: Optional[np.ndarray] = None,
                 scan_impl: Optional[str] = None,
                 shard_launches: Optional[List[List[int]]] = None):
        self.mesh = mesh
        self.rows: List[List[torch.device]] = [
            [_resolve(d) for d in row] for row in mesh.rows]
        self.device_type = mesh.device_type
        n_model = mesh.shape["model"]
        self.st = shard_ruleset_tables(cr, n_model)
        if tenant_rule_mask is None:
            tenant_rule_mask = np.ones((1, max(cr.n_rules, 1)), bool)
        self.tenant_mask = tenant_rule_mask.astype(np.float32)
        self.scan_impl = (default_impl(self.device_type)
                          if scan_impl is None else scan_impl)
        #: {impl: seconds} of the last :meth:`autoselect_scan_impl`
        self.last_timings: Dict[str, float] = {}
        if self.device_type == "cuda":
            # the vote and mapping products must be exact float32
            torch.backends.cuda.matmul.allow_tf32 = False
            for dev in {d for row in self.rows for d in row}:
                load_kernels(dev)
        self._shards: Dict[Tuple[torch.device, int], _ShardTables] = {}
        self._replicated: Dict[torch.device, _Replicated] = {}
        self._scanners: Dict[tuple, object] = {}
        self._streams: Dict[Tuple[int, int], torch.cuda.Stream] = {}
        #: the serving cycles' kernel launches of each local (data row,
        #: model shard) entry; a caller that rebuilds the engine passes
        #: its grid on, so the counts outlive a ruleset swap as the
        #: kernels' own tallies do
        self.shard_launches = (shard_launches if shard_launches is not None
                               else [[0] * n_model for _ in self.rows])

    # ------------------------------------------------------------ impl

    @property
    def scan_impl(self) -> str:
        return self._scan_impl

    @scan_impl.setter
    def scan_impl(self, impl: str) -> None:
        check_impl(impl, self.device_type)
        self._scan_impl = impl

    def set_scan_impl(self, scan_impl: str) -> None:
        self.scan_impl = scan_impl

    def autoselect_scan_impl(self, B: int = 256, L: int = 256,
                             iters: int = 17,
                             global_rows: bool = False) -> str:
        """Time the sharded scan impls on this mesh, keep the fastest and
        return it; ``last_timings`` holds ``{impl: seconds of iters
        steps}``.  Candidates: ``take`` and ``pair`` on a CPU mesh,
        ``take`` and ``pallas2`` on a card mesh (every impl
        :func:`check_impl` lets run there).  Inputs: ``B`` (rounded up
        to a multiple of the data axis) rows of ``L`` seeded bytes
        0..255 (``default_rng(7)``), one request per row, with
        shard-local request ids, or global ones for ``global_rows`` (the
        step variant the caller serves with: ``MeshEngine`` passes
        True).  Each candidate runs one warm step, then ``iters`` steps
        timed on the host clock with every card of the mesh synchronized
        at both ends: the step dispatches every entry from the host, as
        serving does, so the host's work is part of the time.  A card
        mesh times ``CARD_ROUNDS`` rounds, each candidate once a round in
        turn, and keeps each one's median round; a CPU mesh one round on
        one torch thread (``models.engine.bake_off_rounds``,
        ``bake_off_threads``).  Its launches are tallied under
        ``launch_scope(AUTOSELECT_SCOPE)``.  A mesh over several
        processes keeps the configured impl (its inputs would have to be
        built on every process).  A candidate that raises stops the
        bake-off: no impl is installed in its place."""
        import statistics
        import time

        if process_count() > 1:
            return self.scan_impl
        candidates = ["take", "pair" if self.device_type == "cpu"
                      else "pallas2"]
        n_data = self.mesh.shape["data"]
        B = -(-B // n_data) * n_data
        L += L % 2                       # the pair scan steps byte pairs
        rng = np.random.default_rng(7)
        tokens = rng.integers(0, 256, (B, L), dtype=np.int32).astype(
            np.uint8)
        lengths = np.full((B,), L, np.int32)
        row_req = (np.arange(B, dtype=np.int32) if global_rows
                   else np.tile(np.arange(B // n_data, dtype=np.int32),
                                n_data))
        row_sv = np.ones((B, self.st.rule_sv.shape[1]), np.int8)
        tenants = np.zeros((B,), np.int32)
        cards = sorted({d for row in self.rows for d in row
                        if d.type == "cuda"}, key=str)

        def step():
            return self.step(tokens, lengths, row_req, row_sv, tenants, B,
                             global_rows=global_rows)

        def sync():
            for d in cards:
                torch.cuda.synchronize(d)

        configured = self.scan_impl
        rounds = {impl: [] for impl in candidates}
        try:
            with launch_scope(AUTOSELECT_SCOPE), \
                    bake_off_threads(self.rows[0][0]):
                for impl in candidates:
                    self.scan_impl = impl
                    step()                                  # warm
                sync()
                for _ in range(bake_off_rounds(self.rows[0][0])):
                    for impl in candidates:
                        self.scan_impl = impl
                        t0 = time.perf_counter()
                        for _ in range(iters):
                            step()
                        sync()
                        rounds[impl].append(time.perf_counter() - t0)
        finally:
            self.scan_impl = configured
        timings = {impl: statistics.median(ts) for impl, ts in rounds.items()}
        best = min(timings, key=timings.get)
        self.last_timings = timings
        self.set_scan_impl(best)
        return best

    # ------------------------------------------------- per-device state

    def shard_tables(self, device: torch.device, s: int) -> _ShardTables:
        """Shard ``s``'s tables on ``device`` (one copy per device, however
        many mesh entries name it)."""
        key = (device, s)
        tabs = self._shards.get(key)
        if tabs is None:
            tabs = self._shards[key] = _ShardTables(self.st, s, device)
        return tabs

    def replicated(self, device: torch.device) -> _Replicated:
        rep = self._replicated.get(device)
        if rep is None:
            rep = self._replicated[device] = _Replicated(
                self.st, self.tenant_mask, device)
        return rep

    def scanner(self, device: torch.device, s: int):
        """The live impl's kernel scanner for shard ``s`` on ``device``;
        None for a plain scan (a CPU mesh)."""
        if device.type != "cuda":
            return None
        key = (self.scan_impl, device, s)
        sc = self._scanners.get(key)
        if sc is None:
            cls = PairScanner if self.scan_impl == "pallas2" else StepScanner
            sc = self._scanners[key] = cls(self.shard_tables(device, s).scan)
        return sc

    def drop_compiled(self) -> None:
        """Forget the scanners and table copies; later steps rebuild
        them.  On a card the shard tables were read on the per-shard
        side streams: those drain first, so no queued launch reads a
        freed block."""
        for st in self._streams.values():
            st.synchronize()
        self._shards = {}
        self._replicated = {}
        self._scanners = {}

    # ------------------------------------------------------------ step

    def _shard_vote(self, d: int, s: int, tok: np.ndarray,
                    ln: np.ndarray) -> torch.Tensor:
        """One entry's partial votes (B_s, R) float32 on its device: the
        word-local scan, the factor gather and ``fh @ fr[s]``."""
        dev = self.rows[d][s]
        tabs = self.shard_tables(dev, s)
        tok_t = torch.from_numpy(np.ascontiguousarray(tok)).to(dev)
        ln_host = torch.from_numpy(np.ascontiguousarray(ln, np.int32))
        sc = self.scanner(dev, s)
        if sc is not None:
            match, _ = sc(tok_t, ln_host)
            if tok.shape[0] and current_scope() == SERVE_SCOPE:
                self.shard_launches[d][s] += 1
        elif self.scan_impl == "take":
            match, _ = scan_bytes(tabs.scan, tok_t, ln_host)
        else:
            match, _ = scan_pairs(tabs.scan, tok_t, ln_host)
        mw = match.index_select(1, tabs.factor_word)
        fh = ((mw >> tabs.factor_bit) & 1).to(torch.float32)
        return torch.matmul(fh, tabs.factor_rule)

    def _row_votes(self, d: int, tok: np.ndarray,
                   ln: np.ndarray) -> torch.Tensor:
        """Data row ``d``'s merged votes (B_s, R) on its first device:
        the JAX ``psum`` over ``model``.  On a card each shard runs on a
        CUDA stream of its own, after the caller's current stream."""
        row = self.rows[d]
        dev0 = row[0]
        if self.device_type != "cuda":
            votes = [self._shard_vote(d, s, tok, ln)
                     for s in range(len(row))]
        else:
            votes = []
            streams = []
            for s, dev in enumerate(row):
                st = self._streams.get((d, s))
                if st is None:
                    st = self._streams[(d, s)] = torch.cuda.Stream(dev)
                st.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.device(dev), torch.cuda.stream(st):
                    votes.append(self._shard_vote(d, s, tok, ln))
                streams.append(st)
            for dev, st, v in zip(row, streams, votes):
                cur = torch.cuda.current_stream(dev)
                cur.wait_stream(st)
                v.record_stream(cur)
        total = votes[0]
        for v in votes[1:]:
            total = total + v.to(dev0)
        return total

    def _row_partials(self, d: int, tok, ln, rr, sv, seg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Data row ``d``'s per-request partials over its own rows:
        (rule hits, rows-present) as (seg, R) int32 0/1 on its first
        device."""
        dev0 = self.rows[d][0]
        rep = self.replicated(dev0)
        row_rule = self._row_votes(d, tok, ln) > 0
        sv_t = torch.from_numpy(np.ascontiguousarray(sv)).to(
            dev0, torch.float32)
        applies = torch.matmul(sv_t, rep.rule_sv_t) > 0
        row_rule = row_rule & applies
        rr_t = torch.from_numpy(np.ascontiguousarray(rr, np.int64)).to(dev0)
        # the port's segment max starts from 0, so a segment with no
        # rows on this data row reads 0, never INT32_MIN
        rh = _segment_max(row_rule.to(torch.int32), rr_t, seg)
        ap = _segment_max(applies.to(torch.int32), rr_t, seg)
        return rh, ap

    def _finish(self, rh: torch.Tensor, ap: torch.Tensor,
                tenants: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Merged partials → (rule_hits, class_hits, scores) on their
        device: the no-prefilter rules, the EP tenant mask, the class and
        score products."""
        rep = self.replicated(rh.device)
        rule_hits = (rh > 0) | ((ap > 0) & rep.nopf[None, :])
        ten = torch.from_numpy(
            np.ascontiguousarray(tenants, np.int64)).to(rh.device)
        tmask = rep.tenant.index_select(0, ten % rep.tenant.shape[0])
        rule_hits = rule_hits & tmask
        hits_f = rule_hits.to(torch.float32)
        class_hits = torch.matmul(hits_f, rep.rule_class) > 0
        scores = torch.matmul(hits_f, rep.score).to(torch.int32)
        return rule_hits, class_hits, scores

    def step(self, tokens: np.ndarray, lengths: np.ndarray,
             row_req: np.ndarray, row_sv: np.ndarray, tenants: np.ndarray,
             num_requests: int, global_rows: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One sharded step over this process's data rows; outputs on
        the mesh's first device.

        ``global_rows=False`` (the :meth:`detect` contract): row_req
        holds SHARD-LOCAL request ids, each data row reduces its own
        rows, and the (Q, R) output is the concatenation of the rows'
        verdicts (this process's rows: dcn.py gathers the rest).
        ``global_rows=True`` (the serving adapter, serve_mesh.py):
        row_req holds GLOBAL request ids, rows may sit on ANY data row,
        and the rows' clamped 0/1 partials are summed over ``data``."""
        n_data = self.mesh.shape["data"]
        local = self.mesh.local_rows
        B = tokens.shape[0]
        if B % local:
            raise ValueError("%d rows do not split over %d data rows"
                             % (B, local))
        b = B // local
        seg = num_requests if global_rows else num_requests // n_data
        out_dev = self.rows[0][0]
        parts = []
        for d in range(local):
            rows = slice(d * b, (d + 1) * b)
            parts.append(self._row_partials(
                d, tokens[rows], lengths[rows], row_req[rows],
                row_sv[rows], seg))
        if global_rows:
            rh = parts[0][0]
            ap = parts[0][1]
            for prh, pap in parts[1:]:
                rh = rh + prh.to(out_dev)
                ap = ap + pap.to(out_dev)
            if self.mesh.spans_processes:
                rh = all_reduce_sum(rh)
                ap = all_reduce_sum(ap)
            return self._finish(rh, ap, tenants)
        outs = [self._finish(prh, pap, tenants[d * seg:(d + 1) * seg])
                for d, (prh, pap) in enumerate(parts)]
        return tuple(torch.cat([o[i].to(out_dev) for o in outs])
                     for i in range(3))

    def detect(self, tokens, lengths, row_req, row_sv, tenants,
               num_requests: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """row_req must hold SHARD-LOCAL request indices (each data row
        owns Q/n_data consecutive requests).  num_requests is the global
        request count.

        A mesh that spans processes takes this process's slice of each
        input (``dcn.make_global``; every process contributes its
        ``local_batch_bounds`` share) and returns the full outputs as
        numpy on every process (``dcn.gather_global``)."""
        n_data = self.mesh.shape["data"]
        if num_requests % n_data != 0:
            raise ValueError(
                "num_requests=%d not divisible by data-axis size %d — pad "
                "the batch with empty requests" % (num_requests, n_data))
        tokens = np.asarray(tokens)
        if self.scan_impl == "pair" and tokens.shape[1] % 2:
            # scan_pairs needs even L; the padding column lies past every
            # row's length (the dead class)
            tokens = np.pad(tokens, ((0, 0), (0, 1)))
        rh, ch, sc = self.step(
            tokens, np.asarray(lengths, np.int32),
            np.asarray(row_req, np.int32), np.asarray(row_sv, np.int8),
            np.asarray(tenants, np.int32), num_requests)
        return gather_global(rh), gather_global(ch), gather_global(sc)


def check_impl(impl: str, device_type: str) -> None:
    """Raise ValueError unless ``impl`` can run on ``device_type``."""
    if impl not in ShardedEngine.SCAN_IMPLS:
        raise ValueError("sharded scan_impl must be one of %s, got %r"
                         % (ShardedEngine.SCAN_IMPLS, impl))
    if impl != "take" and (impl == "pair") != (device_type == "cpu"):
        raise ValueError(
            "sharded scan_impl %r cannot run on a %s mesh: pallas2 is the "
            "pair kernel (CUDA), 'pair' the plain CPU scan"
            % (impl, device_type))


def _resolve(device: torch.device) -> torch.device:
    """A mesh entry as a concrete device: raises for ``cuda`` without a
    card; an index-less ``cuda`` names the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
