"""Serve the multi-device detection step behind the single-device engine
API.

The port of ``ingress_plus_tpu/parallel/serve_mesh.py``.
``MeshEngine`` adapts :class:`ShardedEngine` (DP×TP over a Mesh,
shard.py) to the ``DetectionEngine`` interface the serving stack
consumes (the pipeline's bucket dispatch, the batcher's hot swap, the
server's ``--scan-impl``), so ``serve --mesh data=2,model=4`` runs the
SAME deadline batcher, bucketing and confirm pipeline with the scan
spread over a device mesh.

Row layout contract: the adapter uses the sharded step's GLOBAL-ROWS
variant (``ShardedEngine.step(global_rows=True)``) — rows ride in caller
order with GLOBAL request ids, the data rows each segment-reduce their
own row slice against all Q segments, and the per-request partials are
summed over ``data``.  Row placement is therefore free, and every launch
shape is a pure function of (B, L, Q).

Tenant (EP) masking stays in the PIPELINE (``mask_hits``), exactly as for
the single-device engine — the adapter always builds the sharded step
with the trivial all-tenants mask so the two paths cannot diverge on EP
semantics.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset
from ingress_plus_tpu_torch.parallel.mesh import Mesh, default_devices
from ingress_plus_tpu_torch.parallel.shard import ShardedEngine
from ingress_plus_tpu_torch.utils.device import DeviceLike
from ingress_plus_tpu_torch.utils.overlap import collect as overlap_collect

#: the virtual CPU devices a ``--platform cpu`` mesh may name (the JAX
#: tests' count)
CPU_DEVICES = 8


def batch_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The data-parallel serve mesh: every local device on the ``data``
    axis, one model shard each (default: every CUDA card).  Scan rows
    shard across it at request granularity (serve/lanes.py LanePool)
    with the sigpack replicated once per device
    (``DetectionEngine.tables_for``)."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    return Mesh([[d] for d in devs])


def run_lane_measurement(cr: CompiledRuleset, n_lanes: int,
                         n_req: int = 1024, max_batch: int = 64,
                         mode: str = "block", seed: int = 42,
                         tier_warmup: bool = True,
                         device: DeviceLike = None) -> dict:
    """Measure the LANE-SHARDED serve plane end to end: a real Batcher
    with ``n_lanes`` per-device lanes (one per CUDA card, or on the CPU
    when ``device="cpu"``), warmed then driven with a labeled corpus
    through the real admission queue.  Returns ``req_per_s_mesh`` plus
    per-lane utilization; every number is the host clock of this
    process around work that ends in verdicts."""
    from ingress_plus_tpu_torch.models.pipeline import (
        DetectionPipeline,
        warm_sizes,
    )
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus
    from ingress_plus_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    devices = default_devices() if dev.type == "cuda" else [dev]
    pipeline = DetectionPipeline(cr, mode=mode, device=dev)
    # throughput harness: the whole corpus floods the queue at once, so
    # the SLO machinery stands down — a huge deadline and a queue that
    # fits the corpus
    batcher = Batcher(pipeline, max_batch=max_batch,
                      max_delay_s=0.0005, n_lanes=n_lanes,
                      lane_devices=devices,
                      hard_deadline_s=600.0,
                      queue_cap=max(8192, n_req + 16))
    try:
        corpus = generate_corpus(n=n_req, attack_fraction=0.2, seed=seed)
        requests = [lr.request for lr in corpus]
        t_w0 = time.perf_counter()
        if tier_warmup and n_lanes > 1:
            batcher.warm_lanes()
        elif tier_warmup:
            for size in warm_sizes(max_batch):
                pipeline.detect(requests[:size])
            pipeline.reset_detection_observations()
        # one unmeasured pass of the corpus itself: first loads inside
        # the measured window would book as throughput
        futs = [batcher.submit(r) for r in requests]
        for f in futs:
            f.result(timeout=600)
        warm_s = time.perf_counter() - t_w0
        batcher.reset_latency_observations()
        ps = pipeline.stats
        c0, e0, p0 = ps.confirm_us, ps.engine_us, ps.prep_us
        t0 = time.perf_counter()
        futs = [batcher.submit(r) for r in requests]
        verdicts = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        d_confirm = ps.confirm_us - c0
        d_stages = d_confirm + (ps.engine_us - e0) + (ps.prep_us - p0)
        lanes = batcher.lanes.snapshot()
        util = {str(ln["lane"]): (round(ln["busy_us"] / (wall * 1e6), 4)
                                  if wall > 0 else None)
                for ln in lanes}
        return {
            "platform": dev.type,
            "n_devices": len(devices),
            "n_lanes": n_lanes,
            "requests": n_req,
            "req_per_s_mesh": round(n_req / wall, 1) if wall > 0 else None,
            "wall_s": round(wall, 3),
            "warmup_s": round(warm_s, 1),
            "verdicts": len(verdicts),
            "fail_open": sum(1 for v in verdicts if v.fail_open),
            "attacks": sum(1 for v in verdicts if v.attack),
            "per_device_utilization": util,
            "per_lane": [{k: ln[k] for k in
                          ("lane", "device", "requests", "rows",
                           "dispatch_fill", "hangs", "errors", "busy_us")}
                         for ln in lanes],
            "serve_time_recompiles": pipeline.stats.engine_compiles,
            "confirm_share": (round(d_confirm / d_stages, 4)
                              if d_stages > 0 else None),
            "confirm_us": d_confirm,
            "confirm_workers": pipeline.confirm_pool.n_workers,
            "pipeline_overlap": overlap_collect(batcher),
            "ruleset": {"rules": int(cr.n_rules),
                        "words": int(cr.tables.n_words)},
        }
    finally:
        batcher.close()


def parse_mesh_spec(spec: str, n_devices: Optional[int] = None,
                    platform: str = "cuda") -> Mesh:
    """'data=2,model=4' (or '2x4') → a Mesh over this host's devices.
    On ``cuda`` the entries are distinct cards, and a product above
    ``torch.cuda.device_count()`` (capped by ``n_devices``) raises; on
    ``cpu`` every entry is ``cpu``, up to :data:`CPU_DEVICES`.  A 0 on
    either axis raises."""
    spec = spec.strip()
    try:
        if "x" in spec and "=" not in spec:
            d, m = spec.split("x", 1)
            n_data, n_model = int(d), int(m)
        else:
            kv = dict(p.split("=", 1) for p in spec.split(","))
            n_data, n_model = int(kv["data"]), int(kv["model"])
    except (KeyError, ValueError) as e:
        raise ValueError("mesh spec %r: want '2x4' or 'data=2,model=4'"
                         % spec) from e
    if n_data < 1 or n_model < 1:
        raise ValueError("mesh axes must be >= 1: %r" % spec)
    need = n_data * n_model
    if platform == "cuda":
        devs = default_devices()
    elif platform == "cpu":
        devs = [torch.device("cpu")] * CPU_DEVICES
    else:
        raise ValueError("unsupported mesh platform %r" % platform)
    if n_devices is not None:
        devs = devs[:n_devices]
    if need > len(devs):
        raise ValueError("mesh %dx%d needs %d devices, have %d"
                         % (n_data, n_model, need, len(devs)))
    return Mesh([devs[i * n_model:(i + 1) * n_model]
                 for i in range(n_data)])


class MeshEngine:
    """DetectionEngine-compatible facade over the sharded DP×TP step."""

    #: sharded impls only — the pipeline and server select from these
    SCAN_IMPLS = ShardedEngine.SCAN_IMPLS

    def __init__(self, cr: CompiledRuleset, mesh: Mesh,
                 scan_impl: Optional[str] = None,
                 shard_launches: Optional[List[List[int]]] = None):
        if mesh.spans_processes:
            raise ValueError(
                "MeshEngine serves a single-process mesh (its dispatch "
                "builds host-local arrays); a mesh over processes rides "
                "dcn.make_global into ShardedEngine.detect instead")
        self.ruleset = cr
        self.mesh = mesh
        self._sharded = ShardedEngine(cr, mesh, scan_impl=scan_impl,
                                      shard_launches=shard_launches)
        #: the device the stream lane and the serve lane use: the mesh's
        #: first entry
        self.device = self._sharded.rows[0][0]
        self._tables = None        # lazy single-device tables (stream lane)

    # ------------------------------------------------ engine API surface

    @property
    def scan_impl(self) -> str:
        return self._sharded.scan_impl

    @scan_impl.setter
    def scan_impl(self, v: str) -> None:
        self._sharded.set_scan_impl(v)

    @property
    def sharded(self) -> ShardedEngine:
        return self._sharded

    @property
    def tables(self):
        """Single-device EngineTables on :attr:`device` for consumers
        that scan OUTSIDE the mesh step (the stream lane's chunk scans;
        only whole-batch prefilter rides the mesh)."""
        if self._tables is None:
            from ingress_plus_tpu_torch.models.engine import EngineTables

            self._tables = EngineTables.from_ruleset(self.ruleset,
                                                     device=self.device)
        return self._tables

    def head_slicing_active(self) -> bool:
        """The sharded step scans the full tables."""
        return False

    def exec_keys(self, device=None) -> tuple:
        """What a dispatch would load for the first time: the shard
        tables of the mesh and, on a card, the live impl's kernels (the
        pipeline's recompile gauge)."""
        keys = (("mesh-tables", repr(self.mesh)),)
        if self.device.type == "cuda":
            keys += (("kernel", self.scan_impl, repr(self.mesh)),)
        return keys

    def device_info(self) -> dict:
        """Engine-API twin of DetectionEngine.device_info (served by
        /rules/stats), plus the mesh the scan is sharded over and each
        (data row, model shard) entry's kernel launches."""
        t = self.ruleset.tables
        return {
            "scan_impl": self.scan_impl,
            "scan_contract": "prepped-rows",
            "device": str(self.device),
            "n_rules": int(self.ruleset.n_rules),
            "n_factors": int(t.n_factors),
            "n_words": int(t.n_words),
            "max_factor_len": int(t.max_factor_len),
            "mesh": self.mesh_info(),
        }

    def mesh_info(self) -> dict:
        sh = self._sharded
        return {"data": int(self.mesh.shape["data"]),
                "model": int(self.mesh.shape["model"]),
                "devices": [[str(d) for d in row] for row in sh.rows],
                "w_shard": int(sh.st.w_shard),
                "k_max": int(sh.st.k_max),
                "shard_launches": [list(r) for r in sh.shard_launches]}

    def swap_ruleset(self, cr: CompiledRuleset) -> None:
        self.ruleset = cr
        self._tables = None
        self._sharded = ShardedEngine(
            cr, self.mesh, scan_impl=self.scan_impl,
            shard_launches=self._sharded.shard_launches)

    def drop_compiled(self) -> None:
        """Forget every scanner and table copy (the recompile_storm
        fault site)."""
        self._sharded.drop_compiled()
        self._tables = None

    def rebuilt(self, cr: CompiledRuleset) -> "MeshEngine":
        """Fresh engine of the SAME kind on a new ruleset (batcher hot
        swap contract — see DetectionEngine.rebuilt)."""
        return MeshEngine(cr, self.mesh, scan_impl=self.scan_impl,
                          shard_launches=self._sharded.shard_launches)

    def autoselect_scan_impl(self, **kw) -> dict:
        """Time the sharded impls on the live mesh, install the fastest
        and return ``{impl: seconds}`` (the server prints it).  Times the
        global-rows step, the variant :meth:`_dispatch` serves with."""
        kw.setdefault("global_rows", True)
        self._sharded.autoselect_scan_impl(**kw)
        return dict(self._sharded.last_timings)

    # -------------------------------------------------------- dispatch

    def _dispatch(self, tokens, lengths, row_req, row_sv,
                  num_requests: int):
        """One global-rows sharded step; returns (rule_hits, class_hits,
        scores) as tensors.  The row axis pads to n_data * B_s with B_s a
        power of two of at least 8 (a function of the row count alone),
        L pads to even (the pair recurrence consumes byte PAIRS)."""
        eng = self._sharded
        n_data = self.mesh.shape["data"]
        tokens = np.asarray(tokens)
        lengths = np.asarray(lengths, np.int32)
        row_req = np.asarray(row_req, np.int32)
        row_sv = np.asarray(row_sv, np.int8)

        B = tokens.shape[0]
        B_s = max(8, 1 << int(np.ceil(np.log2(max(1, -(-B // n_data))))))
        L = tokens.shape[1]
        if L % 2:
            L += 1
        tok2 = np.zeros((n_data * B_s, L), tokens.dtype)
        len2 = np.zeros((n_data * B_s,), np.int32)
        # padding rows carry request id 0 — harmless ONLY because their
        # row_sv stays all-zero: ``applies`` is then false for every
        # rule, so they never contribute a vote
        req2 = np.zeros((n_data * B_s,), np.int32)
        sv2 = np.zeros((n_data * B_s, row_sv.shape[1]), np.int8)
        tok2[:B, :tokens.shape[1]] = tokens
        len2[:B] = lengths
        req2[:B] = row_req
        sv2[:B] = row_sv
        ten2 = np.zeros((num_requests,), np.int32)
        return eng.step(tok2, len2, req2, sv2, ten2, num_requests,
                        global_rows=True)

    def detect_device(self, tokens, lengths, row_req, row_sv,
                      num_requests: int) -> np.ndarray:
        rh, _, _ = self._dispatch(tokens, lengths, row_req, row_sv,
                                  num_requests)
        return rh.cpu().numpy()

    def detect(self, tokens, lengths, row_req, row_sv, num_requests: int):
        return tuple(x.cpu().numpy() for x in self._dispatch(
            tokens, lengths, row_req, row_sv, num_requests))

    def detect_device_multi(self, buckets: Sequence, num_requests: int,
                            head_only: bool = False,
                            device: Optional[torch.device] = None
                            ) -> np.ndarray:
        """The pipeline's multi-bucket dispatch: one sharded step per
        bucket, rule hits OR-ed (the JAX pipeline's per-bucket path for
        engines without a fused dispatch).  ``head_only`` is moot (the
        step scans the full tables); ``device``, a serve lane's card,
        must be the mesh's own first device."""
        if device is not None and torch.device(device) != self.device:
            raise ValueError("mesh engine on %s dispatched for lane "
                             "device %s" % (self.device, device))
        rule_hits = np.zeros((num_requests, max(self.ruleset.n_rules, 1)),
                             bool)
        for tok, ln, rr, rs in buckets:
            rule_hits |= self.detect_device(tok, ln, rr, rs, num_requests)
        return rule_hits
