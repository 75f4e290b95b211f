"""Sequence-parallel streaming scan — the ring-attention analog.

The port of ``ingress_plus_tpu/parallel/stream.py``.  A giant body is
split along the byte axis across the ``model`` mesh axis; every shard
scans its slice *plus a halo of the last HALO bytes of the previous
slice*, where HALO ≥ the longest factor.  Because bitap state only ever
depends on the last (factor_len - 1) bytes, the halo makes each local
scan exact: matches ending in slice s are found by shard s.  Matches
ending inside the halo are found again by the previous shard — harmless,
the match mask is a sticky OR.

PyTorch has no ``ppermute``: the halo is a slice of the neighbour
shard's tokens, copied to the shard's device, and the JAX ``all_gather``
plus OR is an OR of the shards' match words on the first device.  On
``cuda`` each shard's scan is the step kernel (``ops/step_scan.py
StepScanner``), on ``cpu`` the plain ``scan_bytes``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ingress_plus_tpu_torch.ops.scan import ScanTables, scan_bytes
from ingress_plus_tpu_torch.ops.step_scan import StepScanner
from ingress_plus_tpu_torch.parallel.mesh import Mesh

HALO = 32  # ≥ max factor length (bitap.WORD_BITS); exactness bound


def ring_scan(tables: ScanTables, mesh: Mesh, tokens,
              lengths: Optional[np.ndarray] = None,
              axis: str = "model") -> torch.Tensor:
    """Scan (B, L_total) byte rows sequence-sharded along ``axis``.

    tokens must be (B, L_total) with L_total divisible by the axis size.
    ``lengths`` (B,) gives each row's true byte count — rows may be
    RAGGED: shard ``s`` clips its slice to ``clip(len - s*L_local, 0,
    L_local)`` bytes, so a shard past a row's end scans nothing and
    padding garbage can't match.  The halo a shard receives is valid
    whenever it scans at all: a positive clipped length means every
    predecessor slice was full.  ``lengths=None`` scans every byte.
    The shards are the entries of the mesh's first row along ``model``
    (or its first column along ``data``); ``tables`` are copied to each
    shard's device, and the shards that name one device scan in one call
    (one kernel launch on a card).  Returns the merged sticky match words
    (B, W) int32 on the first shard's device."""
    devs = (mesh.rows[0] if axis == "model"
            else [row[0] for row in mesh.rows])
    n = len(devs)
    tokens = np.asarray(tokens)
    B, L_total = tokens.shape
    if L_total % n:
        raise ValueError("row width %d does not split over %d shards"
                         % (L_total, n))
    L_local = L_total // n
    if L_local < HALO:
        raise ValueError(
            "per-shard slice %d < HALO %d: the halo would be short and "
            "boundary-spanning matches silently lost — use fewer shards or "
            "a longer body" % (L_local, HALO))
    if lengths is None:
        lengths = np.full((B,), L_total, np.int32)
    lengths = np.asarray(lengths, np.int64)
    # shards that name the same device scan in one call: their halo'd
    # slices are independent rows of one (n*B, L_local + HALO) batch
    groups: Dict[torch.device, List[int]] = {}
    for idx, dev in enumerate(devs):
        groups.setdefault(dev, []).append(idx)
    merged = None
    for dev, idxs in groups.items():
        ext = np.zeros((len(idxs) * B, L_local + HALO), tokens.dtype)
        lens = np.zeros((len(idxs) * B,), np.int32)
        for j, idx in enumerate(idxs):
            lo = idx * L_local
            rows = slice(j * B, (j + 1) * B)
            # this shard's share of each row: 0 when the row ended earlier
            eff = np.clip(lengths - lo, 0, L_local)
            if idx == 0:
                # shard 0 has no predecessor: its slice alone,
                # left-aligned (the padding lies past its lengths)
                ext[rows, :L_local] = tokens[:, :L_local]
                lens[rows] = eff
            else:
                ext[rows] = tokens[:, lo - HALO:lo + L_local]
                lens[rows] = np.where(eff > 0, eff + HALO, 0)
        tok_t = torch.from_numpy(ext).to(dev)
        len_t = torch.from_numpy(lens)
        t = _tables_on(tables, dev)
        if dev.type == "cuda":
            match, _ = StepScanner(t)(tok_t, len_t)
        else:
            match, _ = scan_bytes(t, tok_t, len_t)
        # OR the group's shards (the JAX all_gather + OR), then across
        # groups on the first shard's device
        match = match.view(len(idxs), B, -1)
        part = match[0]
        for j in range(1, len(idxs)):
            part = part | match[j]
        part = part.to(devs[0])
        merged = part if merged is None else merged | part
    return merged


def _tables_on(tables: ScanTables, dev: torch.device) -> ScanTables:
    if tables.device == dev:
        return tables
    return ScanTables(**{k: getattr(tables, k).to(dev) for k in (
        "byte_table", "init_mask", "final_mask", "byte_class",
        "class_table", "pair_reach", "pair_final")})
