"""Batched bitap scan — plain PyTorch versions.

The port of ``ingress_plus_tpu/ops/scan.py``.  The recurrence per byte
(element-wise over words — compiler/bitap.py says why no cross-word
carries exist):

    S' = ((S << 1) | INIT) & B[byte]
    M' = M | (S' & FINAL)

Shapes: tokens (B, L) uint8 or integer in [0, 255], lengths (B,) int32,
state/match (B, W).  Words are held as **int32 bit patterns**: torch's
uint32 has no shifts or ``index_select`` on the CPU.  ``<<`` on int32 is
the same bit pattern as on uint32, and ``(x >> b) & 1`` reads bit ``b``
whatever the sign, so every result here is bit-identical to the uint32
reference.  Convert with :func:`to_numpy_u32` / :func:`from_numpy_u32`
only at numpy boundaries.

``scan_pairs`` is the plain version of the CUDA pair-scan kernel
(ops/pair_scan.py): same inputs, same outputs, one Python step per byte
pair.  It is a reference, not a fast path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ingress_plus_tpu_torch.compiler.bitap import BitapTables
from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device


def from_numpy_u32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy words → int32 tensor with the same bit pattern."""
    return torch.from_numpy(
        np.array(a, np.uint32).view(np.int32)
    ).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor → uint32 numpy array with the same bit pattern."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(
        np.uint32)


class ScanTables:
    """Device-resident scan tables.

    ``byte_table`` (256, W) and the init/final masks are the per-byte
    recurrence.  Byte-class compression: the 256 byte rows collapse to k
    distinct classes; ``byte_class`` (257,) maps byte → class with
    ``[256]`` = the DEAD class k (all-zero reach) used as padding, and
    ``class_table`` (k+1, W) holds the classes' reach.  The class-pair
    stride folds two steps into one gather:

        S2 = ((S<<2) | (I<<1) | I) & R'[c1,c2]
        R'[c1,c2] = ((T[c1]<<1) | I) & T[c2]

    with odd-position match ends collected via FA[c1] = T[c1] & final
    (``pair_final``)."""

    def __init__(self, byte_table: torch.Tensor, init_mask: torch.Tensor,
                 final_mask: torch.Tensor, byte_class: torch.Tensor,
                 class_table: torch.Tensor, pair_reach: torch.Tensor,
                 pair_final: torch.Tensor):
        self.byte_table = byte_table      # (256, W) int32
        self.init_mask = init_mask        # (W,) int32
        self.final_mask = final_mask      # (W,) int32
        self.byte_class = byte_class      # (257,) int64
        self.class_table = class_table    # (k+1, W) int32
        self.pair_reach = pair_reach      # ((k+1)^2, W) int32
        self.pair_final = pair_final      # (k+1, W) int32

    @classmethod
    def from_bitap(cls, t: BitapTables,
                   device: DeviceLike = None) -> "ScanTables":
        dev = resolve_device(device)
        bt = np.asarray(t.byte_table, np.uint32)
        byte_class, T, pair_reach, pair_final, _k = \
            build_class_pair_tables(bt, t.init_mask, t.final_mask)
        return cls(
            byte_table=from_numpy_u32(bt, dev),
            init_mask=from_numpy_u32(t.init_mask, dev),
            final_mask=from_numpy_u32(t.final_mask, dev),
            byte_class=torch.from_numpy(byte_class.astype(np.int64)).to(dev),
            class_table=from_numpy_u32(T, dev),
            pair_reach=from_numpy_u32(pair_reach, dev),
            pair_final=from_numpy_u32(pair_final, dev),
        )

    @property
    def device(self) -> torch.device:
        return self.byte_table.device

    @property
    def n_words(self) -> int:
        return self.byte_table.shape[1]

    @property
    def n_classes(self) -> int:
        """Real classes (excluding the dead padding class)."""
        return self.class_table.shape[0] - 1


def build_class_pair_tables(byte_table: np.ndarray, init_mask: np.ndarray,
                            final_mask: np.ndarray,
                            k_pad: Optional[int] = None):
    """Byte-class compression + folded pair recurrence tables (numpy).

    Returns (byte_class (257,), class_table (K+1, W), pair_reach
    ((K+1)^2, W), pair_final (K+1, W), k); the DEAD class (zero reach)
    sits at index K = ``k_pad or k`` and byte_class[256] maps to it."""
    bt = byte_table.astype(np.uint32)
    uniq, inv = np.unique(bt, axis=0, return_inverse=True)
    inv = np.asarray(inv).ravel()  # numpy <2.0 returns (256, 1), axis=0
    k = int(uniq.shape[0])
    K = k_pad if k_pad is not None else k
    if K < k:
        raise ValueError("k_pad=%d < actual class count %d" % (K, k))
    T = np.zeros((K + 1, bt.shape[1]), np.uint32)
    T[:k] = uniq
    byte_class = np.concatenate(
        [inv.astype(np.int32), np.asarray([K], np.int32)])
    init = init_mask.astype(np.uint32)[None, None, :]
    pair = ((T[:, None, :] << np.uint32(1)) | init) & T[None, :, :]
    pair_reach = pair.reshape((K + 1) * (K + 1), -1)
    pair_final = T & final_mask.astype(np.uint32)[None, :]
    return byte_class, T, pair_reach, pair_final, k


def classes_for(byte_class: torch.Tensor, tokens: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """(B, L) byte rows → (B, L) int64 class ids, with padding (pos ≥
    length) mapped to the DEAD class via the 256 sentinel."""
    L = tokens.shape[1]
    pos = torch.arange(L, device=tokens.device)[None, :]
    toks = torch.where(pos < lengths.to(torch.int64)[:, None],
                       tokens.to(torch.int64),
                       torch.full((), 256, dtype=torch.int64,
                                  device=tokens.device))
    return byte_class[toks]


def _zeros_or(x: Optional[torch.Tensor], B: int, W: int,
              device: torch.device) -> torch.Tensor:
    if x is None:
        return torch.zeros((B, W), dtype=torch.int32, device=device)
    return x.to(torch.int32)


def scan_bytes(
    tables: ScanTables,
    tokens: torch.Tensor,    # (B, L) uint8/int
    lengths: torch.Tensor,   # (B,) int32
    state: Optional[torch.Tensor] = None,   # (B, W) int32 — stream carry
    match: Optional[torch.Tensor] = None,   # (B, W) int32 — sticky
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan a batch of byte rows; returns (match, state) after each row's
    ``length`` bytes.  Padded steps are identity on both S and M, so the
    state is exact and may be carried into the next chunk of a stream."""
    B, L = tokens.shape
    W = tables.n_words
    dev = tables.device
    S = _zeros_or(state, B, W, dev)
    M = _zeros_or(match, B, W, dev)
    toks = tokens.to(torch.int64)
    lens = lengths.to(torch.int64)
    I = tables.init_mask[None, :]
    F = tables.final_mask[None, :]
    for t in range(L):
        reach = tables.byte_table.index_select(0, toks[:, t])
        S_new = ((S << 1) | I) & reach
        valid = (t < lens)[:, None]
        S = torch.where(valid, S_new, S)
        M = torch.where(valid, M | (S_new & F), M)
    return M, S


def scan_pairs(
    tables: ScanTables,
    tokens: torch.Tensor,    # (B, L) uint8/int, L even
    lengths: torch.Tensor,   # (B,) int32
    state: Optional[torch.Tensor] = None,
    match: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-pair-stride scan: L/2 steps, one (B, W) pair-reach gather
    per two bytes plus one (B, W) gather for odd-position match ends.
    Returns the same ``match`` as :func:`scan_bytes`.  The state differs
    by contract: rows shorter than L are padded with the DEAD class, so
    their returned ``state`` is zero — use this path for request scans
    (only ``match`` is read) and equal-length chunk waves, never for
    carrying state across ragged stream chunks."""
    B, L = tokens.shape
    if L % 2:
        raise ValueError("scan_pairs needs even L (pad_rows rounds up)")
    W = tables.n_words
    dev = tables.device
    S = _zeros_or(state, B, W, dev)
    M = _zeros_or(match, B, W, dev)
    k1 = tables.class_table.shape[0]   # k + 1 (dead class last)
    cls = classes_for(tables.byte_class, tokens, lengths)    # (B, L)
    c1 = cls[:, 0::2].t().contiguous()                       # (L/2, B)
    pair_idx = (c1 * k1 + cls[:, 1::2].t()).contiguous()
    I = tables.init_mask[None, :]
    IOR = (I << 1) | I
    F = tables.final_mask[None, :]
    for t in range(L // 2):
        R = tables.pair_reach.index_select(0, pair_idx[t])     # (B, W)
        FA1 = tables.pair_final.index_select(0, c1[t])         # (B, W)
        M = M | (((S << 1) | I) & FA1)                         # ends at 1
        S = ((S << 2) | IOR) & R
        M = M | (S & F)                                        # ends at 2
    return M, S


def pad_rows(rows: list, max_len: Optional[int] = None, round_to: int = 128
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side helper: pack variable-length byte strings into a padded
    (B, L) uint8 matrix + lengths, L rounded up to ``round_to``."""
    if not rows:
        return np.zeros((0, round_to), np.uint8), np.zeros((0,), np.int32)
    L = max_len or max(1, max(len(r) for r in rows))
    L = ((L + round_to - 1) // round_to) * round_to
    out = np.zeros((len(rows), L), dtype=np.uint8)
    lengths = np.zeros((len(rows),), dtype=np.int32)
    for i, r in enumerate(rows):
        r = r[:L]
        out[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lengths[i] = len(r)
    return out, lengths
