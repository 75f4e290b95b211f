"""The shift-AND (bitap) recurrence of a pack, in plain PyTorch.

For every byte ``b`` of a row, each 32-bit word ``S`` of the state steps
``S = ((S << 1) | init) & byte_table[b]`` and the sticky match word
collects ``S & final``.  A factor is at most 32 bytes (one word), so the
state after a byte depends on the last 32 bytes alone: a long row is cut
into segments, each scanned from the zero state over the ``halo`` bytes
before it as well, and the segments' match words are OR-ed.  A match
that the zero state finds in the halo is a true match too, so the OR is
exact.  All segments of all rows run as one batch per length bucket, one
step per byte, on any torch device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from wafbench.reference.pack import Pack

#: bytes of a row a segment scans beyond its halo
SEGMENT = 4096
#: segments scanned in one batch (bounds the state's memory)
MAX_BATCH = 32768


class Scanner:
    def __init__(self, pack: Pack, device: str = "cpu"):
        self.device = torch.device(device)
        # 32-bit words held in int64: the shift never leaves the low bits
        # set past bit 31 once ANDed with the byte table
        self.table = torch.from_numpy(pack.byte_table.astype(np.int64)).to(
            self.device)
        self.init = torch.from_numpy(pack.init_mask.astype(np.int64)).to(
            self.device)[None, :]
        self.final = torch.from_numpy(pack.final_mask.astype(np.int64)).to(
            self.device)[None, :]
        self.n_words = pack.n_words
        self.halo = int(pack.factor_len.max()) if len(pack.factor_len) else 0
        if self.halo > 32:
            raise ValueError("a factor longer than a word: %d" % self.halo)

    def match_words(self, rows: Sequence[bytes]) -> np.ndarray:
        """(len(rows), W) uint32: each row's sticky match words."""
        segs: List[bytes] = []
        owner: List[int] = []
        for i, row in enumerate(rows):
            for start in range(0, max(len(row), 1), SEGMENT):
                lo = max(0, start - self.halo)
                segs.append(row[lo:start + SEGMENT])
                owner.append(i)
        out = np.zeros((len(rows), self.n_words), np.uint32)
        buckets: Dict[int, List[int]] = {}
        for j, s in enumerate(segs):
            if s:
                L = 64
                while L < len(s):
                    L *= 2
                buckets.setdefault(L, []).append(j)
        for L, idx in sorted(buckets.items()):
            for lo in range(0, len(idx), MAX_BATCH):
                part = idx[lo:lo + MAX_BATCH]
                m = self._scan([segs[j] for j in part], L)
                for k, j in enumerate(part):
                    out[owner[j]] |= m[k]
        return out

    def _scan(self, segs: List[bytes], L: int) -> np.ndarray:
        B = len(segs)
        buf = np.zeros((B, L), np.uint8)
        lens = np.zeros((B,), np.int64)
        for k, s in enumerate(segs):
            buf[k, :len(s)] = np.frombuffer(s, np.uint8)
            lens[k] = len(s)
        toks = torch.from_numpy(buf).to(self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        S = torch.zeros((B, self.n_words), dtype=torch.int64,
                        device=self.device)
        M = torch.zeros_like(S)
        for t in range(int(lens.max())):
            S_new = ((S << 1) | self.init) & self.table.index_select(
                0, toks[:, t].to(torch.int64))
            live = (t < lens_t)[:, None]
            S = torch.where(live, S_new, S)
            M = torch.where(live, M | (S_new & self.final), M)
        return M.cpu().numpy().astype(np.uint32)
