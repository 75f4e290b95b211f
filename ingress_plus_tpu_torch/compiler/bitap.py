"""Packed bit-parallel shift-and (bitap) tables.

The subset of ``ingress_plus_tpu/compiler/bitap.py`` the runtime needs:
the ``BitapTables`` container a compiled pack loads into, the host-side
factor→rule mapping the stream lane finishes with, and the numpy oracle
``reference_scan``.  The scan
recurrence, evaluated per input byte (ops/scan.py):

    S' = ((S << 1) | INIT) & B[byte]          # uint32 words, lane-parallel
    M |= S' & FINAL                           # sticky match accumulator

Every factor occupies a contiguous bit range inside a single 32-bit word,
so the left shift never carries across words: the scan is element-wise
over (batch, words).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WORD_BITS = 32


@dataclass
class BitapTables:
    """Packed scan tables + factor metadata.

    Arrays (all numpy, ready for device upload):
      byte_table   (256, n_words) uint32 — B[byte]: positional class masks
      init_mask    (n_words,)     uint32 — factor start bits
      final_mask   (n_words,)     uint32 — factor end bits
      factor_word  (n_factors,)   int32  — word index of each factor's final bit
      factor_bit   (n_factors,)   int32  — bit index of each factor's final bit
      factor_rule_indptr / factor_rule_ids — CSR map factor → rule indices
                   (many rules can share one deduped factor)
      rule_nfactors (n_rules,)    int32  — 0 ⇒ rule has no prefilter (always
                   confirm); >0 ⇒ rule fires iff ≥1 of its factors fires
    """

    byte_table: np.ndarray
    init_mask: np.ndarray
    final_mask: np.ndarray
    factor_word: np.ndarray
    factor_bit: np.ndarray
    factor_rule_indptr: np.ndarray
    factor_rule_ids: np.ndarray
    rule_nfactors: np.ndarray
    factor_len: np.ndarray  # (n_factors,) int32 — for streaming halo width
    #: word-tier boundary (docs/SCAN_KERNEL.md "per-bucket slicing"):
    #: words [0, n_head_words) hold every factor that can fire on a
    #: short-stream row (uri/args/headers); words beyond it hold factors
    #: owned exclusively by body/response-only rules, so a dispatch
    #: whose rows carry no body/response stream-variant may scan the
    #: word prefix only.  Defaults to the full width (no tiering).
    n_head_words: int = -1
    #: factors that share a longer host factor's bit chain (exact
    #: shared-prefix merging) — provenance only, no runtime meaning
    n_prefix_shared: int = 0

    def __post_init__(self):
        if self.n_head_words < 0:
            self.n_head_words = self.byte_table.shape[1]

    @property
    def n_words(self) -> int:
        return self.byte_table.shape[1]

    @property
    def n_factors(self) -> int:
        return self.factor_word.shape[0]

    @property
    def max_factor_len(self) -> int:
        return int(self.factor_len.max()) if self.n_factors else 0


def reference_scan(tables: BitapTables, data: bytes) -> np.ndarray:
    """Pure-numpy oracle for the scan recurrence: the sticky match mask
    M (n_words,) uint32 after scanning ``data`` from the zero state."""
    S = np.zeros((tables.n_words,), dtype=np.uint32)
    M = np.zeros((tables.n_words,), dtype=np.uint32)
    B = tables.byte_table
    init = tables.init_mask
    final = tables.final_mask
    for byte in data:
        S = ((S << np.uint32(1)) | init) & B[byte]
        M |= S & final
    return M


def matches_to_factors(tables: BitapTables, M: np.ndarray) -> np.ndarray:
    """Match mask → boolean (n_factors,) factor-hit vector."""
    return ((M[tables.factor_word] >> tables.factor_bit.astype(np.uint32))
            & 1).astype(bool)


def factors_to_rules(tables: BitapTables,
                     factor_hits: np.ndarray) -> np.ndarray:
    """Factor hits → boolean (n_rules,) rule prefilter-hit vector."""
    n_rules = tables.rule_nfactors.shape[0]
    out = np.zeros((n_rules,), dtype=bool)
    for f in np.nonzero(factor_hits)[0]:
        lo, hi = tables.factor_rule_indptr[f], tables.factor_rule_indptr[f + 1]
        out[tables.factor_rule_ids[lo:hi]] = True
    return out

