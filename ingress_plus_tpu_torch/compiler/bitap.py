"""Packed bit-parallel shift-and (bitap) tables.

The port of ``ingress_plus_tpu/compiler/bitap.py``: the ``BitapTables``
container a compiled pack loads into, the compiler's packer
(``pack_factors``), the host-side factor→rule mapping the stream lane
finishes with, and the numpy oracle ``reference_scan``.  The scan
recurrence, evaluated per input byte (ops/scan.py):

    S' = ((S << 1) | INIT) & B[byte]          # uint32 words, lane-parallel
    M |= S' & FINAL                           # sticky match accumulator

Every factor occupies a contiguous bit range inside a single 32-bit word,
so the left shift never carries across words: the scan is element-wise
over (batch, words).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler.factors import ClassSeq

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


def pack_factors(
    rule_factors: Sequence[List[ClassSeq]],
    n_rules: int | None = None,
    prefix_merge: bool = False,
    rule_tier: Optional[np.ndarray] = None,
) -> BitapTables:
    """Pack per-rule factor groups into shared tables.

    rule_factors[r] is rule r's alternative list (possibly empty = no
    prefilter).  Identical ClassSeqs across rules are deduplicated
    (factor interning — rules reference deduped factors through the
    factor→rule CSR map).

    ``prefix_merge=True`` additionally merges shared prefixes EXACTLY:
    a factor whose class sequence equals the first |A| positions of an
    already-placed longer factor occupies ZERO new bits — chain bit
    |A|-1 of the host is active iff the last |A| bytes matched exactly
    A, so marking that interior bit in ``final_mask`` and pointing the
    short factor's (word, bit) at it reproduces its semantics
    bit-for-bit.  (General trie merging at branch points is NOT
    possible in plain shift-and: the left shift cannot fan one parent
    bit out to two child chains without a per-step scatter.)

    ``rule_tier`` (n_rules,) int8/int32, 0 = head, 1 = tail: factors
    owned by at least one tier-0 rule pack into the leading words;
    factors owned ONLY by tier-1 rules pack after ``n_head_words``, so
    a dispatch that provably cannot fire them (no body/response rows)
    may scan the word prefix alone.  Prefix merging never crosses the
    boundary in the unsound direction: tail hosts are placed after
    every head factor, so a head factor can never land in tail words.
    """
    if n_rules is None:
        n_rules = len(rule_factors)

    # Dedup factors; remember which rules own each.
    uniq: Dict[ClassSeq, List[int]] = {}
    for r, group in enumerate(rule_factors):
        for seq in group:
            if not (1 <= len(seq) <= WORD_BITS):
                raise ValueError("factor length %d out of range" % len(seq))
            uniq.setdefault(seq, []).append(r)

    def _tier(seq: ClassSeq) -> int:
        if rule_tier is None:
            return 0
        return int(min(int(rule_tier[r]) for r in uniq[seq]))

    # first-fit decreasing inside each tier; stable, so insertion
    # (= rule) order breaks length ties deterministically
    seqs = sorted(uniq.keys(), key=lambda s: (_tier(s), -len(s)))

    # Bin-pack into words: each factor gets len(seq) contiguous bits.
    # Tail-tier factors open a fresh word region (n_head_words is the
    # boundary); prefix-merged factors ride a host's bits instead.
    word_used: List[int] = []
    placements: List[Tuple[int, int]] = []  # (word, offset) per seq
    merged: List[bool] = []
    prefix_host: Dict[ClassSeq, Tuple[int, int]] = {}
    n_head_words: Optional[int] = None
    head_words_frozen = False
    n_shared = 0
    for seq in seqs:
        L = len(seq)
        if rule_tier is not None and not head_words_frozen \
                and _tier(seq) == 1:
            n_head_words = len(word_used)
            head_words_frozen = True
        if prefix_merge and seq in prefix_host:
            placements.append(prefix_host[seq])
            merged.append(True)
            n_shared += 1
            continue
        lo = (n_head_words or 0) if head_words_frozen else 0
        for w in range(lo, len(word_used)):
            if word_used[w] + L <= WORD_BITS:
                placements.append((w, word_used[w]))
                word_used[w] += L
                break
        else:
            placements.append((len(word_used), 0))
            word_used.append(L)
        merged.append(False)
        if prefix_merge:
            w, off = placements[-1]
            for pl in range(1, L):
                prefix_host.setdefault(seq[:pl], (w, off))
    n_words = max(1, len(word_used))
    if n_head_words is None:
        n_head_words = n_words

    byte_table = np.zeros((256, n_words), dtype=np.uint32)
    init_mask = np.zeros((n_words,), dtype=np.uint32)
    final_mask = np.zeros((n_words,), dtype=np.uint32)
    factor_word = np.zeros((len(seqs),), dtype=np.int32)
    factor_bit = np.zeros((len(seqs),), dtype=np.int32)
    factor_len = np.zeros((len(seqs),), dtype=np.int32)

    indptr = [0]
    rule_ids: List[int] = []
    rule_nfactors = np.zeros((n_rules,), dtype=np.int32)

    for f, (seq, (w, off), shared) in enumerate(
            zip(seqs, placements, merged)):
        L = len(seq)
        init_mask[w] |= np.uint32(1 << off)
        final_mask[w] |= np.uint32(1 << (off + L - 1))
        factor_word[f] = w
        factor_bit[f] = off + L - 1
        factor_len[f] = L
        if not shared:   # a shared prefix's bits are the host's bits
            for j, cls in enumerate(seq):
                bit = np.uint32(1 << (off + j))
                for b in cls:
                    byte_table[b, w] |= bit
        owners = sorted(set(uniq[seq]))
        rule_ids.extend(owners)
        indptr.append(len(rule_ids))
        for r in owners:
            rule_nfactors[r] += 1

    return BitapTables(
        byte_table=byte_table,
        init_mask=init_mask,
        final_mask=final_mask,
        factor_word=factor_word,
        factor_bit=factor_bit,
        factor_rule_indptr=np.asarray(indptr, dtype=np.int32),
        factor_rule_ids=np.asarray(rule_ids, dtype=np.int32),
        rule_nfactors=rule_nfactors,
        factor_len=factor_len,
        n_head_words=n_head_words,
        n_prefix_shared=n_shared,
    )


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

