"""Budgeted approximate sigpack reduction — scan cost from *structure*,
not rule count.

BENCH_r05's own attribution proved throughput degrades ~linearly with
ruleset size (1405 rules / 343 words → 5013 req/s vs 2009 rules / 535
words → 2250 on the same host): every packed word widens the per-byte
scan recurrence, so the automaton itself — not the ops shell — is where
pack growth is paid.  This module shrinks the factor universe the way
the approximate-NFA literature does for NIDS prefilters (PAPERS.md:
"Approximate Reduction of Finite Automata for High-Speed NIDS",
arXiv:1710.08647): every operation may only make the prefilter fire
MORE often (a strict over-approximation — extra candidates are absorbed
by the exact CPU confirm lane, which decides every verdict), and the
aggregate over-firing is bounded by a configurable *candidate-inflation
budget* priced against a fixed byte-frequency model of web traffic and
measurable against a real corpus (``measure_inflation``).

Reduction pipeline (all deterministic — pack fingerprints must be
reproducible; no RNG, no wall clock):

  1. window truncation   — factors longer than ``max_factor_len`` keep
                           their highest-information window.  A window
                           of a mandatory factor is itself mandatory.
  2. case-fold widening  — widen alpha positions to the case-insensitive
                           closure when ≥2 distinct factors collapse to
                           the same canonical (superset classes ⇒ fires
                           on a superset; widening that dedupes pays for
                           its bits twice over).
  3. near-identical pair merge — same-length factors whose positionwise
                           class union stays tight are replaced by the
                           union factor (fires whenever either would).
  4. byte-class coarsening (``coarsen_byte_classes``, post-pack) — merge
                           near-duplicate byte equivalence classes of
                           the packed byte_table by OR-ing their rows.
                           The recurrence is monotone in table bits
                           (S' = ((S<<1)|I) & B[byte]), so added bits
                           only ever ADD matches; fewer distinct rows =
                           smaller class-pair gather tables on device.

Ops 1-3 rewrite the factor universe before packing; the exact interning
and shared-prefix bit merging live in compiler/bitap.pack_factors.
``budget <= 0`` disables every approximate op (exact mode; the
budget-boundary contract pinned by tests/test_pack_reduction.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler import factors as F
from ingress_plus_tpu_torch.compiler.factors import ClassSeq

if TYPE_CHECKING:   # import cycle: profile.py prices with byte_model
    from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile

__all__ = [
    "ReductionConfig",
    "ReductionReport",
    "reduce_rule_groups",
    "coarsen_byte_classes",
    "byte_model",
    "batch_reference_scan",
    "candidate_matrix",
    "measure_inflation",
]


@dataclass(frozen=True)
class ReductionConfig:
    """Knobs for the approximate reduction.

    ``budget`` is the allowed *relative candidate-mass inflation* under
    the byte-frequency model: 0.25 means the estimated expected number
    of (request, rule) prefilter candidates may grow by at most 25%.
    It is a modeling bound enforced greedily per merge; the measured
    end-to-end inflation on a real corpus (``measure_inflation``, the
    bench PACKSCALE leg) is typically far below it because merges are
    taken cheapest-first.  ``budget <= 0`` = exact mode (no approximate
    op fires; tables are bit-identical to the unreduced compile when
    ``prefix_merge`` is also off)."""

    budget: float = 0.25
    #: window-truncation target: factors longer than this keep their
    #: best (highest-information) window.  12 selective bytes carry
    #: ~70+ bits — overwhelming for a prefilter — at a third of the
    #: device word cost of the 32-byte maximum.
    max_factor_len: int = 12
    fold_merge: bool = True
    pair_merge: bool = True
    #: positionwise union merge acceptance: |union class| may not exceed
    #: this multiple of the larger input class (keeps merged factors
    #: tight so their fire rate stays near the inputs')
    pair_widen_cap: float = 2.0
    class_merge: bool = True
    #: ceiling on byte-class merges per compile (coarsening is the one
    #: op whose cost model is per-pack global; the cap bounds it even
    #: if the budget math would allow more)
    class_merge_cap: int = 64
    #: EXACT shared-prefix bit merging in pack_factors (not budget
    #: accounted — it never changes scan semantics)
    prefix_merge: bool = True
    #: EXACT word tiering: pack factors owned only by body/response
    #: rules into the trailing words (enables per-bucket word slicing)
    word_tiering: bool = True
    #: measured-traffic pricing (docs/RETUNE.md): when set,
    #: the profile's observed byte distribution replaces the static
    #: ``byte_model`` in every merge/coarsen price, per-rule candidate
    #: rates re-weight the owner mass (hot rules' factors become
    #: expensive to widen), and the hottest rules' factors are pinned
    #: to their exact windows.  A pricing input ONLY — soundness never
    #: depends on it (``compare=False``: two configs differing only in
    #: profile still compare equal as knob sets; the pack fingerprint
    #: covers the resulting tables regardless).
    profile: Optional["MeasuredProfile"] = field(default=None,
                                                compare=False)
    #: fraction of observed-active rules pinned hot (exact windows)
    hot_frac: float = 0.1
    #: how many top-expensive-confirm rules get relaxed quick-reject
    #: literal derivation (models/confirm.py qr_relax)
    qr_relax_top: int = 16

    @classmethod
    def off(cls) -> "ReductionConfig":
        """Legacy-exact mode: bit-identical tables to the pre-reduction
        compiler (used by the frozen bench fixture so cross-round
        throughput numbers stay comparable)."""
        return cls(budget=0.0, max_factor_len=F.MAX_FACTOR_LEN,
                   fold_merge=False, pair_merge=False, class_merge=False,
                   prefix_merge=False, word_tiering=False)

    @property
    def approximate(self) -> bool:
        return self.budget > 0.0


@dataclass
class ReductionReport:
    """Provenance of one reduction run — serialized into the compiled
    artifact's json meta and surfaced by rulecheck's JSON report, so an
    operator can always answer "what did the compiler merge, and what
    did it cost" for the pack actually serving."""

    budget: float = 0.0
    spent: float = 0.0            # estimated inflation actually spent
    factors_in: int = 0           # unique factors before reduction
    factors_out: int = 0
    truncated: int = 0
    fold_merged: int = 0          # factors absorbed by fold canonicals
    pair_merged: int = 0          # factors absorbed by union merges
    prefix_shared: int = 0        # factors riding a host's bits (exact)
    class_merges: int = 0         # byte-class coarsening merges
    classes_in: int = 0
    classes_out: int = 0
    #: measured end-to-end candidate inflation on a corpus sample
    #: (filled by bench / tests via measure_inflation; None = unmeasured)
    measured_inflation: Optional[float] = None
    #: content hash of the MeasuredProfile that priced this reduction
    #: (None = static byte model) — the provenance chain retune audits
    profile_hash: Optional[str] = None
    #: factors pinned to exact windows by the profile's hot-rule tier
    hot_factors: int = 0
    #: rules whose quick-reject derivation was relaxed (qr_relax)
    qr_relaxed: int = 0
    notes: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict:
        d = dict(self.__dict__)
        # plain-python scalars only: this dict goes through json.dumps
        # in CompiledRuleset.save and the rulecheck report
        for k, v in d.items():
            if isinstance(v, (np.floating, np.integer)):
                d[k] = v.item()
        d["notes"] = list(self.notes)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ReductionReport":
        out = cls()
        for k, v in (d or {}).items():
            if hasattr(out, k):
                setattr(out, k, v)
        return out


# --------------------------------------------------------------- byte model

_MODEL: Optional[np.ndarray] = None


def byte_model() -> np.ndarray:
    """Fixed (256,) byte-frequency model of normalized web-request text,
    used to price factor fire rates.  Deliberately a constant (not
    corpus-derived): compile output must be deterministic across hosts
    and corpora.  Shape: alphanumerics dominate, URL/form punctuation is
    common, the rest of ASCII is rare, non-ASCII is negligible-but-
    nonzero (decoded bodies do carry it)."""
    global _MODEL
    if _MODEL is not None:
        return _MODEL
    w = np.full(256, 0.02, dtype=np.float64)      # high/control floor
    for b in range(0x20, 0x7F):
        w[b] = 0.4                                # printable baseline
    for b in range(ord("a"), ord("z") + 1):
        w[b] = 4.0
    for b in range(ord("A"), ord("Z") + 1):
        w[b] = 1.0
    for b in range(ord("0"), ord("9") + 1):
        w[b] = 2.0
    for ch in "/=&?.-_%+:;, ":
        w[ord(ch)] = 2.0
    _MODEL = w / w.sum()
    return _MODEL


def _seq_prob(seq: ClassSeq, mu: np.ndarray) -> float:
    """P(a random position starts a match of ``seq``) under the model —
    the per-position fire rate the budget math prices merges with."""
    p = 1.0
    for cls in seq:
        m = 0.0
        for b in cls:
            m += mu[b]
        p *= m
        if p == 0.0:
            return 0.0
    return p


# ------------------------------------------------------ factor-level passes


def _fold_close(cls: frozenset) -> frozenset:
    """Case-insensitive closure of a byte class."""
    out = set(cls)
    for b in cls:
        if 0x41 <= b <= 0x5A:
            out.add(b + 0x20)
        elif 0x61 <= b <= 0x7A:
            out.add(b - 0x20)
    return frozenset(out)


def _fold_seq(seq: ClassSeq) -> ClassSeq:
    return tuple(_fold_close(c) for c in seq)


def _sig(seq: ClassSeq) -> bytes:
    """Cheap locality signature for the neighbor pair-merge scan: the
    folded minimum byte per position.  Near-identical factors (case
    variants, small class widenings of the same literal) sort adjacent."""
    out = bytearray()
    for cls in seq:
        b = min(cls)
        if 0x41 <= b <= 0x5A:
            b += 0x20
        out.append(b)
    return bytes(out)


# Ubiquitous wire tokens: strings present in essentially every normalized
# request row (header names, protocol/UA boilerplate).  The independence
# assumption in _seq_prob cannot see that a merged union's positions
# correlate into one of these, so a union that happens to cover e.g.
# "user-agent" is priced as astronomically rare while actually firing on
# every row — the one failure mode where the greedy merge can silently
# destroy a prefilter group's selectivity.  Merges whose OUTPUT matches a
# wire token (when no input did) are vetoed outright instead of priced.
_WIRE_LITERALS: Tuple[bytes, ...] = (
    b"user-agent", b"accept-encoding", b"accept-language", b"accept",
    b"content-type", b"content-length", b"connection", b"keep-alive",
    b"cookie", b"referer", b"host", b"mozilla/", b"http/1.",
    b"gzip, deflate", b"text/html", b"charset", b"multipart/form-data",
    b"x-www-form-urlencoded", b"applewebkit", b"gecko",
)


def _matches_wire_literal(seq: ClassSeq) -> bool:
    """True if ``seq`` (case-folded) can match inside any ubiquitous wire
    token — i.e. the factor would fire on essentially every request."""
    folded = [_fold_close(c) for c in seq]
    n = len(folded)
    for lit in _WIRE_LITERALS:
        if len(lit) < n:
            continue
        for off in range(len(lit) - n + 1):
            if all(lit[off + j] in folded[j] for j in range(n)):
                return True
    return False


def _apply_mapping(mapping: Dict[ClassSeq, ClassSeq],
                   seq: ClassSeq) -> ClassSeq:
    """Chase merge chains (A→B, B→C ⇒ A→C), path-compressing."""
    seen = []
    while seq in mapping and mapping[seq] != seq:
        seen.append(seq)
        seq = mapping[seq]
    for s in seen:
        mapping[s] = seq
    return seq


def reduce_rule_groups(
    rule_factors: Sequence[List[ClassSeq]],
    cfg: ReductionConfig,
    rule_weights: Optional[np.ndarray] = None,
    hot_rules: Optional[np.ndarray] = None,
) -> Tuple[List[List[ClassSeq]], ReductionReport]:
    """Apply the factor-level approximate passes (truncate / fold-widen /
    pair-merge) to per-rule factor groups under ``cfg.budget``.

    Soundness: every rewrite replaces an alternative with one that
    matches a SUPERSET of strings (wider classes and/or a sub-window),
    so "every rule match contains a group match" is preserved and the
    prefilter can only gain candidates, never lose one.  The budget is
    spent greedily cheapest-first on the estimated candidate-mass
    increase Σ_f p(f)·|owner rules of f|.

    Profile pricing: ``rule_weights`` (R,) floats scale each
    owner rule's mass contribution by its observed candidate rate, and
    ``hot_rules`` (R,) bool pins the hottest rules' factors out of every
    approximate pass — their prefilter precision is what keeps the
    confirm lane cheap, so their windows stay exact while cold rules
    absorb the budget.  Both are pricing/tiering inputs only: the
    superset argument above never depends on them."""
    report = ReductionReport(budget=cfg.budget)
    groups = [list(g) for g in rule_factors]
    # factor universe: seq → owner-rule mass (shared factors price once
    # per owning rule — each owner books its own candidates; with a
    # profile, each owner books at its measured candidate weight)
    owners: Dict[ClassSeq, float] = {}
    for i, g in enumerate(groups):
        w = 1.0 if rule_weights is None else float(rule_weights[i])
        for s in dict.fromkeys(g):
            owners[s] = owners.get(s, 0.0) + w
    report.factors_in = len(owners)
    if not cfg.approximate or not owners:
        report.factors_out = len(owners)
        return groups, report

    hot: set = set()
    if hot_rules is not None:
        for i, g in enumerate(groups):
            if hot_rules[i]:
                hot.update(g)
    report.hot_factors = len(hot)

    mu = None
    if cfg.profile is not None:
        mu = cfg.profile.byte_mu()
    if mu is None:
        mu = byte_model()
    base_mass = sum(_seq_prob(s, mu) * n for s, n in owners.items())
    base_mass = max(base_mass, 1e-300)
    budget_mass = cfg.budget * base_mass
    spent = 0.0
    mapping: Dict[ClassSeq, ClassSeq] = {}

    def owners_of(seq: ClassSeq) -> float:
        return owners.get(seq, 0.0)

    # ---- pass 1: window truncation (cheapest possible inflation: a
    # high-information window of len>=max_factor_len is still absurdly
    # selective, so ΔM ≈ 0 — but it is charged like everything else)
    cands = []
    for seq in owners:
        if seq in hot:
            continue   # hot tier: exact windows, no approximate rewrite
        if len(seq) > cfg.max_factor_len:
            short = F.best_window(seq, cfg.max_factor_len)
            d = (_seq_prob(short, mu) - _seq_prob(seq, mu)) * owners_of(seq)
            cands.append((max(d, 0.0), seq, short))
    for d, seq, short in sorted(cands, key=lambda t: (t[0], _sig(t[1]))):
        if spent + d > budget_mass:
            break
        mapping[seq] = short
        spent += d
        report.truncated += 1

    def _universe() -> Dict[ClassSeq, float]:
        u: Dict[ClassSeq, float] = {}
        for s, n in owners.items():
            t = _apply_mapping(mapping, s)
            u[t] = u.get(t, 0.0) + n
        return u

    # ---- pass 2: case-fold widening where it dedupes
    if cfg.fold_merge:
        uni = _universe()
        by_fold: Dict[ClassSeq, List[ClassSeq]] = {}
        for s in uni:
            if s in hot:
                continue
            by_fold.setdefault(_fold_seq(s), []).append(s)
        cands2 = []
        for canon, members in by_fold.items():
            distinct = [m for m in members if m != canon]
            if len(members) < 2 or not distinct:
                continue
            if _matches_wire_literal(canon) and not any(
                    _matches_wire_literal(m) for m in members):
                continue   # widening would cover request boilerplate
            total = sum(uni[m] for m in members)
            d = _seq_prob(canon, mu) * total - sum(
                _seq_prob(m, mu) * uni[m] for m in members)
            cands2.append((max(d, 0.0), canon, members))
        for d, canon, members in sorted(
                cands2, key=lambda t: (t[0], _sig(t[1]))):
            if spent + d > budget_mass:
                continue
            spent += d
            for m in members:
                if m != canon:
                    mapping[_apply_mapping(mapping, m)] = canon
                    report.fold_merged += 1

    # ---- pass 3: near-identical same-length union merges (signature-
    # sorted neighbor scan keeps this O(n log n) and deterministic)
    if cfg.pair_merge:
        uni = _universe()
        by_len: Dict[int, List[ClassSeq]] = {}
        for s in uni:
            if s in hot:
                continue
            by_len.setdefault(len(s), []).append(s)
        merges = []
        for L, seqs in sorted(by_len.items()):
            seqs.sort(key=_sig)
            for i, a in enumerate(seqs):
                for b in seqs[i + 1:i + 9]:   # neighbor window
                    u = []
                    ok = True
                    for ca, cb in zip(a, b):
                        cu = ca | cb
                        if len(cu) > max(4, cfg.pair_widen_cap
                                         * max(len(ca), len(cb))):
                            ok = False
                            break
                        u.append(cu)
                    if not ok:
                        continue
                    useq = tuple(u)
                    if _matches_wire_literal(useq) and not (
                            _matches_wire_literal(a)
                            or _matches_wire_literal(b)):
                        continue   # union would cover request boilerplate
                    d = (_seq_prob(useq, mu) * (uni[a] + uni[b])
                         - _seq_prob(a, mu) * uni[a]
                         - _seq_prob(b, mu) * uni[b])
                    merges.append((max(d, 0.0), a, b, useq))
        merged_away: set = set()
        for d, a, b, useq in sorted(
                merges, key=lambda t: (t[0], _sig(t[1]), _sig(t[2]))):
            if a in merged_away or b in merged_away:
                continue
            if spent + d > budget_mass:
                continue
            spent += d
            mapping[_apply_mapping(mapping, a)] = useq
            mapping[_apply_mapping(mapping, b)] = useq
            merged_away.add(a)
            merged_away.add(b)
            report.pair_merged += 2 if useq not in (a, b) else 1

    # ---- rewrite the rule groups through the final mapping
    out_groups: List[List[ClassSeq]] = []
    final: Dict[ClassSeq, int] = {}
    for g in groups:
        ng = list(dict.fromkeys(_apply_mapping(mapping, s) for s in g))
        out_groups.append(ng)
        for s in dict.fromkeys(ng):
            final[s] = final.get(s, 0) + 1
    report.factors_out = len(final)
    report.spent = spent / base_mass
    return out_groups, report


# ------------------------------------------------- byte-class coarsening


def coarsen_byte_classes(
    byte_table: np.ndarray,       # (256, W) uint32 — mutated copy returned
    factor_word: np.ndarray,
    factor_bit: np.ndarray,
    factor_len: np.ndarray,
    factor_owners: np.ndarray,    # (F,) int — owner-rule count per factor
    budget_frac: float,
    merge_cap: int = 64,
    mu: Optional[np.ndarray] = None,   # pricing model override (profile)
) -> Tuple[np.ndarray, int, int, int, float]:
    """Merge near-duplicate byte equivalence classes of the packed table
    by OR-ing their rows (monotone in the recurrence ⇒ matches only
    grow).  Returns (new_byte_table, n_merges, classes_in, classes_out,
    spent_frac).

    The estimated inflation of merging classes (U, V) is computed
    per factor from the positionwise class-mass ratios after the merge,
    weighted by the factor's fire rate and owner count — the same
    candidate-mass currency the factor-level passes spend."""
    bt = byte_table.astype(np.uint32).copy()
    if mu is None:
        mu = byte_model()
    uniq, inv = np.unique(bt, axis=0, return_inverse=True)
    inv = np.asarray(inv).ravel()
    k = uniq.shape[0]
    if budget_frac <= 0.0 or k <= 2 or merge_cap <= 0:
        return bt, 0, k, k, 0.0

    W = bt.shape[1]
    bits = ((uniq[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(np.float64)                       # (k, W, 32)
    class_mass = np.array([mu[inv == c].sum() for c in range(k)])
    # per-(w,bit) class mass currently reaching that state bit
    pos_mass = np.einsum("c,cwb->wb", class_mass, bits)  # (W, 32)
    pos_mass = np.maximum(pos_mass, 1e-12)

    # factor position bookkeeping: flat (w*32+bit) ids per factor
    fpos: List[np.ndarray] = []
    for f in range(factor_word.shape[0]):
        w = int(factor_word[f])
        fin = int(factor_bit[f])
        L = int(factor_len[f])
        fpos.append(w * 32 + np.arange(fin - L + 1, fin + 1))
    flat = np.concatenate(fpos) if fpos else np.zeros(0, np.int64)
    lens = np.array([len(p) for p in fpos], dtype=np.int64)
    starts = np.zeros_like(lens)
    if len(lens):
        starts[1:] = np.cumsum(lens)[:-1]
    log_pm = np.log(pos_mass).ravel()
    # factor fire rate p(f) under the model (product of position masses)
    fprob = (np.exp(np.add.reduceat(log_pm[flat], starts))
             if len(flat) else np.zeros(0))
    if len(lens):
        fprob[lens == 0] = 0.0
    base_mass = float((fprob * factor_owners).sum())
    if base_mass <= 0.0:
        return bt, 0, k, k, 0.0
    budget_mass = budget_frac * base_mass

    # candidate pairs: nearest rows by bit distance, via sorted popcount
    # neighborhood (deterministic, O(k^2) worst case but k is ~10^2)
    order = np.lexsort(uniq.T[::-1])
    cands = []
    for oi in range(k):
        for oj in range(oi + 1, min(oi + 13, k)):
            i, j = int(order[oi]), int(order[oj])
            # Δ per (w,bit): bits one side reaches and the other doesn't
            di = bits[i] - bits[j]
            add = (np.maximum(di, 0) * class_mass[j]
                   + np.maximum(-di, 0) * class_mass[i])   # (W, 32)
            if not add.any():
                continue
            ratio = np.log1p(add / pos_mass).ravel()
            if len(flat):
                fd = np.exp(np.add.reduceat(ratio[flat], starts))
                fd[lens == 0] = 1.0
                dmass = float(((fd - 1.0) * fprob * factor_owners).sum())
            else:
                dmass = 0.0
            cands.append((dmass, i, j))
    cands.sort(key=lambda t: (t[0], t[1], t[2]))
    taken: set = set()
    spent = 0.0
    n_merges = 0
    for dmass, i, j in cands:
        if n_merges >= merge_cap or spent + dmass > budget_mass:
            break
        if i in taken or j in taken:
            continue
        merged = uniq[i] | uniq[j]
        bt[inv == i] = merged
        bt[inv == j] = merged
        taken.add(i)
        taken.add(j)
        spent += dmass
        n_merges += 1
    k_out = int(np.unique(bt, axis=0).shape[0])
    return bt, n_merges, k, k_out, spent / base_mass


# --------------------------------------------------- measured verification


def batch_reference_scan(tables, rows: Sequence[bytes]) -> np.ndarray:
    """Vectorized numpy twin of compiler.bitap.reference_scan over a row
    batch: returns (B, W) uint32 sticky match masks.  This is the CPU
    oracle the measured-inflation gate and the equivalence tests scan
    with (pure numpy — usable inside the compiler)."""
    B = len(rows)
    W = tables.n_words
    S = np.zeros((B, W), dtype=np.uint32)
    M = np.zeros((B, W), dtype=np.uint32)
    if B == 0:
        return M
    maxlen = max((len(r) for r in rows), default=0)
    toks = np.zeros((B, maxlen), dtype=np.int64)
    lens = np.zeros(B, dtype=np.int64)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        lens[i] = len(r)
    bt = tables.byte_table
    init = tables.init_mask[None, :]
    for t in range(maxlen):
        live = lens > t
        if not live.any():
            break
        S_new = ((S << np.uint32(1)) | init) & bt[toks[:, t]]
        S = np.where(live[:, None], S_new, S)
        M = np.where(live[:, None], M | (S_new & tables.final_mask[None, :]),
                     M)
    return M


def candidate_matrix(tables, rows: Sequence[bytes]) -> np.ndarray:
    """(B, R) bool prefilter candidate matrix for raw byte rows (no
    stream-variant masking — this is the raw factor→rule gate the
    budget bounds)."""
    from ingress_plus_tpu_torch.compiler.bitap import (
        factors_to_rules,
        matches_to_factors,
    )

    M = batch_reference_scan(tables, rows)
    R = tables.rule_nfactors.shape[0]
    out = np.zeros((len(rows), R), dtype=bool)
    for i in range(len(rows)):
        out[i] = factors_to_rules(tables, matches_to_factors(tables, M[i]))
    return out


def measure_inflation(exact_tables, reduced_tables,
                      rows: Sequence[bytes]) -> Dict:
    """Measured candidate inflation of ``reduced_tables`` over
    ``exact_tables`` on a row sample, plus the superset check (a single
    lost candidate = an unsound reduction = a bug).  Returns a dict
    ready for reports/PACKSCALE.json / the rulecheck provenance block."""
    ce = candidate_matrix(exact_tables, rows)
    cr = candidate_matrix(reduced_tables, rows)
    lost = int(np.logical_and(ce, ~cr).sum())
    n_exact = int(ce.sum())
    n_red = int(cr.sum())
    return {
        "rows": len(rows),
        "candidates_exact": n_exact,
        "candidates_reduced": n_red,
        "lost_candidates": lost,          # MUST be 0 (soundness)
        "inflation": (round((n_red - n_exact) / n_exact, 4)
                      if n_exact else 0.0),
    }
