"""Mandatory-factor extraction: regex AST → byte-class sequences.

A *factor* is a fixed-length sequence of byte classes such that every match
of the rule's regex contains (at some offset) a string matching one of the
rule's factor alternatives.  The TPU bitap kernel scans for factors; the CPU
confirm stage re-checks full regex semantics on hits.  This is the
Hyperscan-style literal-factor decomposition chosen in SURVEY.md §7 for the
libproton/CRS hot loop, built to be *sound*: a factor set never misses a
true match (it may over-trigger; the confirm stage removes false positives).

Terminology:
  ClassSeq  — tuple of frozensets (byte classes), one per position.
  Group     — list of ClassSeq alternatives; "every match contains one of
              these".  A rule's prefilter uses its best-scoring group.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ingress_plus_tpu_torch.compiler.regex_ast import (
    Alt,
    Anchor,
    Concat,
    Lit,
    Repeat,
)

ClassSeq = Tuple[frozenset, ...]
Group = List[ClassSeq]

MAX_FACTOR_LEN = 32      # one factor must fit in a 32-bit bitap word
MAX_ALTERNATIVES = 64    # cap on enumeration blowup per group
MIN_GROUP_BITS = 6.0     # below this a group is too weak to prefilter


def seq_bits(seq: ClassSeq) -> float:
    """Information content of a class sequence (selectivity score)."""
    return sum(math.log2(256.0 / max(1, len(c))) for c in seq)


def best_window(seq: ClassSeq, width: int = MAX_FACTOR_LEN) -> ClassSeq:
    """Highest-information contiguous window of at most ``width`` positions."""
    if len(seq) <= width:
        return seq
    scores = [math.log2(256.0 / max(1, len(c))) for c in seq]
    best_i, best_s = 0, sum(scores[:width])
    cur = best_s
    for i in range(1, len(seq) - width + 1):
        cur += scores[i + width - 1] - scores[i - 1]
        if cur > best_s:
            best_i, best_s = i, cur
    return seq[best_i : best_i + width]


def _trim(seq: ClassSeq) -> ClassSeq:
    """Drop uninformative (all-byte) edges, clamp to MAX_FACTOR_LEN."""
    lo, hi = 0, len(seq)
    while lo < hi and len(seq[lo]) == 256:
        lo += 1
    while hi > lo and len(seq[hi - 1]) == 256:
        hi -= 1
    return best_window(seq[lo:hi])


def enumerate_seqs(node, cap: int = MAX_ALTERNATIVES) -> Optional[List[ClassSeq]]:
    """Exactly enumerate the class sequences ``node`` can match, or None if
    unbounded / too many.  Zero-width nodes yield [()]."""
    if isinstance(node, Lit):
        return [(node.chars,)]
    if isinstance(node, Anchor):
        return [()]
    if isinstance(node, Concat):
        acc: List[ClassSeq] = [()]
        for part in node.parts:
            sub = enumerate_seqs(part, cap)
            if sub is None:
                return None
            acc = [a + s for a in acc for s in sub]
            if len(acc) > cap:
                return None
        return acc
    if isinstance(node, Alt):
        out: List[ClassSeq] = []
        for opt in node.options:
            sub = enumerate_seqs(opt, cap)
            if sub is None:
                return None
            out.extend(sub)
            if len(out) > cap:
                return None
        # dedup
        return list(dict.fromkeys(out))
    if isinstance(node, Repeat):
        if node.max is None or node.max > 8:
            return None
        base = enumerate_seqs(node.node, cap)
        if base is None:
            return None
        out = []
        for k in range(node.min, node.max + 1):
            acc: List[ClassSeq] = [()]
            for _ in range(k):
                acc = [a + s for a in acc for s in base]
                if len(acc) > cap:
                    return None
            out.extend(acc)
            if len(out) > cap:
                return None
        return list(dict.fromkeys(out))
    raise TypeError("unknown node %r" % (node,))


def _score_group(group: Group) -> float:
    """A group is as strong as its weakest alternative."""
    if not group:
        return -1.0
    return min(seq_bits(s) for s in group)


def _finish_group(seqs: List[ClassSeq]) -> Optional[Group]:
    """Trim/clamp alternatives; a group with any empty alternative is useless
    (it would match everywhere)."""
    out = []
    for s in dict.fromkeys(seqs):
        t = _trim(s)
        if len(t) == 0:
            return None
        out.append(t)
    if not out or len(out) > MAX_ALTERNATIVES:
        return None
    return out


def mandatory_groups(node) -> List[Group]:
    """All mandatory groups of ``node``: for every returned group, any string
    matching ``node`` contains a substring matching one of the group's
    alternatives."""
    # Whole-node enumeration is the strongest possible group.
    whole = enumerate_seqs(node)
    if whole is not None:
        g = _finish_group(whole)
        return [g] if g else []

    if isinstance(node, Repeat):
        if node.min >= 1:
            return mandatory_groups(node.node)
        return []

    if isinstance(node, Alt):
        combined: Group = []
        for opt in node.options:
            subgroups = mandatory_groups(opt)
            if not subgroups:
                return []  # one branch has no factor → alt has none
            best = max(subgroups, key=_score_group)
            combined.extend(best)
            if len(combined) > MAX_ALTERNATIVES:
                return []
        g = _finish_group(combined)
        return [g] if g else []

    if isinstance(node, Concat):
        groups: List[Group] = []
        run: List[ClassSeq] = [()]  # cross product of enumerable children

        def close_run():
            nonlocal run
            if run and run != [()]:
                g = _finish_group(run)
                if g:
                    groups.append(g)
            run = [()]

        for part in node.parts:
            sub = enumerate_seqs(part)
            if sub is not None and len(sub) * len(run) <= MAX_ALTERNATIVES:
                run = [a + s for a in run for s in sub]
                # keep run length bounded; overly long seqs get trimmed later
                if max((len(s) for s in run), default=0) > 4 * MAX_FACTOR_LEN:
                    close_run()
            else:
                close_run()
                groups.extend(mandatory_groups(part))
        close_run()
        return groups

    return []


def best_factor_group(node) -> Optional[Group]:
    """The highest-scoring mandatory group, or None if nothing usable."""
    groups = [g for g in mandatory_groups(node) if _score_group(g) >= MIN_GROUP_BITS]
    if not groups:
        return None
    return max(groups, key=_score_group)
