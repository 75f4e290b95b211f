"""Read a compiled pack file (``<path>.npz`` + ``<path>.json``, the
format the port's ``CompiledRuleset.save`` writes) into plain arrays.

The reference reads the same committed file the program serves and
derives everything else from it itself."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from wafbench.reference.consts import CLASSES, STREAMS, VARIANTS


@dataclass
class Pack:
    version: str
    byte_table: np.ndarray        # (256, W) uint32: byte -> word masks
    init_mask: np.ndarray         # (W,) uint32: first bit of each factor
    final_mask: np.ndarray        # (W,) uint32: last bit of each factor
    factor_word: np.ndarray       # (F,) word holding the factor's last bit
    factor_bit: np.ndarray        # (F,) that bit
    factor_rules: List[np.ndarray]  # per factor: the rules it prefilters
    factor_len: np.ndarray        # (F,) bytes a factor spans
    rule_nfactors: np.ndarray     # (R,) 0 = confirm-only rule
    rule_sv_mask: np.ndarray      # (R, N_SV) bool: stream-variants a rule reads
    rule_class: np.ndarray        # (R,)
    rule_score: np.ndarray        # (R,)
    rule_action: np.ndarray       # (R,) 0 pass, 1 block, 2 deny
    rule_paranoia: np.ndarray     # (R,)
    rule_ids: np.ndarray          # (R,) int64
    confirm: list                 # per rule: the confirm spec (dict)
    anomaly_threshold: int
    paranoia_level: int

    @property
    def n_words(self) -> int:
        return self.byte_table.shape[1]

    @property
    def n_rules(self) -> int:
        return self.rule_ids.shape[0]


def load_pack(path) -> Pack:
    """Load ``path`` (without suffix).  Refuses a pack whose stored class,
    stream or variant names differ from the reference's, and one with
    runtime ctl exclusions, which the reference does not model."""
    path = Path(path)
    with np.load(path.with_suffix(".npz")) as z:
        a = {k: z[k] for k in z.files}
    meta = json.loads(path.with_suffix(".json").read_text())
    for key, want in (("classes", CLASSES), ("streams", STREAMS),
                      ("variants", VARIANTS)):
        if key in meta and list(meta[key]) != list(want):
            raise ValueError("pack %s: %s %r differ from the reference's"
                             % (path, key, meta[key]))
    if meta.get("ctl_specs"):
        raise ValueError("pack %s has ctl exclusions; the reference "
                         "does not model them" % path)
    indptr, ids = a["factor_rule_indptr"], a["factor_rule_ids"]
    return Pack(
        version=meta["version"],
        byte_table=a["byte_table"].astype(np.uint32),
        init_mask=a["init_mask"].astype(np.uint32),
        final_mask=a["final_mask"].astype(np.uint32),
        factor_word=a["factor_word"].astype(np.int64),
        factor_bit=a["factor_bit"].astype(np.int64),
        factor_rules=[ids[indptr[f]:indptr[f + 1]].astype(np.int64)
                      for f in range(len(indptr) - 1)],
        factor_len=a["factor_len"].astype(np.int64),
        rule_nfactors=a["rule_nfactors"],
        rule_sv_mask=a["rule_sv_mask"].astype(bool),
        rule_class=a["rule_class"],
        rule_score=a["rule_score"].astype(np.int64),
        rule_action=a["rule_action"],
        rule_paranoia=a["rule_paranoia"],
        rule_ids=a["rule_ids"].astype(np.int64),
        confirm=meta["confirm"],
        # the pipeline's precedence: the pack's compiled CRS config, else
        # the classic defaults (threshold 5, paranoia level 2)
        anomaly_threshold=int(meta.get("anomaly_threshold") or 5),
        paranoia_level=int(meta.get("paranoia_hint") or 2),
    )
