"""The compiled-pack artifact: ``CompiledRuleset`` and its loader.

The subset of ``ingress_plus_tpu/compiler/ruleset.py`` the runtime needs.
``CompiledRuleset.load`` reads the checkpoint format the JAX package's
compiler writes (``<path>.npz`` + ``<path>.json``), so a pack compiled
there serves here unchanged.  The compiler itself is not part of this
package.

Scan-variant model: each stream (uri/args/headers/body/resp_*) is scanned
in up to six normalization variants:

    0 raw           — bytes as received
    1 urldec        — urlDecodeUni + removeNulls
    2 urldec_html   — urldec + htmlEntityDecode
    3 squash_raw    — raw with all SQUASH_BYTES deleted (whitespace \\ ' " ^)
    4 squash_dec    — urldec_html with all SQUASH_BYTES deleted
    5 squash_urldec — urldec with all SQUASH_BYTES deleted
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ingress_plus_tpu_torch.compiler.bitap import BitapTables
from ingress_plus_tpu_torch.compiler.seclang import CLASSES, STREAMS, Rule

#: scan-row normalization variants (serve/normalize.py variant_chain)
VARIANTS = ("raw", "urldec", "urldec_html", "squash_raw", "squash_dec",
            "squash_urldec")
N_SV = len(STREAMS) * len(VARIANTS)  # stream-variant row space

#: the word-tier split: streams every request row can carry vs the
#: body/response streams only some requests produce.  Factors owned
#: exclusively by tail-stream rules pack after BitapTables.n_head_words
#: so bodyless dispatches scan a word prefix.
HEAD_STREAMS = ("uri", "args", "headers")
N_HEAD_SV = len(HEAD_STREAMS) * len(VARIANTS)

_WS_BYTES = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B])
# Bytes deleted by the squash variants (stream side AND factor side).
# Superset of what cmdLine deletes; whitespace covers compress/remove.
SQUASH_BYTES = _WS_BYTES | frozenset([0x5C, 0x27, 0x22, 0x5E])  # \ ' " ^


@dataclass
class RuleMeta:
    """Per-rule compile result (everything the runtime needs off-device)."""

    rule: Rule
    index: int
    variant: int
    has_prefilter: bool
    confirm: Dict  # JSON-serializable confirm descriptor


@dataclass
class CompiledRuleset:
    """Scan tables + metadata; the deployable/hot-swappable artifact."""

    tables: BitapTables
    rules: List[RuleMeta]
    # (n_rules, N_SV) bool — which stream-variant rows count for each rule
    rule_sv_mask: np.ndarray
    rule_class: np.ndarray      # (n_rules,) int32 → CLASSES
    rule_score: np.ndarray      # (n_rules,) int32 anomaly score
    rule_action: np.ndarray     # (n_rules,) int32 0=pass 1=block 2=deny
    rule_paranoia: np.ndarray   # (n_rules,) int32
    rule_ids: np.ndarray        # (n_rules,) int64 CRS ids
    version: str = ""
    #: CRS anomaly-mode config resolved at compile time (None = the pack
    #: doesn't use anomaly mode; the pipeline keeps its default threshold)
    anomaly_threshold: Optional[int] = None
    paranoia_hint: Optional[int] = None
    #: runtime ctl exclusions, resolved to concrete rule ids at compile
    #: time: carrying rule INDEX → {"remove_ids": [...], "target_excl":
    #: {str(id): [tok, ...]}, "engine": "off"|"detection_only"|None}.
    #: Applied per request by the confirm stage when the carrying rule
    #: matches (models/confirm_plane.py confirm_one).
    ctl_specs: Dict[int, Dict] = field(default_factory=dict)
    #: approximate-reduction provenance (None = exact compile)
    reduction: Optional[Dict] = None

    @property
    def n_rules(self) -> int:
        return len(self.rules)

    @property
    def classes(self) -> Tuple[str, ...]:
        return tuple(CLASSES)

    @classmethod
    def load(cls, path: str | Path) -> "CompiledRuleset":
        """Read a checkpoint artifact: ``<path>.npz`` + ``<path>.json``."""
        path = Path(path)
        with np.load(path.with_suffix(".npz")) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(path.with_suffix(".json").read_text())
        tables = BitapTables(
            byte_table=arrays["byte_table"],
            init_mask=arrays["init_mask"],
            final_mask=arrays["final_mask"],
            factor_word=arrays["factor_word"],
            factor_bit=arrays["factor_bit"],
            factor_rule_indptr=arrays["factor_rule_indptr"],
            factor_rule_ids=arrays["factor_rule_ids"],
            rule_nfactors=arrays["rule_nfactors"],
            factor_len=arrays["factor_len"],
            # checkpoints without a tier boundary keep the full width
            n_head_words=(int(arrays["n_head_words"])
                          if "n_head_words" in arrays else -1),
            n_prefix_shared=(int(arrays["n_prefix_shared"])
                             if "n_prefix_shared" in arrays else 0),
        )
        rules = []
        action_names = {0: "pass", 1: "block", 2: "deny"}
        all_tags = meta.get("tags", [[]] * len(meta["confirm"]))
        for i, confirm in enumerate(meta["confirm"]):
            rule = Rule(
                rule_id=int(arrays["rule_ids"][i]),
                operator=confirm["op"],
                argument=confirm.get("arg", ""),
                targets=list(confirm.get("targets", ["args"])),
                raw_targets=list(confirm.get("raw_targets", [])),
                transforms=confirm.get("transforms", []),
                action=action_names[int(arrays["rule_action"][i])],
                tags=list(all_tags[i]),
            )
            rules.append(RuleMeta(rule=rule, index=i,
                                  variant=confirm.get("variant", 0),
                                  has_prefilter=bool(tables.rule_nfactors[i]),
                                  confirm=confirm))
        return cls(
            tables=tables, rules=rules,
            rule_sv_mask=arrays["rule_sv_mask"],
            rule_class=arrays["rule_class"],
            rule_score=arrays["rule_score"],
            rule_action=arrays["rule_action"],
            rule_paranoia=arrays["rule_paranoia"],
            rule_ids=arrays["rule_ids"], version=meta["version"],
            anomaly_threshold=meta.get("anomaly_threshold"),
            paranoia_hint=meta.get("paranoia_hint"),
            ctl_specs={int(k): v
                       for k, v in meta.get("ctl_specs", {}).items()},
            reduction=meta.get("reduction"),
        )
