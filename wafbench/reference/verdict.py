"""The plain reference verdict: a request in, the verdict the serving
entry owes it out.

It follows the semantics of the port's ``DetectionPipeline`` in block
mode, written plainly:

1. host prep: the request's streams, each stream's normalization
   variants, identical rows merged (``normalize.rows_for_requests``,
   ``merge_rows``);
2. the prefilter: every row scanned by the pack's shift-AND recurrence
   (:mod:`wafbench.reference.scan`); a rule is a candidate when one of
   its factors matched in any row of the request, or it has no factors,
   and one of the request's rows carries a stream-variant the rule
   reads; then the paranoia mask;
3. confirm: every candidate's exact rule (:mod:`confirm`) on the
   request's confirm streams;
4. scoring and mode: the confirmed rules' scores summed against the
   pack's anomaly threshold; block mode blocks an attack or a deny.

An upload (a streamed body) is judged as the port's stream lane owes
it: the head of the request (its body empty) through steps 1-2, the
body's chunks through the stream normalization (:mod:`stream`), each
body variant's row scanned whole and gated by its own stream-variant,
then steps 3-4 on the request with its (capped) body; a capped body
that is not an attack passes flagged fail-open.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import List, Sequence

import numpy as np

from wafbench.reference.confirm import ConfirmRule
from wafbench.reference.consts import (
    CLASSES,
    MODE_NAME_STRENGTH,
    MODE_STRENGTH,
    STREAM_INDEX,
    VARIANTS,
)
from wafbench.reference.normalize import (
    Request,
    merge_rows,
    rows_for_requests,
)
from wafbench.reference.pack import Pack, load_pack
from wafbench.reference.stream import StreamState
from wafbench.reference.unpack import grpc_content_kind, header_lookup

#: the batch path's longest scan row: the serving entry sends longer
#: bodies through its stream lane, so buffered traffic must not carry one
MAX_ROW = 16384


def verdict_dict(attack: bool, blocked: bool, fail_open: bool, score: int,
                 classes: Sequence[str], rule_ids: Sequence[int]) -> dict:
    """A verdict as the benchmark compares it: every field of the wire's
    verdict frame, classes and rule ids sorted."""
    return {"attack": bool(attack), "blocked": bool(blocked),
            "fail_open": bool(fail_open), "score": int(score),
            "classes": sorted(classes),
            "rule_ids": sorted(int(r) for r in rule_ids)}


class Reference:
    """``device``: where the scan runs (None: this reference only
    confirms and scores, as a worker of :mod:`wafbench.check` does)."""

    def __init__(self, pack_path, mode: str = "block",
                 device: str = "cpu", confirm: bool = True):
        self.pack: Pack = load_pack(Path(pack_path))
        p = self.pack
        self.mode = mode
        self.scanner = None
        if device is not None:
            from wafbench.reference.scan import Scanner

            self.scanner = Scanner(p, device=device)
        self.confirms = [ConfirmRule(c) for c in p.confirm]
        self.paranoia_mask = p.rule_paranoia <= p.paranoia_level
        self.needed_sv = set(
            int(sv) for sv in np.nonzero(p.rule_sv_mask.any(axis=0))[0])
        self.no_factors = p.rule_nfactors == 0
        #: False runs the prefilter's candidates as the verdict, with no
        #: confirm: the control that breaks the configuration's guarantee
        #: of exact verdicts
        self.confirm = confirm

    # --------------------------------------------------------- prefilter

    def _rules_of(self, match: np.ndarray) -> np.ndarray:
        """(R,) bool: rules with a factor whose last bit is set in the
        match words ``match`` (W,)."""
        p = self.pack
        bits = (match[p.factor_word].astype(np.int64) >> p.factor_bit) & 1
        out = np.zeros((p.n_rules,), bool)
        for f in np.nonzero(bits)[0]:
            out[p.factor_rules[f]] = True
        return out

    def candidates(self, requests: Sequence[Request]) -> np.ndarray:
        """(Q, R) bool: the masked prefilter candidates of buffered
        requests, their rows scanned in one batch."""
        return self.candidates_and_rows(requests)[0]

    def candidates_and_rows(self, requests: Sequence[Request]):
        """``candidates`` and, per request, its scan rows' (count,
        bytes): the work any implementation of the scan has to do."""
        p = self.pack
        rows: List[bytes] = []
        owner: List[int] = []
        svs: List[List[int]] = []
        for qi, req in enumerate(requests):
            data, _, sv = merge_rows(rows_for_requests(
                [req], needed_sv=self.needed_sv))
            for d, s in zip(data, sv):
                if len(d) > MAX_ROW:
                    raise ValueError("a buffered row of %d bytes: the "
                                     "serving entry streams it" % len(d))
                rows.append(d)
                owner.append(qi)
                svs.append(s)
        match = self.scanner.match_words(rows)
        out = np.zeros((len(requests), p.n_rules), bool)
        applies = np.zeros_like(out)
        work = np.zeros((len(requests), 2), np.int64)
        for k, qi in enumerate(owner):
            out[qi] |= self._rules_of(match[k])
            applies[qi] |= p.rule_sv_mask[:, svs[k]].any(axis=1)
            work[qi] += (1, len(rows[k]))
        # a rule without factors reaches confirm wherever it applies
        out = (out | self.no_factors[None, :]) & applies
        return out & self.paranoia_mask[None, :], work

    # ------------------------------------------------- confirm and score

    def finalize(self, req, cand: np.ndarray) -> dict:
        p = self.pack
        hit_rules = np.nonzero(cand)[0].tolist()
        if self.confirm:
            streams = req.confirm_streams() if hit_rules else {}
            confirmed = [r for r in hit_rules
                         if self.confirms[r].matches_streams(streams)]
        else:
            confirmed = hit_rules
        score = int(p.rule_score[confirmed].sum()) if confirmed else 0
        classes = {CLASSES[p.rule_class[r]] for r in confirmed}
        attack = bool(confirmed) and score >= p.anomaly_threshold
        deny = any(p.rule_action[r] == 2 for r in confirmed)
        eff = min(MODE_NAME_STRENGTH[self.mode],
                  MODE_STRENGTH.get(getattr(req, "mode", 2), 3))
        greylisted = getattr(req, "greylisted", False)
        mode_blocks = eff >= 3 or (eff == 2 and greylisted)
        blocked = mode_blocks and (attack or deny)
        return verdict_dict(attack, blocked, False, score, classes,
                            [p.rule_ids[r] for r in confirmed])

    def verdicts(self, requests: Sequence[Request]) -> List[dict]:
        """The verdicts of buffered requests."""
        cand = self.candidates(requests)
        return [self.finalize(req, cand[qi])
                for qi, req in enumerate(requests)]

    # ------------------------------------------------------------ uploads

    def upload_verdict(self, meta: Request, chunks: Sequence[bytes]) -> dict:
        """The verdict of a streamed body: ``meta`` is the request with
        an empty body, ``chunks`` the body as it arrives."""
        req, cand, truncated, _work = self.uploads_candidates(
            [(meta, chunks)])[0]
        return self.finish_upload(req, cand, truncated)

    def finish_upload(self, req: Request, cand: np.ndarray,
                      truncated: bool) -> dict:
        v = self.finalize(req, cand)
        if truncated and not v["attack"]:
            v["fail_open"] = True
        return v

    def _body_rows(self, meta: Request, chunks: Sequence[bytes]):
        """The stream normalization of one body: ``(variants, one row per
        variant, the stream state)``."""
        p = self.pack
        nv = len(VARIANTS)
        si = STREAM_INDEX[meta.body_stream]
        base = [(v, si * nv + v, 0) for v in range(nv)
                if si * nv + v in self.needed_sv]
        variants = list(base)
        if "base64" not in meta.parsers_off:
            variants += [(v, sv, 1) for v, sv, _ in base]
        pb_kind = grpc_content_kind(
            header_lookup(meta.headers, "content-type"))
        if "json" not in meta.parsers_off and pb_kind is not None:
            variants += [(v, sv, 2) for v, sv, _ in base]
        st = StreamState(meta, variants, p.n_words, p.version,
                         body_cap=1 << 20, pb_kind=pb_kind)
        parts: List[bytearray] = [bytearray() for _ in variants]
        for chunk in chunks:
            for _st, vi, inc in st.feed(chunk):
                parts[vi] += inc
        for _st, vi, inc in st.flush():
            parts[vi] += inc
        return variants, [bytes(x) for x in parts], st

    def uploads_candidates(self, uploads):
        """For each ``(meta, chunks)`` upload: ``(request with its
        confirm body, candidates, truncated, (rows, row bytes))``.  The
        bodies' rows are scanned in one batch."""
        p = self.pack
        bodies = [self._body_rows(meta, chunks) for meta, chunks in uploads]
        uniq = sorted({r for _v, rows, _st in bodies for r in rows if r})
        where = {r: i for i, r in enumerate(uniq)}
        match = self.scanner.match_words(uniq)
        head, head_work = self.candidates_and_rows([m for m, _ in uploads])
        out = []
        for k, (variants, rows, st) in enumerate(bodies):
            body_hits = np.zeros((p.n_rules,), bool)
            applies_any = np.zeros((p.n_rules,), bool)
            for vi, (_v, sv, _src) in enumerate(variants):
                applies = p.rule_sv_mask[:, sv]
                if rows[vi]:
                    body_hits |= (self._rules_of(match[where[rows[vi]]])
                                  & applies)
                applies_any |= applies
            body_hits |= self.no_factors & applies_any
            cand = (body_hits | head[k]) & self.paranoia_mask
            mine = {r for r in rows if r}
            work = head_work[k] + (len(mine), sum(len(r) for r in mine))
            out.append((replace(uploads[k][0], body=bytes(st.acc)), cand,
                        st.truncated, work))
        return out
