"""Non-circular prefilter-loss gate.

The F1 eval (utils/evalf1.py) scores against corpus labels that were
authored from the same templates as the rule pack — high F1 there is
close to guaranteed by construction.  The strongest claim this
framework can make NON-circularly is:

    prefilter ∧ confirm  ≡  confirm-only
    (the device prefilter never loses a confirm-stage match)

This module proves it by measurement: every request is run through the
normal path (the device prefilter — on a card the raw-byte pair kernel,
``pallas3`` — → host confirm on prefiltered rules) AND through
confirm-only (every paranoia-masked rule evaluated exactly on the
host); any rule confirmed by the bypass but absent from the normal
path's confirmed set is a prefilter loss — a silent detection hole.
``reference=`` adds the kernel's own parity on the same fuzzed bytes:
a second pipeline (a CPU one, holding the plain scan) prefilters every
chunk too, and the masked (Q, R) matrices must be equal bit for bit.

The corpus is the labeled 10k-request replay corpus PLUS byte-level
mutation fuzz of every attack request (case flips, url/double-url
encoding, html entities, inserted SQL comments and whitespace, base64
and gzip body wraps, random byte edits).  Mutants don't need to stay
semantically valid attacks: the property under test is path equivalence
on arbitrary bytes, so even "broken" mutants are useful inputs.

CLI (on the card by default; ``--platform cpu`` runs the plain scan):
    python -m ingress_plus_tpu_torch.utils.prefilter_gate --n 10000 --fuzz 2 \
        [--platform cpu] [--out chiprun_out/PREFILTER_GATE.json]
"""

from __future__ import annotations

import argparse
import base64
import gzip
import json
import random
import sys
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote

import numpy as np

from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device


# --------------------------------------------------------------- mutation

def _enc_random(rng: random.Random, s: str, frac: float) -> str:
    out = []
    for ch in s:
        if ch.isalnum() and rng.random() < frac:
            out.append("%%%02x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


def _case_flip(rng: random.Random, s: str) -> str:
    return "".join(c.upper() if rng.random() < 0.5 else c.lower()
                   for c in s)


def mutate_request(rng: random.Random, req: Request) -> Request:
    """One random byte-level mutation of a request (uri/body/headers)."""
    uri, body, headers = req.uri, req.body, dict(req.headers)
    roll = rng.random()
    if roll < 0.18:
        uri = _case_flip(rng, uri)
    elif roll < 0.36:
        uri = _enc_random(rng, uri, 0.3)
    elif roll < 0.46:
        # double-encode: % → %25
        uri = uri.replace("%", "%25") if "%" in uri else _enc_random(
            rng, uri, 0.6)
    elif roll < 0.56:
        uri = uri.replace(" ", "/**/").replace("+", "%09")
    elif roll < 0.64 and body:
        body = base64.b64encode(body)
    elif roll < 0.72 and body:
        body = gzip.compress(body)
        headers["Content-Encoding"] = "gzip"
    elif roll < 0.82:
        # html-entity-encode a few uri chars past the query
        q = uri.find("?")
        if q >= 0:
            tail = "".join("&#%d;" % ord(c) if rng.random() < 0.2 else c
                           for c in uri[q + 1:])
            uri = uri[:q + 1] + tail
    elif roll < 0.92:
        # random byte edits in the body (or uri tail)
        if body:
            b = bytearray(body)
            for _ in range(rng.randrange(1, 4)):
                b[rng.randrange(len(b))] = rng.randrange(32, 127)
            body = bytes(b)
        else:
            uri += "&z=" + "".join(chr(rng.randrange(33, 127))
                                   for _ in range(8))
    else:
        # split tokens with encoded whitespace
        uri = uri.replace("=", "=%0a", 1)
    return Request(method=req.method, uri=uri, headers=headers, body=body,
                   tenant=req.tenant, request_id=req.request_id + "-mut",
                   mode=req.mode, parsers_off=req.parsers_off)


# ------------------------------------------------------------------ gate

def run_gate(n: int = 10_000, fuzz_per_attack: int = 2,
             seed: int = 20260729, batch: int = 256,
             pipeline=None, progress: bool = True,
             device: DeviceLike = None, reference=None) -> dict:
    """The gate's report.  Without ``pipeline`` it builds the bundled
    pack's monitoring pipeline on ``device`` (None = the card; no card
    raises).  ``reference``, a second pipeline of the same pack, must
    give the same masked prefilter matrix on every chunk: its count of
    unequal chunks is the report's ``reference_unequal_chunks``."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    t0 = time.time()
    if pipeline is None:
        device = resolve_device(device)  # no card raises before the compile
        pipeline = DetectionPipeline(
            compile_ruleset(load_bundled_rules()), mode="monitoring",
            device=device)
    p = pipeline
    R = p.ruleset.n_rules

    corpus = generate_corpus(n=n, attack_fraction=0.3, seed=seed)
    rng = random.Random(seed ^ 0x5eed)
    requests: List[Request] = [lr.request for lr in corpus]
    n_base = len(requests)
    for lr in corpus:
        if lr.is_attack:
            for _ in range(fuzz_per_attack):
                requests.append(mutate_request(rng, lr.request))
    n_total = len(requests)

    mismatches: List[dict] = []
    checked = 0
    confirm_only_hits = 0
    normal_hits = 0
    unequal_chunks = 0
    for lo in range(0, n_total, batch):
        chunk = requests[lo:lo + batch]
        pre = p.prefilter(chunk)                    # (Q, R) masked bool
        if reference is not None and not np.array_equal(
                pre, reference.prefilter(chunk)):
            unequal_chunks += 1
        all_rules = p.mask_hits(chunk, np.ones((len(chunk), R), bool))
        for qi, req in enumerate(chunk):
            streams = req.confirm_streams()
            cache: Dict = {}
            confirmed_normal = {
                int(r) for r in np.nonzero(pre[qi])[0]
                if p.confirms[r].matches_streams(streams, cache)}
            confirmed_all = {
                int(r) for r in np.nonzero(all_rules[qi])[0]
                if p.confirms[r].matches_streams(streams, cache)}
            lost = confirmed_all - confirmed_normal
            confirm_only_hits += len(confirmed_all)
            normal_hits += len(confirmed_normal)
            if lost:
                mismatches.append({
                    "request_id": req.request_id,
                    "uri": req.uri[:200],
                    "lost_rule_ids": sorted(
                        int(p.ruleset.rule_ids[r]) for r in lost),
                })
            checked += 1
        if progress and (lo // batch) % 8 == 0:
            print("gate: %d/%d checked, %d mismatches, %.0fs" %
                  (checked, n_total, len(mismatches), time.time() - t0),
                  file=sys.stderr, flush=True)

    report = {
        "gate": "prefilter-loss (prefilter∧confirm ≡ confirm-only)",
        "requests_base": n_base,
        "requests_fuzzed": n_total - n_base,
        "requests_total": n_total,
        "rules": R,
        "confirm_only_rule_hits": confirm_only_hits,
        "normal_rule_hits": normal_hits,
        "mismatches": len(mismatches),
        "mismatch_samples": mismatches[:20],
        "seed": seed,
        "elapsed_s": round(time.time() - t0, 1),
        "ruleset_version": p.ruleset.version,
        "platform": p.engine.device.type,
        "scan_impl": p.engine.scan_impl,
    }
    if reference is not None:
        report["reference_chunks"] = -(-n_total // batch)
        report["reference_unequal_chunks"] = unequal_chunks
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.utils.prefilter_gate")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--fuzz", type=int, default=2,
                    help="mutants per attack request")
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--out", default=None, help="write JSON here too")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the device (default: the card; no fallback)")
    args = ap.parse_args(argv)
    from ingress_plus_tpu_torch.utils.platform import ensure_live_backend

    dev = ensure_live_backend(args.platform)
    report = run_gate(n=args.n, fuzz_per_attack=args.fuzz, seed=args.seed,
                      device=dev)
    line = json.dumps(report, indent=1)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    sys.exit(0 if report["mismatches"] == 0 else 1)


if __name__ == "__main__":
    main()
