"""The closed-loop pack retuner as a library: profile in, retuned pack
out, with every regeneration zero-FN-pinned (docs/RETUNE.md).

The port's copy of the library half of the JAX repository's
``tools/retune.py``, which the retune daemon (control/retuned.py)
drives.  The serve plane measures per-rule candidate rates, confirm
cost, quick-reject coverage and the scanned-byte distribution
(models/rule_stats.py); the compiler prices its approximate reduction
against those measurements (compiler/profile.py → compiler/reduce.py);
and the result re-enters serving only through the staged-rollout
admission gates a hand-rolled pack faces (control/rollout.py).  Truth
gates, in order:

  1. measured inflation  — candidate superset check on a corpus sample
                           (``measure_inflation``): lost_candidates MUST
                           be 0; the measured inflation is recorded and
                           compared LOUDLY against the configured budget
  2. golden replay       — retuned vs static verdicts over the golden
                           corpus + benign fixtures: zero new false
                           negatives, zero new benign blocks (exact
                           confirm semantics on both sides, on CPU
                           pipelines: the diff is about the PACKS)
  3. staged rollout      — the pack is admitted into a real Batcher via
                           RolloutController.admit and driven through
                           shadow → canary → LIVE while mixed traffic
                           flows (exactly-one-verdict preserved)
  4. A/B throughput      — retuned pack + cross-cycle verdict cache vs
                           the static pack over a production-shaped
                           corpus (mixed + flood repeats)

``device`` (None = the CUDA card) places the profile replay, the staged
rollout's batcher and the A/B pipelines.

Determinism contract: the same profile BYTES + the same rules compile
to the same pack fingerprint.
"""

from __future__ import annotations

import random
import sys
import time
from typing import List, Optional

from ingress_plus_tpu_torch.utils.device import DeviceLike

#: the A/B speedup the retuned pack + verdict cache aims for
AB_TARGET = 1.2


def _load_rules(rules_dir: Optional[str] = None):
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir
    from ingress_plus_tpu_torch.compiler.sigpack import load_bundled_rules

    return load_seclang_dir(rules_dir) if rules_dir else load_bundled_rules()


def _corpus(n: int, seed: int, attack_fraction: float = 0.3) -> List:
    from ingress_plus_tpu_torch.utils.corpus import generate_corpus

    return [lr.request for lr in generate_corpus(
        n=n, attack_fraction=attack_fraction, seed=seed)]


def build_profile(rules=None, corpus_n: int = 256, seed: int = 42,
                  batch: int = 64, device: DeviceLike = None):
    """Bootstrap a MeasuredProfile from a telemetry replay: run the
    bench-shaped corpus through a pipeline on the static-priced
    pack and freeze its RuleStats.  A production node exports the same
    artifact from real traffic via /rules/stats?format=profile."""
    from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline

    if rules is None:
        rules = _load_rules()
    cr = compile_ruleset(rules)
    pipe = DetectionPipeline(cr, mode="detect", device=device)
    corpus = _corpus(corpus_n, seed)
    for i in range(0, len(corpus), batch):
        pipe.detect(corpus[i:i + batch])
    return MeasuredProfile.from_rule_stats(pipe.rule_stats)


def _replay_fns(static_pipe, retuned_pipe, requests) -> dict:
    """Golden-replay diff: verdicts of the retuned pack vs the static
    pack over ``requests`` (exact CPU confirm semantics on both sides —
    detect_cpu_only, so the diff is about the PACKS, not the device)."""
    vs = static_pipe.detect_cpu_only(requests)
    vr = retuned_pipe.detect_cpu_only(requests)
    new_fns, new_fn_ids, new_blocks = 0, [], 0
    for a, b in zip(vs, vr):
        if a.attack and not b.attack:
            new_fns += 1
            new_fn_ids.append(a.request_id)
        if b.blocked and not a.blocked:
            new_blocks += 1
    return {"requests": len(requests), "new_fns": new_fns,
            "new_fn_ids": new_fn_ids[:16], "new_blocks": new_blocks}


def _staged_rollout(static_cr, retuned_cr, timeout_s: float = 120.0,
                    device: DeviceLike = None) -> dict:
    """Drive the retuned pack through the REAL staged-rollout machinery
    (admission → shadow → canary → LIVE) on a live batcher on ``device``
    while mixed traffic flows: every regeneration re-enters serving
    through the guarded rollout."""
    from ingress_plus_tpu_torch.control.rollout import (
        LIVE,
        REJECTED,
        ROLLED_BACK,
        RolloutConfig,
        RolloutController,
        RolloutRejected,
    )
    from ingress_plus_tpu_torch.utils.faults import _collect, _mk_batcher

    # production-shaped traffic: corpus requests carry realistic headers.
    # The bare faults fixtures have NO headers, so the CRS header-absence
    # rules (920280/920320) fire on the shadow lane's exact CPU replay
    # but not on the device path — a pre-existing fixture artifact that
    # would book every candidate (even a bit-identical one) as a
    # verdict_diff and roll it back.
    traffic = _corpus(96, 20260805, attack_fraction=0.25)

    b = _mk_batcher(cr=static_cr, device=device)
    ro = RolloutController(b, RolloutConfig(
        steps=(0.25, 1.0), step_min_requests=8, shadow_min_requests=4,
        shadow_sample=1.0, corpus_n=64, diff_min_compared=4))
    b.rollout = ro
    out: dict = {"admitted": False, "state": None, "violations": []}
    try:
        try:
            report = ro.admit(ruleset=retuned_cr)
        except RolloutRejected as e:
            out["state"] = REJECTED
            out["reject"] = e.report
            return out
        out["admitted"] = True
        out["replay"] = report.get("replay")
        deadline = time.monotonic() + timeout_s
        wave = 0
        while ro.state not in (LIVE, ROLLED_BACK, REJECTED) \
                and time.monotonic() < deadline:
            lo = (wave * 24) % len(traffic)
            futs = [b.submit(r) for r in traffic[lo:lo + 24]]
            _vs, viol = _collect(futs, timeout_s=30)
            out["violations"] += viol
            wave += 1
        out["state"] = ro.state
        out["rollback_reason"] = ro.rollback_reason
        out["serving"] = b.pipeline.ruleset.version
    finally:
        b.close()
    return out


def _ab_throughput(static_cr, retuned_cr, corpus_n: int = 512,
                   seed: int = 42, flood_dup: int = 4, iters: int = 3,
                   cache_entries: int = 65536,
                   device: DeviceLike = None) -> dict:
    """A/B the closed loop end to end on a production-shaped corpus
    (mixed traffic + a flood shape: the first
    n//flood_dup requests repeated flood_dup times, shuffled): static
    pack with the per-cycle memo only, vs retuned pack + cross-cycle
    verdict cache.  Best-of-``iters`` pipeline.detect wall time."""
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline

    mixed = _corpus(corpus_n, seed, attack_fraction=0.2)
    flood = mixed[:max(1, corpus_n // flood_dup)] * flood_dup
    random.Random(7).shuffle(flood)
    corpus = mixed + flood

    def _run(pipe) -> float:
        best = float("inf")
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            for i in range(0, len(corpus), 64):
                pipe.detect(corpus[i:i + 64])
            best = min(best, time.perf_counter() - t0)
        return best

    arms = {}
    for tag, cr, cache in (("static", static_cr, 0),
                           ("retuned+cache", retuned_cr, cache_entries)):
        pipe = DetectionPipeline(cr, mode="detect", device=device,
                                 confirm_cache_entries=cache)
        # warm every serve shape out of the measurement
        for i in range(0, len(corpus), 64):
            pipe.detect(corpus[i:i + 64])
        sec = _run(pipe)
        arms[tag] = {
            "seconds": round(sec, 4),
            "req_per_s": round(len(corpus) / sec, 1),
            "cache": (pipe.confirm_cache.snapshot()
                      if pipe.confirm_cache is not None else None),
        }
    speedup = (arms["static"]["seconds"]
               / arms["retuned+cache"]["seconds"])
    return {"requests": len(corpus), "flood_dup": flood_dup,
            "iters": iters, "arms": arms,
            "speedup": round(speedup, 3), "target": AB_TARGET,
            "meets_target": speedup >= AB_TARGET}


def retune(rules=None, profile=None, corpus_n: int = 256, seed: int = 42,
           staged: bool = True, ab: bool = True, ab_iters: int = 3,
           inflation_rows: int = 256, device: DeviceLike = None) -> dict:
    """The closed loop as a library call (the retune daemon drives
    this).  Returns the full report dict; ``ok`` is the
    conjunction of every hard gate that RAN (A/B is measurement, not a
    library-level gate — a caller applies its own threshold)."""
    from ingress_plus_tpu_torch.compiler.profile import MeasuredProfile
    from ingress_plus_tpu_torch.compiler.reduce import (
        ReductionConfig,
        measure_inflation,
    )
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.normalize import merge_rows, \
        rows_for_requests

    t0 = time.time()
    if rules is None:
        rules = _load_rules()
    if profile is None:
        profile = build_profile(rules, corpus_n=corpus_n, seed=seed,
                                device=device)
    elif not isinstance(profile, MeasuredProfile):
        profile = MeasuredProfile.load(profile)

    static_cr = compile_ruleset(rules)
    cfg = ReductionConfig(profile=profile)
    retuned_cr = compile_ruleset(rules, reduction=cfg)
    exact_cr = compile_ruleset(rules, reduction=ReductionConfig.off())

    report: dict = {
        "profile": {"hash": profile.content_hash(),
                    "source": profile.source,
                    "requests": profile.requests,
                    "rules": len(profile.rules),
                    "byte_axis": len(profile.byte_freq) == 256},
        "static_fingerprint": static_cr.version,
        "retuned_fingerprint": retuned_cr.version,
        "reduction": retuned_cr.reduction,
    }

    # gate 1: measured inflation — superset soundness + budget honesty
    sample = _corpus(inflation_rows, seed + 1)
    rows = merge_rows(rows_for_requests(sample))[0]
    infl_static = measure_inflation(exact_cr.tables, static_cr.tables, rows)
    infl = measure_inflation(exact_cr.tables, retuned_cr.tables, rows)
    report["inflation"] = {"static": infl_static, "retuned": infl,
                           "budget": cfg.budget}
    lost_ok = infl["lost_candidates"] == 0
    if not lost_ok:
        print("RETUNE FAIL: reduced pack LOST %d candidates — unsound "
              "reduction, this is a compiler bug"
              % infl["lost_candidates"], file=sys.stderr)
    if infl["inflation"] > cfg.budget:
        print("RETUNE WARNING: measured inflation %.3f exceeds the "
              "configured budget %.2f (model underprices this corpus; "
              "static-model pack measures %.3f)"
              % (infl["inflation"], cfg.budget, infl_static["inflation"]),
              file=sys.stderr)

    # gate 2: golden replay — zero new FNs / new blocks vs the static pack
    replay_corpus = _corpus(192, 20260804, attack_fraction=0.5)
    sp = DetectionPipeline(static_cr, mode="detect", device="cpu")
    rp = DetectionPipeline(retuned_cr, mode="detect", device="cpu")
    replay = _replay_fns(sp, rp, replay_corpus)
    report["replay"] = replay
    replay_ok = replay["new_fns"] == 0 and replay["new_blocks"] == 0
    if not replay_ok:
        print("RETUNE FAIL: golden replay diverged: %d new FNs, %d new "
              "blocks" % (replay["new_fns"], replay["new_blocks"]),
              file=sys.stderr)

    # gate 3: staged rollout to LIVE through the guarded rollout
    rollout_ok = True
    if staged and lost_ok and replay_ok:
        ro = _staged_rollout(static_cr, retuned_cr, device=device)
        report["rollout"] = ro
        rollout_ok = (ro.get("state") == "live"
                      and not ro.get("violations"))
        if not rollout_ok:
            print("RETUNE FAIL: staged rollout ended %s (violations: %s)"
                  % (ro.get("state"), ro.get("violations")),
                  file=sys.stderr)

    # stage 4: A/B throughput (measurement; a caller gates on its own floor)
    if ab:
        report["ab"] = _ab_throughput(static_cr, retuned_cr,
                                      seed=seed, iters=ab_iters,
                                      device=device)

    report["ok"] = bool(lost_ok and replay_ok and rollout_ok)
    report["seconds"] = round(time.time() - t0, 1)
    report["_retuned_cr"] = retuned_cr    # stripped before serialization
    return report
