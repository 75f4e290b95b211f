"""CLI: ``python -m ingress_plus_tpu_torch.analysis``.

    python -m ingress_plus_tpu_torch.analysis                    # bundled tree
    python -m ingress_plus_tpu_torch.analysis --rules path/ --format sarif
    python -m ingress_plus_tpu_torch.analysis --format json --output /tmp/RULECHECK.json
    python -m ingress_plus_tpu_torch.analysis --conc             # concurrency analyzer
    python -m ingress_plus_tpu_torch.analysis --evade            # evasion-closure analyzer
    python -m ingress_plus_tpu_torch.analysis --evade --fail-on warning

All three analyzers share one convention: ``--fail-on`` severity grammar,
text/JSON/SARIF renderers (findings.py), and the exit-code contract —
0 when no unsuppressed finding reaches ``--fail-on`` severity (default:
error), 1 when one does, 2 on operational error (unreadable tree or
baseline).  ``dbg rulecheck``, ``dbg evadecheck`` and ``dbg concheck``
ride on exactly this contract.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ingress_plus_tpu_torch.analysis import (
    BaselineError,
    SEVERITIES,
    run_concheck,
    run_evadecheck,
    run_rulecheck,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.analysis")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--conc", action="store_true",
                       help="run concheck (the serve-plane concurrency "
                            "analyzer) instead of rulecheck")
    which.add_argument("--evade", action="store_true",
                       help="run evadecheck (the evasion-closure "
                            "analyzer) instead of rulecheck")
    ap.add_argument("--rules", default=None,
                    help="rules tree (directory of *.conf, or an entry "
                         "config); default: the bundled CRS tree "
                         "(ignored by --conc)")
    ap.add_argument("--format", choices=["text", "json", "sarif"],
                    default="text")
    ap.add_argument("--baseline", default="auto",
                    help="suppression baseline JSON; 'auto' (default) "
                         "resolves the analyzer's checked-in baseline "
                         "(<rules>/rulecheck-baseline.json, "
                         "analysis/concheck-baseline.json, "
                         "analysis/evadecheck-baseline.json), "
                         "'none' disables suppression")
    ap.add_argument("--fail-on", choices=list(SEVERITIES),
                    default="error",
                    help="exit nonzero when an unsuppressed finding of "
                         "this severity (or worse) exists")
    ap.add_argument("--output", default=None,
                    help="also write the rendered report to this path")
    args = ap.parse_args(argv)

    from ingress_plus_tpu_torch.compiler.seclang import SecLangError

    baseline = None if args.baseline == "none" else args.baseline
    if args.conc:
        tool, run = "concheck", lambda: run_concheck(
            baseline_path=baseline)
    elif args.evade:
        tool, run = "evadecheck", lambda: run_evadecheck(
            rules_path=args.rules, baseline_path=baseline)
    else:
        tool, run = "rulecheck", lambda: run_rulecheck(
            rules_path=args.rules, baseline_path=baseline)

    try:
        report = run()
    except (OSError, BaselineError, SecLangError, SyntaxError) as e:
        print("%s: %s" % (tool, e), file=sys.stderr)
        return 2

    out = {"text": report.to_text, "json": report.to_json,
           "sarif": report.to_sarif}[args.format]()
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(out)
    print(out, end="")

    gating = report.gating(args.fail_on)
    if gating:
        print("%s: %d unsuppressed finding(s) at or above severity %r"
              % (tool, len(gating), args.fail_on), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
