"""The control of ``correct``: the reference's prefilter candidates
served as the verdict, with no confirm, in the program's place.

The configurations state no precision; they guarantee an exact verdict
for every request, with none degraded.  The control breaks that
guarantee the way the program's own brownout rung does (prefilter-only
verdicts), and the comparison that decides ``correct`` has to catch it:

    python3 -m wafbench.control --workload <cell> --seed N --units K

builds the first K units of the cell's mix for the seed (a run's
count), works out the control's verdicts and the reference's, and
prints the numbers :mod:`wafbench.check` compares, as a JSON line.
``wafbench/tests/test_wafbench_reference.py`` keeps it at a test's size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from wafbench import check, manifest
from wafbench.gen import Traffic, load_mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wafbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = manifest.load_manifest()
    cell = manifest.cell(man, args.workload)
    conf = manifest.config(man, cell["config"])
    pack = str(manifest.ROOT / conf["pack"])
    traffic = Traffic(load_mix(cell["traffic"]), args.seed)
    ids = list(range(1, args.units + 1))
    t0 = time.perf_counter()
    workers = check.default_workers()
    control, _ = check.reference_verdicts(
        traffic, ids, pack, conf["mode"], args.device, workers,
        confirm=False)
    j = check.judge(traffic, ids, control, pack, conf["mode"], args.device,
                    workers)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "units": args.units, "correct": j.correct,
                      "compared": j.numbers(),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
