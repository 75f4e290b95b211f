"""A CPU rehearsal of ``chip_smoke.py`` phase 17: the port's servers
behind the repository's own front door.

``chip_smoke.phase_front_door`` runs here on ``--platform cpu`` servers
(no warmup, at small sizes): leg A (phase 3's first requests and the
large bodies through the C++ sidecar, then 8 chunked streams of small
phase 6 bodies, every verdict the CPU pipeline's), leg B (config #1's
corpus at 512 frames, loadgen through the sidecar and direct, attacks
equal to the CPU library pipeline's, none blocked or failed open), leg C
(the rendered sidecar and two rendered servers at the rendered 50 ms
deadline, checked only by ``front_invariants``) and leg D (the nginx
module's harness and selftest).  On the CPU no kernel launches, so the
phase's launch check is the card's alone, and the servers start without
warmup, so their first loads are not held at 0.
"""

import torch

import chip_smoke
from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
from ingress_plus_tpu_torch.serve.stream import StreamEngine
from ingress_plus_tpu_torch.utils.stream_corpus import drive_streams, stream_cases
from ingress_plus_tpu_torch.weights import load_pack

from torch_ported_tests import one_torch_thread  # noqa: F401

CHUNK = 2048


def test_phase_17_rehearsal_on_cpu():
    requests = chip_smoke.phase3_requests()
    requests = requests[:96] + requests[-3:]     # the largest bodies too
    cpu = DetectionPipeline(load_pack(), device="cpu", fail_open=False)
    want = [chip_smoke.verdict_key(v)
            for v in chip_smoke.run_pipeline(cpu, requests)]
    cases = stream_cases(4 * CHUNK, CHUNK, chip_smoke.SEED)
    keys = [chip_smoke.verdict_key(v)
            for v in drive_streams(StreamEngine(cpu), cases, CHUNK)]
    res, shapes, (shim_cr, shim_shapes) = chip_smoke.phase_front_door(
        requests, want, cases, keys, CHUNK, "cpu", torch.device("cpu"),
        server_args=("--platform", "cpu", "--no-warmup",
                     "--hard-deadline-ms", "20000"),
        corpus_n=512, c_requests=256)
    a = res["A"]
    assert a["identical_verdicts"] == len(requests)
    assert (a["streams"], a["response_scans"]) == (chip_smoke.FRONT_STREAMS, 1)
    assert a["sidecar"]["requests_in"] == len(requests) + 9
    b = res["B"]
    assert [r["via"] for r in b["runs"]] == list(chip_smoke.FRONT_RUNS)
    assert all(r["attacks"] == b["reference_attacks"] > 0
               and r["requests"] == 512 for r in b["runs"])
    c = res["C"]
    assert c["deadline_ms"] == 50 and c["requests"] == 256
    assert [(r["connections"], r["inflight"]) for r in c["loads"]] == list(
        chip_smoke.FRONT_LOADS)
    d = res["D"]
    assert d["harness_ok"] == d["harness_checks"] >= 31
    assert len(d["ws_scenarios"]) >= 9 and len(d["selftest"]) == 6
    assert shim_cr.n_rules == 3
    # the CPU servers launch no kernel: no shape to re-time
    assert all(not rows for rows in shapes.values())
    assert all(not rows for rows in shim_shapes.values())
