"""The port's F1 gate (``utils/evalf1.py``) on the CPU: the analogs of
``tests/test_evalf1.py``'s two tests, and the port's ``F1Report`` counts
equal to the JAX package's at a small n on the same corpus.  Tolerance:
none on the counts (req/s is a host clock and is not compared).
"""

import json

from ingress_plus_tpu.utils.evalf1 import evaluate as jax_evaluate
from ingress_plus_tpu_torch.utils import evalf1
from ingress_plus_tpu_torch.utils.evalf1 import evaluate

COUNTS = ("n", "tp", "fp", "fn", "tn", "blocked", "precision", "recall",
          "f1", "per_class_recall", "false_positives", "false_negatives",
          "mode", "n_rules", "per_family")


def test_f1_on_bundled_ruleset():
    rep = evaluate(n=384, batch=128, seed=7, device="cpu")
    assert rep.n == 384
    assert rep.platform == "cpu"
    assert rep.recall >= 0.99, rep.false_negatives
    assert rep.precision >= 0.99, rep.false_positives
    assert rep.f1 >= 0.99
    assert all(r >= 0.95 for r in rep.per_class_recall.values()), \
        rep.per_class_recall


def test_f1_monitoring_never_blocks():
    rep = evaluate(n=128, batch=128, seed=11, mode="monitoring", warm=False,
                   device="cpu")
    assert rep.req_s > 0
    assert rep.blocked == 0
    assert rep.mode == "monitoring"


def test_counts_equal_jax():
    got = evaluate(n=256, batch=64, seed=20260729, device="cpu").to_dict()
    want = jax_evaluate(n=256, batch=64, seed=20260729).to_dict()
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["tp"] + got["fn"] > 40 and got["tn"] > 100


def test_cli_on_the_cpu(capsys):
    assert evalf1.main(["--n", "64", "--batch", "64", "--platform",
                        "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["n"], rep["platform"], rep["blocked"]) == (64, "cpu", 0)
