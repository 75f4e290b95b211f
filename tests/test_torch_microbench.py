"""The port's microbench (``utils/microbench.py``) on the CPU.

The timing primitives keep their contract (best-of-n seconds; the
K-difference is the per-iteration cost, <= 0 meaning no signal), the
scan-mode A/B reports the JAX function's keys and each kernel scanner's
parity with its plain version, and the confirm bench counts the same
memo hits and quick-reject skips as the JAX package's on the same corpus,
with the same verdicts whichever detectors the confirm stage runs.
Times themselves are host clocks here and are not compared.
"""

import json
import time

import pytest

from ingress_plus_tpu.utils import microbench as jax_microbench
from ingress_plus_tpu_torch.utils import microbench
from ingress_plus_tpu_torch.utils.microbench import (
    MODES,
    bench_confirm,
    bench_scan_modes,
    best_time,
    k_diff_time,
)


def test_best_time_and_k_diff_on_the_cpu():
    calls = []

    def call(k, rep):
        calls.append((k, rep))
        time.sleep(0.004 * k)
        return k

    t = best_time(call, 3, n=2, device="cpu")
    assert calls == [(3, 0), (3, 1), (3, 2)]      # one warm call, then n
    assert 0.012 <= t < 0.5
    calls.clear()
    per = k_diff_time(call, 4, n=2, device="cpu")
    assert [k for k, _ in calls] == [4, 4, 4, 1, 1, 1]
    assert 0.002 < per < 0.2
    # no signal: a call that does not grow with k
    assert k_diff_time(lambda k, rep: None, 5, n=1, device="cpu") < 0.01


def test_best_time_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        best_time(lambda k, rep: None, 2)


def _keys(d):
    return set(d)


@pytest.fixture(scope="module")
def scan_modes():
    port = bench_scan_modes(shapes=((8, 64),), iters=3,
                            interpret_shape=(8, 64), device="cpu")
    jax = jax_microbench.bench_scan_modes(shapes=((8, 64),), iters=3,
                                          interpret_shape=(8, 64))
    return port, jax


def test_scan_modes_report_the_jax_keys_and_parity(scan_modes):
    port, jax = scan_modes
    assert _keys(jax) <= _keys(port)
    assert _keys(jax["shapes"][0]) <= _keys(port["shapes"][0])
    assert _keys(jax["interpret_parity"]) <= _keys(port["interpret_parity"])
    assert (port["platform"], port["fused_lowering"]) == ("cpu",
                                                          "plain-reference")
    assert port["n_words"] == jax["n_words"] == 225
    row = port["shapes"][0]
    assert (row["B"], row["L"]) == (8, 64)
    assert sorted(row["mb_s"]) == sorted(MODES)
    assert row["xla_scan_mb_s"] == row["mb_s"]["take"]
    assert row["fused_mb_s"] == row["mb_s"]["pallas3"]
    assert port["interpret_parity"]["ok"] is True
    assert port["interpret_parity"]["kernels"] == {
        "pallas": True, "pallas3": True, "pallas2": True}


def test_sweep_cli_on_the_cpu(capsys):
    assert microbench.main(["--only", "pair", "--batch", "4", "--len", "32",
                            "--iters", "3", "--platform", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("mode=")]
    assert len(lines) == 2 and all("mode=pair" in ln for ln in lines)


@pytest.fixture(scope="module")
def confirm_runs():
    """The port's confirm bench with the twin and with the Python
    detectors, and the JAX package's, at a small n."""
    mp = pytest.MonkeyPatch()
    try:
        mp.delenv("IPT_NO_NATIVE_CONFIRM", raising=False)
        native = bench_confirm(n_req=64, iters=2, device="cpu")
        mp.setenv("IPT_NO_NATIVE_CONFIRM", "1")
        python = bench_confirm(n_req=64, iters=2, device="cpu")
    finally:
        mp.undo()
    return native, python, jax_microbench.bench_confirm(n_req=64, iters=2)


CONFIGS = ["%s/%s" % (c, t) for c in ("mixed", "flood")
           for t in ("off", "qr", "memo", "qr+memo")]


def test_confirm_bench_counts_equal_jax(confirm_runs):
    native, python, jax = confirm_runs
    assert _keys(jax) <= _keys(native)
    assert (native["device"], native["native"], python["native"]) == (
        "cpu", True, False)
    for run in (native, python):
        for cfg in CONFIGS:
            assert _keys(jax[cfg]) <= _keys(run[cfg])
            assert run[cfg]["memo_hits"] == jax[cfg]["memo_hits"], cfg
            assert run[cfg]["req_per_s"] > 0
            assert 0 < run[cfg]["confirm_ms"] <= run[cfg]["wall_ms"]
        assert run["quick_reject"] == jax["quick_reject"]
    assert native["flood/memo"]["memo_hits"] > 0
    assert native["verdicts_sha256"] == python["verdicts_sha256"]
    json.dumps(native)
