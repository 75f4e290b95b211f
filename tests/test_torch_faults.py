"""The port's fault-matrix harness (``utils/faults.py run_fault_matrix``).

Every ported scenario on a CPU pipeline, one case each, must come back
``ok`` with the JAX package's invariants: every admitted request
resolves to exactly one verdict, no fault becomes an unhandled
exception or a block, and each scenario's own recovery.  All 19 of the
JAX package's scenarios are here, the four fleet ones included (their
nodes are port serve loops on the CPU); a name that is no scenario
never passes.  Then a card stand-in (the engine's device reads ``cuda:0``, its tensors
stay on the CPU) runs ``dispatch_raise`` and ``dispatch_hang`` with the
card's invariants: the breaker-open batches fail open, none blocks, and
nothing moves to the host (``detect_cpu_only`` is never called).
"""

import contextlib

import pytest
import torch

from ingress_plus_tpu.utils.faults import SCENARIOS as JAX_SCENARIOS
from ingress_plus_tpu_torch.utils import faults
from ingress_plus_tpu_torch.utils.faults import (
    SCENARIOS,
    run_fault_matrix,
)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    faults.clear()
    yield
    faults.clear()


def test_every_jax_scenario_is_ported_or_named():
    assert list(SCENARIOS) == list(JAX_SCENARIOS)
    assert len(SCENARIOS) == 19 and "fleet_partition_daemon" in SCENARIOS
    assert not hasattr(faults, "NOT_PORTED")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_ok_on_cpu(name):
    rep = run_fault_matrix(only=[name], device="cpu")
    res = rep["scenarios"][name]
    assert res["ok"], res
    assert rep["passed"]
    assert set(rep) == {"passed", "scenarios"}


def test_unported_scenario_never_passes():
    """A name the matrix does not have is reported as a failure, never
    a vacuous pass."""
    rep = run_fault_matrix(only=["fleet_scrape", "no_such_scenario"],
                           device="cpu")
    assert not rep["passed"]
    assert rep["scenarios"]["fleet_scrape"]["ok"]
    assert rep["scenarios"]["no_such_scenario"] == {
        "ok": False, "violations": ["no such scenario"]}


class _FakeStream:
    def __init__(self, device=None):
        self.device = device


@pytest.fixture()
def card_stand_in(monkeypatch):
    """Pipelines built by the harness get an engine whose device reads
    ``cuda:0`` (the plain scan underneath); the CUDA stream calls of the
    lanes are no-ops; ``detect_cpu_only`` records every call."""
    from ingress_plus_tpu_torch.models import pipeline as tpipe
    from ingress_plus_tpu_torch.models.engine import DetectionEngine

    class CardEngine(DetectionEngine):
        def __init__(self, cr, scan_impl=None, device=None):
            super().__init__(cr, device="cpu")
            self.device = torch.device("cuda", 0)

        def rebuilt(self, cr):
            return CardEngine(cr)

        def detect_device_multi(self, buckets, num_requests,
                                head_only=False, device=None,
                                sync_ns=None):
            return super().detect_device_multi(
                buckets, num_requests, head_only, torch.device("cpu"),
                sync_ns)

    reached = []

    def cpu_only(self, requests):
        reached.append(len(list(requests)))
        raise RuntimeError("detect_cpu_only reached on a card pipeline")

    monkeypatch.setattr(tpipe, "DetectionEngine", CardEngine)
    monkeypatch.setattr(tpipe.DetectionPipeline, "detect_cpu_only",
                        cpu_only)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "set_stream", lambda s: None)
    return reached


@pytest.mark.parametrize("name", ["dispatch_raise", "dispatch_hang"])
def test_scenario_card_invariants(name, card_stand_in):
    rep = run_fault_matrix(only=[name], device="cpu")
    res = rep["scenarios"][name]
    assert res["ok"], res
    assert res["breaker_fail_open_batches"] >= 1
    assert res["cpu_fallback_batches"] == 0
    assert res["breaker"]["state"] == "closed"
    assert card_stand_in == []
