"""The port's card probe (``utils/platform.py``) on a host without a
card: the probe reports the absence, the CPU needs no probe, and asking
for the card raises instead of falling back to the CPU."""

import subprocess

import pytest
import torch

from ingress_plus_tpu_torch.utils import platform


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_probe_reports_no_card(no_card):
    plat, err = platform.probe_backend_once(timeout=120, use_cache=False)
    assert plat is None and "no CUDA card" in err
    assert platform.LAST_PROBE["platform"] is None
    assert platform.LAST_PROBE["device_count"] == 0
    assert platform.LAST_PROBE["error"] == err
    assert platform.LAST_PROBE["probe_s"] >= 0


def test_probe_timeout_is_an_error(monkeypatch):
    def hang(*a, **kw):
        raise subprocess.TimeoutExpired(a[0], kw.get("timeout"))
    monkeypatch.setattr(platform.subprocess, "run", hang)
    assert platform.probe_backend_once(timeout=3, use_cache=False) == (
        None, "card init hung >3s")
    assert platform.LAST_PROBE["error"] == "card init hung >3s"


def test_cpu_needs_no_probe(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("probed for the CPU")
    monkeypatch.setattr(platform, "probe_backend_once", boom)
    assert platform.ensure_live_backend("cpu") == torch.device("cpu")


def test_the_card_raises_without_one(no_card):
    with pytest.raises(RuntimeError, match="no CUDA card answers"):
        platform.ensure_live_backend()
    with pytest.raises(RuntimeError, match="no CUDA card answers"):
        platform.ensure_live_backend("cuda:0")
