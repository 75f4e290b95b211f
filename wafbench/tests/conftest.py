import os
import sys
from pathlib import Path

import pytest

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside a fixture without)")


def _children():
    """(pid, command) of every process whose parent is this one."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = open("/proc/%s/stat" % d).read()
            cmd = open("/proc/%s/cmdline" % d, "rb").read()
        except OSError:
            continue
        if int(stat[stat.rfind(")") + 2:].split()[1]) == me:
            out.append((int(d), cmd.replace(b"\0", b" ").decode()[:200]))
    return out


@pytest.fixture
def leaves_no_process():
    """The test's code stops and waits for every process it starts."""
    yield
    assert _children() == []
