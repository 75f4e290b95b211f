"""Run a test file of the JAX package against the port.

``ported(name, exclude)`` reads ``tests/<name>.py``, rewrites every
``ingress_plus_tpu`` name to ``ingress_plus_tpu_torch`` and executes the
result as a module of its own.  A ``tests/test_torch_*.py`` file puts the
returned tests and fixtures into its globals, so pytest collects the JAX
package's own cases, unchanged but for the package name, against the
port.  ``exclude`` maps each left-out test to the reason; a name there
that the file no longer defines fails the import, so the list stays true.
``patch`` replaces names in the rewritten module before its tests run
(a twin that also runs the JAX function on the same input, say).
"""

from __future__ import annotations

import re
import types
from pathlib import Path
from typing import Dict, Optional

import pytest
import torch

TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module runs the port's CPU pipeline:
    its plain scan issues many small ops, and under a parallel test run
    the intra-op threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction"))


def ported(name: str, exclude: Dict[str, str],
           patch: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    path = TESTS / (name + ".py")
    src = re.sub(r"\bingress_plus_tpu\b", "ingress_plus_tpu_torch",
                 path.read_text())
    mod = types.ModuleType("ported_" + name)
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    vars(mod).update(patch or {})
    out = {k: v for k, v in vars(mod).items()
           if (k.startswith("test_") and callable(v)) or _is_fixture(v)}
    missing = sorted(set(exclude) - set(out))
    if missing:
        raise LookupError("%s defines no %s" % (path.name, missing))
    for k in exclude:
        del out[k]
    return out
