"""The JAX package's ``tests/test_observability_e2e.py`` against the port
on the CPU (``tests/torch_ported_tests.py``), its server's fixed HTTP
port 19931 a free port of this process, but for one case: (c) it holds
stage timings taken on the host clock against each other, and fails on
the JAX side too under parallel load (ROADMAP's watch list)."""

from torch_ported_tests import ported

globals().update(ported("test_observability_e2e", exclude={
    "test_surfaces_agree_on_stage_timings": "(c) host-clock stage timings",
}, ports=(19931,)))
