"""The JAX package's ``tests/test_brute_e2e.py``, whole, against the port on
the CPU (``tests/torch_ported_tests.py``), its server's fixed HTTP port
19911 a free port of this process."""

from torch_ported_tests import ported

globals().update(ported("test_brute_e2e", exclude={}, ports=(19911,)))
