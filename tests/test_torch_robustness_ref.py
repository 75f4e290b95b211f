"""The JAX package's ``tests/test_robustness.py``, whole, against the port on
the CPU (``tests/torch_ported_tests.py``)."""

from torch_ported_tests import ported

globals().update(ported("test_robustness", exclude={}))
