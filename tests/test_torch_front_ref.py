"""The JAX package's ``tests/test_front.py``, whole, against the port on
the CPU (``tests/torch_ported_tests.py``), the backend port 9941 it
spells a free port of this process."""

from torch_ported_tests import ported

globals().update(ported("test_front", exclude={}, ports=(9941,)))
