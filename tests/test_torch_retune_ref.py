"""The JAX package's ``tests/test_retune.py``, whole, against the port on
the CPU (``tests/torch_ported_tests.py``).  Its ``import retune`` (the
JAX ``tools/retune.py``) is the port's library half of that tool,
``ingress_plus_tpu_torch/control/retune.py``."""

from torch_ported_tests import ported

from ingress_plus_tpu_torch.control import retune

globals().update(ported("test_retune", exclude={},
                        patch={"retune": retune}))
