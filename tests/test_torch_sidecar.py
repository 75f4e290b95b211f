"""The C++ sidecar in front of the port's server, on the CPU.

The JAX package's ``tests/test_sidecar.py`` runs whole against the port
(``tests/torch_ported_tests.py``): the sidecar and loadgen binaries come
from the port's build of ``native/sidecar`` (``build_native``), its
fixed status ports (19911-19915) are free ports of this process, and its
socket paths fit AF_UNIX under any temporary directory.  The server
behind the sidecar is ``python -m ingress_plus_tpu_torch.serve
--platform cpu``.
"""

from torch_ported_tests import native_patch, ported

globals().update(ported(
    "test_sidecar", exclude={}, patch=native_patch("BIN", "LOADGEN"),
    ports=(19911, 19912, 19913, 19914, 19915)))
