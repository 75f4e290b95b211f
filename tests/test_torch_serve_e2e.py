"""The port's server end to end under the C++ loadgen, on the CPU.

The JAX package's ``tests/test_serve_e2e.py`` runs whole against the
port (``tests/torch_ported_tests.py``): loadgen comes from the port's
build of ``native/sidecar``, the server's fixed HTTP port 19901 is a
free port of this process, and its socket path fits AF_UNIX under any
temporary directory.
"""

from torch_ported_tests import native_patch, ported

globals().update(ported("test_serve_e2e", exclude={},
                        patch=native_patch("LOADGEN"), ports=(19901,)))
