"""The JAX package's ``tests/test_native_confirm.py`` against the port on
the CPU (``tests/torch_ported_tests.py``), but for one case: (a) it reads
``libdetect._NATIVE``, the JAX module's ``ctypes`` handle, which the
port's twin has under ``native_library()``."""

from torch_ported_tests import ported

globals().update(ported("test_native_confirm", exclude={
    "test_dispatch_uses_native":
        "(a) libdetect._NATIVE; the port's twin is test_torch_native_"
        "confirm.py::test_dispatch_native_nul_and_the_switch",
}))
