"""The port's WebSocket analysis path, on the CPU.

The JAX package's ``tests/test_websocket.py`` runs whole against the
port (``tests/torch_ported_tests.py``): the RFC 6455 parser, ``WSStream``
on the port's ``Batcher``, and WTPI frames over a real socket to
``python -m ingress_plus_tpu_torch.serve --platform cpu``.
"""

from torch_ported_tests import ported

globals().update(ported("test_websocket", exclude={}))
