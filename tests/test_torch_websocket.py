"""The port's WebSocket analysis path, on the CPU.

The JAX package's ``tests/test_websocket.py`` runs whole against the
port (``tests/torch_ported_tests.py``): the RFC 6455 parser, ``WSStream``
on the port's ``Batcher``, and WTPI frames over a real socket to
``python -m ingress_plus_tpu_torch.serve --platform cpu``.  The port's
``DetectionPipeline`` defaults to the card and raises without one, so
the file's own construction gets ``device="cpu"``.
"""

from torch_ported_tests import one_torch_thread, ported  # noqa: F401

from ingress_plus_tpu_torch.models import pipeline


class OnCpu(pipeline.DetectionPipeline):
    def __init__(self, *args, device="cpu", **kw):
        super().__init__(*args, device=device, **kw)


globals().update(ported("test_websocket", exclude={},
                        patch={"DetectionPipeline": OnCpu}))
