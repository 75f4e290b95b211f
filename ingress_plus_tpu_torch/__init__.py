"""ingress_plus_tpu_torch — the WAF detection framework on PyTorch + CUDA.

The port of ``ingress_plus_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It mirrors the JAX package's layout (``compiler/``, ``ops/``,
``models/``, ``serve/``, ``utils/``) and imports nothing of it.  Entry
points take ``device`` and default to ``cuda``; without a card they
raise.  ``device="cpu"`` runs the plain PyTorch versions of the kernels.

The hand-written CUDA kernel lives in ``csrc/`` and is built at first use
(ops/pair_scan.py).  The bundled OWASP-CRS-shaped pack ships compiled in
``packs/`` (weights.py ``load_pack``).
"""
