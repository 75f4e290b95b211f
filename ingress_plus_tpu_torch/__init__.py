"""ingress_plus_tpu_torch — the WAF detection framework on PyTorch + CUDA.

The port of ``ingress_plus_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It mirrors the JAX package's layout (``compiler/``, ``ops/``,
``models/``, ``serve/``, ``utils/``) and imports nothing of it.  Entry
points take ``device`` and default to ``cuda``; without a card they
raise.  ``device="cpu"`` runs the plain PyTorch versions of the kernels.

The hand-written CUDA kernels live in ``csrc/`` and are built at first
use (ops/cuda_build.py).  The SecLang compiler (``compiler/``) compiles the
port's copy of the OWASP-CRS-shaped rules (``rules/``) into the same packs
as the JAX compiler; the bundled pack also ships compiled in ``packs/``
(weights.py ``load_pack``).  ``control/rollout.py`` takes rule changes
through the guarded rollout.
"""
