"""Device selection for the port's entry points.

Every entry point takes ``device``; ``None`` means the CUDA card.  A run
that asks for the card where there is none raises: the port never falls
back to the CPU on its own.  The CPU is reached only by asking for it
(``device="cpu"``), which is how the tests run the plain versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` → ``cuda``.  Raises
    RuntimeError when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for (device=%r) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions" % (device,))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % (device,))
    return dev
