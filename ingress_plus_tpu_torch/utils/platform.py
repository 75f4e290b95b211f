"""The card probe: is there a CUDA card, and which.

The port of ``ingress_plus_tpu/utils/platform.py``.  That module deals
with jax's platform flags: it probes the default backend in a throwaway
subprocess (a remote backend could hang in client init), forces the CPU
with virtual devices when the probe fails, and asserts the virtual mesh.
On torch the port keeps two of its four names, with their roles:

- :func:`probe_backend_once` runs ``torch.cuda`` in a throwaway
  subprocess under a hard timeout (a wedged driver hangs in context
  creation, which an in-process try cannot recover from) and returns
  ``(platform, err)``; :data:`LAST_PROBE` holds the card's name, the card
  count and the power limit (``nvidia-smi``) beside the probe's seconds
  and error.
- :func:`ensure_live_backend` guards the first in-process touch of the
  card: it probes and then resolves the device
  (``utils/device.py:resolve_device``).  It RAISES when no card answers.
  The JAX one forced the CPU there; the port never falls back to the CPU
  on its own.

Dropped: ``force_cpu_devices`` and ``assert_cpu_devices``.  Virtual CPU
devices are a jax mesh notion, and a torch caller reaches the CPU by
passing ``device="cpu"``, which every port entry point takes; no caller
in the port pins a process.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional, Tuple

import torch

from ingress_plus_tpu_torch.utils.device import DeviceLike, resolve_device

#: the child's probe: the card count and the first card's name, after a
#: tiny computation on it (the context creation is what can hang)
_PROBE_CHILD = (
    "import json, torch\n"
    "ok = torch.cuda.is_available()\n"
    "if ok:\n"
    "    torch.ones(1, device='cuda').add_(1).sum().item()\n"
    "print('PROBE=' + json.dumps({'count': torch.cuda.device_count() if ok "
    "else 0, 'name': torch.cuda.get_device_name(0) if ok else None}))\n")

#: process-level cache of a SUCCESSFUL probe's platform; failures are not
#: cached, so a retry sees a fresh attempt
_PROBE_OK: Optional[str] = None

#: the last completed probe (success or failure): {platform,
#: device_count, name, power_limit, probe_s, error}
LAST_PROBE: dict = {}


def power_limit(timeout: float = 30.0) -> Optional[str]:
    """The first card's ``name, power.limit`` line as nvidia-smi gives it,
    or None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def probe_backend_once(timeout: int = 60, use_cache: bool = True
                       ) -> Tuple[Optional[str], Optional[str]]:
    """``torch.cuda`` in a throwaway subprocess under a hard timeout.

    Returns ``("cuda", None)`` when a card answers, else ``(None,
    error)``.  A success is cached for the process (``use_cache``);
    every call that probes updates :data:`LAST_PROBE`."""
    global _PROBE_OK
    if use_cache and _PROBE_OK is not None:
        return _PROBE_OK, None
    t0 = time.time()

    def done(platform, err, fields=None):
        fields = fields or {}
        LAST_PROBE.clear()
        LAST_PROBE.update(
            platform=platform, device_count=fields.get("count"),
            name=fields.get("name"),
            power_limit=power_limit() if platform else None,
            probe_s=round(time.time() - t0, 1), error=err)
        return platform, err

    try:
        p = subprocess.run([sys.executable, "-c", _PROBE_CHILD],
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return done(None, "card init hung >%ds" % timeout)
    out = [line for line in p.stdout.splitlines()
           if line.startswith("PROBE=")]
    if p.returncode != 0 or not out:
        err = (p.stderr.strip().splitlines() or ["rc=%d" % p.returncode])[-1]
        return done(None, err[:300])
    fields = json.loads(out[-1][len("PROBE="):])
    if not fields["count"]:
        return done(None, "no CUDA card: torch.cuda.is_available() is "
                          "False", fields)
    _PROBE_OK = "cuda"
    return done(_PROBE_OK, None, fields)


def ensure_live_backend(device: DeviceLike = None,
                        timeout: int = 60) -> torch.device:
    """The device to run on, after checking that it answers.

    ``device`` as :func:`resolve_device` takes it (None = the card).  The
    CPU needs no probe.  For a card, :func:`probe_backend_once` runs
    first, and a card that does not answer (absent, or hung past
    ``timeout``) raises RuntimeError: there is no fallback to the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return resolve_device(device)
    plat, err = probe_backend_once(timeout)
    if plat is None:
        raise RuntimeError("no CUDA card answers (%s); pass device='cpu' "
                           "to run the plain PyTorch versions" % err)
    return resolve_device(device)
