"""Unix socket paths that fit ``sockaddr_un``.

A unix socket's path must fit ``sun_path``: 108 bytes with the closing
NUL on Linux, so 107 of path.  Python's ``bind`` refuses a longer one,
but the C++ sidecar, loadgen and the nginx module's client copy the path
with ``strncpy`` and cut it silently: they then bind or connect to
another name, and whoever waits on the socket waits forever.  Every
socket path the port's tools hand to a process comes from
:func:`socket_path`, which keeps it whole.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

#: the longest path ``sun_path`` holds, its NUL aside
MAX_SOCKET_PATH = 107
#: where a socket goes when its own directory is too deep
SHORT_ROOT = "/tmp"


def socket_path(directory, name: str) -> str:
    """``directory/name`` when that fits :data:`MAX_SOCKET_PATH` bytes;
    else ``name`` in a new directory under ``/tmp``
    (``mkdtemp(prefix="ipt", dir="/tmp")``, removed when this process
    exits).  Raises ValueError only if even that is too long."""
    path = os.path.join(os.fspath(directory), name)
    if len(os.fsencode(path)) <= MAX_SOCKET_PATH:
        return path
    short = os.path.join(SHORT_ROOT, "iptXXXXXXXX", name)
    if len(os.fsencode(short)) > MAX_SOCKET_PATH:
        raise ValueError("socket name too long for AF_UNIX even under %s: "
                         "%r" % (SHORT_ROOT, name))
    d = tempfile.mkdtemp(prefix="ipt", dir=SHORT_ROOT)
    atexit.register(shutil.rmtree, d, True)
    return os.path.join(d, name)
