"""Mesh construction helpers.

The port of ``ingress_plus_tpu/parallel/mesh.py``.  One grid of torch
devices, two logical axes:
  ``data``  — request-batch sharding (DP)
  ``model`` — bitap-word / ruleset sharding (TP)

PyTorch has no ``shard_map``: a :class:`Mesh` is an explicit
``(n_data, n_model)`` grid of ``torch.device`` entries, and the sharded
step (shard.py) loops over it.  An entry may name a device more than
once — eight entries of ``cpu`` are the counterpart of the JAX tests'
eight virtual CPU devices, and eight of ``cuda:0`` run a 2x4 mesh on one
card.

A mesh that spans processes (dcn.py ``hybrid_mesh``) holds only this
process's data rows: ``shape["data"]`` counts every process's rows,
``local_rows`` this one's, which start at global row ``data_offset``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ingress_plus_tpu_torch.utils.device import DeviceLike


class Mesh:
    """An ``(n_data, n_model)`` grid of torch devices."""

    axis_names = ("data", "model")

    def __init__(self, rows: Sequence[Sequence[torch.device]],
                 n_data: Optional[int] = None, data_offset: int = 0):
        self.rows: List[List[torch.device]] = [
            [torch.device(d) for d in row] for row in rows]
        widths = {len(r) for r in self.rows}
        if not self.rows or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh needs >= 1 row of equal, non-zero "
                             "width, got %r" % (rows,))
        types = {d.type for row in self.rows for d in row}
        if len(types) != 1:
            raise ValueError("a mesh spans one device type, got %s"
                             % sorted(types))
        self.n_data = len(self.rows) if n_data is None else int(n_data)
        self.data_offset = int(data_offset)
        if not 0 <= self.data_offset <= self.n_data - len(self.rows):
            raise ValueError("local rows %d at offset %d exceed n_data %d"
                             % (len(self.rows), self.data_offset,
                                self.n_data))

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": len(self.rows[0])}

    @property
    def size(self) -> int:
        return self.n_data * len(self.rows[0])

    @property
    def local_rows(self) -> int:
        return len(self.rows)

    @property
    def spans_processes(self) -> bool:
        return len(self.rows) < self.n_data

    @property
    def device_type(self) -> str:
        return self.rows[0][0].type

    def devices(self) -> List[torch.device]:
        """This process's entries, row-major."""
        return [d for row in self.rows for d in row]

    def __repr__(self) -> str:
        return "Mesh(%dx%d, %s)" % (self.n_data, len(self.rows[0]),
                                    [[str(d) for d in r] for r in self.rows])


def default_devices() -> List[torch.device]:
    """Every CUDA card of this host; raises without one (the port never
    falls back to the CPU on its own)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a mesh over the CUDA cards was asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "devices=['cpu'] * n for the plain versions")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a ("data", "model") mesh over ``devices`` (default: every
    CUDA card).  Defaults: all devices on the model axis (n_data=1);
    pass an explicit split for data-parallel layouts.  ``devices`` may
    repeat an entry."""
    devs = [torch.device("cuda" if d is None else d)
            for d in (devices if devices is not None
                      else default_devices())]
    n = len(devs)
    if n_data is None and n_model is None:
        n_data, n_model = 1, n
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n or n == 0:
        raise ValueError("mesh %sx%s != %d devices" % (n_data, n_model, n))
    return Mesh([devs[i * n_model:(i + 1) * n_model]
                 for i in range(n_data)])


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.shape["data"], mesh.shape["model"]
