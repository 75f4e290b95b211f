"""Multi-process support on ``torch.distributed``.

The port of ``ingress_plus_tpu/parallel/dcn.py``.  Each process runs its
own serve loop feeding its local devices — requests never cross
processes, like nginx replicas.  A mesh may still span processes for
ruleset sharding: :func:`hybrid_mesh` puts the ``data`` axis over
processes and the ``model`` axis over each process's local devices, so
the vote sum over ``model`` never leaves a process and only the few
bytes of per-request verdicts cross between them.

Process bring-up is :func:`init_distributed`, gated on the standard env
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): a no-op in
one process, ``gloo`` on the CPU and ``nccl`` on CUDA cards.  JAX's
``make_global`` / ``gather_global`` become this process's slice of a
batch and ``dist.all_gather`` of the outputs; the sharded step's sum
over ``data`` becomes ``dist.all_reduce``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ingress_plus_tpu_torch.parallel.mesh import Mesh, default_devices
from ingress_plus_tpu_torch.utils.device import DeviceLike

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device_type: str = "cuda") -> bool:
    """Gated ``dist.init_process_group``.

    Args fall back to the standard env (MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK; ``init_method`` None = ``env://``).  Returns True
    when a multi-process group was (or already is) initialized, False
    for one process — callers never branch on the environment
    themselves.  A partial or malformed env raises ValueError.  The
    backend defaults to ``nccl`` for ``device_type`` cuda, ``gloo`` for
    cpu."""
    if _active():
        return True
    if world_size is None:
        env = {k: os.environ.get(k) for k in ENV}
        present = [k for k, v in env.items() if v]
        if not present:
            return False
        if len(present) != len(ENV):
            raise ValueError("distributed env incomplete: %s set, %s "
                             "missing" % (present, sorted(set(ENV)
                                                          - set(present))))
        try:
            world_size = int(env["WORLD_SIZE"])
            rank = int(env["RANK"]) if rank is None else rank
            int(env["MASTER_PORT"])
        except ValueError as e:
            raise ValueError("distributed env malformed: %s" % e) from e
    if world_size <= 1:
        return False
    rank = 0 if rank is None else int(rank)
    if not 0 <= rank < world_size:
        raise ValueError("rank %d outside world size %d"
                         % (rank, world_size))
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def hybrid_mesh(n_model: Optional[int] = None,
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """("data", "model") mesh with processes on the data axis.

    Multi-process: data axis = process count × this process's rows,
    model axis = local devices (``n_model`` may further split a
    process's devices between data and model); the mesh holds this
    process's rows only.  One process: ``make_mesh(n_model=...)``."""
    from ingress_plus_tpu_torch.parallel.mesh import make_mesh

    procs = process_count()
    if procs <= 1:
        return make_mesh(n_model=n_model, devices=devices)
    devs = [torch.device("cuda" if d is None else d)
            for d in (devices if devices is not None
                      else default_devices())]
    if n_model is None:
        n_model = len(devs)
    if len(devs) % n_model != 0:
        raise ValueError("n_model=%d does not divide %d local devices"
                         % (n_model, len(devs)))
    rows = len(devs) // n_model
    return Mesh([devs[i * n_model:(i + 1) * n_model] for i in range(rows)],
                n_data=procs * rows, data_offset=process_index() * rows)


def local_batch_bounds(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """[start, end) of the global batch this process feeds: the rows of
    its own data-axis slots (a one-process mesh owns everything)."""
    n_data = mesh.shape["data"]
    if global_batch % n_data != 0:
        raise ValueError("batch %d not divisible by data axis %d"
                         % (global_batch, n_data))
    per_row = global_batch // n_data
    return (mesh.data_offset * per_row,
            (mesh.data_offset + mesh.local_rows) * per_row)


def make_global(mesh: Mesh, spec, local_np: np.ndarray,
                global_shape: Optional[Tuple[int, ...]] = None
                ) -> np.ndarray:
    """This process's slice of a batch array, checked against
    ``global_shape``: the input a sharded step takes on a mesh that
    spans processes (no process ever holds another's bytes).
    ``spec`` names each axis's mesh axis (``("data", None)``); only a
    leading ``data`` axis is split.  One process: the array itself."""
    arr = np.ascontiguousarray(local_np)
    if global_shape is None or not mesh.spans_processes:
        return arr
    spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    want = list(global_shape)
    if spec and spec[0] == "data":
        want[0] = global_shape[0] * mesh.local_rows // mesh.shape["data"]
    if list(arr.shape) != want:
        raise ValueError("local slice %s does not match global %s over "
                         "mesh %s" % (arr.shape, tuple(global_shape),
                                      mesh.shape))
    return arr


def gather_global(x: torch.Tensor) -> np.ndarray:
    """This process's rows of an output → the full output as numpy on
    every process (``dist.all_gather`` along the first axis; the
    verdict fan-back, a few bytes per request).  One process: numpy."""
    if not _active() or process_count() <= 1:
        return x.cpu().numpy()
    dtype = x.dtype
    # gloo gathers no bool tensors: ride as uint8
    t = x.to(torch.uint8) if dtype == torch.bool else x
    if dist.get_backend() == "gloo":
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    out = torch.cat(parts).cpu()
    return (out.to(torch.bool) if dtype == torch.bool else out).numpy()


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every process (the sharded step's reduction
    over ``data`` when the mesh spans processes), on ``x``'s device."""
    if not _active():
        return x
    t = x.cpu() if dist.get_backend() == "gloo" else x
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.to(x.device)


def device_duty_summary() -> dict:
    """Process topology plus local device inventory, for /healthz."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = ([str(torch.device("cuda", i)) for i in range(n)] if n
             else ["cpu"])
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_device_count": len(local) * process_count(),
    }
