"""Device-mesh parallelism: the port of ``ingress_plus_tpu/parallel``.

| Strategy | Here |
|----------|------|
| DP | batch rows split over the ``data`` axis of a Mesh (mesh.py) |
| TP | bitap words (the ruleset) split over ``model``; the scan is
       word-local, only the factor→rule vote is summed (shard.py) |
| EP | tenant→rule masks applied to the merged votes |
| SP | a giant body split along its bytes with a 32-byte halo taken
       from the neighbour shard (stream.py ``ring_scan``) |

A Mesh is an explicit grid of torch devices, and the sharded step loops
over it (no ``shard_map`` in PyTorch): each shard scans on its own device
and CUDA stream, and the collectives are explicit sums onto the data
row's first device.  Between processes the data axis rides
``torch.distributed`` (dcn.py).  ``serve_mesh.MeshEngine`` serves the
step behind the single-device engine API (the server's ``--mesh``).
"""

from ingress_plus_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from ingress_plus_tpu_torch.parallel.shard import (  # noqa: F401
    ShardedEngine,
    shard_ruleset_tables,
)
