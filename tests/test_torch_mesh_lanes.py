"""The JAX package's ``tests/test_mesh_lanes.py`` against the port on the
CPU (``tests/torch_ported_tests.py``), but for two cases:

- (a) one asserts the JAX runtime's CPU device name in ``dbg breaker``'s
  lane rows; the port's rows name ``cpu``;
- (c) one counts compiles over bursts whose batching follows the host's
  clock, and fails on the JAX side too under parallel load (ROADMAP's
  watch list).
"""

from torch_ported_tests import ported

globals().update(ported("test_mesh_lanes", exclude={
    "test_metrics_healthz_and_dbg_lane_views":
        "(a) TFRT_CPU; the port's twin is test_torch_batcher.py::"
        "test_breaker_render_names_each_lanes_device",
    "test_steady_state_serving_never_recompiles":
        "(c) compile count over clock-batched bursts",
}))
