"""The JAX package's ``tests/test_flight_recorder.py`` against the port on
the CPU (``tests/torch_ported_tests.py``), but for one case: (c) the
recorder's on/off A/B on the host clock, which fails on the JAX side too
under parallel load (ROADMAP's watch list)."""

from torch_ported_tests import ported

globals().update(ported("test_flight_recorder", exclude={
    "test_clean_path_ab_overhead": "(c) on/off A/B on the host clock",
}))
