"""The JAX package's ``tests/test_trace_histogram.py`` against the port on
the CPU (``tests/torch_ported_tests.py``), but for one case: (b) it
imports the JAX ``bench.py``, which is not ported."""

from torch_ported_tests import ported

globals().update(ported("test_trace_histogram", exclude={
    "test_bench_scrape_path_imports_without_server": "(b) imports bench.py",
}))
