"""The nginx module's client and phase machine against the port, on the
CPU.

The JAX package's ``tests/test_shim.py`` runs against the port
(``tests/torch_ported_tests.py``): ``shim_selftest`` through the C++
sidecar into the port's server, ``shim_harness`` (the module linked
against the nginx test double) straight at it, with ACLs pushed over the
port's config plane, and the template's directives against the module's
command table.  The binaries come from the port's build of
``native/`` (``build_native``), never ``make`` in ``native/``; the fixed
HTTP port 19907 is a free port of this process.
"""

from torch_ported_tests import native_patch, ported

from ingress_plus_tpu_torch.ops.cuda_build import build_native


def test_nginx_module_compiles():
    """The module object goes through a real compiler with the shim
    Makefile's ``-Wall -Wextra -Werror`` against the vendored nginx_compat
    headers: compiled afresh into the port's build of ``native/`` (the
    JAX test deletes and remakes ``native/shim``'s object in place)."""
    obj = build_native(["ngx_http_detect_tpu_module.o"], force=True)[
        "ngx_http_detect_tpu_module.o"]
    assert obj.exists() and obj.stat().st_size > 0


globals().update(ported(
    "test_shim", exclude={},
    patch={**native_patch("SELFTEST", "SIDECAR", "HARNESS"),
           "test_nginx_module_compiles": test_nginx_module_compiles},
    ports=(19907,)))
