"""The port's rulecheck (``analysis/``: scan, reach, txflow, the CLI) and
promlint, held to the JAX package.

The JAX package's ``tests/test_rulecheck.py`` runs here whole against the
port, with its SecLang tree fixtures going through both packages:
``scan_tree``, ``check_reachability`` and ``check_tx_dataflow`` are
replaced in that run by twins that also run the JAX analyzer on the same
tree and require the same findings.  The bundled tree's full report and
promlint's findings are compared directly.
"""

import pytest
from torch_ported_tests import ported

from ingress_plus_tpu_torch.analysis import run_rulecheck
from ingress_plus_tpu_torch.analysis.promlint import check_exposition
from ingress_plus_tpu_torch.analysis.reach import check_reachability
from ingress_plus_tpu_torch.analysis.scan import scan_tree
from ingress_plus_tpu_torch.analysis.txflow import check_tx_dataflow


class _Scans(list):
    """The port's scans of a tree, with the path they were taken from."""

    path = None


def _twin_scan_tree(path):
    scans = _Scans(scan_tree(path))
    scans.path = path
    return scans


def _twin(port_check, jax_module, name):
    def check(scans, **kw):
        import importlib

        from ingress_plus_tpu.analysis.scan import scan_tree as jax_scan_tree

        got = port_check(scans, **kw)
        if isinstance(scans, _Scans):
            ref = getattr(importlib.import_module(jax_module), name)(
                jax_scan_tree(scans.path), **kw)
            assert [f.to_dict() for f in got] == \
                [f.to_dict() for f in ref]
        return got
    return check


_TWINS = {
    "scan_tree": _twin_scan_tree,
    "check_reachability": _twin(check_reachability,
                                "ingress_plus_tpu.analysis.reach",
                                "check_reachability"),
    "check_tx_dataflow": _twin(check_tx_dataflow,
                               "ingress_plus_tpu.analysis.txflow",
                               "check_tx_dataflow"),
}
globals().update(ported("test_rulecheck", exclude={}, patch=_TWINS))


def _port_paths(text: str) -> str:
    """A JAX report's text with its package's paths as the port's."""
    return text.replace("ingress_plus_tpu/", "ingress_plus_tpu_torch/")


def test_rulecheck_report_equals_the_jax_packages_on_the_bundled_tree():
    from ingress_plus_tpu.analysis import run_rulecheck as jax_rulecheck

    for bl in ("auto", None):
        port, ref = run_rulecheck(baseline_path=bl), jax_rulecheck(
            baseline_path=bl)
        assert len(port.findings) > 40
        assert port.to_json() == _port_paths(ref.to_json())
        assert port.to_sarif() == _port_paths(ref.to_sarif())


def test_twin_checks_ran_on_the_fixture_trees(tmp_path):
    """The twins above compare only scans they took; a tree with a
    dangling marker goes through both packages and both flag it."""
    (tmp_path / "a.conf").write_text(
        'SecRule TX:PL "@lt 2" "id:100,phase:2,pass,skipAfter:NO-SUCH"\n')
    ported_globals = globals()["test_flow_dangling_marker_error"].__globals__
    for name, twin in _TWINS.items():
        assert ported_globals[name] is twin
    findings = _TWINS["check_reachability"](_twin_scan_tree(tmp_path))
    assert [f.check for f in findings] == ["flow.dangling-marker"]


_EXPOSITIONS = {
    "good": "\n".join([
        "# HELP ipt_good_total good things",
        "# TYPE ipt_good_total counter",
        "ipt_good_total 3",
        "# HELP ipt_h histogram of things",
        "# TYPE ipt_h histogram",
        'ipt_h_bucket{le="1"} 1',
        'ipt_h_bucket{le="+Inf"} 2',
        "ipt_h_sum 2",
        "ipt_h_count 2"]),
    "prefix": "# HELP foo_total x\n# TYPE foo_total counter\nfoo_total 1",
    "suffix": "# HELP ipt_bad x\n# TYPE ipt_bad counter\nipt_bad 1",
    "help": "# TYPE ipt_x_total counter\nipt_x_total 1",
    "type": "ipt_untyped_total 1",
    "inf": ('# HELP ipt_h x\n# TYPE ipt_h histogram\n'
            'ipt_h_bucket{le="1"} 1'),
    "monotonic": ('# HELP ipt_h x\n# TYPE ipt_h histogram\n'
                  'ipt_h_bucket{le="1"} 5\nipt_h_bucket{le="+Inf"} 2'),
    "unbounded": "\n".join(
        ["# HELP ipt_rule_total x", "# TYPE ipt_rule_total counter"]
        + ['ipt_rule_total{rule="%d"} 1' % i for i in range(50)]),
    "node": ('# HELP ipt_q x\n# TYPE ipt_q gauge\n'
             'ipt_q{node="n1"} 1\nipt_q{agg="mean"} 1\n'
             'ipt_q{instance="a"} 2'),
    "nan": "# HELP ipt_eff x\n# TYPE ipt_eff gauge\nipt_eff NaN",
}


@pytest.mark.parametrize("name", sorted(_EXPOSITIONS))
@pytest.mark.parametrize("fleet", [False, True])
def test_promlint_findings_equal_the_jax_packages(name, fleet):
    from ingress_plus_tpu.analysis.promlint import (
        check_exposition as jax_check,
    )

    text = _EXPOSITIONS[name]
    got = check_exposition(text, fleet=fleet)
    assert got == jax_check(text, fleet=fleet)
    assert (got == []) == (name in ("good", "nan")), got


def test_promlint_live_port_exposition_clean(tmp_path):
    """A port CPU server's exposition after multi-tenant traffic passes
    the port's lint and the JAX package's (the tenant fold engaged)."""
    from ingress_plus_tpu.analysis.promlint import (
        check_exposition as jax_check,
    )
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline
    from ingress_plus_tpu_torch.serve.batcher import Batcher
    from ingress_plus_tpu_torch.serve.normalize import Request
    from ingress_plus_tpu_torch.serve.server import ServeLoop

    cr = compile_ruleset(parse_seclang(
        'SecRule ARGS "@rx (?i)union\\s+select" "id:1,phase:2,block,'
        'severity:CRITICAL,tag:\'attack-sqli\'"'))
    b = Batcher(DetectionPipeline(cr, mode="monitoring", device="cpu"),
                max_batch=16)
    try:
        futs = []
        for i in range(64):
            uri = ("/p?q=1%27%20UNION%20SELECT%20x" if i % 2 == 0
                   else "/ok?page=%d" % i)
            futs.append(b.submit(Request(uri=uri, headers={}, body=b"",
                                         request_id="r-%d" % i,
                                         tenant=i % 48)))
        for f in futs:
            f.result(timeout=60)
        text = ServeLoop(b, socket_path=str(tmp_path / "s.sock")
                         )._metrics_text()
    finally:
        b.close()
    assert check_exposition(text) == [] == jax_check(text)
    assert 'tenant="other"' in text
    assert "ipt_kernel_launches_total" in text
