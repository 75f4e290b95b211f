"""The port's deploy renderer (``control/deploy.py``), its trace ring and
the postanalytics consolidator, on the CPU.

The JAX package's ``tests/test_deploy_trace.py`` runs against the port
but for three tests that pin the JAX render (each named below with its
reason); their port twins follow.  Every ``python -m
ingress_plus_tpu_torch.…`` command the port renders is accepted by that
module's own argument parser, the port reads the JAX ``deploy/values.yaml``
and renders what the JAX renderer does from it but for the documented
translations, and the serve image's ``COPY`` sources exist.
"""

import argparse
import dataclasses
import re
from pathlib import Path

import pytest

import chip_smoke
from ingress_plus_tpu.control import deploy as jdeploy
from ingress_plus_tpu_torch.control.deploy import (
    DeployValues,
    render_all,
    write_static,
)

from torch_ported_tests import ported

REPO = Path(__file__).resolve().parent.parent
TORCH_DEPLOY = REPO / "deploy" / "torch"

globals().update(ported("test_deploy_trace", exclude={
    "test_render_contains_architecture":
        "(a) pins google.com/tpu: 1; the port asks for nvidia.com/gpu: 1 "
        "(twin: test_port_render_contains_architecture)",
    "test_static_manifests_in_sync":
        "(a) reads the pre-port deploy/static/; the port writes "
        "deploy/torch/static/ (twin: test_port_static_manifests_in_sync)",
    "test_values_yaml_drives_render":
        "(a) the JAX deploy/values.yaml names the JAX image (twin: "
        "test_port_values_yaml_drives_render)",
}))


def test_port_render_contains_architecture():
    v = DeployValues(chips_per_host=2, balance="ewma", deadline_ms=30)
    out = render_all(v)
    dep = out["deployment.yaml"]
    # one serve loop per card, each with its own socket and one card
    assert dep.count("name: serve-") == 2
    assert "/run/ipt/serve-0.sock" in dep and "/run/ipt/serve-1.sock" in dep
    assert dep.count("limits: {nvidia.com/gpu: 1}") == 2
    assert "google.com/tpu" not in dep
    # each container sees its one card as device 0: no visible-devices env
    for text in out.values():
        assert "_VISIBLE_" not in text and "env:" not in text
    assert "- /run/ipt/serve-0.sock,/run/ipt/serve-1.sock" in dep
    assert "- ewma" in dep
    assert '- "30"' in dep
    assert dep.count("path: /healthz") == 2
    assert dep.count("- ingress_plus_tpu_torch.serve") == 2
    assert "ingress_plus_tpu_torch.post.export" in dep
    assert dep.count("name: ipt-spool, mountPath") >= 3
    assert "image: ingress-plus-tpu-torch:latest" in dep
    fleet = out["fleet.yaml"]
    assert fleet.count("limits: {nvidia.com/gpu: 1}") == 3
    for mod in ("serve", "control.fleetobs", "control.retuned"):
        assert "- ingress_plus_tpu_torch.%s" % mod in fleet
    assert not re.search(r"\bingress_plus_tpu\.", "".join(out.values()))
    cm = out["configmap.yaml"]
    assert 'detection-backend: "tpu"' in cm
    assert 'fail-open: "true"' in cm


def test_port_static_manifests_in_sync(tmp_path):
    """deploy/torch/static equals a fresh render of
    deploy/torch/values.yaml, which is the port's defaults."""
    fresh = tmp_path / "static"
    values = DeployValues.from_yaml((TORCH_DEPLOY / "values.yaml").read_text())
    write_static(fresh, values)
    committed = TORCH_DEPLOY / "static"
    assert sorted(p.name for p in committed.iterdir()) == \
        sorted(p.name for p in fresh.iterdir())
    for f in fresh.iterdir():
        assert (committed / f.name).read_text() == f.read_text(), \
            "deploy/torch/static/%s is stale — run python -m " \
            "ingress_plus_tpu_torch.control.deploy" % f.name


def test_port_values_yaml_drives_render():
    v = DeployValues.from_yaml((TORCH_DEPLOY / "values.yaml").read_text())
    assert v == DeployValues()
    assert v.image == "ingress-plus-tpu-torch:latest"
    assert render_all(v) == render_all(DeployValues())
    custom = DeployValues.from_yaml(
        "replicas: 5\nbalance: chash\nfail-open: false\n"
        "deadline-ms: 75\ntenants:\n  1: [attack-sqli, attack-xss]\n")
    assert custom.replicas == 5 and custom.balance == "chash"
    assert custom.fail_open is False and custom.deadline_ms == 75
    assert custom.tenants == {1: ["attack-sqli", "attack-xss"]}
    dep = render_all(custom)["deployment.yaml"]
    assert "replicas: 5" in dep and "chash" in dep
    with pytest.raises(ValueError, match="unknown key"):
        DeployValues.from_yaml("replcias: 5\n")


def test_port_reads_jax_values_and_renders_only_the_translations():
    """The JAX ``deploy/values.yaml`` parses into the port's DeployValues
    as into JAX's; rendered from it, the port's manifests are the JAX
    package's with the documented translations applied, no others."""
    text = (REPO / "deploy" / "values.yaml").read_text()
    v = DeployValues.from_yaml(text)
    jv = jdeploy.DeployValues.from_yaml(text)
    assert dataclasses.asdict(v) == dataclasses.asdict(jv)
    assert v.image == "ingress-plus-tpu:latest"
    ours, theirs = render_all(v), jdeploy.render_all(jv)
    assert sorted(ours) == sorted(theirs)
    for name, want in theirs.items():
        want = re.sub(r"\bingress_plus_tpu\.", "ingress_plus_tpu_torch.",
                      want)
        want = want.replace("google.com/tpu", "nvidia.com/gpu")
        want = re.sub(r"          env:\n            - \{name: "
                      r"TPU_VISIBLE_CHIPS, value: \"\d+\"\}\n", "", want)
        assert ours[name] == want, name


def _python_commands(text):
    """{container: argv after ``python -m``} of a rendered manifest."""
    lines = text.splitlines()
    out = {}
    for at in [k for k, ln in enumerate(lines) if ln == "      containers:"]:
        for ln in lines[at + 1:]:
            m = re.match(r"^        - name: (\S+)$", ln)
            if not m:
                if ln.startswith("---"):
                    break
                continue
            cmd = chip_smoke.rendered_container(
                "\n".join(lines[at:]), m.group(1))["command"]
            if cmd[:2] == ["python", "-m"]:
                out[m.group(1)] = cmd[2:]
    return out


class _Parsed(Exception):
    pass


def _parser_accepts(main, argv, known=False):
    """Run ``main(argv)`` until its parser has parsed ``argv``: the
    parse must succeed (with ``known``, leave nothing unparsed)."""
    orig_args = argparse.ArgumentParser.parse_args
    orig_known = argparse.ArgumentParser.parse_known_args

    def parse_args(self, args=None, namespace=None):
        raise _Parsed(orig_args(self, args, namespace))

    def parse_known_args(self, args=None, namespace=None):
        ns, rest = orig_known(self, args, namespace)
        assert rest == [], rest
        raise _Parsed(ns)

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser,
               "parse_known_args" if known else "parse_args",
               parse_known_args if known else parse_args)
    try:
        main(argv)
    except _Parsed as p:
        return p.args[0]
    finally:
        mp.undo()
    raise AssertionError("%r never parsed its arguments" % main)


def test_every_rendered_command_parses():
    from ingress_plus_tpu_torch.control import fleetobs, retuned
    from ingress_plus_tpu_torch.post import export
    from ingress_plus_tpu_torch.serve import front, server

    seen = {}
    for name, text in render_all(DeployValues()).items():
        for container, argv in _python_commands(text).items():
            mod, args = argv[0], argv[1:]
            if mod == "ingress_plus_tpu_torch.serve" and "--front" in args:
                ns = _parser_accepts(front.main, args, known=True)
                assert len(ns.backend) == 3
            else:
                main = {"ingress_plus_tpu_torch.serve": server.main,
                        "ingress_plus_tpu_torch.post.export": export.main,
                        "ingress_plus_tpu_torch.control.fleetobs":
                            fleetobs.main,
                        "ingress_plus_tpu_torch.control.retuned":
                            retuned.main}[mod]
                ns = _parser_accepts(main, args)
            seen["%s/%s" % (name, container)] = ns
    assert sorted(seen) == sorted(
        ["deployment.yaml/serve-%d" % i for i in range(4)]
        + ["deployment.yaml/postanalytics"]
        + ["fleet.yaml/serve-%d" % i for i in range(3)]
        + ["fleet.yaml/front", "fleet.yaml/fleet-aggregator",
           "fleet.yaml/retune-daemon"])
    serve0 = seen["deployment.yaml/serve-0"]
    assert (serve0.socket, serve0.http_port, serve0.mode) == \
        ("/run/ipt/serve-0.sock", 9901, "block")
    assert serve0.platform == "cuda"    # the card, never a CPU fallback


def test_serve_image_copies_what_exists():
    text = (TORCH_DEPLOY / "Dockerfile.serve").read_text()
    copies = re.findall(r"^COPY (\S+) (\S+)$", text, re.M)
    assert ("ingress_plus_tpu_torch/", "ingress_plus_tpu_torch/") in copies
    for src, _ in copies:
        assert (REPO / src).exists(), src
    assert 'ENTRYPOINT ["python", "-m", "ingress_plus_tpu_torch.serve"]' \
        in text
    assert "ingress_plus_tpu/" not in text.replace(
        "ingress_plus_tpu_torch/", "")
