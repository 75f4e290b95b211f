"""Deployment rendering — the packaging/operator tier (SURVEY.md §2.3 L6).

Reference: the wallarm-extended Helm chart† (controller Deployment +
wallarm sidecars + Tarantool postanalytics Deployment, driven by
``values.yaml`` ``controller.wallarm.*`` keys) and the pre-rendered static
manifests under ``deploy/static/``†.

This module is the same idea sized to the detection framework: a typed
values object rendered into k8s manifests.  The pod layout it emits is
the architecture of SURVEY.md §3.3, on NVIDIA cards:

    [ingress pod]        nginx + shim (unchanged data plane)
      └─ sidecar         native/sidecar (mux, balancer, fail-open SLO)
      └─ serve-loop × N  one per card, each on its own UDS
      └─ postanalytics   spool consolidator (the cron-sidecar analog)

The spool emptyDir is pod-local, so the consolidator MUST live in the
ingress pod (the reference runs its export cron as a controller-pod
sidecar for the same reason); the serve loops' in-process PostChannel +
spool plays the Tarantool-queue role, and a central collector — when one
exists — is reached via ``export_url``.

Manifests are YAML text rendered by template strings — the reference
renders Go templates to text the same way; no YAML library is needed (or
available) and the golden tests pin the output byte-for-byte
(tests/test_torch_deploy.py, template_test.go† style).

``python -m ingress_plus_tpu_torch.control.deploy [outdir]`` regenerates
``deploy/torch/static/`` from ``deploy/torch/values.yaml`` (the
chart→static pipeline of the reference).

The manifests are the JAX package's (``ingress_plus_tpu/control/
deploy.py``) with these translations and no others:

- every rendered module path is the port's: ``ingress_plus_tpu_torch.serve``
  (the serve loops, the fleet replicas and the front),
  ``.post.export``, ``.control.fleetobs`` and ``.control.retuned``;
- each serve container asks for ``nvidia.com/gpu: 1`` where the JAX
  render asks for ``google.com/tpu: 1``;
- the per-container ``TPU_VISIBLE_CHIPS=i`` env is dropped, not turned
  into ``CUDA_VISIBLE_DEVICES=i``: under the NVIDIA device plugin a
  container that asks for one card sees it as device 0, so
  ``CUDA_VISIBLE_DEVICES=1`` would leave ``serve-1`` with no card (and
  the port's server refuses to start without one);
- the default ``image`` is ``ingress-plus-tpu-torch:latest``, and the CLI
  writes ``deploy/torch/static/`` from ``deploy/torch/values.yaml``,
  never the pre-port ``deploy/static/``.  ``DeployValues``' fields keep
  their names, so ``from_yaml`` reads the JAX ``deploy/values.yaml`` too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List


@dataclass
class DeployValues:
    """values.yaml analog — the operator-tunable surface."""

    namespace: str = "ingress-plus-tpu"
    name: str = "ipt"
    replicas: int = 2                    # ingress pods (DP over hosts)
    chips_per_host: int = 4              # serve loops per pod (1/card)
    image: str = "ingress-plus-tpu-torch:latest"
    balance: str = "rr"                  # rr | ewma | chash
    deadline_ms: int = 50
    status_port: int = 9902
    http_port: int = 9901                # serve loop 0's metrics/config
    mode: str = "block"
    rules_configmap: str = "ipt-rules"
    fail_open: bool = True
    batch_window_us: int = 500
    max_batch: int = 256
    spool_dir: str = "/var/spool/ipt"
    lkg_dir: str = "/var/lib/ipt/lkg"    # last-known-good pack store
    export_url: str = ""                 # postanalytics collector
    export_interval_s: float = 5.0
    # --- fleet tier (docs/SERVING.md "Fleet serving"): the
    # shared admission front + N detection replicas + the telemetry
    # aggregator + the continuous retune daemon in one pod.  0 fleet
    # nodes = the tier is not rendered (single-pod layout only).
    fleet_nodes: int = 3                 # replicas behind the front
    front_http_port: int = 9921          # front /metrics,/front/nodes
    fleet_http_port: int = 9911          # aggregator /fleet/*
    retune_min_interval_s: float = 600.0
    retune_cooldown_s: float = 1800.0
    tenants: Dict[int, List[str]] = field(default_factory=dict)


    @classmethod
    def from_yaml(cls, text: str) -> "DeployValues":
        """Parse the values file (deploy/values.yaml analog of the
        chart's values.yaml†).  A deliberately tiny YAML subset — flat
        ``key: value`` pairs plus one ``tenants:`` block mapping tenant
        id to a tag list — because no YAML library is available in the
        serve image and the operator surface is exactly DeployValues.
        Unknown keys are a hard error (a typo'd key silently keeping
        its default is how bad deploys ship)."""
        v = cls()
        fields = {f: type(getattr(v, f)) for f in v.__dataclass_fields__}
        in_tenants = False
        for ln, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if in_tenants and (line.startswith("  ") or
                               line.startswith("\t")):
                key, _, val = line.strip().partition(":")
                try:
                    tid = int(key.strip())
                except ValueError:
                    raise ValueError("values.yaml:%d: tenant id %r is "
                                     "not an integer" % (ln, key))
                tags = [t.strip().strip("'\"")
                        for t in val.strip().strip("[]").split(",")
                        if t.strip()]
                v.tenants[tid] = tags
                continue
            in_tenants = False
            if line != line.lstrip():
                raise ValueError("values.yaml:%d: unexpected indent %r"
                                 % (ln, raw))
            key, sep, val = line.partition(":")
            key = key.strip().replace("-", "_")
            if not sep:
                raise ValueError("values.yaml:%d: expected key: value, "
                                 "got %r" % (ln, raw))
            if key == "tenants":
                in_tenants = True
                continue
            if key not in fields:
                raise ValueError("values.yaml:%d: unknown key %r "
                                 "(valid: %s)" % (ln, key,
                                                  ", ".join(sorted(fields))))
            val = val.strip().strip("'\"")
            ftype = fields[key]
            if ftype is bool:
                setattr(v, key, val.lower() in ("true", "1", "yes", "on"))
            elif ftype is int:
                setattr(v, key, int(val))
            elif ftype is float:
                setattr(v, key, float(val))
            else:
                setattr(v, key, val)
        return v


def _serve_socket(i: int) -> str:
    return "/run/ipt/serve-%d.sock" % i


def render_configmap(v: DeployValues) -> str:
    """Global-config ConfigMap (the ~200-key ConfigMap tier, ours)."""
    lines = [
        "apiVersion: v1",
        "kind: ConfigMap",
        "metadata:",
        "  name: %s-config" % v.name,
        "  namespace: %s" % v.namespace,
        "data:",
        "  enable-detection: \"true\"",
        "  detection-backend: \"tpu\"",
        "  default-mode: \"%s\"" % v.mode,
        "  fail-open: \"%s\"" % ("true" if v.fail_open else "false"),
        "  batch-window-us: \"%d\"" % v.batch_window_us,
        "  max-batch: \"%d\"" % v.max_batch,
        "  sidecar-socket: \"/run/ipt/detect.sock\"",
        "  detect-timeout-ms: \"%d\"" % v.deadline_ms,
    ]
    return "\n".join(lines) + "\n"


def render_deployment(v: DeployValues) -> str:
    """The ingress pod: nginx+shim container, native sidecar, N serve
    loops (one per card) — the wallarm-sidecar-per-pod layout of the
    chart."""
    upstreams = ",".join(_serve_socket(i) for i in range(v.chips_per_host))
    out = [
        "apiVersion: apps/v1",
        "kind: Deployment",
        "metadata:",
        "  name: %s-controller" % v.name,
        "  namespace: %s" % v.namespace,
        "spec:",
        "  replicas: %d" % v.replicas,
        "  selector:",
        "    matchLabels: {app: %s-controller}" % v.name,
        "  template:",
        "    metadata:",
        "      labels: {app: %s-controller}" % v.name,
        "    spec:",
        "      volumes:",
        "        - name: ipt-run",
        "          emptyDir: {}",
        "        - name: ipt-rules",
        "          configMap: {name: %s}" % v.rules_configmap,
        "        - name: ipt-spool",
        "          emptyDir: {}",
        "        # last-known-good ruleset store (docs/ROBUSTNESS.md "
        "\"Guarded",
        "        # rollout\"): packs that reach LIVE persist here; a "
        "serve",
        "        # container restarting mid-rollout prefers this "
        "artifact over",
        "        # the ConfigMap rules tree",
        "        - name: ipt-lkg",
        "          emptyDir: {}",
        "      containers:",
        "        - name: controller",
        "          image: %s" % v.image,
        "          args: [\"/nginx-ingress-controller\"]",
        "          volumeMounts:",
        "            - {name: ipt-run, mountPath: /run/ipt}",
        "        - name: detect-sidecar",
        "          image: %s" % v.image,
        "          command:",
        "            - /usr/local/bin/ipt-sidecar",
        "            - --listen",
        "            - /run/ipt/detect.sock",
        "            - --upstream",
        "            - %s" % upstreams,
        "            - --balance",
        "            - %s" % v.balance,
        "            - --deadline-ms",
        "            - \"%d\"" % v.deadline_ms,
        "            - --status-port",
        "            - \"%d\"" % v.status_port,
        "          volumeMounts:",
        "            - {name: ipt-run, mountPath: /run/ipt}",
    ]
    for i in range(v.chips_per_host):
        out += [
            "        - name: serve-%d" % i,
            "          image: %s" % v.image,
            "          command:",
            "            - python",
            "            - -m",
            "            - ingress_plus_tpu_torch.serve",
            "            - --socket",
            "            - %s" % _serve_socket(i),
            "            - --mode",
            "            - %s" % v.mode,
            "            - --rules-dir",
            "            - /etc/ipt/rules",
            "            - --max-batch",
            "            - \"%d\"" % v.max_batch,
            "            - --max-delay-us",
            "            - \"%d\"" % v.batch_window_us,
            "            - --http-port",
            "            - \"%d\"" % (v.http_port + i),
            "            - --spool-dir",
            "            - %s" % v.spool_dir,
            "            - --lkg-dir",
            "            - %s" % v.lkg_dir,
            "          resources:",
            "            limits: {nvidia.com/gpu: 1}",
            "          livenessProbe:",
            "            httpGet: {path: /healthz, port: %d}"
            % (v.http_port + i),
            "            initialDelaySeconds: 30",
            "            periodSeconds: 5",
            "          # readiness is split from liveness "
            "(docs/ROBUSTNESS.md):",
            "          # /readyz goes 503 while the dispatch breaker "
            "is open or the",
            "          # brownout ladder is above full detection, "
            "pulling the pod",
            "          # from rotation instead of routing traffic "
            "into a brownout",
            "          readinessProbe:",
            "            httpGet: {path: /readyz, port: %d}"
            % (v.http_port + i),
            "            initialDelaySeconds: 10",
            "            periodSeconds: 3",
            "          volumeMounts:",
            "            - {name: ipt-run, mountPath: /run/ipt}",
            "            - {name: ipt-rules, mountPath: /etc/ipt/rules}",
            "            - {name: ipt-spool, mountPath: %s}" % v.spool_dir,
            "            - {name: ipt-lkg, mountPath: %s}" % v.lkg_dir,
        ]
    # postanalytics consolidator — shares the pod's spool emptyDir (a
    # separate Deployment could never see it; emptyDir is pod-local)
    out += [
        "        - name: postanalytics",
        "          image: %s" % v.image,
        "          command:",
        "            - python",
        "            - -m",
        "            - ingress_plus_tpu_torch.post.export",
        "            - --spool-dir",
        "            - %s" % v.spool_dir,
        "            - --interval-s",
        "            - \"%g\"" % v.export_interval_s,
    ]
    if v.export_url:
        out += [
            "            - --url",
            "            - %s" % v.export_url,
        ]
    out += [
        "          volumeMounts:",
        "            - {name: ipt-spool, mountPath: %s}" % v.spool_dir,
    ]
    return "\n".join(out) + "\n"


def render_service(v: DeployValues) -> str:
    out = [
        "apiVersion: v1",
        "kind: Service",
        "metadata:",
        "  name: %s-metrics" % v.name,
        "  namespace: %s" % v.namespace,
        "spec:",
        "  selector: {app: %s-controller}" % v.name,
        "  ports:",
        "    - {name: sidecar-status, port: %d}" % v.status_port,
    ]
    for i in range(v.chips_per_host):
        out.append("    - {name: serve-%d-http, port: %d}"
                   % (i, v.http_port + i))
    return "\n".join(out) + "\n"


def _fleet_socket(i: int) -> str:
    return "/run/ipt/fleet-%d.sock" % i


def render_fleet(v: DeployValues) -> str:
    """The fleet pod: N detection replicas behind ONE
    shared admission front, the telemetry aggregator scraping all of
    them, and the continuous retune daemon closing the loop.  Every
    replica carries its own /readyz readiness probe (the front stops
    routing to an unready node before k8s does); the front's own
    readiness is 503-when-zero-nodes-up, so the Service only pulls the
    POD when the whole fleet inside is dark — one dead replica is a
    capacity event, not a service event."""
    # fleet replicas' HTTP planes start well clear of the single-pod
    # tier (http_port..+chips) AND the aggregator/front ports (99xx)
    node_port = v.http_port + 40
    backends = ",".join("n%d=%s@127.0.0.1:%d"
                        % (i, _fleet_socket(i), node_port + i)
                        for i in range(v.fleet_nodes))
    out = [
        "apiVersion: apps/v1",
        "kind: Deployment",
        "metadata:",
        "  name: %s-fleet" % v.name,
        "  namespace: %s" % v.namespace,
        "spec:",
        "  replicas: 1",
        "  selector:",
        "    matchLabels: {app: %s-fleet}" % v.name,
        "  template:",
        "    metadata:",
        "      labels: {app: %s-fleet}" % v.name,
        "    spec:",
        "      volumes:",
        "        - name: ipt-run",
        "          emptyDir: {}",
        "        - name: ipt-rules",
        "          configMap: {name: %s}" % v.rules_configmap,
        "        # ONE shared LKG dir for the whole fleet: the fleet",
        "        # rollout journal, the FLEET_LKG pointer, and the",
        "        # retune daemon's cycle ledger all live here — a node",
        "        # (or the daemon) restarting mid-rollout converges to",
        "        # this, not to whatever it was serving",
        "        - name: ipt-fleet-lkg",
        "          emptyDir: {}",
        "      containers:",
    ]
    for i in range(v.fleet_nodes):
        out += [
            "        - name: serve-%d" % i,
            "          image: %s" % v.image,
            "          command:",
            "            - python",
            "            - -m",
            "            - ingress_plus_tpu_torch.serve",
            "            - --socket",
            "            - %s" % _fleet_socket(i),
            "            - --mode",
            "            - %s" % v.mode,
            "            - --rules-dir",
            "            - /etc/ipt/rules",
            "            - --max-batch",
            "            - \"%d\"" % v.max_batch,
            "            - --max-delay-us",
            "            - \"%d\"" % v.batch_window_us,
            "            - --http-port",
            "            - \"%d\"" % (node_port + i),
            "            - --lkg-dir",
            "            - %s" % v.lkg_dir,
            "          resources:",
            "            limits: {nvidia.com/gpu: 1}",
            "          livenessProbe:",
            "            httpGet: {path: /healthz, port: %d}"
            % (node_port + i),
            "            initialDelaySeconds: 30",
            "            periodSeconds: 5",
            "          readinessProbe:",
            "            httpGet: {path: /readyz, port: %d}"
            % (node_port + i),
            "            initialDelaySeconds: 10",
            "            periodSeconds: 3",
            "          volumeMounts:",
            "            - {name: ipt-run, mountPath: /run/ipt}",
            "            - {name: ipt-rules, mountPath: /etc/ipt/rules}",
            "            - {name: ipt-fleet-lkg, mountPath: %s}" % v.lkg_dir,
        ]
    out += [
        "        # the shared admission front (serve/front.py): one",
        "        # listener, least-loaded routing, retry-on-connect,",
        "        # half-open canary re-admission; when EVERY node is",
        "        # down it serves the fail-open verdict itself",
        "        - name: front",
        "          image: %s" % v.image,
        "          command:",
        "            - python",
        "            - -m",
        "            - ingress_plus_tpu_torch.serve",
        "            - --front",
        "            - --socket",
        "            - /run/ipt/front.sock",
        "            - --http-port",
        "            - \"%d\"" % v.front_http_port,
    ]
    for i in range(v.fleet_nodes):
        out += [
            "            - --backend",
            "            - n%d=%s@127.0.0.1:%d"
            % (i, _fleet_socket(i), node_port + i),
        ]
    out += [
        "          readinessProbe:",
        "            # 503 only when ZERO backends are up: one dead",
        "            # replica must not pull the pod from rotation",
        "            httpGet: {path: /readyz, port: %d}" % v.front_http_port,
        "            initialDelaySeconds: 5",
        "            periodSeconds: 3",
        "          volumeMounts:",
        "            - {name: ipt-run, mountPath: /run/ipt}",
        "        - name: fleet-aggregator",
        "          image: %s" % v.image,
        "          command:",
        "            - python",
        "            - -m",
        "            - ingress_plus_tpu_torch.control.fleetobs",
        "            - --port",
        "            - \"%d\"" % v.fleet_http_port,
        "            - --interval-s",
        "            - \"%g\"" % v.export_interval_s,
    ]
    for i in range(v.fleet_nodes):
        out += [
            "            - --node",
            "            - n%d=127.0.0.1:%d" % (i, node_port + i),
        ]
    out += [
        "          readinessProbe:",
        "            httpGet: {path: /fleet/healthz, port: %d}"
        % v.fleet_http_port,
        "            initialDelaySeconds: 5",
        "            periodSeconds: 5",
        "        # the continuous retune daemon (control/retuned.py):",
        "        # watches /fleet/drift, retunes through the four",
        "        # gates, hands the winner to the fleet-staged rollout",
        "        - name: retune-daemon",
        "          image: %s" % v.image,
        "          command:",
        "            - python",
        "            - -m",
        "            - ingress_plus_tpu_torch.control.retuned",
        "            - --fleet-url",
        "            - 127.0.0.1:%d" % v.fleet_http_port,
        "            - --lkg-dir",
        "            - %s" % v.lkg_dir,
        "            - --min-interval-s",
        "            - \"%g\"" % v.retune_min_interval_s,
        "            - --cooldown-s",
        "            - \"%g\"" % v.retune_cooldown_s,
    ]
    for i in range(v.fleet_nodes):
        out += [
            "            - --node",
            "            - n%d=127.0.0.1:%d" % (i, node_port + i),
        ]
    out += [
        "          volumeMounts:",
        "            - {name: ipt-fleet-lkg, mountPath: %s}" % v.lkg_dir,
        "---",
        "apiVersion: v1",
        "kind: Service",
        "metadata:",
        "  name: %s-fleet" % v.name,
        "  namespace: %s" % v.namespace,
        "spec:",
        "  selector: {app: %s-fleet}" % v.name,
        "  ports:",
        "    - {name: front-http, port: %d}" % v.front_http_port,
        "    - {name: fleet-http, port: %d}" % v.fleet_http_port,
    ]
    # the fleet replicas' HTTP planes are scraped pod-locally by the
    # aggregator; only the rollups leave the pod
    return "\n".join(out) + "\n"


def render_all(v: DeployValues) -> Dict[str, str]:
    """filename → manifest text (the chart's template set)."""
    out = {
        "configmap.yaml": render_configmap(v),
        "deployment.yaml": render_deployment(v),
        "service.yaml": render_service(v),
    }
    if v.fleet_nodes > 0:
        out["fleet.yaml"] = render_fleet(v)
    return out


def write_static(outdir: str | Path,
                 values: DeployValues | None = None) -> List[str]:
    """Regenerate the static manifests (deploy/torch/static)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    v = values or DeployValues()
    written = []
    for name, text in render_all(v).items():
        (outdir / name).write_text(text)
        written.append(name)
    return sorted(written)


if __name__ == "__main__":
    import argparse

    repo = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(prog="ingress_plus_tpu_torch.control.deploy")
    ap.add_argument("outdir", nargs="?",
                    default=str(repo / "deploy" / "torch" / "static"))
    ap.add_argument("--values",
                    default=str(repo / "deploy" / "torch" / "values.yaml"),
                    help="values file driving the render (the chart's "
                         "values.yaml analog)")
    args = ap.parse_args()
    values = None
    if Path(args.values).exists():
        values = DeployValues.from_yaml(Path(args.values).read_text())
        print("values: %s" % args.values)
    for f in write_static(args.outdir, values):
        print("wrote %s" % f)
