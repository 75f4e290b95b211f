"""Control plane — the reference's Go controller re-shaped for the
detection backend (SURVEY.md §2.1), on the port's serve plane.

The reference stack is: k8s informers → annotation extraction → model
build (`Configuration{Servers, Locations}`) → template render (nginx.conf)
→ reload-vs-dynamic decision → data-plane update (SIGHUP or Lua endpoint
POST).  Files here mirror that pipeline one-to-one, minus the parts that
are pure kubernetes plumbing (informers/leader election):

    objects.py      — minimal Ingress/ConfigMap object model
                      (pkg/apis/ingress/types.go† analog)
    annotations.py  — parser framework + wallarm/detection annotation
                      set (internal/ingress/annotations/†)
    config.py       — global config tiers (controller/config/config.go†)
    model.py        — Ingress objects → Configuration model
                      (controller/controller.go† getConfiguration)
    template.py     — model → nginx.conf text incl. detection-backend
                      routing (controller/template/† + nginx.tmpl†)
    sync.py         — syncIngress analog: render, diff, reload-vs-dynamic,
                      push tenant table and ACLs to the serve loop
                      (controller/nginx.go† + configuration.lua† channel)
    admission.py    — dry-run validation webhook (internal/admission/†)
    deploy.py       — values → k8s manifests (the Helm chart analog)
    rollout.py      — guarded ruleset and scoring-head rollout
    fleetobs.py, fleetctl.py, retune.py, retuned.py — the fleet tier
    dbg.py          — inspection CLI (cmd/dbg/main.go†)

The re-exports below import only the standard library: ``python -m
ingress_plus_tpu_torch.control.fleetobs`` (and ``.retuned``) run this
file first, and the fleet tier loads no torch.
"""

from ingress_plus_tpu_torch.control.annotations import Extractor  # noqa: F401
from ingress_plus_tpu_torch.control.config import GlobalConfig  # noqa: F401
from ingress_plus_tpu_torch.control.model import build_configuration  # noqa: F401
from ingress_plus_tpu_torch.control.objects import ConfigMap, Ingress  # noqa: F401
from ingress_plus_tpu_torch.control.template import render  # noqa: F401
