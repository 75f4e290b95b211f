"""Fleet-staged rollout: the guarded-rollout state machine, across nodes.

One pack, N serve nodes (docs/SERVING.md "Fleet serving").  The single-
node RolloutController stages a candidate through shadow → canary →
ramp on ONE process; this module sequences those rollouts across the
fleet so a bad pack is caught by the cheapest possible blast radius:

1. **Central admission** — the candidate clears the static/compile/
   golden-replay gates ONCE, on the canary node.  A rejection here
   touches no traffic anywhere.
2. **Canary node** — the canary node's own staged rollout (shadow
   mirror, ramped canary lanes) runs to LIVE while every sibling keeps
   serving the incumbent.
3. **Node-by-node promote** — siblings admit the already-vetted pack
   one at a time.  Between promotions the fleet observer's skew
   findings act as tripwires: a node serving a generation that is
   neither incumbent nor candidate, or a fresh p99/confirm-share
   outlier on a just-promoted node, halts the wave.
4. **Fleet rollback** — ANY node rejecting (or a tripwire firing)
   rolls the WHOLE fleet back to the fleet LKG pointer: one artifact,
   one per-node ack ledger.  The journal is rewritten at every
   transition, so a controller that crashes mid-wave converges every
   node back to LKG at restart (``recover()``) — the fleet never stays
   split-brained between generations.

The fleet LKG pointer (``FLEET_LKG``) is separate from each node's own
LKG: it names the last pack that went live on EVERY node, plus which
version each node last acknowledged.  Writes are write-then-rename,
like control/rollout.py's per-node pointer.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ingress_plus_tpu_torch.control.rollout import (
    LIVE,
    REJECTED,
    ROLLED_BACK,
    RolloutController,
    RolloutRejected,
    persist_lkg,
)
from ingress_plus_tpu_torch.utils import faults

FLEET_IDLE = "idle"
FLEET_ADMITTED = "admitted"
FLEET_CANARY = "canary"
FLEET_PROMOTING = "promoting"
FLEET_LIVE = "live"
FLEET_ROLLED_BACK = "rolled_back"

FLEET_STATES = (FLEET_IDLE, FLEET_ADMITTED, FLEET_CANARY,
                FLEET_PROMOTING, FLEET_LIVE, FLEET_ROLLED_BACK)

FLEET_LKG_POINTER = "FLEET_LKG"
FLEET_JOURNAL = "fleet_rollout.json"

#: skew kinds that halt a promotion wave when they name a node the wave
#: already touched (generation skew is handled separately — it is
#: EXPECTED mid-wave between promoted and pending nodes)
TRIPWIRE_KINDS = ("p99_outlier", "confirm_share_outlier")


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def load_fleet_lkg(lkg_dir) -> Optional[dict]:
    """The fleet pointer: {"artifact", "version", "acks"} or None."""
    ptr = Path(lkg_dir) / FLEET_LKG_POINTER
    if not ptr.is_file():
        return None
    try:
        return json.loads(ptr.read_text())
    except (OSError, ValueError):
        return None


def load_fleet_lkg_pack(lkg_dir):
    """CompiledRuleset behind the fleet pointer, or None."""
    from ingress_plus_tpu_torch.compiler.ruleset import CompiledRuleset

    meta = load_fleet_lkg(lkg_dir)
    if meta is None:
        return None
    try:
        faults.raise_if("lkg_corrupt")
        return CompiledRuleset.load(Path(lkg_dir) / meta["artifact"])
    except Exception:
        return None


class FleetNode:
    """fleetctl's handle on one serve node (in-process flavor): its
    batcher (for direct LKG convergence) and its RolloutController
    (for staged rollouts).  ``HttpFleetNode`` is the wire twin — same
    surface over /configuration/ruleset + /rollout."""

    def __init__(self, name: str, batcher, rollout: RolloutController):
        self.name = name
        self.batcher = batcher
        self.rollout = rollout

    @property
    def serving_version(self) -> str:
        return self.batcher.pipeline.ruleset.version

    def admit(self, ruleset=None, artifact_path=None,
              overrides=None) -> dict:
        return self.rollout.admit(ruleset=ruleset,
                                  artifact_path=artifact_path,
                                  overrides=overrides)

    def pump(self) -> None:
        self.rollout.tick()

    def state(self) -> str:
        return self.rollout.state

    def candidate_version(self) -> str:
        return self.rollout.status().get("candidate") or ""

    def failure_reason(self) -> str:
        ro = self.rollout
        return (ro.rollback_reason
                or (ro.last_admission or {}).get("reason", "")
                or ro.state)

    def abort(self, reason: str) -> bool:
        return self.rollout.abort(reason)

    def incumbent_pack(self):
        return self.batcher.pipeline.ruleset

    def converge_to(self, cr, artifact=None) -> bool:
        """Force-install ``cr`` (rollback/recovery path — the staged
        machinery is exactly what we're converging away from)."""
        if cr is None:
            return False
        if self.serving_version == cr.version:
            return True
        try:
            self.batcher.swap_ruleset(cr)
            return True
        except Exception:
            return False

    def status_brief(self) -> dict:
        st = self.rollout.status()
        return {"name": self.name,
                "generation": self.serving_version,
                "rollout_state": st["state"],
                "candidate": st["candidate"],
                "fraction": st["fraction"]}


class HttpFleetNode:
    """The wire twin of FleetNode for deployed fleets: staged rollouts
    ride POST /configuration/ruleset?mode=staged (artifact paths on a
    shared volume — deploy/ mounts the LKG dir fleet-wide), state rides
    GET /rollout, and LKG convergence is the break-glass ?mode=force
    swap.  Rulesets can only travel by artifact path here."""

    def __init__(self, name: str, target: str, timeout_s: float = 30.0):
        self.name = name
        self.target = target          # "host:port"
        self.timeout_s = timeout_s

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None) -> dict:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            "http://%s%s" % (self.target, path),
            data=(json.dumps(payload).encode()
                  if payload is not None else None),
            headers={"Content-Type": "application/json"},
            method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:  # structured 4xx bodies
            try:
                return json.loads(e.read() or b"{}")
            except ValueError:
                return {"error": "http %d" % e.code}
        except (urllib.error.URLError, OSError) as e:
            # an unreachable node must surface as a node-level failure
            # (converge_failed / unreachable), never an exception — a
            # dead node is precisely when fleet_rollback runs, and it
            # promises "partial failures are reported, not raised"
            return {"error":
                    "unreachable: %s" % (getattr(e, "reason", None) or e)}

    @property
    def serving_version(self) -> str:
        st = self._call("GET", "/rollout")
        return str(st.get("incumbent", ""))

    def admit(self, ruleset=None, artifact_path=None,
              overrides=None) -> dict:
        if artifact_path is None:
            raise RolloutRejected(
                "load", "no_artifact", "",
                {"error": "HTTP nodes admit artifact paths only"})
        payload = {"path": str(artifact_path)}
        payload.update(overrides or {})
        rep = self._call("POST", "/configuration/ruleset?mode=staged",
                         payload)
        if rep.get("rejected") or rep.get("error"):
            raise RolloutRejected(
                rep.get("stage", "admit"),
                rep.get("reason", rep.get("error", "rejected")),
                str(artifact_path), rep)
        return rep

    def pump(self) -> None:
        pass  # the remote batcher ticks its own rollout

    def state(self) -> str:
        st = self._call("GET", "/rollout")
        if "state" not in st and st.get("error"):
            return "unreachable"
        return str(st.get("state", "idle"))

    def candidate_version(self) -> str:
        return str(self._call("GET", "/rollout").get("candidate") or "")

    def failure_reason(self) -> str:
        st = self._call("GET", "/rollout")
        return str(st.get("rollback_reason") or st.get("error")
                   or st.get("state", ""))

    def abort(self, reason: str) -> bool:
        return bool(self._call("POST", "/rollout",
                               {"action": "abort"}).get("aborted"))

    def incumbent_pack(self):
        return None  # pack bytes live on the node, not here

    def converge_to(self, cr, artifact=None) -> bool:
        if artifact is None:
            return False
        if cr is not None and self.serving_version == cr.version:
            return True
        rep = self._call("POST", "/configuration/ruleset?mode=force",
                         {"path": str(artifact)})
        return bool(rep.get("ruleset"))

    def status_brief(self) -> dict:
        st = self._call("GET", "/rollout")
        return {"name": self.name,
                "generation": st.get("incumbent"),
                "rollout_state": st.get("state", "unreachable"),
                "candidate": st.get("candidate"),
                "fraction": st.get("fraction")}


class FleetController:
    """Sequences per-node staged rollouts; owns the fleet LKG pointer,
    the per-node ack ledger, and the crash-recovery journal."""

    def __init__(self, nodes: List[FleetNode], lkg_dir,
                 observer=None,
                 traffic_pump: Optional[Callable[[FleetNode], None]]
                 = None):
        if not nodes:
            raise ValueError("a fleet needs at least one node")
        self.nodes = list(nodes)
        self.lkg_dir = Path(lkg_dir)
        self.lkg_dir.mkdir(parents=True, exist_ok=True)
        self.observer = observer       # FleetObserver | None (tripwires)
        self.traffic_pump = traffic_pump
        self.state = FLEET_IDLE
        self.candidate_version = ""
        self.incumbent_version = ""
        self.rollback_reason = ""
        self.rollbacks = 0
        self.fleet_promotions = 0
        self.acks: Dict[str, str] = {}     # node → acked pack version
        self.last_admission: Optional[dict] = None
        self.last_recovery: Optional[dict] = None
        self._idx = 0                      # node currently rolling
        self._candidate_src: dict = {}
        self._candidate_cr = None          # CompiledRuleset | None
        self._tripwire_seen: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------- ledger / journal

    @property
    def journal_path(self) -> Path:
        return self.lkg_dir / FLEET_JOURNAL

    def _write_journal(self) -> None:
        _atomic_write(self.journal_path, json.dumps({
            "state": self.state,
            "candidate": self.candidate_version,
            "incumbent": self.incumbent_version,
            "node_idx": self._idx,
            "acks": dict(self.acks),
            "rollback_reason": self.rollback_reason,
            "nodes": [n.name for n in self.nodes],
            "updated": time.time(),
        }, indent=1))

    def _write_fleet_lkg(self, cr) -> None:
        """Persist the pack + move the fleet pointer (atomic)."""
        base = persist_lkg(cr, self.lkg_dir)
        _atomic_write(self.lkg_dir / FLEET_LKG_POINTER, json.dumps({
            "artifact": base.name,
            "version": cr.version,
            "acks": {n.name: n.serving_version for n in self.nodes},
            "updated": time.time(),
        }))

    def _ensure_fleet_lkg(self) -> None:
        """Before the first wave ever: the incumbent IS the LKG (a
        rollback target must exist before anything can need one)."""
        if load_fleet_lkg(self.lkg_dir) is not None:
            return
        inc = self.nodes[0].incumbent_pack()
        if inc is not None:
            self._write_fleet_lkg(inc)

    # ------------------------------------------------------ admission

    def begin(self, ruleset=None, artifact_path=None,
              overrides: Optional[dict] = None) -> dict:
        """Central admission on the canary node.  Returns the admission
        report; a rejection leaves the fleet idle and untouched."""
        with self._lock:
            if self.state in (FLEET_ADMITTED, FLEET_CANARY,
                              FLEET_PROMOTING):
                raise RuntimeError("fleet rollout already in flight "
                                   "(state=%s)" % self.state)
            self.state = FLEET_ADMITTED
        self.incumbent_version = self.nodes[0].serving_version
        self.rollback_reason = ""
        self.acks = {}
        self._idx = 0
        self._tripwire_seen = set()
        self._candidate_src = {"ruleset": ruleset,
                               "artifact_path": artifact_path,
                               "overrides": overrides}
        self._candidate_cr = ruleset
        if ruleset is None and artifact_path is not None:
            try:
                from ingress_plus_tpu_torch.compiler.ruleset import \
                    CompiledRuleset

                self._candidate_cr = CompiledRuleset.load(artifact_path)
            except Exception:
                self._candidate_cr = None
        self._ensure_fleet_lkg()
        try:
            report = self.nodes[0].admit(ruleset=ruleset,
                                         artifact_path=artifact_path,
                                         overrides=overrides)
        except RolloutRejected as e:
            with self._lock:
                self.state = FLEET_IDLE
            self.last_admission = {"ok": False, **e.report}
            self._write_journal()
            return self.last_admission
        self.candidate_version = self.nodes[0].candidate_version()
        self.last_admission = {"ok": True, **report}
        with self._lock:
            self.state = FLEET_CANARY
        self._write_journal()
        return self.last_admission

    # ------------------------------------------------------ the wave

    def _check_tripwires(self) -> Optional[str]:
        if self.observer is None:
            return None
        try:
            findings = self.observer.healthz().get("skew_findings") or []
        except Exception:
            return None
        touched = set(self.acks) | {self.nodes[self._idx].name
                                    if self._idx < len(self.nodes)
                                    else ""}
        expected = {self.incumbent_version, self.candidate_version}
        for f in findings:
            kind, node = f.get("kind"), f.get("node")
            key = (kind, node, f.get("detail"))
            if key in self._tripwire_seen:
                continue
            if kind in TRIPWIRE_KINDS and node in touched:
                self._tripwire_seen.add(key)
                return "%s:%s" % (kind, node)
            if kind == "generation_skew":
                # mid-wave incumbent/candidate split is the PLAN; a
                # generation outside that pair is an alien pack.  Only
                # the node's OWN generation decides (the detail string
                # also names the fleet majority, which almost always IS
                # incumbent or candidate — matching against it would
                # never flag the alien node)
                gen = f.get("generation")
                if gen is None:  # older observers: first %r in detail
                    m = re.match(r"serving pack generation '([^']*)'",
                                 f.get("detail", ""))
                    gen = m.group(1) if m else None
                if gen is not None and gen not in expected:
                    self._tripwire_seen.add(key)
                    return "alien_generation:%s" % node
        return None

    def poll(self) -> str:
        """Advance the wave one step.  Call from the control loop (the
        retune daemon / drill pump); traffic itself rides the nodes."""
        if self.state not in (FLEET_CANARY, FLEET_PROMOTING):
            return self.state
        tripped = self._check_tripwires()
        if tripped:
            self.fleet_rollback("skew_tripwire:" + tripped)
            return self.state
        node = self.nodes[self._idx]
        node.pump()
        st = node.state()
        if st in (REJECTED, ROLLED_BACK):
            self.fleet_rollback("node:%s:%s"
                                % (node.name, node.failure_reason()))
            return self.state
        if st != LIVE or node.serving_version != self.candidate_version:
            return self.state
        # node done: ack it, move the wave on
        self.acks[node.name] = self.candidate_version
        self._idx += 1
        if self._idx >= len(self.nodes):
            self._finalize()
            return self.state
        with self._lock:
            self.state = FLEET_PROMOTING
        self._write_journal()
        nxt = self.nodes[self._idx]
        try:
            nxt.admit(**self._candidate_src)
        except RolloutRejected as e:
            self.fleet_rollback("node:%s:admission:%s"
                                % (nxt.name, e.report.get("reason")))
        return self.state

    def _finalize(self) -> None:
        strays = [n.name for n in self.nodes
                  if n.serving_version != self.candidate_version]
        if strays:
            self.fleet_rollback("post_wave_divergence:%s"
                                % ",".join(strays))
            return
        cr = self._candidate_cr or self.nodes[0].incumbent_pack()
        if cr is not None:
            self._write_fleet_lkg(cr)
        with self._lock:
            self.state = FLEET_LIVE
            self.fleet_promotions += 1
        self._write_journal()

    def drive(self, deadline_s: float = 120.0) -> str:
        """Pump the wave to a terminal state (in-process harnesses: the
        traffic_pump supplies each node's rollout the traffic it needs
        to walk its ramp)."""
        deadline = time.monotonic() + deadline_s
        while (self.state in (FLEET_CANARY, FLEET_PROMOTING)
               and time.monotonic() < deadline):
            if self.traffic_pump is not None:
                self.traffic_pump(self.nodes[min(self._idx,
                                                 len(self.nodes) - 1)])
            self.poll()
        return self.state

    # ------------------------------------------------------ rollback

    def fleet_rollback(self, reason: str) -> dict:
        """Converge EVERY node to the fleet LKG: abort in-flight
        rollouts, force-install the LKG pack wherever the serving
        generation differs.  Partial failures are reported, not
        raised — a node that cannot converge is an operator page."""
        with self._lock:
            self.state = FLEET_ROLLED_BACK
            self.rollback_reason = reason
            self.rollbacks += 1
        lkg_cr = load_fleet_lkg_pack(self.lkg_dir)
        meta = load_fleet_lkg(self.lkg_dir)
        artifact = (self.lkg_dir / meta["artifact"]
                    if meta and meta.get("artifact") else None)
        per_node = {}
        for n in self.nodes:
            n.abort("fleet_rollback:" + reason)
            if lkg_cr is None and artifact is None:
                per_node[n.name] = "no_fleet_lkg"
                continue
            ok = n.converge_to(lkg_cr, artifact)
            per_node[n.name] = "converged" if ok else "converge_failed"
            if ok and lkg_cr is not None:
                self.acks[n.name] = lkg_cr.version
        self._write_journal()
        report = {"reason": reason, "nodes": per_node,
                  "lkg": getattr(lkg_cr, "version", None)}
        self.last_recovery = report
        return report

    # ------------------------------------------------------ recovery

    def recover(self) -> dict:
        """Crash-mid-wave convergence: if the journal says a rollout
        was in flight, every node converges to the fleet LKG before
        anything else happens.  Idempotent; safe to call at every
        startup."""
        try:
            journal = json.loads(self.journal_path.read_text())
        except (OSError, ValueError):
            return {"recovered": False, "why": "no journal"}
        if journal.get("state") not in (FLEET_ADMITTED, FLEET_CANARY,
                                        FLEET_PROMOTING,
                                        FLEET_ROLLED_BACK):
            return {"recovered": False,
                    "why": "journal state %r is terminal"
                           % journal.get("state")}
        lkg_cr = load_fleet_lkg_pack(self.lkg_dir)
        if lkg_cr is None:
            return {"recovered": False, "why": "no fleet LKG pack"}
        meta = load_fleet_lkg(self.lkg_dir)
        artifact = (self.lkg_dir / meta["artifact"]
                    if meta and meta.get("artifact") else None)
        per_node = {}
        for n in self.nodes:
            n.abort("fleet_recovery")
            ok = n.converge_to(lkg_cr, artifact)
            per_node[n.name] = "converged" if ok else "converge_failed"
            if ok:
                self.acks[n.name] = lkg_cr.version
        with self._lock:
            self.state = FLEET_IDLE
            self.candidate_version = ""
            self.rollback_reason = "recovered:%s" % journal.get("state")
        self._write_journal()
        report = {"recovered": True,
                  "from_state": journal.get("state"),
                  "lkg": lkg_cr.version, "nodes": per_node}
        self.last_recovery = report
        return report

    # ------------------------------------------------------ status

    def status(self) -> dict:
        with self._lock:
            idx = self._idx
            return {
                "state": self.state,
                "candidate": self.candidate_version or None,
                "incumbent": self.incumbent_version or None,
                "node_idx": idx,
                "rollbacks": self.rollbacks,
                "fleet_promotions": self.fleet_promotions,
                "rollback_reason": self.rollback_reason,
                "acks": dict(self.acks),
                "lkg": load_fleet_lkg(self.lkg_dir),
                "nodes": [{
                    **n.status_brief(),
                    "stage": ("done" if n.name in self.acks
                              else "rolling" if (i == idx and self.state
                                                 in (FLEET_CANARY,
                                                     FLEET_PROMOTING))
                              else "pending"),
                    "acked": self.acks.get(n.name),
                } for i, n in enumerate(self.nodes)],
            }


# ===================================================== node harness
# In-process fleet for drills/scenarios: each node is a real Batcher +
# ServeLoop with its UDS plane served from a background thread, so the
# front speaks to it over the actual wire — and ``kill()`` severs the
# listener AND every established connection, exactly like SIGKILL.


class NodeHarness:
    """One in-process serve node with a kill/revive switch."""

    def __init__(self, name: str, batcher, socket_path: str):
        from ingress_plus_tpu_torch.serve.server import ServeLoop

        self.name = name
        self.batcher = batcher
        self.socket_path = socket_path
        self.serve = ServeLoop(batcher, socket_path=socket_path)
        #: False between ``kill()`` and ``revive()``: a killed process
        #: answers no readiness probe either
        self.alive = True
        self._loop = None
        self._stop_ev = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        import asyncio

        ready = threading.Event()

        def _run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            stop = asyncio.Event()
            self._stop_ev = stop

            async def _main() -> None:
                await self.serve.start()
                ready.set()
                await stop.wait()
                for s in self.serve._servers:
                    s.close()
                self.serve._servers = []

            try:
                loop.run_until_complete(_main())
            finally:
                loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="node-" + self.name)
        self._thread.start()
        if not ready.wait(timeout=15):
            raise RuntimeError("node %s failed to start" % self.name)

    def kill(self) -> None:
        """Sever the node's wire presence (listener + live conns) and
        fail its readiness probe; the batcher stays warm so
        ``revive()`` is instant."""
        self.alive = False
        done = threading.Event()

        def _k() -> None:
            for s in self.serve._servers:
                s.close()
            self.serve._servers = []
            for w in list(self.serve._conn_writers):
                try:
                    w.transport.abort()
                except Exception:
                    pass
            done.set()

        if self._loop is not None:
            self._loop.call_soon_threadsafe(_k)
            done.wait(timeout=10)

    def revive(self) -> None:
        import asyncio

        if self._loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(self.serve.start(),
                                               self._loop)
        fut.result(timeout=15)
        self.alive = True

    def close(self) -> None:
        if self._loop is not None and self._stop_ev is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.batcher.close()


def build_drill_fleet(n_nodes: int, lkg_dir,
                      socket_prefix: Optional[str] = None,
                      observer: bool = False, device=None, **batcher_kw):
    """N in-process drill nodes (incumbent pack) on ``device`` (None =
    the CUDA card, "cpu" for the plain scan) + a front over them + a
    FleetController wired with the drill traffic pump.  Socket paths are
    ``<socket_prefix>-<pid>-<node>.sock``, moved under ``/tmp`` where
    that would not fit AF_UNIX (``utils/uds.py socket_path``).  Returns
    (harnesses, front, fleet, obs) — caller owns teardown."""
    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.control.rollout import (
        _DRILL_INCUMBENT, _drill_config, _drill_traffic)
    from ingress_plus_tpu_torch.serve.front import BackendNode, FrontLoop
    from ingress_plus_tpu_torch.utils.faults import _mk_batcher
    from ingress_plus_tpu_torch.utils.uds import socket_path

    import tempfile

    if socket_prefix is None:
        socket_prefix = os.path.join(tempfile.gettempdir(), "ipt-fdrill")

    def sock(node) -> str:
        return socket_path(os.path.dirname(socket_prefix), "%s-%d-%s.sock" % (
            os.path.basename(socket_prefix), os.getpid(), node))

    cr_inc = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
    harnesses = []
    fleet_nodes = []
    for i in range(n_nodes):
        b = _mk_batcher(cr=cr_inc, device=device, **batcher_kw)
        ro = RolloutController(b, _drill_config())
        b.rollout = ro
        h = NodeHarness("n%d" % i, b, sock(i))
        h.start()
        harnesses.append(h)
        fleet_nodes.append(FleetNode(h.name, b, ro))

    obs = None
    if observer:
        from ingress_plus_tpu_torch.control.fleetobs import (
            FleetObserver, serve_loop_transport)

        obs = FleetObserver()
        for h in harnesses:
            obs.add_node(h.name,
                         transport=serve_loop_transport(h.serve))

    # a killed node fails its probe as a SIGKILLed process would: the
    # front ejects it even when no request happens to route there
    backends = [BackendNode(
        name=h.name, socket_path=h.socket_path,
        probe=(lambda h=h: h.alive and
               h.serve.http_get("/readyz")[0].startswith("200")))
        for h in harnesses]
    front = FrontLoop(backends, sock("front"), probe_interval_s=0.2)
    front.start_background()

    wave = [0]

    def _pump(node: FleetNode) -> None:
        wave[0] += 1
        _drill_traffic(node.batcher, 24, "fleet%d" % wave[0])

    fleet = FleetController(fleet_nodes, lkg_dir, observer=obs,
                            traffic_pump=_pump)
    return harnesses, front, fleet, obs


def run_fleet_drill(lkg_dir=None, device=None) -> dict:
    """Drive the whole fleet control plane end to end in one process,
    every node's batcher on ``device`` — a caller gates on ``passed``:

    1. **front_kill** — a 3-node front wave with one node killed
       mid-send: zero verdict loss, no silent unblocked attacks;
    2. **fleet_live** — the good candidate admitted once centrally,
       canaried, promoted node by node to LIVE everywhere, fleet LKG
       written with every ack;
    3. **bad_pack_rejected** — the broken pack stopped at central
       admission, fleet untouched;
    4. **mid_wave_rollback** — a node failing mid-promote rolls the
       WHOLE fleet back to the fleet LKG;
    5. **daemon_cycle** — one forced retune-daemon cycle end to end:
       profile → four gates → fleet-staged rollout to LIVE.
    """
    import tempfile

    from ingress_plus_tpu_torch.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu_torch.compiler.seclang import parse_seclang
    from ingress_plus_tpu_torch.control.rollout import (
        _DRILL_BROKEN, _DRILL_CANDIDATE, _DRILL_INCUMBENT)
    from ingress_plus_tpu_torch.control.retuned import ROLLOUT_LIVE, RetuneDaemon
    from ingress_plus_tpu_torch.utils import faults
    from ingress_plus_tpu_torch.utils.faults import FaultPlan, _front_wave

    tmp = None
    if lkg_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="ipt-fleetdrill-")
        lkg_dir = tmp.name
    report: Dict[str, dict] = {}
    saved = faults.active()
    faults.clear()
    harnesses, front, fleet, obs = build_drill_fleet(
        3, lkg_dir, socket_prefix=os.path.join(tempfile.gettempdir(), "ipt-fleetdrill"),
        observer=True,
        device=device)
    live = [(harnesses, front)]   # whichever build the finally must reap
    try:
        # --- leg 1: node killed mid-wave behind the front
        violations: List[str] = []
        faults.install(FaultPlan.from_spec("node_kill:times=1"))
        _front_wave(front, 32, "warm", violations)
        got = _front_wave(front, 64, "kill", violations,
                          kill=harnesses[1].kill)
        faults.clear()
        report["front_kill"] = {
            "ok": len(got) == 64 and not violations,
            "verdicts": len(got), "sent": 64,
            "violations": violations,
        }
        harnesses[1].revive()

        # --- leg 2: good pack to LIVE fleet-wide
        cr_good = compile_ruleset(parse_seclang(_DRILL_CANDIDATE))
        adm = fleet.begin(ruleset=cr_good)
        state = fleet.drive(deadline_s=120) if adm.get("ok") else fleet.state
        lkg = load_fleet_lkg(lkg_dir)
        report["fleet_live"] = {
            "ok": (state == FLEET_LIVE
                   and all(n.serving_version == cr_good.version
                           for n in fleet.nodes)
                   and bool(lkg) and lkg["version"] == cr_good.version
                   and len(lkg["acks"]) == len(fleet.nodes)),
            "state": state, "acks": dict(fleet.acks),
            "lkg": lkg and lkg["version"],
        }

        # --- leg 3: broken pack stopped at central admission
        cr_bad = compile_ruleset(parse_seclang(_DRILL_BROKEN))
        adm = fleet.begin(ruleset=cr_bad)
        report["bad_pack_rejected"] = {
            "ok": (not adm.get("ok") and fleet.state == FLEET_IDLE
                   and all(n.serving_version == cr_good.version
                           for n in fleet.nodes)),
            "stage": adm.get("stage"), "reason": adm.get("reason"),
        }

        # --- leg 4: mid-wave node failure → fleet rollback to LKG
        cr_inc = compile_ruleset(parse_seclang(_DRILL_INCUMBENT))
        adm = fleet.begin(ruleset=cr_inc)
        faults.install(FaultPlan.from_spec("swap_fail:after=1,times=1"))
        state = fleet.drive(deadline_s=120) if adm.get("ok") else fleet.state
        faults.clear()
        report["mid_wave_rollback"] = {
            "ok": (state == FLEET_ROLLED_BACK
                   and all(n.serving_version == cr_good.version
                           for n in fleet.nodes)),
            "state": state, "reason": fleet.rollback_reason,
        }

        # --- leg 5: one forced daemon cycle end to end.  Fresh fleet:
        # the kill/rollback legs above left REAL timing skew behind
        # (which the tripwires would rightly act on — that is their
        # job); the daemon leg proves the happy path on a steady-state
        # fleet like the one a deployed daemon watches.
        front.stop()
        for h in harnesses:
            h.close()
        live.clear()
        harnesses, front, fleet, obs = build_drill_fleet(
            3, os.path.join(lkg_dir, "daemon"),
            socket_prefix=os.path.join(tempfile.gettempdir(),
                                       "ipt-fleetdrill2"),
            observer=True,
            device=device)
        live.append((harnesses, front))
        daemon = RetuneDaemon(obs, fleet, lkg_dir,
                              rules=parse_seclang(_DRILL_INCUMBENT),
                              min_interval_s=0.0, cooldown_s=0.0,
                              retune_kw={"corpus_n": 64, "ab": False,
                                         "staged": False,
                                         "device": device})
        for node in fleet.nodes:      # an even profile on every node
            fleet.traffic_pump(node)
        obs.scrape()
        rec = daemon.cycle(force=True)
        report["daemon_cycle"] = {
            "ok": (rec["result"] == ROLLOUT_LIVE
                   and all(n.serving_version == rec.get("candidate")
                           for n in fleet.nodes)),
            "result": rec["result"], "detail": rec.get("detail", ""),
            "candidate": rec.get("candidate"),
            "gates": rec.get("gates"),
        }
        return {"passed": all(leg["ok"] for leg in report.values()),
                "legs": report}
    finally:
        faults.clear()
        if saved is not None:
            faults.install(saved)
        for hs, fr in live:
            fr.stop()
            for h in hs:
                h.close()
        if tmp is not None:
            tmp.cleanup()
