"""The port's post plane against the JAX package's, on the CPU.

Analogs of ``tests/test_post.py``: each case drives the JAX classes and
the port's with identical inputs (hits with fixed ``ts``) and holds the
two outputs equal — ``to_dict()`` of every attack, ``status()`` and
``snapshot()`` bodies, spooled JSON lines — then asserts what the JAX
test asserts on the port's output.  No tolerance: the outputs are JSON.
Fields read off the wall clock (``uptime_s``, a channel hit's ``ts`` and
``elapsed_us``) are dropped before the comparison.
"""

import json
from dataclasses import asdict
from types import SimpleNamespace

import pytest

import ingress_plus_tpu.post as jpost
import ingress_plus_tpu_torch.post as tpost
from ingress_plus_tpu.post import aggregate as jaggregate
from ingress_plus_tpu.post import brute as jbrute
from ingress_plus_tpu.post import topk as jtopk
from ingress_plus_tpu.serve import normalize as jnormalize
from ingress_plus_tpu_torch.post import aggregate as taggregate
from ingress_plus_tpu_torch.post import brute as tbrute
from ingress_plus_tpu_torch.post import topk as ttopk
from ingress_plus_tpu_torch.serve import normalize as tnormalize


def _ns(post, aggregate, brute, topk, normalize):
    return SimpleNamespace(
        Hit=post.Hit, HitQueue=post.HitQueue, Attack=aggregate.Attack,
        aggregate_attacks=post.aggregate_attacks,
        BruteDetector=post.BruteDetector, BruteConfig=brute.BruteConfig,
        NodeCounters=post.NodeCounters, Exporter=post.Exporter,
        PostChannel=post.PostChannel, RulesetWatcher=post.RulesetWatcher,
        SpaceSaving=topk.SpaceSaving, Request=normalize.Request)


JAX = _ns(jpost, jaggregate, jbrute, jtopk, jnormalize)
PORT = _ns(tpost, taggregate, tbrute, ttopk, tnormalize)


def both(fn):
    """``fn(pkg)`` on the JAX package and on the port; the two results
    must be equal.  Returns the port's."""
    want, got = fn(JAX), fn(PORT)
    assert got == want
    return got


def mk_hit(P, ts=0.0, client="1.2.3.4", tenant=0, classes=("sqli",),
           uri="/a?x=1", attack=True, blocked=True, score=5, rid="r1",
           rule_ids=(942100,)):
    return P.Hit(ts=ts, request_id=rid, tenant=tenant, client=client,
                 method="GET", uri=uri, classes=classes, rule_ids=rule_ids,
                 score=score, blocked=blocked, attack=attack)


def dicts(attacks):
    return [a.to_dict() for a in attacks]


def status(d):
    d = dict(d)
    d.pop("uptime_s", None)
    return d


def hit_fields(hits):
    return [{k: v for k, v in asdict(h).items()
             if k not in ("ts", "elapsed_us")} for h in hits]


# ------------------------------------------------------------------ queue

def test_queue_bounded_drop_oldest():
    def run(P):
        q = P.HitQueue(maxlen=3)
        for i in range(5):
            q.put(mk_hit(P, ts=float(i), rid=str(i)))
        n = (len(q), q.dropped, q.total)
        got = q.drain()
        return n, [asdict(h) for h in got], len(q)

    (n, got, left) = both(run)
    assert n == (3, 2, 5)
    assert [h["request_id"] for h in got] == ["2", "3", "4"]
    assert left == 0


def test_queue_drain_partial():
    def run(P):
        q = P.HitQueue()
        for i in range(10):
            q.put(mk_hit(P, ts=float(i)))
        return len(q.drain(4)), len(q)

    assert both(run) == (4, 6)


# -------------------------------------------------------------- aggregate

def test_aggregate_groups_by_tenant_client_class():
    def run(P):
        hits = [
            mk_hit(P, ts=1, client="a", classes=("sqli",)),
            mk_hit(P, ts=2, client="a", classes=("sqli",), blocked=False),
            mk_hit(P, ts=3, client="b", classes=("sqli",)),
            mk_hit(P, ts=4, client="a", classes=("xss",)),
            mk_hit(P, ts=5, client="a", classes=(), attack=False),
        ]
        return dicts(P.aggregate_attacks(hits, gap_s=60))

    attacks = both(run)
    keys = {(a["client"], a["class"]): a for a in attacks}
    assert set(keys) == {("a", "sqli"), ("b", "sqli"), ("a", "xss")}
    a = keys[("a", "sqli")]
    assert a["count"] == 2 and a["blocked"] == 1
    assert a["first_ts"] == 1 and a["last_ts"] == 2


def test_aggregate_session_window_splits():
    attacks = both(lambda P: dicts(P.aggregate_attacks(
        [mk_hit(P, ts=t) for t in (0, 10, 200, 210)], gap_s=60)))
    assert len(attacks) == 2
    assert sorted(a["count"] for a in attacks) == [2, 2]


def test_aggregate_multiclass_hit_fans_out():
    attacks = both(lambda P: dicts(P.aggregate_attacks(
        [mk_hit(P, classes=("sqli", "xss"))])))
    assert {a["class"] for a in attacks} == {"sqli", "xss"}


def test_aggregate_samples_bounded():
    (a,) = both(lambda P: dicts(P.aggregate_attacks(
        [mk_hit(P, ts=i, rid=str(i), rule_ids=(i,)) for i in range(50)])))
    assert a["count"] == 50
    assert len(a["sample_uris"]) <= PORT.Attack.MAX_SAMPLES
    assert len(a["sample_rule_ids"]) <= PORT.Attack.MAX_SAMPLES


# ------------------------------------------------------------------ brute

def test_brute_detects_auth_burst_once_per_window():
    def run(P):
        det = P.BruteDetector(P.BruteConfig(window_s=60, threshold=5))
        return dicts(det.observe(
            [mk_hit(P, ts=float(i), uri="/wp-login.php", attack=False,
                    blocked=False, classes=()) for i in range(20)]))

    attacks = both(run)
    assert len(attacks) == 1
    assert attacks[0]["class"] == "brute"
    assert attacks[0]["count"] >= 5


def test_brute_ignores_non_auth_and_slow_rates():
    def run(P):
        det = P.BruteDetector(P.BruteConfig(window_s=60, threshold=5))
        slow = [mk_hit(P, ts=float(i * 100), uri="/login", attack=False,
                       classes=()) for i in range(20)]
        other = [mk_hit(P, ts=float(i), uri="/search?q=x", attack=False,
                        classes=()) for i in range(20)]
        return dicts(det.observe(slow)), dicts(det.observe(other))

    assert both(run) == ([], [])


def test_brute_separate_clients_tracked_separately():
    def run(P):
        det = P.BruteDetector(P.BruteConfig(window_s=60, threshold=10))
        return dicts(det.observe(
            [mk_hit(P, ts=float(i), uri="/auth", client="c%d" % (i % 4),
                    attack=False, classes=()) for i in range(36)]))

    assert both(run) == []     # 9 per client < 10


def test_dirbust_count_is_distinct_paths_not_window_hits():
    def run(P):
        det = P.BruteDetector(P.BruteConfig(
            window_s=60, threshold=1000, dirbust_threshold=10,
            dirbust_window_s=60))
        hits, t = [], 0.0
        for i in range(12):             # 12 distinct paths...
            for _ in range(3):          # ...fetched 3x each = 36 hits
                hits.append(mk_hit(P, ts=t, uri="/backup/%02d/config.old"
                                   % i, attack=False, blocked=False,
                                   classes=()))
                t += 0.1
        return dicts(det.observe(hits))

    dirbusts = [a for a in both(run) if a["class"] == "dirbust"]
    assert len(dirbusts) == 1
    d = dirbusts[0]
    assert 10 <= d["count"] <= 12
    assert "distinct paths" in d["sample_points"][0]["value"]


# --------------------------------------------------------------- counters

def test_counters_math():
    def run(P):
        c = P.NodeCounters()
        c.record(attack=True, blocked=True, fail_open=False,
                 classes=["sqli"], tenant=1, mode=2)
        c.record(attack=True, blocked=False, fail_open=False,
                 classes=["xss"], tenant=1, mode=1)
        c.record(attack=False, blocked=False, fail_open=True,
                 classes=[], tenant=0, mode=2)
        return status(c.snapshot())

    s = both(run)
    assert s["requests"] == 3 and s["attacks"] == 2
    assert s["blocked"] == 1 and s["monitored"] == 1
    assert s["fail_open"] == 1
    assert s["by_class"] == {"sqli": 1, "xss": 1}
    assert s["by_tenant"] == {"1": 2}


def test_counters_cardinality_capped():
    def run(P):
        c = P.NodeCounters()
        for i in range(P.NodeCounters.MAX_CLASS_KEYS + 50):
            c.record(attack=True, blocked=False, fail_open=False,
                     classes=["class-%d" % i], tenant=i, mode=1)
        s = status(c.snapshot())
        c.record(attack=True, blocked=False, fail_open=False,
                 classes=["class-0"], tenant=0, mode=1)
        again = c.snapshot()["by_class"]["class-0"]
        c2 = P.NodeCounters()
        for i in range(P.NodeCounters.MAX_TENANT_KEYS + 10):
            c2.record(attack=True, blocked=False, fail_open=False,
                      classes=["sqli"], tenant=i, mode=1)
        c3 = P.NodeCounters()
        c3.record_export_events(
            [{"class": "c%d" % i, "tenant": i}
             for i in range(P.NodeCounters.MAX_EXPORT_KEYS)])
        return s, again, status(c2.snapshot()), status(c3.snapshot())

    s, again, s2, s3 = both(run)
    N = PORT.NodeCounters
    assert len(s["by_class"]) <= N.MAX_CLASS_KEYS
    assert s["by_class"]["other"] >= 50
    assert again == 2
    assert sum(s["by_class"].values()) == s["attacks"]
    from ingress_plus_tpu_torch.control.sync import MAX_TENANTS
    assert N.MAX_TENANT_KEYS == MAX_TENANTS + 1
    assert len(s2["by_tenant"]) <= N.MAX_TENANT_KEYS
    assert s2["by_tenant"]["-1"] >= 10
    assert sum(s2["by_tenant"].values()) == s2["attacks"]
    assert len(s3["export_events"]) <= N.MAX_EXPORT_KEYS
    assert s3["export_events"].get("other", 0) > 0


def test_attack_rule_id_dedup_capped_and_ordered():
    def run(P):
        a = P.Attack(tenant=0, client="c", attack_class="sqli",
                     first_ts=0.0, last_ts=0.0)
        a.add(mk_hit(P, rule_ids=(3, 1, 3, 2)))
        a.add(mk_hit(P, rule_ids=tuple(range(100, 120))))
        return a.to_dict()

    d = both(run)
    assert d["sample_rule_ids"] == [3, 1, 2, 100, 101, 102, 103, 104]
    assert len(d["sample_rule_ids"]) == PORT.Attack.MAX_SAMPLES
    assert "_rid_seen" not in d


def test_space_saving_sketch_topk():
    def run(P):
        sk = P.SpaceSaving(capacity=4)
        for _ in range(50):
            sk.offer("/login")
        for _ in range(30):
            sk.offer("/admin")
        for i in range(20):
            sk.offer("/sweep/%d" % i)
        return sk.items(), sk.items(1)

    items, first = both(run)
    assert len(items) == 4
    top, second = items[0], items[1]
    assert top["key"] == "/login"
    assert top["count"] - top["max_error"] <= 50 <= top["count"]
    assert second["key"] == "/admin"
    assert second["count"] - second["max_error"] <= 30 <= second["count"]
    assert first == [top]


class _V:
    attack = True
    blocked = True
    fail_open = False
    classes = ("sqli",)
    rule_ids = (942100,)
    score = 5


def test_post_channel_top_attacked_in_status():
    def run(P):
        ch = P.PostChannel(brute=False)
        for i in range(5):
            ch.record(P.Request(uri="/login?u=%d" % i, request_id=str(i),
                                tenant=3), _V())
        ch.record(P.Request(uri="/other", request_id="x", tenant=1), _V())
        return status(ch.status())

    st = both(run)
    top = st["top_attacked"]
    assert top["paths"][0]["key"] == "/login"
    assert top["paths"][0]["count"] == 5
    assert top["tenants"][0]["key"] == "3"


# --------------------------------------------------------------- exporter

def _spooled(tmp_path):
    return [json.loads(line) for f in sorted(tmp_path.glob("attacks.*.jsonl"))
            for line in f.read_text().splitlines()]


def test_exporter_spools_attacks(tmp_path):
    def run(P):
        d = tmp_path / P.Hit.__module__.split(".")[0]
        q = P.HitQueue()
        for i in range(3):
            q.put(mk_hit(P, ts=float(i)))
        q.put(mk_hit(P, ts=4.0, attack=False, classes=()))
        ex = P.Exporter(q, spool_dir=str(d), brute=None)
        n = ex.flush_once()
        files = list(d.glob("attacks.*.jsonl"))   # one per pid
        return n, len(files), _spooled(d), ex.flush_once()

    n, n_files, recs, again = both(run)
    assert n == 1 and n_files == 1
    assert recs[0]["class"] == "sqli" and recs[0]["count"] == 3
    assert again == 0


def test_exporter_brute_included(tmp_path):
    def run(P):
        d = tmp_path / P.Hit.__module__.split(".")[0]
        q = P.HitQueue()
        for i in range(30):
            q.put(mk_hit(P, ts=float(i), uri="/login", attack=False,
                         classes=()))
        ex = P.Exporter(q, spool_dir=str(d),
                        brute=P.BruteDetector(P.BruteConfig(threshold=5)))
        return ex.flush_once(), _spooled(d)

    n, recs = both(run)
    assert n == 1 and recs[0]["class"] == "brute"


# ---------------------------------------------------------------- channel

def test_post_channel_records_and_status():
    def run(P):
        ch = P.PostChannel(brute=False)

        class V:
            attack, blocked, fail_open = True, True, False
            classes, rule_ids, score = ["sqli"], [942100], 5

        req = P.Request(uri="/x?a=1",
                        headers={"X-Real-IP": "9.9.9.9, proxy"},
                        request_id="rq1", tenant=3)
        ch.record(req, V())
        return status(ch.status()), hit_fields(ch.queue.drain())

    st, hits = both(run)
    assert st["requests"] == 1 and st["attacks"] == 1
    assert st["queue"]["depth"] == 1
    assert hits[0]["client"] == "9.9.9.9"
    assert hits[0]["tenant"] == 3


# ---------------------------------------------------------------- watcher

_ONE_RULE = ('SecRule ARGS "@rx (?i)union\\s+select" '
             '"id:942100,phase:2,block,severity:CRITICAL,'
             'tag:\'attack-sqli\'"')


def test_ruleset_watcher_triggers_swap_on_new_artifact(tmp_path):
    """A JAX-saved pack in the artifact dir: both watchers post the same
    path once and remember the same version."""
    from ingress_plus_tpu.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu.compiler.seclang import parse_seclang

    cr = compile_ruleset(parse_seclang(_ONE_RULE))
    art = tmp_path / "v1"
    cr.save(art)

    def run(P):
        posts = []

        def poster(path, payload):
            posts.append((path, payload))
            return {"ruleset": cr.version}

        w = P.RulesetWatcher(str(tmp_path), "127.0.0.1:0", poster=poster)
        first = w.check_once()
        return first, posts, w.current_version, w.check_once(), w.swaps

    first, posts, version, again, swaps = both(run)
    assert first is True
    assert posts == [("/configuration/ruleset", {"path": str(art)})]
    assert version == cr.version
    assert again is False and swaps == 1


def test_ruleset_watcher_empty_dir(tmp_path):
    def run(P):
        w = P.RulesetWatcher(str(tmp_path), "127.0.0.1:0",
                             poster=lambda p, d: {})
        return w.check_once(), w.errors

    assert both(run) == (False, 0)


@pytest.mark.parametrize("code,reason,remembered", [
    (422, "new_fns", True),                 # gate rejection: skipped
    (422, "rollout_in_progress", False),    # transient: retried
    (409, None, False),
])
def test_ruleset_watcher_rejections(tmp_path, code, reason, remembered):
    """The watcher's HTTP error handling, the same on both sides."""
    import io
    import urllib.error

    (tmp_path / "v1.npz").write_bytes(b"x")
    (tmp_path / "v1.json").write_text(json.dumps({"version": "v-1"}))

    def run(P):
        def poster(path, payload):
            raise urllib.error.HTTPError(
                "http://x", code, "no", {},
                io.BytesIO(json.dumps({"reason": reason}).encode()))

        w = P.RulesetWatcher(str(tmp_path), "127.0.0.1:0", poster=poster)
        return (w.check_once(), sorted(w.rejected_versions), w.errors,
                w.current_version)

    ok, rejected, errors, cur = both(run)
    assert ok is False and errors == 1 and cur is None
    assert rejected == (["v-1"] if remembered else [])


def test_matched_points_flow_to_attack_export():
    """Verdict.matches ride the Hit into the aggregated attack record;
    the JAX and port pipelines' verdicts feed their channels."""
    from ingress_plus_tpu.compiler.ruleset import compile_ruleset
    from ingress_plus_tpu.compiler.seclang import parse_seclang
    from ingress_plus_tpu.models.pipeline import (
        DetectionPipeline as JaxPipeline,
    )
    from ingress_plus_tpu_torch.compiler.ruleset import (
        compile_ruleset as port_compile,
    )
    from ingress_plus_tpu_torch.compiler.seclang import (
        parse_seclang as port_parse,
    )
    from ingress_plus_tpu_torch.models.pipeline import DetectionPipeline

    pipes = {
        "jax": JaxPipeline(compile_ruleset(parse_seclang(_ONE_RULE)),
                           mode="block"),
        "port": DetectionPipeline(port_compile(port_parse(_ONE_RULE)),
                                  mode="block", device="cpu"),
    }

    def run(P):
        pl = pipes["jax" if P is JAX else "port"]
        req = P.Request(uri="/p?a=clean&q=1+union+select+password",
                        request_id="r1")
        v = pl.detect([req])[0]
        ch = P.PostChannel(brute=False)
        ch.record(req, v)
        hits = ch.queue.drain()
        return (bool(v.attack), list(v.matches), hit_fields(hits),
                [{k: x for k, x in a.items()
                  if k not in ("first_ts", "last_ts")}
                 for a in dicts(P.aggregate_attacks(hits))])

    attack, matches, hits, recs = both(run)
    assert attack and matches
    assert matches[0]["rule_id"] == 942100
    assert "union" in matches[0]["value"].lower()
    assert matches[0]["var"] == "ARGS:q"
    assert hits[0]["matches"][0]["rule_id"] == 942100
    assert recs[0]["sample_points"][0]["rule_id"] == 942100
