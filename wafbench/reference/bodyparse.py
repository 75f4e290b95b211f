"""Frozen copy of the port's ``serve/bodyparse.py`` (imports point at the reference).
Its original docstring follows.

Multipart/form-data and JSON bodies → per-variable collections.

The reference's wallarm module parses request bodies into typed data
points in-process (SURVEY.md §3.3 "parse request → decode/unpack
(url/json/xml/b64/gzip)"), and ModSecurity's multipart and JSON body
processors populate ARGS_POST / FILES / FILES_NAMES so per-variable
rules, `&ARGS` counts, and exclusion selectors resolve on non-urlencoded
POSTs (SURVEY.md §2.2 libmodsecurity row).  This module is the exact
CPU analog for the confirm stage (models/confirm.py): the TPU scan still
sees the raw body stream (every part value / JSON string is a substring
of — or an unpack segment of — the scanned bytes, so the prefilter∧
confirm soundness contract is untouched); here we recover the exact
variables ModSecurity would build.

Fail-safe contract: a PRESENT body that cannot be faithfully parsed
returns None — the caller (models/confirm.py `_parse_collection`)
abstains for counts/negation and falls back to the whole-stream blob
superset for positive pattern operators.  Fabricating partial
collections would feed wrong values to `&ARGS @eq 0`-shaped rules
(the urlencoded path).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

#: multipart hard bounds (DoS guards; ModSecurity's analogs are
#: SecUploadFileLimit / the multipart part-header limits)
MAX_PARTS = 256
MAX_PART_HEADER_BYTES = 8 << 10

#: JSON processor bounds: deeper/wider documents abstain entirely
#: (truncating would fabricate wrong `&ARGS` counts)
MAX_JSON_DEPTH = 32
MAX_JSON_ARGS = 512

@dataclass
class MultipartForm:
    """Parsed multipart/form-data body.

    ``fields``: (field_name, value) for every non-file part —
    ModSecurity's ARGS_POST.  ``files``: (field_name, filename) for
    every part carrying a filename — FILES_NAMES are the field names,
    FILES values are the client-supplied filenames (ModSecurity
    multipart processor semantics; file CONTENT stays in the raw body
    stream for the scanner, it is not a variable)."""

    fields: List[Tuple[bytes, bytes]] = field(default_factory=list)
    files: List[Tuple[bytes, bytes]] = field(default_factory=list)


def multipart_boundary(content_type: bytes) -> Optional[bytes]:
    """Boundary token from a Content-Type value (original case — the
    delimiter match is case-sensitive per RFC 2046).

    Parses the parameter tail SEQUENTIALLY with the same cursor parser
    as Content-Disposition (a regex search let
    ``x="boundary=AAA"; boundary=real`` spoof the boundary from inside
    another parameter's quotes — the parse then succeeded on the fake
    framing, suppressing REQUEST_BODY while the backend parsed the real
    parts)."""
    _type, sep, rest = content_type.partition(b";")
    if not sep:
        return None
    b = _header_params(rest).get(b"boundary")
    return b[:256] if b else None


def _header_params(s: bytes) -> dict:
    """Sequential ``key=value`` parameter parse of a header value tail
    (after the media type), RFC 2045 style: quoted-strings with
    backslash escapes, token values up to the next ``;``.

    SEQUENTIAL is load-bearing: a regex findall over
    the whole line let a crafted parameter like ``xp="name=trusted"``
    inject a fake ``name`` from inside another parameter's quotes —
    spoofing the field name past ``!ARGS:x`` exclusions.  Here the
    cursor consumes each parameter fully before looking for the next
    key, so quoted content is never re-scanned.  First occurrence of a
    key wins — a duplicated name= cannot override the real one."""
    params: dict = {}
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i:i + 1] in (b";", b" ", b"\t"):
            i += 1
        j = i
        while j < n and s[j:j + 1] not in (b"=", b";"):
            j += 1
        if j >= n or s[j:j + 1] != b"=":
            i = j + 1
            continue
        key = s[i:j].strip().lower()
        j += 1
        if s[j:j + 1] == b'"':
            val = bytearray()
            k = j + 1
            while k < n:
                c = s[k:k + 1]
                if c == b"\\" and k + 1 < n:
                    val += s[k + 1:k + 2]
                    k += 2
                    continue
                if c == b'"':
                    break
                val += c
                k += 1
            i = k + 1
            value = bytes(val)
        else:
            k = j
            while k < n and s[k:k + 1] != b";":
                k += 1
            value = s[j:k].strip()
            i = k
        if key and key not in params:
            params[key] = value
    return params


def _disposition_params(headers: bytes):
    """(name, filename, has_filename) from one part's header block.
    ``has_filename`` distinguishes filename="" (an empty file input —
    still a file part) from no filename at all (a plain field)."""
    for line in re.split(rb"\r\n|\n", headers):
        head, sep, tail = line.partition(b":")
        if not sep or head.strip().lower() != b"content-disposition":
            continue
        # skip the disposition type token ("form-data") before the
        # parameter list
        _type, _sep, rest = tail.partition(b";")
        params = _header_params(rest)
        return (params.get(b"name"), params.get(b"filename"),
                b"filename" in params)
    return None, None, False


def parse_multipart(body: bytes,
                    content_type: bytes) -> Optional[MultipartForm]:
    """RFC 7578 part parsing, strict enough to never fabricate pairs.

    None (abstain) when: no boundary parameter, no opening delimiter,
    no closing ``--boundary--`` (a truncated/streamed-capped body must
    not yield a partial collection the counts then trust), a part with
    malformed framing or no field name, or bound overrun.  Lenient
    where real clients are: LF-only line endings and preamble bytes
    before the first delimiter are accepted."""
    boundary = multipart_boundary(content_type)
    if not boundary:
        return None
    delim = b"--" + boundary
    # a delimiter only counts at the start of a line (RFC 2046:
    # splitting on a mid-line occurrence fabricated
    # parts no RFC parser would see); the body-initial delimiter has
    # no preceding CRLF, so prepend one to unify the cases
    chunks = re.split(rb"\r?\n" + re.escape(delim),
                      (b"\r\n" + body) if body.startswith(delim)
                      else body)
    if len(chunks) < 2:
        return None     # opening delimiter never appears
    # chunks[0] is the preamble (RFC permits it; browsers send none)
    form = MultipartForm()
    closed = False
    for chunk in chunks[1:]:
        if closed:
            return None         # content after the closing delimiter
        if chunk[:2] == b"--":
            closed = True       # "--boundary--" epilogue; ignore rest
            continue
        # a true delimiter line ends with CRLF (or LF); anything else
        # means the boundary text merely prefixed a longer line token
        # inside content — malformed
        if chunk[:2] == b"\r\n":
            part = chunk[2:]
        elif chunk[:1] == b"\n":
            part = chunk[1:]
        else:
            return None
        # header/value boundary = the EARLIEST blank line, CRLF or LF
        # framed (preferring \r\n\r\n let an LF-framed
        # part hide its real value before a later CRLFCRLF, swallowing
        # the payload into the discarded header block)
        a = part.find(b"\r\n\r\n")
        b = part.find(b"\n\n")
        if a >= 0 and (b < 0 or a < b):
            sep, skip = a, 4
        elif b >= 0:
            sep, skip = b, 2
        else:
            return None
        if sep > MAX_PART_HEADER_BYTES:
            return None
        # the CRLF preceding the next delimiter was consumed by the
        # split, so the remainder IS the exact part value
        headers, value = part[:sep], part[sep + skip:]
        name, filename, has_filename = _disposition_params(headers)
        if name is None:
            return None
        if has_filename:
            form.files.append((name, filename or b""))
        else:
            form.fields.append((name, value))
        if len(form.fields) + len(form.files) > MAX_PARTS:
            return None
    if not closed:
        return None
    return form


def _json_scalar(o) -> bytes:
    if isinstance(o, str):
        return o.encode("utf-8", "surrogateescape")
    if isinstance(o, bool):
        return b"true" if o else b"false"
    if o is None:
        return b""
    return str(o).encode()


def flatten_json(data: bytes,
                 max_depth: int = MAX_JSON_DEPTH,
                 max_args: int = MAX_JSON_ARGS
                 ) -> Optional[List[Tuple[bytes, bytes]]]:
    """JSON document → [(name, value)] ARGS entries, ModSecurity
    JSON-processor style: names are dotted paths prefixed ``json``
    (``{"a":{"b":1}}`` → ``json.a.b``), array elements repeat the
    parent path (the v2 processor's flattening — indices are not part
    of the name, so ``!ARGS:json.tags`` excludes every element).

    None (abstain) on: invalid JSON, depth beyond ``max_depth``, or
    more than ``max_args`` scalars — a truncated collection would
    fabricate exact-looking counts."""
    try:
        obj = json.loads(data.decode("utf-8", "surrogateescape"))
    except Exception:
        return None
    out: List[Tuple[bytes, bytes]] = []

    def walk(o, path: bytes, depth: int) -> bool:
        if depth > max_depth:
            return False
        if isinstance(o, dict):
            for k, v in o.items():
                kb = str(k).encode("utf-8", "surrogateescape")
                if not walk(v, path + b"." + kb, depth + 1):
                    return False
            return True
        if isinstance(o, list):
            for v in o:
                if not walk(v, path, depth + 1):
                    return False
            return True
        if len(out) >= max_args:
            return False
        out.append((path, _json_scalar(o)))
        return True

    if not walk(obj, b"json", 0):
        return None
    return out
