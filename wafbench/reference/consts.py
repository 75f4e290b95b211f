"""Constants of the pack format the reference reads, copied from the
port's compiler (``compiler/seclang.py``, ``compiler/ruleset.py``).
:func:`wafbench.reference.pack.load_pack` checks them against the names
the pack file itself stores."""

CLASSES = [
    "protocol", "scanner", "lfi", "rfi", "rce", "php", "nodejs",
    "xss", "sqli", "session", "java", "generic", "leak", "acl",
]
STREAMS = ("uri", "args", "headers", "body", "resp_headers", "resp_body")
STREAM_INDEX = {s: i for i, s in enumerate(STREAMS)}
VARIANTS = ("raw", "urldec", "urldec_html", "squash_raw", "squash_dec",
            "squash_urldec")
N_SV = len(STREAMS) * len(VARIANTS)
_WS_BYTES = frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B])
#: bytes deleted by the squash variants
SQUASH_BYTES = _WS_BYTES | frozenset([0x5C, 0x27, 0x22, 0x5E])
#: the client IP the trusted plane ships as a header (``models/acl.py``)
CLIENT_IP_HEADER = "x-detect-tpu-client-ip"
#: wallarm_mode strengths (``models/pipeline.py``): wire value -> strength
MODE_STRENGTH = {0: 0, 1: 1, 3: 2, 2: 3}
MODE_NAME_STRENGTH = {"off": 0, "monitoring": 1, "safe_blocking": 2,
                      "block": 3}
