"""Signature packs — the libproton proton.db analog.

The reference's libproton consumes a compiled attack-signature database
(proton.db, closed format, synced from the Wallarm cloud; SURVEY.md §2.2 /
§3.4).  Our open equivalent: keyword/template packs expanded into the same
``Rule`` objects the SecLang front-end produces, so one compiler back-end
serves both formats.

``generate_signature_rules`` deterministically expands the bundled packs to
the ~1.5k-rule scale of benchmark config #2/#3 (BASELINE.md) — realistic
rule-count pressure on the bitap tables without inventing artificial noise:
every generated rule is a plausible attack signature (keyword × context
template).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

from ingress_plus_tpu_torch.compiler.seclang import Rule

RULES_DIR = Path(__file__).resolve().parent.parent / "rules"

# (class, base_id, severity, targets, templates) — {w} is the keyword slot.
# Templates are regexes in our supported subset; authored for this project.
_PACK_TEMPLATES = [
    ("sqli", 942500, "ERROR", ["args", "body"], [
        r"(?i)\b{w}\s*\(",
        r"(?i)'\s*{w}",
        r"(?i){w}\s*\(\s*(?:select|0x|char)",
        r"(?i){w}\s+(?:from|into|table|database|where)\b",
        r"(?i)\b{w}\b\s*(?:--|#|/\*)",
    ]),
    ("rce", 932500, "ERROR", ["args", "body"], [
        r"(?i)(?:;|\||&|`|\$\()\s*{w}(?:\s|$|[;,&|)'\"`\x1f])",
        r"(?i)\b{w}\s+-[a-z]",
        r"(?i)\b{w}\s+/(?:etc|tmp|var|dev|proc)\b",
    ]),
    ("php", 933500, "WARNING", ["args", "body"], [
        r"(?i)\b{w}\s*\(",
        r"(?i){w}\s*\(\s*[\"'\$]",
    ]),
    # false-positive guard: tag names and event-handler attributes need
    # DIFFERENT contexts — `{w}\s*=` over the combined list made benign
    # form fields named like tags ("body=...", "form=...") fire.  Tags
    # match only in tag-open position; handlers match in attribute
    # position (bare or with an active-looking value).
    ("xss_tags", 941500, "ERROR", ["args", "body"], [
        r"(?i)<\s*{w}\b",
        r"(?i)<\s*{w}[^>]{0,64}\s(?:on[a-z]{3,24}|src|href|style|formaction)\s*=",
    ]),
    ("xss_on", 941600, "ERROR", ["args", "body"], [
        r"(?i)\b{w}\s*=",
        r"(?i){w}\s*=\s*(?:[\"'\x60]|&#|&quot|\\u00)",
    ]),
    ("lfi", 930500, "ERROR", ["uri", "args", "body"], [
        r"(?i){w}",
        r"(?i)(?:\.\./|%2e%2e)[^\s]{0,40}{w}",
    ]),
    ("java", 944500, "ERROR", ["args", "body"], [
        r"(?i){w}",
        r"(?i){w}\s*[\.\(]",
    ]),
    # density expansion: the nodejs and
    # ssrf families had no pack coverage, and the biggest families gain
    # an obfuscation-aware template each (comment/space splicing between
    # keyword and call syntax — bounded repeats keep factors extractable)
    ("nodejs", 934500, "ERROR", ["args", "body"], [
        r"(?i)\b{w}\s*\(",
        r"(?i){w}\s*(?:\.|\[)",
    ]),
    ("rfi", 931500, "ERROR", ["uri", "args", "body"], [
        r"(?i){w}",
        r"(?i)=\s*(?:https?|ftp|gopher|dict|file|php|data|jar|zip)[^&]{0,12}{w}",
    ]),
    ("sqli2", 942900, "ERROR", ["args", "body"], [
        r"(?i)\b{w}(?:\s|/\*[^*]{0,32}\*/|%20|\+){1,8}(?:select|from|where|all|distinct|into)\b",
        r"(?i)\b{w}(?:\s|%20|\+|/\*[^*]{0,32}\*/){0,8}\(",
    ]),
    ("xss2", 941840, "ERROR", ["args", "body"], [
        r"(?i){w}\s*(?:=|\()[^>]{0,64}(?:alert|prompt|confirm|eval|fetch|atob|document|window)",
        r"(?i)(?:<|%3c|&lt;?)[^>]{0,48}\b{w}\s*=",
    ]),
    # rce2 template 0 requires a REAL shell separator before the command:
    # not ^ (a benign args row starts with "id=00001") and not a single &
    # (the query-string pair separator — "&id=1" is not "& id").  `;`,
    # `|`, backtick, `&&` and $() keep their full shell meaning.
    ("rce2", 932840, "ERROR", ["args", "body"], [
        r"(?i)(?:[;|`]|&&|\$\(|%0a|%0d|\n|\r)\s*{w}\b",
        r"(?i)\b{w}(?:\s|%20|\$IFS|\$\{IFS\}){1,4}(?:-[a-z0-9]|/[a-z]|>)",
    ]),
    ("php2", 933800, "ERROR", ["args", "body"], [
        r"(?i){w}",
        r"(?i){w}\s*(?:\(|\[|%28|%5b)",
    ]),
    # session tokens in COOKIES are normal traffic — the fixation signal
    # is a session token in PARAMETERS (template 0, args only) or a
    # cookie-assignment expression naming one (template 1; the
    # document.cookie/set-cookie context keeps header matches meaningful)
    ("session", 943530, "WARNING", ["args"], [
        r"(?i)\b{w}\s*(?:=|%3d)",
    ]),
    ("session2", 943600, "WARNING", ["args", "headers"], [
        r"(?i)(?:document\s*\.\s*cookie|set-cookie)[^;&]{0,48}{w}",
    ]),
]

_PACK_KEYWORDS: Dict[str, List[str]] = {
    "sqli": [
        "union", "select", "insert", "update", "delete", "drop", "truncate",
        "exec", "execute", "declare", "fetch", "cursor", "having", "group by",
        "order by", "limit", "offset", "substring", "substr", "concat",
        "group_concat", "load_file", "outfile", "dumpfile", "benchmark",
        "sleep", "pg_sleep", "waitfor", "dbms_lock", "utl_http", "utl_inaddr",
        "extractvalue", "updatexml", "xmltype", "information_schema",
        "sqlite_master", "sysobjects", "syscolumns", "pg_catalog",
        "mysql\\.user", "xp_cmdshell", "xp_dirtree", "sp_executesql",
        "sp_oacreate", "openrowset", "openquery", "linked_server", "char",
        "nchar", "varchar", "cast", "convert", "coalesce", "nullif", "isnull",
        "version", "database", "current_user", "session_user", "system_user",
        "schema", "table_name", "column_name", "hex", "unhex", "to_base64",
        "from_base64", "randomblob", "sqlite_version", "pragma",
        "attach database", "json_extract", "regexp", "rlike", "soundex",
        "make_set", "elt", "procedure analyse",
    ],
    "rce": [
        "cat", "tac", "less", "more", "head", "tail", "nl", "od", "strings",
        "ls", "dir", "find", "locate", "which", "whereis", "id", "whoami",
        "uname", "hostname", "ifconfig", "ip addr", "netstat", "ss", "ps",
        "top", "env", "printenv", "set", "export", "wget", "curl", "fetch",
        "lynx", "nc", "ncat", "netcat", "socat", "telnet", "ssh", "scp",
        "rsync", "ftp", "tftp", "bash", "dash", "zsh", "ksh", "csh", "tcsh",
        "python", "python3", "perl", "ruby", "php", "node", "lua", "awk",
        "sed", "xargs", "tee", "chmod", "chown", "ln", "cp", "mv", "rm",
        "touch", "mkdir", "mkfifo", "mount", "umount", "crontab", "at",
        "systemctl", "service", "kill", "pkill", "nohup", "disown", "sudo",
        "su", "passwd", "useradd", "usermod", "groupadd", "visudo", "dd",
        "base64", "openssl", "gpg", "tar", "gzip", "bzip2", "xz", "zip",
        "unzip", "make", "gcc", "cc", "go run", "rustc",
    ],
    "php": [
        "eval", "assert", "system", "exec", "shell_exec", "passthru", "popen",
        "proc_open", "pcntl_exec", "call_user_func", "call_user_func_array",
        "create_function", "array_map", "array_filter", "array_walk",
        "register_shutdown_function", "register_tick_function", "ob_start",
        "extract", "parse_str", "putenv", "getenv", "ini_set", "ini_get",
        "dl", "symlink", "link", "readlink", "posix_kill", "posix_setuid",
        "posix_getpwuid", "apache_child_terminate", "apache_setenv",
        "highlight_file", "show_source", "php_uname", "phpversion",
        "phpinfo", "get_defined_vars", "get_defined_functions", "scandir",
        "opendir", "readdir", "glob", "file_get_contents",
        "file_put_contents", "fopen", "fwrite", "fputs", "readfile",
        "unlink", "rename", "copy", "tmpfile", "tempnam",
        "move_uploaded_file", "base64_decode", "gzinflate", "gzuncompress",
        "gzdecode", "str_rot13", "convert_uudecode", "hex2bin", "pack",
        "unserialize", "igbinary_unserialize", "yaml_parse", "simplexml_load_string",
    ],
    "xss_tags": [
        "script", "iframe", "embed", "object", "applet", "meta", "base",
        "form", "svg", "math", "video", "audio", "img", "input", "body",
        "style", "link", "textarea", "button", "select", "option", "keygen",
        "marquee", "blink", "details", "dialog", "template", "slot",
        "frame", "frameset", "noscript", "plaintext", "xmp", "listing",
        "bgsound", "layer", "ilayer", "isindex", "portal", "animate",
    ],
    "xss_on": [
        "onabort", "onactivate", "onafterprint", "onanimationend",
        "onanimationiteration", "onanimationstart", "onauxclick",
        "onbeforecopy", "onbeforecut", "onbeforeinput", "onbeforeprint",
        "onbeforeunload", "onblur", "oncanplay", "oncanplaythrough",
        "onchange", "onclick", "onclose", "oncontextmenu", "oncopy",
        "oncuechange", "oncut", "ondblclick", "ondrag", "ondragend",
        "ondragenter", "ondragleave", "ondragover", "ondragstart", "ondrop",
        "ondurationchange", "onemptied", "onended", "onerror", "onfocus",
        "onfocusin", "onfocusout", "onfullscreenchange", "ongotpointercapture",
        "onhashchange", "oninput", "oninvalid", "onkeydown", "onkeypress",
        "onkeyup", "onload", "onloadeddata", "onloadedmetadata", "onloadstart",
        "onlostpointercapture", "onmessage", "onmousedown", "onmouseenter",
        "onmouseleave", "onmousemove", "onmouseout", "onmouseover",
        "onmouseup", "onmousewheel", "onoffline", "ononline", "onpagehide",
        "onpageshow", "onpaste", "onpause", "onplay", "onplaying",
        "onpointercancel", "onpointerdown", "onpointerenter",
        "onpointerleave", "onpointermove", "onpointerout", "onpointerover",
        "onpointerup", "onpopstate", "onprogress", "onratechange", "onreset",
        "onresize", "onscroll", "onsearch", "onseeked", "onseeking",
        "onselect", "onselectionchange", "onselectstart", "onstalled",
        "onstorage", "onsubmit", "onsuspend", "ontimeupdate", "ontoggle",
        "ontouchcancel", "ontouchend", "ontouchmove", "ontouchstart",
        "ontransitionend", "onunload", "onvolumechange", "onwaiting",
        "onwheel",
    ],
    "lfi": [
        "etc/passwd", "etc/shadow", "etc/group", "etc/hosts", "etc/crontab",
        "etc/sudoers", "etc/fstab", "etc/issue", "etc/motd", "etc/mtab",
        "etc/resolv\\.conf", "etc/hostname", "etc/networks",
        "etc/ssh/sshd_config", "etc/ssh/ssh_config", "etc/mysql/my\\.cnf",
        "proc/self/environ", "proc/self/cmdline", "proc/self/maps",
        "proc/self/status", "proc/version", "proc/net/tcp", "proc/net/route",
        "var/log/auth\\.log", "var/log/secure", "var/log/messages",
        "var/log/syslog", "var/log/wtmp", "var/log/lastlog",
        "windows/win\\.ini", "windows/system\\.ini", "boot\\.ini",
        "windows/repair/sam", "windows/system32/config",
        "inetpub/wwwroot", "\\.aws/credentials", "\\.ssh/id_rsa",
        "\\.ssh/authorized_keys", "\\.git/config", "\\.svn/entries",
        "wp-config\\.php", "configuration\\.php", "localsettings\\.php",
        "config\\.inc\\.php", "settings\\.py", "database\\.yml",
        "secrets\\.yml", "appsettings\\.json", "web\\.config",
        "\\.env", "\\.htaccess", "\\.htpasswd", "\\.bash_history",
        "\\.mysql_history", "\\.viminfo",
    ],
    "java": [
        "java\\.lang\\.runtime", "java\\.lang\\.processbuilder",
        "java\\.lang\\.system", "java\\.lang\\.class",
        "java\\.io\\.objectinputstream", "java\\.rmi\\.server",
        "javax\\.naming\\.initialcontext", "javax\\.naming\\.spi",
        "javax\\.script\\.scriptenginemanager", "javax\\.el\\.elprocessor",
        "com\\.sun\\.rowset\\.jdbcrowsetimpl",
        "com\\.sun\\.org\\.apache\\.xalan",
        "org\\.apache\\.commons\\.collections",
        "org\\.apache\\.commons\\.beanutils",
        "org\\.apache\\.xalan\\.xsltc", "org\\.codehaus\\.groovy",
        "org\\.springframework\\.beans", "org\\.springframework\\.context",
        "org\\.hibernate\\.engine", "org\\.mozilla\\.javascript",
        "bsh\\.interpreter", "clojure\\.lang\\.compiler", "ysoserial",
        "marshalsec", "getruntime", "getdeclaredmethod", "getmethod",
        "newinstance", "defineclass", "urlclassloader", "scriptengine",
        "nashorn", "jexl", "mvel", "spel", "freemarker\\.template",
        "velocity\\.runtime",
    ],
    "nodejs": [
        "require", "child_process", "execSync", "spawnSync", "execFileSync",
        "fork", "process\\.binding", "process\\.dlopen", "process\\.env",
        "process\\.mainModule", "process\\.exit", "process\\.kill",
        "global\\.process", "globalThis", "__proto__", "constructor\\.prototype",
        "Object\\.assign", "Object\\.defineProperty", "Object\\.setPrototypeOf",
        "Reflect\\.construct", "Reflect\\.apply", "Function\\.prototype\\.bind",
        "eval", "setTimeout", "setInterval", "setImmediate", "vm\\.runInContext",
        "vm\\.runInNewContext", "vm\\.runInThisContext", "Buffer\\.from",
        "fs\\.readFile", "fs\\.readFileSync", "fs\\.writeFile",
        "fs\\.writeFileSync", "fs\\.unlink", "fs\\.appendFile",
        "net\\.connect", "net\\.createConnection", "dns\\.lookup",
        "http\\.request", "https\\.request", "dgram\\.createSocket",
        "worker_threads", "cluster\\.fork", "v8\\.deserialize",
        "serialize-javascript", "node-serialize", "funcster",
    ],
    "rfi": [
        "169\\.254\\.169\\.254", "metadata\\.google\\.internal",
        "100\\.100\\.100\\.200", "metadata\\.azure\\.com",
        "localhost", "127\\.0\\.0\\.1", "0\\.0\\.0\\.0", "\\[::1\\]",
        "\\[::ffff:", "2130706433", "017700000001", "0x7f000001",
        "10\\.0\\.0\\.", "172\\.16\\.", "192\\.168\\.",
        "file://", "gopher://", "dict://", "sftp://", "tftp://",
        "ldap://", "jar://", "netdoc://", "php://input", "php://filter",
        "data:text/html", "expect://", "ogg://", "zlib://", "glob://",
        "phar://", "compress\\.zlib", "compress\\.bzip2",
        "\\.burpcollaborator\\.", "\\.oast\\.", "\\.interact\\.sh",
        "\\.oastify\\.com", "webhook\\.site", "requestbin\\.",
    ],
    "sqli2": [
        "union", "select", "insert", "update", "delete", "replace",
        "intersect", "merge", "distinctrow", "straight_join",
    ],
    "xss2": [
        "onerror", "onload", "onclick", "onfocus", "onmouseover",
        "ontoggle", "onstart", "onbegin", "onpageshow", "onpointerover",
        "onanimationstart", "ontransitionend", "onwheel", "oninput",
        "formaction", "xlink:href", "srcdoc", "src", "href", "action",
        "data-bind", "ng-init", "ng-bind", "v-html", "x-on:click",
        "setAttribute", "insertAdjacentHTML", "outerHTML", "innerHTML",
        "document\\.write", "document\\.writeln", "execScript",
        "createContextualFragment", "DOMParser", "srcObject",
        "registerProtocolHandler", "showModalDialog", "importScripts",
        "postMessage",
    ],
    "rce2": [
        "cat", "nc", "ncat", "bash", "sh", "zsh", "wget", "curl", "php",
        "perl", "python", "python3", "ruby", "node", "java", "nmap",
        "whoami", "id", "uname", "ifconfig", "ipconfig", "netstat",
        "systeminfo", "tasklist", "reg", "certutil", "bitsadmin",
        "powershell", "pwsh", "cmd", "cmd\\.exe", "rundll32", "regsvr32",
        "mshta", "wscript", "cscript", "schtasks", "wmic", "net user",
        "net localgroup", "sc create", "sc config", "vssadmin", "bcdedit",
        "chmod", "chattr", "insmod", "modprobe", "ld\\.so", "ldconfig",
        "busybox", "telnetd", "dropbear",
    ],
    "php2": [
        "\\$_GET", "\\$_POST", "\\$_REQUEST", "\\$_COOKIE", "\\$_SERVER",
        "\\$_FILES", "\\$_SESSION", "\\$_ENV", "\\$GLOBALS",
        "php://stdin", "php://memory", "php://temp", "php://fd",
        "zend_eval_string", "runkit_function", "override_function",
        "litespeed_request", "fastcgi_finish_request",
        "allow_url_include", "allow_url_fopen", "auto_prepend_file",
        "auto_append_file", "disable_functions", "open_basedir",
        "expect_popen", "imap_open", "mail\\.add_x_header",
        "session\\.upload_progress", "wddx_deserialize", "maxdb_connect",
    ],
    "session": [
        "phpsessid", "jsessionid", "aspsessionid", "asp\\.net_sessionid",
        "cfid", "cftoken", "viewstate", "__viewstate", "csrftoken",
        "xsrf-token", "remember_token", "auth_token", "access_token",
        "refresh_token", "session_key",
    ],
    "session2": [
        "phpsessid", "jsessionid", "aspsessionid", "csrftoken",
        "auth_token", "access_token", "session_key",
    ],
}


def generate_signature_rules() -> List[Rule]:
    """Deterministically expand packs into Rules (keyword × template)."""
    rules: List[Rule] = []
    for cls, base_id, severity, targets, templates in _PACK_TEMPLATES:
        words = _PACK_KEYWORDS[cls]
        rid = base_id
        for t_idx, template in enumerate(templates):
            for w in words:
                pattern = template.replace("{w}", w)
                rules.append(Rule(
                    rule_id=rid,
                    operator="rx",
                    argument=pattern,
                    targets=list(targets),
                    transforms=["urlDecodeUni", "lowercase"],
                    action="block",
                    severity=severity,
                    msg="sigpack:%s template %d keyword %r" % (cls, t_idx, w),
                    # family tag from the pack key: strip both numeric
                    # suffixes (sqli2) and sub-pack suffixes (xss_tags,
                    # xss_on) so tenant masks / RemoveByTag keep matching
                    tags=["attack-%s" % cls.split("_")[0].rstrip("0123456789"),
                          "paranoia-level/2", "sigpack"],
                    paranoia=2,
                ))
                rid += 1
    return rules


def load_bundled_rules(include_sigpack: bool = True) -> List[Rule]:
    """Bundled CRS-shaped SecLang rules (+ signature packs) — the default
    full ruleset for benchmark config #2/#3."""
    from ingress_plus_tpu_torch.compiler.seclang import load_seclang_dir

    rules = load_seclang_dir(RULES_DIR / "crs")
    if include_sigpack:
        rules.extend(generate_signature_rules())
    return rules
