// Strict-syntax SQLi / XSS detectors — C++ twin of
// ingress_plus_tpu/models/libdetect.py (the libdetection analog;
// SURVEY.md §2.2: "TPU tokenizer/lexer kernel or C++ confirm stage in
// sidecar").  Built as libiptdetect.so with a C ABI; the Python module
// dispatches here via ctypes when the library is present, and the
// differential test (tests/test_native_confirm.py) pins this
// implementation byte-for-byte to the Python reference.
//
// The grammar notes live in the Python file; this file mirrors its
// observable behavior exactly — including the tokenizer's alternation
// order (comment before '-'/'/' operators, hex before num), doubled-quote
// string continuation, unterminated strings, and the unknown-byte skip.

#include <cctype>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

constexpr size_t kMaxLen = 4096;
constexpr size_t kMaxTokens = 512;

// ------------------------------------------------------------------ SQLi

const std::unordered_set<std::string>& SqlKeywords() {
  static const auto* kw = new std::unordered_set<std::string>{
      "select", "union", "insert", "update", "delete", "drop", "create",
      "alter", "truncate", "replace", "merge", "exec", "execute", "declare",
      "from", "where", "having", "group", "order", "limit", "offset", "into",
      "values", "table", "database", "and", "or", "not", "like", "between",
      "in", "is", "null", "case", "when", "then", "else", "end", "cast",
      "convert", "waitfor", "delay",
  };
  return *kw;
}

const std::unordered_set<std::string>& SqlFunctions() {
  static const auto* fn = new std::unordered_set<std::string>{
      "sleep", "benchmark", "pg_sleep", "load_file", "version", "user",
      "current_user", "session_user", "system_user", "database", "schema",
      "concat", "group_concat", "char", "chr", "ascii", "substring",
      "substr", "mid", "hex", "unhex", "extractvalue", "updatexml",
      "xp_cmdshell", "randomblob", "sqlite_version", "utl_inaddr",
      "dbms_pipe",
  };
  return *fn;
}

enum class Kind : uint8_t {
  kComment, kStr, kHex, kNum, kWord, kFn, kOp,
  kKwUnion, kKwSelect, kKwFrom, kKwOr, kKwAnd, kKwOther,
};

struct Token {
  Kind kind;
  std::string text;  // lowercased for words/ops where compared
  std::string kw;    // keyword name when kind is kKw*
};

inline bool IsSpace(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
inline bool IsDigit(uint8_t c) { return c >= '0' && c <= '9'; }
inline bool IsAlpha(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
inline bool IsHexDigit(uint8_t c) {
  return IsDigit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}
inline bool IsWordStart(uint8_t c) { return IsAlpha(c) || c == '_'; }
inline bool IsWordCont(uint8_t c) {
  return IsAlpha(c) || IsDigit(c) || c == '_' || c == '$';
}

inline std::string Lower(const uint8_t* p, size_t n) {
  std::string s(reinterpret_cast<const char*>(p), n);
  for (char& c : s)
    if (c >= 'A' && c <= 'Z') c += 32;
  return s;
}

// Quoted literal starting at data[i] (q = ' " or `).  Mirrors the Python
// pattern '(?:[^'\\]|\\.|'')*'? — doubled-quote continuation for '/",
// backslash escapes (none for `), unterminated allowed, and a lone
// trailing backslash is left unconsumed.
size_t LexString(const uint8_t* data, size_t n, size_t i) {
  uint8_t q = data[i];
  bool escapes = (q != '`');
  size_t j = i + 1;
  while (j < n) {
    uint8_t c = data[j];
    if (escapes && c == '\\') {
      if (j + 1 < n) { j += 2; continue; }
      break;  // trailing backslash: regex leaves it for the next token
    }
    if (c == q) {
      if (escapes && j + 1 < n && data[j + 1] == q) { j += 2; continue; }
      return j + 1;  // closed
    }
    ++j;
  }
  return j;  // unterminated
}

std::vector<Token> TokenizeSql(const uint8_t* data, size_t n) {
  std::vector<Token> toks;
  size_t i = 0;
  while (i < n && toks.size() < kMaxTokens) {
    uint8_t c = data[i];
    if (IsSpace(c)) { ++i; continue; }
    // comments (before the '-' '/' '#' operators, like the regex order)
    if (c == '-' && i + 1 < n && data[i + 1] == '-') {
      size_t j = i + 2;
      while (j < n && data[j] != '\n') ++j;
      toks.push_back({Kind::kComment, "--", ""});
      i = j;
      continue;
    }
    if (c == '#') {
      size_t j = i + 1;
      while (j < n && data[j] != '\n') ++j;
      toks.push_back({Kind::kComment, "#", ""});
      i = j;
      continue;
    }
    if (c == '/' && i + 1 < n && data[i + 1] == '*') {
      size_t j = i + 2;
      while (j + 1 < n && !(data[j] == '*' && data[j + 1] == '/')) ++j;
      i = (j + 1 < n) ? j + 2 : n;  // closed or runs to end
      toks.push_back({Kind::kComment, "/*", ""});
      continue;
    }
    if (c == '\'' || c == '"' || c == '`') {
      i = LexString(data, n, i);
      toks.push_back({Kind::kStr, "", ""});
      continue;
    }
    if (c == '0' && i + 1 < n && (data[i + 1] == 'x' || data[i + 1] == 'X')) {
      // the Python pattern is 0x only (lowercase x), hex digits required
      if (data[i + 1] == 'x' && i + 2 < n && IsHexDigit(data[i + 2])) {
        size_t j = i + 2;
        while (j < n && IsHexDigit(data[j])) ++j;
        toks.push_back({Kind::kHex, "", ""});
        i = j;
        continue;
      }
    }
    if (IsDigit(c)) {
      size_t j = i + 1;
      while (j < n && IsDigit(data[j])) ++j;
      if (j + 1 < n && data[j] == '.' && IsDigit(data[j + 1])) {
        ++j;
        while (j < n && IsDigit(data[j])) ++j;
      }
      toks.push_back({Kind::kNum, "", ""});
      i = j;
      continue;
    }
    if (IsWordStart(c)) {
      size_t j = i + 1;
      while (j < n && IsWordCont(data[j])) ++j;
      std::string w = Lower(data + i, j - i);
      const auto& kws = SqlKeywords();
      if (kws.count(w)) {
        Kind k = Kind::kKwOther;
        if (w == "union") k = Kind::kKwUnion;
        else if (w == "select") k = Kind::kKwSelect;
        else if (w == "from") k = Kind::kKwFrom;
        else if (w == "or") k = Kind::kKwOr;
        else if (w == "and") k = Kind::kKwAnd;
        toks.push_back({k, w, w});
      } else if (SqlFunctions().count(w)) {
        toks.push_back({Kind::kFn, w, ""});
      } else {
        toks.push_back({Kind::kWord, w, ""});
      }
      i = j;
      continue;
    }
    // operators, multi-char first (same order as the Python alternation)
    static const char* kOps2[] = {"||", "&&", "<=", ">=", "<>", "!=", "@@"};
    bool matched = false;
    for (const char* op : kOps2) {
      if (i + 1 < n && c == uint8_t(op[0]) && data[i + 1] == uint8_t(op[1])) {
        toks.push_back({Kind::kOp, op, ""});
        i += 2;
        matched = true;
        break;
      }
    }
    if (matched) continue;
    if (std::strchr("=<>+-*/%(),;@!~^&|", c)) {
      toks.push_back({Kind::kOp, std::string(1, char(c)), ""});
      ++i;
      continue;
    }
    ++i;  // unknown byte: skip (strict grammar tolerates noise gaps)
  }
  return toks;
}

inline bool IsValue(const Token& t) {
  return t.kind == Kind::kStr || t.kind == Kind::kNum ||
         t.kind == Kind::kHex || t.kind == Kind::kWord ||
         t.kind == Kind::kFn;
}

inline bool IsLiteral(const Token& t) {
  return t.kind == Kind::kStr || t.kind == Kind::kNum || t.kind == Kind::kHex;
}

inline bool IsKw(const Token& t) {
  return t.kind >= Kind::kKwUnion && t.kind <= Kind::kKwOther;
}

inline bool IsCmpText(const std::string& s) {
  return s == "=" || s == "<" || s == ">" || s == "<=" || s == ">=" ||
         s == "<>" || s == "!=" || s == "like";
}

// True iff toks[lo, hi) contains no `run` consecutive bare words — the
// strictness test separating SQL select-lists from English prose (mirrors
// models/libdetect.py _no_word_run; round-4 fix: co-occurrence matching
// made the strict confirm fire on ordinary sentences).
inline bool NoWordRun(const std::vector<Token>& toks, size_t lo, size_t hi,
                      int run = 3) {
  int streak = 0;
  for (size_t i = lo; i < hi && i < toks.size(); ++i) {
    streak = (toks[i].kind == Kind::kWord) ? streak + 1 : 0;
    if (streak >= run) return false;
  }
  return true;
}

bool SqliTokenPatterns(const std::vector<Token>& toks) {
  // UNION [ALL|DISTINCT] SELECT — structurally adjacent, not mere
  // co-occurrence.  Comments and an opening paren between the keywords
  // are the canonical obfuscations (`union/**/select`, `union(select`)
  // and stay adjacent; arbitrary prose words do not.
  for (size_t i = 0; i < toks.size(); ++i) {
    if (toks[i].kind != Kind::kKwUnion) continue;
    size_t j = i + 1;
    bool saw_modifier = false;
    while (j < toks.size()) {
      const Token& tj = toks[j];
      if (tj.kind == Kind::kComment ||
          (tj.kind == Kind::kOp && tj.text == "(")) {
        ++j;
        continue;
      }
      if (!saw_modifier && tj.kind == Kind::kWord &&
          (tj.text == "all" || tj.text == "distinct")) {
        saw_modifier = true;
        ++j;
        continue;
      }
      break;
    }
    if (j < toks.size() && toks[j].kind == Kind::kKwSelect) return true;
  }
  // SELECT <list> FROM <ref> — SQL-shaped list/ref (no prose word runs
  // within the clause or the 3 tokens after FROM), bounded gap
  for (size_t i = 0; i < toks.size(); ++i) {
    if (toks[i].kind != Kind::kKwSelect) continue;
    size_t hi = std::min(i + 33, toks.size());
    for (size_t j = i + 1; j < hi; ++j) {
      if (toks[j].kind == Kind::kKwFrom) {
        if (NoWordRun(toks, i + 1, std::min(j + 4, toks.size()))) return true;
        break;
      }
    }
  }
  // stacked query: ';' followed by a statement keyword within 3 tokens
  static const std::unordered_set<std::string> kStmt{
      "select", "insert", "update", "delete", "drop", "create",
      "alter", "exec", "execute", "declare", "truncate"};
  for (size_t i = 0; i < toks.size(); ++i) {
    if (toks[i].kind == Kind::kOp && toks[i].text == ";") {
      for (size_t j = i + 1; j < toks.size() && j <= i + 3; ++j)
        if (IsKw(toks[j]) && kStmt.count(toks[j].kw)) return true;
    }
  }
  // boolean glue + comparison: (OR|AND) value cmp value; or bare truthy
  for (size_t i = 0; i < toks.size(); ++i) {
    if (toks[i].kind != Kind::kKwOr && toks[i].kind != Kind::kKwAnd)
      continue;
    size_t rest = toks.size() - (i + 1);
    if (rest < 2) continue;  // python guard: i + 3 <= len(tokens), so a
                             // bare "AND word" at end-of-input is no hit
    // comparison shape over the first 3 NON-comment tokens: inline
    // comments are token separators (OR/**/1/**/=/**/1 ≡ OR 1=1); the
    // truncation test below still reads positions with comments intact
    size_t v[3];
    int nv = 0;
    for (size_t j = i + 1; j < toks.size() && nv < 3; ++j) {
      if (toks[j].kind == Kind::kComment) continue;
      v[nv++] = j;
    }
    if (nv == 3 && IsValue(toks[v[0]]) && IsCmpText(toks[v[1]].text) &&
        IsValue(toks[v[2]]))
      return true;
    // bare truthy value then TRUNCATION: a line comment anywhere, or
    // an inline comment that ENDS the input.  A mid-expression /**/ is
    // not truncation — benign globstar queries ("src/**/lib or
    // docs/**/api") tokenize as value+comment there (review finding).
    if (IsValue(toks[i + 1]) && toks[i + 2].kind == Kind::kComment &&
        (rest == 2 || toks[i + 2].text != "/*"))
      return true;
  }
  // time/exfil function call: fn '('
  for (size_t i = 0; i + 1 < toks.size(); ++i)
    if (toks[i].kind == Kind::kFn && toks[i + 1].text == "(") return true;
  // leading tautology: literal cmp literal (bare words excluded)
  if (toks.size() >= 3 && IsLiteral(toks[0]) &&
      (toks[1].text == "=" || toks[1].text == "<>" || toks[1].text == "!=") &&
      IsLiteral(toks[2]))
    return true;
  return false;
}

bool DetectSqli(const uint8_t* data, size_t n) {
  if (n > kMaxLen) n = kMaxLen;
  if (n == 0) return false;
  for (int pfx = 0; pfx < 3; ++pfx) {
    uint8_t quote = pfx == 1 ? '\'' : '"';
    std::vector<uint8_t> buf;
    const uint8_t* p = data;
    size_t pn = n;
    if (pfx > 0) {
      if (std::memchr(data, quote, n) == nullptr) {
        // python: payload = data when the quote char is absent — the bare
        // pass already covered it
      } else {
        buf.reserve(n + 1);
        buf.push_back(quote);
        buf.insert(buf.end(), data, data + n);
        p = buf.data();
        pn = buf.size();
      }
    }
    std::vector<Token> toks = TokenizeSql(p, pn);
    if (toks.empty()) continue;
    // comment truncation straight after a quote-break: '--, '#, '/* —
    // like the Python, checked on quote passes even when the prefix was
    // not prepended (a string of another quote type still satisfies it)
    if (pfx > 0 && toks.size() >= 2 &&
        toks.front().kind == Kind::kStr && toks.back().kind == Kind::kComment)
      return true;
    if (SqliTokenPatterns(toks)) return true;
  }
  return false;
}

// ------------------------------------------------------------------- XSS

const std::unordered_set<std::string>& ActiveTags() {
  static const auto* tags = new std::unordered_set<std::string>{
      "script", "iframe", "embed", "object", "applet", "svg", "math",
      "base", "meta", "form", "video", "audio", "img", "input",
      "body", "style", "link", "marquee", "details", "template",
  };
  return *tags;
}

inline bool IsWordByte(uint8_t c) {
  return IsAlpha(c) || IsDigit(c) || c == '_';
}

bool XssActiveTag(const std::string& low) {
  for (size_t i = 0; i < low.size(); ++i) {
    if (low[i] != '<') continue;
    size_t j = i + 1;
    while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
    if (j < low.size() && low[j] == '/') {
      ++j;
      while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
    }
    if (j >= low.size() || !IsAlpha(uint8_t(low[j]))) continue;
    size_t k = j + 1;
    while (k < low.size() &&
           (IsAlpha(uint8_t(low[k])) || IsDigit(uint8_t(low[k])) ||
            low[k] == '-'))
      ++k;
    if (ActiveTags().count(low.substr(j, k - j))) return true;
  }
  return false;
}

// \bon[a-zA-Z]{3,30}\s*=\s*["'`]?[^\s"'`>]
bool XssEventAttr(const std::string& low) {
  for (size_t i = 0; i + 1 < low.size(); ++i) {
    if (low[i] != 'o' || low[i + 1] != 'n') continue;
    if (i > 0 && IsWordByte(uint8_t(low[i - 1]))) continue;  // \b
    size_t j = i + 2, letters = 0;
    while (j < low.size() && IsAlpha(uint8_t(low[j]))) { ++j; ++letters; }
    if (letters < 3 || letters > 30) continue;
    while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
    if (j >= low.size() || low[j] != '=') continue;
    ++j;
    while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
    if (j < low.size() &&
        (low[j] == '"' || low[j] == '\'' || low[j] == '`'))
      ++j;
    if (j >= low.size()) continue;
    uint8_t c = uint8_t(low[j]);
    if (!IsSpace(c) && c != '"' && c != '\'' && c != '`' && c != '>')
      return true;
  }
  return false;
}

bool XssJsUri(const std::string& low) {
  for (const char* kw : {"javascript", "vbscript"}) {
    size_t at = 0;
    size_t kn = std::strlen(kw);
    while ((at = low.find(kw, at)) != std::string::npos) {
      size_t j = at + kn;
      while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
      if (j < low.size() && low[j] == ':') return true;
      ++at;
    }
  }
  return false;
}

// data\s*:[^,]{0,60};\s*base64 — note [^,] also matches ';', so (with
// backtracking) ANY ';' within the first 61 non-comma chars can be the
// literal one; try each.
bool XssDataUri(const std::string& low) {
  size_t at = 0;
  while ((at = low.find("data", at)) != std::string::npos) {
    size_t j = at + 4;
    while (j < low.size() && IsSpace(uint8_t(low[j]))) ++j;
    if (j < low.size() && low[j] == ':') {
      ++j;
      for (size_t scanned = 0; j < low.size() && scanned <= 60;
           ++j, ++scanned) {
        if (low[j] == ',') break;
        if (low[j] == ';') {
          size_t k = j + 1;
          while (k < low.size() && IsSpace(uint8_t(low[k]))) ++k;
          if (low.compare(k, 6, "base64") == 0) return true;
        }
      }
    }
    ++at;
  }
  return false;
}

bool DetectXss(const uint8_t* data, size_t n) {
  if (n > kMaxLen) n = kMaxLen;
  if (n == 0) return false;
  std::string low = Lower(data, n);
  if (XssActiveTag(low)) return true;
  if (XssEventAttr(low)) return true;
  if (XssJsUri(low)) return true;
  if (XssDataUri(low)) return true;
  if (low.find("&#") != std::string::npos &&
      low.find("script") != std::string::npos)
    return true;
  return false;
}

}  // namespace

extern "C" {

int ipt_detect_sqli(const uint8_t* data, size_t len) {
  return DetectSqli(data, len) ? 1 : 0;
}

int ipt_detect_xss(const uint8_t* data, size_t len) {
  return DetectXss(data, len) ? 1 : 0;
}

}  // extern "C"
