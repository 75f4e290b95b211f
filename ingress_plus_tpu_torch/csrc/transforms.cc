// The confirm stage's whitespace transforms (models/confirm.py
// compressWhitespace and removeWhitespace) as single passes over the
// bytes, in place of a regex substitution that builds one match object
// per whitespace run.
//
// Whitespace is the set of Python's bytes `\s`: bytes 9 to 13 (\t \n \v \f
// \r) and 32 (space), nothing else (not \x1c-\x1f, \x85 or \xa0).
//
// Each function reads `n` bytes of `in` and returns -1 when the input
// needs no change, writing nothing; else it writes the result into `out`
// (room for `n` bytes: the result is never longer than the input) and
// returns its length.  The two buffers must not overlap.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// branch-free: the loops below run on text a fifth of whose bytes may be
// spaces, at random
inline bool is_space(uint8_t c) {
  return (unsigned(c) - '\t' < 5u) | (c == ' ');
}

}  // namespace

extern "C" {

// Every maximal run of whitespace becomes one space, leading and
// trailing runs included.  No change: no whitespace but lone spaces.
long long ipt_compress_whitespace(const uint8_t* in, size_t n, uint8_t* out) {
  // the first run that is not one lone space; the byte before it, if
  // any, is no whitespace
  size_t i = 0;
  for (;;) {
    while (i < n && !is_space(in[i])) ++i;
    if (i >= n) return -1;
    if (in[i] != ' ' || (i + 1 < n && is_space(in[i + 1]))) break;
    i += 2;  // a lone space and the byte after it
  }
  std::memcpy(out, in, i);
  size_t o = i;
  bool prev = false;
  for (; i < n; ++i) {
    const uint8_t c = in[i];
    const bool w = is_space(c);
    out[o] = w ? ' ' : c;
    o += !(w && prev);
    prev = w;
  }
  return static_cast<long long>(o);
}

// Every whitespace byte is deleted.  No change: no whitespace.
long long ipt_remove_whitespace(const uint8_t* in, size_t n, uint8_t* out) {
  size_t i = 0;
  while (i < n && !is_space(in[i])) ++i;
  if (i == n) return -1;
  std::memcpy(out, in, i);
  size_t o = i;
  for (; i < n; ++i) {
    const uint8_t c = in[i];
    out[o] = c;
    o += !is_space(c);
  }
  return static_cast<long long>(o);
}

}  // extern "C"
