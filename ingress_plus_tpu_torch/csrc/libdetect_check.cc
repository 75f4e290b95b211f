// A runner for the native confirm twin (libdetect.cc) built as one
// executable with it, so that the twin runs under a sanitizer (ASan and
// UBSan) in a process of its own: loading a sanitized shared library into
// Python needs the sanitizer's runtime preloaded.
//
//   libdetect_check INPUT
//
// INPUT holds strings, each a 4-byte little-endian length and that many
// bytes.  Each string is copied into a heap block of exactly its length
// (a read past it lands in the sanitizer's redzone), then passed to
// ipt_detect_sqli and ipt_detect_xss; stdout gets one line per string,
// the two bits ("00", "01", "10" or "11": SQLi, then XSS).  Exits 2 on a
// usage or read error.

#include <cstdint>
#include <cstdio>
#include <memory>

extern "C" {
int ipt_detect_sqli(const uint8_t* data, size_t len);
int ipt_detect_xss(const uint8_t* data, size_t len);
}

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: libdetect_check INPUT\n");
    return 2;
  }
  std::FILE* in = std::fopen(argv[1], "rb");
  if (in == nullptr) {
    std::perror(argv[1]);
    return 2;
  }
  unsigned char head[4];
  size_t count = 0, got = 0;
  while ((got = std::fread(head, 1, 4, in)) == 4) {
    const size_t n = size_t(head[0]) | size_t(head[1]) << 8 |
                     size_t(head[2]) << 16 | size_t(head[3]) << 24;
    std::unique_ptr<uint8_t[]> data(new uint8_t[n]);
    if (std::fread(data.get(), 1, n, in) != n) {
      std::fprintf(stderr, "string %zu: short read\n", count);
      std::fclose(in);
      return 2;
    }
    const int sqli = ipt_detect_sqli(data.get(), n);
    const int xss = ipt_detect_xss(data.get(), n);
    std::printf("%d%d\n", sqli, xss);
    ++count;
  }
  const bool clean = got == 0 && std::feof(in) && !std::ferror(in);
  std::fclose(in);
  if (!clean) {
    std::fprintf(stderr, "read error after %zu strings\n", count);
    return 2;
  }
  return 0;
}
