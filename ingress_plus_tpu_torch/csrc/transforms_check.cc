// A runner for the whitespace transforms (transforms.cc) built as one
// executable with them, so that they run under a sanitizer (ASan and
// UBSan) in a process of its own: loading a sanitized shared library into
// Python needs the sanitizer's runtime preloaded.
//
//   transforms_check INPUT
//
// INPUT holds strings, each a 4-byte little-endian length and that many
// bytes.  Each string is copied into a heap block of exactly its length
// and passed to ipt_compress_whitespace, then ipt_remove_whitespace, each
// with an output heap block of exactly that length (a read or write past
// either lands in the sanitizer's redzone).  For each call stdout gets a
// 4-byte little-endian signed length, -1 for "no change", then the bytes
// written.  Exits 2 on a usage or read error.

#include <cstdint>
#include <cstdio>
#include <memory>

extern "C" {
long long ipt_compress_whitespace(const uint8_t* in, size_t n, uint8_t* out);
long long ipt_remove_whitespace(const uint8_t* in, size_t n, uint8_t* out);
}

namespace {

void emit(long long k, const uint8_t* out) {
  const uint32_t v = static_cast<uint32_t>(static_cast<int32_t>(k));
  const unsigned char head[4] = {
      static_cast<unsigned char>(v), static_cast<unsigned char>(v >> 8),
      static_cast<unsigned char>(v >> 16), static_cast<unsigned char>(v >> 24)};
  std::fwrite(head, 1, 4, stdout);
  if (k > 0) std::fwrite(out, 1, static_cast<size_t>(k), stdout);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: transforms_check INPUT\n");
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
    std::unique_ptr<uint8_t[]> out(new uint8_t[n]);
    emit(ipt_compress_whitespace(data.get(), n, out.get()), out.get());
    out.reset(new uint8_t[n]);
    emit(ipt_remove_whitespace(data.get(), n, out.get()), out.get());
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
