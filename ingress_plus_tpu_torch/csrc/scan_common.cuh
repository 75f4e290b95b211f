// What the two scan kernels share: Hopper bulk copies into shared memory,
// completing on an mbarrier; the geometry of a warp's unit (row, segment);
// and reach reads through staged class-row offsets.
//
// cp.async.bulk moves a contiguous span from device memory into shared
// memory without passing through registers; the copy engine reports the
// bytes it delivered to an mbarrier in shared memory, and threads wait on
// that barrier's phase.  A bulk copy needs 16-byte aligned addresses and
// a size that is a multiple of 16, so a token window is copied as the
// aligned 16-byte granules that contain it (never more than 15 bytes on
// either side, and never across a page, since a granule lies inside one)
// and read from its offset inside the copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_common {

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// makes the barriers' initialisation visible to the copy engine
__device__ inline void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ inline void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase `parity` has completed
__device__ inline void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// orders this thread's earlier shared-memory reads before a later bulk
// copy into the same buffer
__device__ inline void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// copies `bytes` (a multiple of 16) from 16-byte aligned `src` to
// 16-byte aligned `dst`, completing on `bar`
__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The aligned copy of [p, p + bytes): its start, its size, and the offset
// of p inside it.
struct Span {
  const void* start;
  uint32_t size;
  uint32_t head;
};

__device__ inline Span granules(const void* p, uint32_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + bytes + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const void*>(lo), uint32_t(hi - lo),
          uint32_t(a - lo)};
}

// announces and starts the copy of [p, p + bytes) into `dst`
__device__ inline void fetch(void* dst, const void* p, uint32_t bytes,
                             uint64_t* bar) {
  const Span s = granules(p, bytes);
  bar_expect(bar, s.size);
  bulk_copy(dst, s.start, s.size, bar);
}

// One warp's unit: row `row`, segment `seg` of `G` positions.  It scans
// positions [from, end) of its row; the first `warm` of them (the halo,
// segments after the first only) update the state but record no match.
// A unit past its row's end (seg > 0, seg*G >= n) is not live.  The unit
// whose range holds the row's end (segment 0 for an empty row) writes the
// state.
struct Unit {
  int row, seg, n, from, end, warm;
  bool live, ends_row;
};

__device__ inline Unit unit_of(int unit, int nseg, int G, int halo,
                               const int32_t* lengths, int B, int L) {
  Unit u;
  u.row = unit / nseg;
  u.seg = unit - u.row * nseg;
  u.live = false;
  u.ends_row = false;
  u.n = u.from = u.end = u.warm = 0;
  if (u.row < B) {
    int n = lengths[u.row];
    n = n < 0 ? 0 : (n > L ? L : n);
    const int a = u.seg * G;
    u.n = n;
    u.live = u.seg == 0 || a < n;
    u.ends_row = u.live && n <= a + G;
    u.warm = u.seg == 0 ? 0 : halo;
    u.from = a - u.warm;
    u.end = u.live ? min(a + G, n) : u.from;
  }
  return u;
}

// A block's class-table slice is laid out [class][lane]: a class row is
// 32 words, kRowBytes bytes.  A window's positions are staged as the byte
// offsets of their class rows (class * kRowBytes, at most 256 * 128, so
// uint16), read eight at a time with one 16-byte load; a lane adds the
// offset to its own column's address.
constexpr int kRowBytes = 32 * sizeof(uint32_t);

__device__ inline uint32_t reach(const unsigned char* column, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(column + off);
}

// the eight staged offsets at p (16-byte aligned)
__device__ inline void offsets8(const uint16_t* p, uint32_t (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = w[i] & 0xffffu;
    o[2 * i + 1] = w[i] >> 16;
  }
}

}  // namespace scan_common
