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
//
// The checked build (-DSCAN_CHECK; chip_smoke.py phase 19) keeps the same
// code and adds checks that count their failures, by code, in device
// counters the host reads back (<kernel>_check_errors):
//   * bounds: every bulk copy's source span lies inside the buffer it
//     copies from, and inside its shared-memory slot; the token buffer is
//     16-byte aligned; a live unit's row is a row of the launch; a later
//     segment's first window holds its halo;
//   * content: every token a warp stages equals the token in device memory;
//   * ordering, on a shadow of each warp's buffers (Shadow): each lane
//     counts the warp's __syncwarp()s (its epoch).  Two accesses by
//     different lanes to one staged offset, one of them a write, in the
//     same epoch are a race; so is a refill of a raw buffer in the epoch
//     in which another lane read it; a window's wait must use the parity
//     of the barrier's next phase and have a copy outstanding on it.  The
//     shadow records which lane did what in which epoch, not what the
//     timing happened to allow, so a missing __syncwarp or a wrong parity
//     is found even where the warp ran in lockstep and the copy had
//     already landed.
// Not checked: the block-level hand-over of the class-table slice and the
// LUT (one mbarrier phase, then __syncthreads), which every thread of the
// block takes part in.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_common {

// what a check of the checked build found (its first failure's code)
enum CheckCode {
  kCopyOutsideBuffer = 1,   // a bulk copy's span leaves its source buffer
  kCopyOverSlot = 2,        // a window's copy overflows its shared slot
  kStaleToken = 3,          // a staged token differs from device memory
  kShortHalo = 4,           // a later segment's first window < its halo
  kRowOutsideLaunch = 5,    // a live unit's row is not a row of the launch
  kTokensMisaligned = 6,    // the token buffer is not 16-byte aligned
  kRaceStaged = 7,          // staged offsets: detail 1 write after another
                            // lane's write, 2 write after another lane's
                            // read, 3 read of another lane's write, all
                            // in one epoch; 4 read of an unwritten offset
  kRaceRefill = 8,          // a refill and another lane's read of the
                            // buffer in one epoch (detail: the buffer)
  kBarrierParity = 9,       // a wait's parity is not its next phase's
  kBarrierIdle = 10,        // a wait with no copy outstanding on it
};

// positions of a warp's staged window the shadow covers (the larger of
// the two kernels' windows)
constexpr int kShadowWin = 1024;

#ifdef SCAN_CHECK
// the code between the parentheses exists in the checked build only
#define SCAN_CHECK_DO(...) __VA_ARGS__
// in a kernel whose Shadow is `sh`: a warp barrier, which ends the lane's
// epoch; and the wait of the b-th window barrier `bar` with `parity`
#define SCAN_SYNCWARP() (__syncwarp(), sh.synced())
#define SCAN_WINDOW_WAIT(bar, b, parity) sh.wait(bar, b, parity)

// failures by code, and the first one's (code, blockIdx.x, blockIdx.y,
// detail)
constexpr int kCheckCodes = 16;
__device__ unsigned long long check_counts[kCheckCodes];
__device__ unsigned long long check_total;
__device__ int check_first[4];

__device__ inline void check(bool ok, int code, int detail) {
  if (ok) return;
  atomicAdd(&check_counts[code], 1ull);
  if (atomicAdd(&check_total, 1ull) == 0) {
    check_first[0] = code;
    check_first[1] = (int)blockIdx.x;
    check_first[2] = (int)blockIdx.y;
    check_first[3] = detail;
  }
}

// the failures so far: their count by code into counts[kCheckCodes], the
// first one's details into first[4]; returns the total and resets all
inline long long check_errors(unsigned long long* counts, int* first) {
  unsigned long long n = 0;
  const unsigned long long zeros[kCheckCodes] = {};
  const int none[4] = {0, 0, 0, 0};
  if (cudaMemcpyFromSymbol(&n, check_total, sizeof n) != cudaSuccess ||
      cudaMemcpyFromSymbol(counts, check_counts, sizeof zeros) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(first, check_first, sizeof none) != cudaSuccess ||
      cudaMemcpyToSymbol(check_total, zeros, sizeof n) != cudaSuccess ||
      cudaMemcpyToSymbol(check_counts, zeros, sizeof zeros) != cudaSuccess ||
      cudaMemcpyToSymbol(check_first, none, sizeof none) != cudaSuccess)
    return -1;
  return (long long)n;
}

#else
// the shipping build: nothing between the parentheses exists
#define SCAN_CHECK_DO(...)
#define SCAN_SYNCWARP() __syncwarp()
#define SCAN_WINDOW_WAIT(bar, b, parity) bar_wait(bar, parity)
#endif

// the span [p, p + bytes) lies inside [base, base + size)
__device__ inline bool inside(const void* p, size_t bytes,
                              const void* base, size_t size) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  return a >= b && a + bytes <= b + size;
}

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

// announces and starts the copy of [p, p + bytes) into `dst`, a slot of
// `slot` bytes; [p, p + bytes) lies in the buffer [base, base + size),
// which the caller pads so that the granules around it do too
__device__ inline void fetch(void* dst, uint32_t slot, const void* p,
                             uint32_t bytes, const void* base, size_t size,
                             uint64_t* bar) {
  const Span s = granules(p, bytes);
  SCAN_CHECK_DO(check(inside(s.start, s.size, base, size),
                      kCopyOutsideBuffer, (int)bytes);
                check(s.size <= slot, kCopyOverSlot, (int)s.size));
  bar_expect(bar, s.size);
  bulk_copy(dst, s.start, s.size, bar);
}

#ifdef SCAN_CHECK
// One warp's shadow, in shared memory after the kernel's own: a read
// record is (epoch << 32 | the lanes that read in that epoch).
struct ShadowSlot {
  unsigned long long staged_reads;   // the chain's reads of the offsets
  unsigned long long raw_reads[2];   // the staging reads of each buffer
  uint32_t issued[2];                // copies issued on each window barrier
  uint32_t refilled[2];              // the epoch of each buffer's refill
  uint32_t tag[kShadowWin];          // per offset: writer lane << 24 | epoch
};

// A lane's view of its warp's shadow: its epoch and its waits.
struct Shadow {
  ShadowSlot* s;
  uint32_t lane, ep, waited[2];

  __device__ Shadow(ShadowSlot* slot, int lane_)
      : s(slot), lane((uint32_t)lane_), ep(1), waited{0, 0} {}

  // zeroes the slot (the whole warp, before a block barrier)
  __device__ void clear() {
    for (int i = (int)lane; i < kShadowWin; i += 32) s->tag[i] = 0;
    if (lane == 0) {
      s->staged_reads = s->raw_reads[0] = s->raw_reads[1] = 0;
      s->issued[0] = s->issued[1] = s->refilled[0] = s->refilled[1] = 0;
    }
  }

  // after every __syncwarp() of the warp
  __device__ void synced() { ++ep; }

  // the lanes other than this one in a read record of this epoch
  __device__ uint32_t others(const unsigned long long* rec) const {
    const unsigned long long r = *(const volatile unsigned long long*)rec;
    return (uint32_t)(r >> 32) == ep ? (uint32_t)r & ~(1u << lane) : 0u;
  }

  __device__ void mark(unsigned long long* rec) const {
    unsigned long long old = *(volatile unsigned long long*)rec, was;
    do {
      was = old;
      const uint32_t lanes = (uint32_t)(was >> 32) == ep ? (uint32_t)was : 0u;
      old = atomicCAS(rec, was,
                      (unsigned long long)ep << 32 | lanes | (1u << lane));
    } while (old != was);
  }

  // this lane writes staged offset j
  __device__ void write(int j) {
    const uint32_t t = s->tag[j];
    check(!(t && (t & 0xffffffu) == ep && (t >> 24) != lane), kRaceStaged,
          1);
    check(!others(&s->staged_reads), kRaceStaged, 2);
    s->tag[j] = lane << 24 | ep;
  }

  // this lane starts the chain's reads of the staged offsets
  __device__ void chain() { mark(&s->staged_reads); }

  // this lane reads staged offsets [j, j + n)
  __device__ void read(int j, int n) const {
    for (int i = j; i < j + n; ++i) {
      const uint32_t t = s->tag[i];
      check(t != 0, kRaceStaged, 4);
      check(!((t & 0xffffffu) == ep && (t >> 24) != lane), kRaceStaged, 3);
    }
  }

  // lane 0 starts a copy into raw buffer b; `refill`: over a window the
  // warp has read, which must not be in an epoch another lane read it in
  // (checked here, and by each reader after the fact: a lane may still be
  // in its wait when lane 0 gets here)
  __device__ void issue(int b, bool refill) {
    if (refill) {
      check(!others(&s->raw_reads[b]), kRaceRefill, b);
      *(volatile uint32_t*)&s->refilled[b] = ep;
    }
    ++s->issued[b];
  }

  // this lane waits on the b-th window barrier `bar` with `parity`, then
  // reads the buffer (staging).  A parity other than the next phase's, or
  // a wait with no copy outstanding, is counted; the wait then takes the
  // next phase's parity, or is skipped, so that the kernel ends (either
  // would hang it) and the count can be read.
  __device__ void wait(uint64_t* bar, int b, uint32_t parity) {
    const uint32_t next = waited[b] & 1u;
    check(parity == next, kBarrierParity, (int)waited[b]);
    const bool idle = *(const volatile uint32_t*)&s->issued[b] <= waited[b];
    check(!idle, kBarrierIdle, (int)waited[b]);
    if (!idle) bar_wait(bar, next);
    ++waited[b];
    mark(&s->raw_reads[b]);
    check(lane == 0 || *(const volatile uint32_t*)&s->refilled[b] != ep,
          kRaceRefill, b);
  }
};

constexpr size_t kShadowBytes = sizeof(ShadowSlot);
#else
constexpr size_t kShadowBytes = 0;
#endif

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

// The token buffer's bytes a launch may copy: B * L tokens of `tok` bytes,
// to the next 16-byte boundary (the caller's buffer is 16-byte aligned and
// readable that far: ops/cuda_build.py pads a buffer that is not)
__device__ inline size_t token_span(int B, int L, size_t tok) {
  return ((size_t)B * L * tok + 15) & ~size_t(15);
}

}  // namespace scan_common
