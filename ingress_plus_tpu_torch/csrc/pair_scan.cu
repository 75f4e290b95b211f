// Class-pair shift-AND scan for Hopper (sm_90a).
//
// Replaces ingress_plus_tpu/ops/pallas_scan.py::_pair_kernel, in both of
// its configurations:
//   * raw-byte (serving name "pallas3"): uint8 request bytes go through the
//     257-entry byte->class LUT inside the kernel (entry 256 = dead class);
//   * class-id ("pallas2"): int32 class ids that the caller already mapped.
// Its plain PyTorch version is ingress_plus_tpu_torch/ops/scan.py::scan_pairs.
//
// Per (row, word) the kernel runs the folded pair recurrence over
// (R1, R2) = T[class(byte 2t)], T[class(byte 2t+1)]:
//     M |= ((S<<1)|I) & (R1&F)
//     S  = ((S<<2)|(I<<1)|I) & (((R1<<1)|I) & R2)
//     M |= S&F
//
// What bounds it on the H100: integer ALU work and shared-memory lookups in
// the serial chain.  Per (row, word, pair) the recurrence needs 2 class-table
// reads and 8 integer instructions once the bitwise parts fuse into LOP3:
// 3 shifts (S<<1, S<<2, R1<<1; these may issue on the FMA pipe as IMAD.SHL)
// and 5 LOP3 ((S<<1|I)&R1, M|(x&F), (R1<<1|I)&R2, (S<<2|IOR)&r, M|(S&F)),
// which only the 64-lane ALU pipe runs.  Device memory is not the limit:
// the kernel reads B*L token bytes and writes 2*B*W*4 bytes.  Tensor cores
// have nothing to do here: the recurrence is a bitwise shift-AND with no
// product in it.
//
// What the design does about it:
//   * Words carry no bits into each other, so one lane owns one word and
//     keeps S and M in registers; the pair chain runs inside the thread, in
//     place of the TPU kernel's sequential grid axis.
//   * The chain of a row is split across warps (ops/segments.py plans the
//     segment length G, a multiple of 32, so segments start on a pair).  A
//     warp owns one unit, (row r, segment s), over positions [s*G,
//     min((s+1)*G, n)), n = clamp(length, 0, L).  Segment 0 starts from the
//     carried state; segment s > 0 first steps the 16 pairs before its
//     start from S = 0 and records no match there.  That is exact: every
//     byte moves each bit of S one place up and bit 0 never reads S, so the
//     state after 32 bytes holds nothing of the state before them.  The
//     recurrence is monotone in S, so a short warm-up could only lose a
//     match, never invent one (15 pairs do lose one: a 32-byte factor that
//     ends on a segment's first byte).  Matches of the segments are OR-ed
//     into match_out (atomicOr, order-free; the launch first fills
//     match_out with match_in or zeros on the same stream); the unit whose
//     range holds the row's end writes the state, keeps an odd length's
//     half pair, and keeps scan_pairs' contract: state 0 for a row shorter
//     than L.  With one segment (G >= L) the unit stores its words directly
//     and nothing is filled.  A row-starved launch (the batch path's 8-row
//     buckets of long bodies) so gets B * segments warps in place of B.
//   * The prologue uses the card's asynchronous bulk copies.  The class
//     table arrives word-tile-major, (tiles, K+1, 32), so a block's
//     32-word slice is one contiguous span, laid out [class][lane] so a
//     warp's 32 reads of one class row hit 32 distinct banks; no index
//     arithmetic or divide per element.  One thread starts the copies of
//     that slice and (raw-byte configuration) of the LUT's first 256
//     entries (cp.async.bulk, completing on a block mbarrier; a bulk copy
//     moves a multiple of 16 bytes, and the 257 entries are 1028, so the
//     dead index's entry is read on its own) while every warp's
//     lane 0 starts the copies of its unit's first two token windows (on
//     the warp's own two mbarriers): all in flight together.  Each window
//     is mapped once per position (through the LUT, or by clamping the
//     class id) into the warp's staged byte offsets of class rows (class *
//     128, uint16, read eight at a time with one 16-byte load in the
//     chain), and the window two ahead is started into the freed buffer
//     before the warp scans: the copy of the next window overlaps the
//     chain.  Bulk copies rather than 16-byte vector loads: the copy
//     engine moves a window with one instruction and no registers, and
//     the windows' 16-byte granules make any row start or length copyable
//     (the vector load variant was not built, so no same-run comparison
//     exists).
//   * The TPU's one-hot MXU product and bf16 byte planes are gone: they
//     exist only because per-lane gathers are slow on a TPU.  By the
//     composition identity planes_byte[b] == planes_class[byte_class[b]],
//     the LUT lookup followed by the class-table lookup gives the same
//     reach rows.
//
// Layout: block = 8 warps = 8 consecutive units (unit = row * segments +
// segment), grid (word tiles, ceil(B * segments / 8)); lane l handles word
// blockIdx.x*32 + l.  Lanes past W compute on zero reach and write nothing.
// An odd length ends with a half pair whose second byte is the dead class
// (zero reach), so S becomes 0 and no stale data is read.
//
// Launch contract: no memory is allocated here; the caller passes every
// buffer and the stream, and reads the return value (cudaGetLastError()).
// pair_scan_init() runs once before the first launch.  There is no
// fallback: the bindings (ops/pair_scan.py) launch this kernel for CUDA
// tensors or raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kWordsPerBlock = 32;   // one word per lane
constexpr int kUnitsPerBlock = 8;    // one (row, segment) unit per warp
constexpr int kHalo = 32;            // warm-up positions (16 pairs)
constexpr int kLutEntries = 257;     // 256 bytes + the dead index
constexpr int kLutBytes = 1040;      // the LUT's shared slot, 16 B multiple
constexpr int kLutCopied = 256;      // entries bulk-copied (1024 B); the
                                     // dead index is read on its own, so
                                     // no copy reads past the 257 entries
constexpr int kMaxK1 = 257;          // the raw byte table + the dead class

// positions staged per window (even): 2 KB of raw tokens either way
template <bool kBytes>
__host__ __device__ constexpr int window() { return kBytes ? 1024 : 512; }

template <bool kBytes>
__host__ __device__ constexpr int raw_bytes() {   // aligned copy + slack
  return window<kBytes>() * (kBytes ? 1 : 4) + 32;
}

__host__ __device__ inline size_t table_bytes(int k1) {
  return (size_t)k1 * kWordsPerBlock * sizeof(uint32_t);
}

template <bool kBytes>
__host__ __device__ inline size_t smem_bytes(int k1) {
  return table_bytes(k1) + (kBytes ? kLutBytes : 0) +
         kUnitsPerBlock * (2 * raw_bytes<kBytes>() +
                           window<kBytes>() * sizeof(uint16_t)) +
         (1 + 2 * kUnitsPerBlock) * sizeof(uint64_t) +
         kUnitsPerBlock * kShadowBytes;
}

template <bool kBytes>
__global__ void __launch_bounds__(kUnitsPerBlock * 32, 4)
pair_scan_kernel(const void* __restrict__ tokens,
                 const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ byte_class,
                 const uint32_t* __restrict__ class_tiles, int k1,
                 const uint32_t* __restrict__ init_mask,
                 const uint32_t* __restrict__ final_mask,
                 const uint32_t* __restrict__ state_in,
                 const uint32_t* __restrict__ match_in,
                 uint32_t* __restrict__ match_out,
                 uint32_t* __restrict__ state_out, int B, int L, int W,
                 int G, int nseg) {
  using Tok = typename std::conditional<kBytes, uint8_t, int32_t>::type;
  constexpr int kWin = window<kBytes>();
  constexpr int kRaw = raw_bytes<kBytes>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  int* lut = reinterpret_cast<int*>(smem + table_bytes(k1));
  unsigned char* raw_all =
      smem + table_bytes(k1) + (kBytes ? kLutBytes : 0);
  uint16_t* staged_all =
      reinterpret_cast<uint16_t*>(raw_all + kUnitsPerBlock * 2 * kRaw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(staged_all +
                                               kUnitsPerBlock * kWin);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWordsPerBlock + lane;
  const int dead = k1 - 1;
  const Unit u = unit_of(blockIdx.y * kUnitsPerBlock + warp, nseg, G, kHalo,
                         lengths, B, L);
  unsigned char* raw = raw_all + warp * 2 * kRaw;
  uint16_t* staged = staged_all + warp * kWin;
  uint64_t* wbar = bars + 1 + 2 * warp;   // this warp's two windows
  SCAN_CHECK_DO(Shadow sh(reinterpret_cast<ShadowSlot*>(
                              bars + 1 + 2 * kUnitsPerBlock) + warp, lane);
                sh.clear());

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * kUnitsPerBlock; ++i) bar_init(bars + i, 1);
    bar_init_fence();
  }
  if (!__syncthreads_or(u.live)) return;   // every unit past its row's end

  const Tok* src = static_cast<const Tok*>(tokens) + (size_t)u.row * L +
                   u.from;
  const size_t span = token_span(B, L, sizeof(Tok));
  const int total = u.end - u.from;
  const int nwin = (total + kWin - 1) / kWin;
  if (threadIdx.x == 0) {
    const uint32_t* slice = class_tiles + (size_t)blockIdx.x * k1 *
                                              kWordsPerBlock;
    SCAN_CHECK_DO(
        check(((uintptr_t)tokens & 15) == 0, kTokensMisaligned, 0);
        check(inside(slice, table_bytes(k1), class_tiles,
                     gridDim.x * table_bytes(k1)),
              kCopyOutsideBuffer, -1);
        if (kBytes) check(inside(byte_class, kLutCopied * sizeof(int),
                                 byte_class, kLutEntries * sizeof(int)),
                          kCopyOutsideBuffer, -2));
    bar_expect(bars, (uint32_t)(table_bytes(k1) +
                                (kBytes ? kLutCopied * sizeof(int) : 0)));
    bulk_copy(tbl, slice, (uint32_t)table_bytes(k1), bars);
    if (kBytes) bulk_copy(lut, byte_class, kLutCopied * sizeof(int), bars);
  }
  if (lane == 0) {
    for (int k = 0; k < 2 && k < nwin; ++k) {
      SCAN_CHECK_DO(sh.issue(k, false));
      fetch(raw + k * kRaw, kRaw, src + k * kWin,
            min(kWin, total - k * kWin) * (uint32_t)sizeof(Tok), tokens,
            span, wbar + k);
    }
  }
  bar_wait(bars, 0);
  if (kBytes) {   // byte -> offset of its class row; bad ids read as dead
    for (int i = threadIdx.x; i < kLutEntries; i += blockDim.x) {
      const int c = i < kLutCopied ? lut[i] : byte_class[i];
      lut[i] = ((unsigned)c < (unsigned)k1 ? c : dead) * kRowBytes;
    }
  }
  __syncthreads();
  if (!u.live) return;   // whole warp leaves; no block barrier follows
  SCAN_CHECK_DO(check(u.row < B, kRowOutsideLaunch, u.row));

  const bool active = w < W;
  const size_t at = (size_t)u.row * W + w;
  const uint32_t I = active ? init_mask[w] : 0u;
  const uint32_t F = active ? final_mask[w] : 0u;
  const uint32_t IOR = (I << 1) | I;
  uint32_t S = (u.seg == 0 && active && state_in) ? state_in[at] : 0u;
  uint32_t M = (nseg == 1 && active && match_in) ? match_in[at] : 0u;
  const unsigned char* column =   // this lane's word of every class row
      reinterpret_cast<const unsigned char*>(tbl + lane);
  // one full pair: the match ending on its first byte, then two steps
  auto pair = [&](uint32_t o1, uint32_t o2) {
    const uint32_t R1 = reach(column, o1);
    const uint32_t R2 = reach(column, o2);
    M |= ((S << 1) | I) & (R1 & F);
    S = ((S << 2) | IOR) & (((R1 << 1) | I) & R2);
    M |= S & F;
  };

  for (int k = 0; k < nwin; ++k) {
    const int cnt = min(kWin, total - k * kWin);
    unsigned char* buf = raw + (k & 1) * kRaw;
    SCAN_WINDOW_WAIT(wbar + (k & 1), k & 1, (k >> 1) & 1);
    const Tok* toks = reinterpret_cast<const Tok*>(
        buf + granules(src + k * kWin, cnt * sizeof(Tok)).head);
    for (int j = lane; j < cnt; j += 32) {
      SCAN_CHECK_DO(check(toks[j] == src[k * kWin + j], kStaleToken, k);
                    sh.write(j));
      if (kBytes) {
        staged[j] = (uint16_t)lut[toks[j]];
      } else {
        const int c = toks[j];
        staged[j] = (uint16_t)(((unsigned)c < (unsigned)k1 ? c : dead) *
                               kRowBytes);
      }
    }
    SCAN_SYNCWARP();
    if (lane == 0 && k + 2 < nwin) {
      SCAN_CHECK_DO(sh.issue(k & 1, true));
      proxy_fence();
      fetch(buf, kRaw, src + (k + 2) * kWin,
            min(kWin, total - (k + 2) * kWin) * (uint32_t)sizeof(Tok),
            tokens, span, wbar + (k & 1));
    }
    SCAN_CHECK_DO(sh.chain());
    const uint16_t* off = staged;
    int steps = cnt;
    if (k == 0 && u.warm) {   // the halo: state only
      SCAN_CHECK_DO(check(cnt >= kHalo, kShortHalo, cnt));
#pragma unroll
      for (int j = 0; j < kHalo; j += 8) {
        uint32_t o[8];
        SCAN_CHECK_DO(sh.read(j, 8));
        offsets8(off + j, o);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const uint32_t R1 = reach(column, o[i]);
          const uint32_t R2 = reach(column, o[i + 1]);
          S = ((S << 2) | IOR) & (((R1 << 1) | I) & R2);
        }
      }
      off += kHalo;
      steps -= kHalo;
    }
    int j = 0;
#pragma unroll 2
    for (; j + 8 <= steps; j += 8) {
      uint32_t o[8];
      SCAN_CHECK_DO(sh.read((int)(off - staged) + j, 8));
      offsets8(off + j, o);
#pragma unroll
      for (int i = 0; i < 8; i += 2) pair(o[i], o[i + 1]);
    }
    for (; j + 1 < steps; j += 2) {
      SCAN_CHECK_DO(sh.read((int)(off - staged) + j, 2));
      pair(off[j], off[j + 1]);
    }
    if (j < steps) {
      // odd length: the half pair's second byte is the dead class
      SCAN_CHECK_DO(sh.read((int)(off - staged) + j, 1));
      M |= ((S << 1) | I) & (reach(column, off[j]) & F);
      S = 0u;
    }
    SCAN_SYNCWARP();   // the next window overwrites the staged offsets
  }
  if (active) {
    if (nseg == 1) {
      match_out[at] = M;
    } else if (M) {
      atomicOr(match_out + at, M);
    }
    // scan_pairs contract: dead padding kills the state of a short row
    if (u.ends_row) state_out[at] = u.n < L ? 0u : S;
  }
}

template <bool kBytes>
int launch(const void* tokens, const int32_t* lengths,
           const int32_t* byte_class, const uint32_t* class_tiles, int k1,
           const uint32_t* init_mask, const uint32_t* final_mask,
           const uint32_t* state_in, const uint32_t* match_in,
           uint32_t* match_out, uint32_t* state_out, int B, int L, int W,
           int G, int nseg, int blocks, cudaStream_t stream) {
  const dim3 grid((W + kWordsPerBlock - 1) / kWordsPerBlock, blocks);
  const dim3 block(kUnitsPerBlock * 32);
  pair_scan_kernel<kBytes><<<grid, block, smem_bytes<kBytes>(k1), stream>>>(
      tokens, lengths, byte_class, class_tiles, k1, init_mask, final_mask,
      state_in, match_in, match_out, state_out, B, L, W, G, nseg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest class count (k + 1, dead class included) the kernel accepts.
int pair_scan_max_k1() { return kMaxK1; }

// Call once after loading, before any launch: allows both configurations
// the dynamic shared memory of the largest class table.  Returns a CUDA
// error code; 0 = ready.
int pair_scan_init() {
  cudaError_t err = cudaFuncSetAttribute(
      pair_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<true>(kMaxK1));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      pair_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<false>(kMaxK1));
}

// tokens: uint8 (B, L) when byte_class is given (raw-byte configuration),
// else int32 class ids (B, L); 16-byte aligned and readable to the next
// 16-byte boundary past its end (token_span: windows are copied as whole
// 16-byte granules).  byte_class: int32 (257,), 16-byte aligned;
// class_tiles: uint32 (ceil(W/32), k1, 32), 16-byte aligned, words past W
// zero.  state_in / match_in may be null (zeros).  G: the segment length
// (ops/segments.py): G >= L is one segment, else a multiple of 32 of at
// least 32.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a G the kernel cannot split by); 0 = launched.
int pair_scan_launch(const void* tokens, const void* lengths,
                     const void* byte_class, const void* class_tiles, int k1,
                     const void* init_mask, const void* final_mask,
                     const void* state_in, const void* match_in,
                     void* match_out, void* state_out, int B, int L, int W,
                     int G, void* stream) {
  if (B == 0 || W == 0) return 0;
  if (G < L && (G < kHalo || G % 32 != 0)) return (int)cudaErrorInvalidValue;
  const int nseg = G >= L ? 1 : (L + G - 1) / G;
  const long blocks = ((long)B * nseg + kUnitsPerBlock - 1) / kUnitsPerBlock;
  if (blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto* ct = static_cast<const uint32_t*>(class_tiles);
  const auto* im = static_cast<const uint32_t*>(init_mask);
  const auto* fm = static_cast<const uint32_t*>(final_mask);
  const auto* si = static_cast<const uint32_t*>(state_in);
  const auto* mi = static_cast<const uint32_t*>(match_in);
  auto* mo = static_cast<uint32_t*>(match_out);
  auto* so = static_cast<uint32_t*>(state_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (nseg > 1) {   // the units OR their matches into match_out
    const size_t words = (size_t)B * W * sizeof(uint32_t);
    const cudaError_t err =
        mi ? cudaMemcpyAsync(mo, mi, words, cudaMemcpyDeviceToDevice, s)
           : cudaMemsetAsync(mo, 0, words, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (byte_class != nullptr) {
    return launch<true>(tokens, len, static_cast<const int32_t*>(byte_class),
                        ct, k1, im, fm, si, mi, mo, so, B, L, W, G, nseg,
                        (int)blocks, s);
  }
  return launch<false>(tokens, len, nullptr, ct, k1, im, fm, si, mi, mo, so,
                       B, L, W, G, nseg, (int)blocks, s);
}

#ifdef SCAN_CHECK
// The checked build's failures since the last call: counts[16] gets
// them by code (scan_common.cuh CheckCode), first[4] the first one's
// code, blockIdx.x, blockIdx.y and detail; resets them.  Returns their
// total, or -1 when a CUDA call fails.
long long pair_scan_check_errors(unsigned long long* counts, int* first) {
  return scan_common::check_errors(counts, first);
}
#endif

}  // extern "C"
