// Per-byte shift-AND scan with an exact per-row state, for Hopper (sm_90a).
//
// Replaces ingress_plus_tpu/ops/pallas_scan.py::_scan_kernel (serving name
// "pallas", PallasScanner).  Its plain PyTorch version is
// ingress_plus_tpu_torch/ops/scan.py::scan_bytes.
//
// Per (row, word), for each of the row's first clamp(length, 0, L) bytes b:
//     S = ((S<<1)|I) & T[class(b)]
//     M |= S & F
// where class() is the 257-entry byte->class LUT and T the class table.
// Bytes past a row's length are not stepped, so the returned state is the
// state after exactly `length` bytes and carries into the row's next chunk
// (the stream lane chains waves this way), and a row of length 0 returns
// its state and match unchanged.  The state is never zeroed: that is the
// contract the pair kernel (pair_scan.cu) cannot keep, since it folds two
// bytes per step and kills the state of every row shorter than L.
//
// What bounds it on the H100: integer work and shared-memory lookups in the
// serial chain.  Per (row, word, byte) the recurrence is 1 shift, 2 LOP3
// ((S<<1|I)&R and M|(S&F)) and 1 class-table read.  At the SM's pipe rates
// (LOP3 on the 64-lane ALU pipe, every instruction through 128 lanes of
// issue, table reads through 32 shared-memory banks) the three tie at 1/32
// of an SM clock per (row, word, byte).  Device memory is not the limit: the
// kernel reads B*L token bytes and reads and writes 2*B*W*4 bytes of state
// and match.  Tensor cores have nothing to do here: the recurrence is a
// bitwise shift-AND with no product in it.
//
// What the design does about it:
//   * Words carry no bits into each other, so one lane owns one word and
//     keeps S and M in registers; the byte chain runs inside the thread, in
//     place of the TPU kernel's sequential grid axis and its per-step
//     validity mask.
//   * The chain of a row is split across warps (ops/segments.py plans the
//     segment length G).  A warp owns one unit, (row r, segment s), over
//     bytes [s*G, min((s+1)*G, n)), n = clamp(length, 0, L).  Segment 0
//     starts from the carried state; segment s > 0 first steps the 32
//     bytes before its start from S = 0 and records no match there.  That
//     is exact: each step moves every bit one place up and bit 0 never
//     reads S, so bit j of the state after a byte depends on the last j+1
//     bytes only, and after 32 bytes nothing of the state before them is
//     left (31 would do for the first recorded state, which already
//     includes the segment's first byte; 32 keeps segment starts 32-byte
//     aligned).  The recurrence is monotone in S, so a short warm-up could
//     only lose a match, never invent one.  Matches of the segments are
//     OR-ed into match_out (atomicOr, order-free; the launch first fills
//     match_out with match_in or zeros on the same stream); the state is
//     written by the one unit whose range holds the row's end (segment 0
//     for an empty row, which writes state_in back).  With one segment
//     (G >= L) the unit stores its words directly and nothing is filled.
//     A row-starved launch (a stream wave of 8-32 rows, an 8-row bucket)
//     so gets B * segments warps in place of B.
//   * The prologue uses the card's asynchronous bulk copies.  The class
//     table arrives word-tile-major, (tiles, K+1, 32), so a block's
//     32-word slice is one contiguous span, laid out [class][lane] so a
//     warp's 32 reads of one class row hit 32 distinct banks; no index
//     arithmetic or divide per element.  One thread starts the copies of
//     that slice and of the LUT's first 256 entries (cp.async.bulk,
//     completing on a block mbarrier; a bulk copy moves a multiple of 16
//     bytes, and the 257 entries are 1028, so the dead index's entry is
//     read on its own) while every warp's lane 0 starts the copies of its
//     unit's first two byte windows (on the warp's own two mbarriers): all
//     in flight together.  The LUT is then rewritten once into the byte
//     offsets of class rows (class * 128).  Each window is applied through
//     the LUT once per byte into the warp's staged offsets (uint16, read
//     eight at a time with one 16-byte load in the chain, so a byte costs
//     one table read, an add and its three recurrence instructions), and
//     the window two ahead is started into the freed buffer before the
//     warp scans: the copy of the next window overlaps the chain.  Bulk
//     copies rather than 16-byte vector loads: the copy engine moves a
//     window with one instruction and no registers, and the windows'
//     16-byte granules make any row start or length copyable (the vector
//     load variant was not built, so no same-run comparison exists).  The
//     raw 256-row byte table of
//     the bundled pack (about 230 KB) would not fit beside the windows;
//     byte_table[b] == class_table[byte_class[b]], so the LUT followed by
//     the class-table read gives the same reach rows.
//   * The TPU's one-hot MXU product over bf16 byte planes is gone: it
//     exists only because per-lane gathers are slow on a TPU.
// Words are int32 bit patterns on the PyTorch side; here they are uint32,
// so << is a logical shift whatever the top bit.
//
// Layout: block = 8 warps = 8 consecutive units (unit = row * segments +
// segment), grid (word tiles, ceil(B * segments / 8)); lane l handles word
// blockIdx.x*32 + l.  Lanes past W compute on zero reach and write nothing.
//
// Launch contract: no memory is allocated here; the caller passes every
// buffer and the stream, and reads the return value (cudaGetLastError()).
// step_scan_init() runs once per device before the first launch.  There
// is no fallback: the binding (ops/step_scan.py) launches this kernel for
// CUDA tensors or raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using namespace scan_common;

constexpr int kWordsPerBlock = 32;   // one word per lane
constexpr int kUnitsPerBlock = 8;    // one (row, segment) unit per warp
constexpr int kHalo = 32;            // warm-up bytes before a later segment
constexpr int kWin = 1024;           // bytes staged per window
constexpr int kRawBytes = kWin + 32; // a window's aligned copy, with slack
constexpr int kLutEntries = 257;     // 256 bytes + the dead index
constexpr int kLutBytes = 1040;      // the LUT's shared slot, 16 B multiple
constexpr int kLutCopied = 256;      // entries bulk-copied (1024 B); the
                                     // dead index is read on its own, so
                                     // no copy reads past the 257 entries
constexpr int kMaxK1 = 257;          // the raw byte table + the dead class

__host__ __device__ inline size_t table_bytes(int k1) {
  return (size_t)k1 * kWordsPerBlock * sizeof(uint32_t);
}

__host__ __device__ inline size_t smem_bytes(int k1) {
  return table_bytes(k1) + kLutBytes +
         kUnitsPerBlock * (2 * kRawBytes + kWin * sizeof(uint16_t)) +
         (1 + 2 * kUnitsPerBlock) * sizeof(uint64_t) +
         kUnitsPerBlock * kShadowBytes;
}

__global__ void __launch_bounds__(kUnitsPerBlock * 32, 4)
step_scan_kernel(const uint8_t* __restrict__ tokens,
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
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  int* lut = reinterpret_cast<int*>(smem + table_bytes(k1));
  unsigned char* raw_all = smem + table_bytes(k1) + kLutBytes;
  uint16_t* staged_all =
      reinterpret_cast<uint16_t*>(raw_all + kUnitsPerBlock * 2 * kRawBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(staged_all +
                                               kUnitsPerBlock * kWin);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * kWordsPerBlock + lane;
  const Unit u = unit_of(blockIdx.y * kUnitsPerBlock + warp, nseg, G, kHalo,
                         lengths, B, L);
  unsigned char* raw = raw_all + warp * 2 * kRawBytes;
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

  const uint8_t* src = tokens + (size_t)u.row * L + u.from;
  const size_t span = token_span(B, L, 1);
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
        check(inside(byte_class, kLutCopied * sizeof(int), byte_class,
                     kLutEntries * sizeof(int)),
              kCopyOutsideBuffer, -2));
    bar_expect(bars, (uint32_t)(table_bytes(k1) + kLutCopied * sizeof(int)));
    bulk_copy(tbl, slice, (uint32_t)table_bytes(k1), bars);
    bulk_copy(lut, byte_class, kLutCopied * sizeof(int), bars);
  }
  if (lane == 0) {
    for (int k = 0; k < 2 && k < nwin; ++k) {
      SCAN_CHECK_DO(sh.issue(k, false));
      fetch(raw + k * kRawBytes, kRawBytes, src + k * kWin,
            min(kWin, total - k * kWin), tokens, span, wbar + k);
    }
  }
  bar_wait(bars, 0);
  // byte -> byte offset of its class row; ids outside [0, k1) read as dead
  for (int i = threadIdx.x; i < kLutEntries; i += blockDim.x) {
    const int c = i < kLutCopied ? lut[i] : byte_class[i];
    lut[i] = ((unsigned)c < (unsigned)k1 ? c : k1 - 1) * kRowBytes;
  }
  __syncthreads();
  if (!u.live) return;   // whole warp leaves; no block barrier follows
  SCAN_CHECK_DO(check(u.row < B, kRowOutsideLaunch, u.row));

  const bool active = w < W;
  const size_t at = (size_t)u.row * W + w;
  const uint32_t I = active ? init_mask[w] : 0u;
  const uint32_t F = active ? final_mask[w] : 0u;
  uint32_t S = (u.seg == 0 && active && state_in) ? state_in[at] : 0u;
  uint32_t M = (nseg == 1 && active && match_in) ? match_in[at] : 0u;
  const unsigned char* column =   // this lane's word of every class row
      reinterpret_cast<const unsigned char*>(tbl + lane);

  for (int k = 0; k < nwin; ++k) {
    const int cnt = min(kWin, total - k * kWin);
    unsigned char* buf = raw + (k & 1) * kRawBytes;
    SCAN_WINDOW_WAIT(wbar + (k & 1), k & 1, (k >> 1) & 1);
    const unsigned char* bytes =
        buf + granules(src + k * kWin, cnt).head;
    for (int j = lane; j < cnt; j += 32) {
      SCAN_CHECK_DO(check(bytes[j] == src[k * kWin + j], kStaleToken, k);
                    sh.write(j));
      staged[j] = (uint16_t)lut[bytes[j]];
    }
    SCAN_SYNCWARP();
    if (lane == 0 && k + 2 < nwin) {
      SCAN_CHECK_DO(sh.issue(k & 1, true));
      proxy_fence();
      fetch(buf, kRawBytes, src + (k + 2) * kWin,
            min(kWin, total - (k + 2) * kWin), tokens, span, wbar + (k & 1));
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
        for (int i = 0; i < 8; ++i) S = ((S << 1) | I) & reach(column, o[i]);
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
      for (int i = 0; i < 8; ++i) {
        S = ((S << 1) | I) & reach(column, o[i]);
        M |= S & F;
      }
    }
    for (; j < steps; ++j) {
      SCAN_CHECK_DO(sh.read((int)(off - staged) + j, 1));
      S = ((S << 1) | I) & reach(column, off[j]);
      M |= S & F;
    }
    SCAN_SYNCWARP();   // the next window overwrites the staged offsets
  }
  if (active) {
    if (nseg == 1) {
      match_out[at] = M;
    } else if (M) {
      atomicOr(match_out + at, M);
    }
    if (u.ends_row) state_out[at] = S;
  }
}

}  // namespace

extern "C" {

// Largest class count (k + 1, dead class included) the kernel accepts.
int step_scan_max_k1() { return kMaxK1; }

// Call once per device after loading, before any launch: allows the kernel
// the dynamic shared memory of the largest class table.  Returns a CUDA
// error code; 0 = ready.
int step_scan_init() {
  return (int)cudaFuncSetAttribute(
      step_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxK1));
}

// tokens: uint8 (B, L), 16-byte aligned and readable to the next 16-byte
// boundary past its end (token_span: windows are copied as whole 16-byte
// granules); lengths: int32 (B,); byte_class: int32 (257,),
// 16-byte aligned; class_tiles: uint32 (ceil(W/32), k1, 32), 16-byte
// aligned, words past W zero; init/final: uint32 (W,); state_in /
// match_in: uint32 (B, W) or null (zeros); outputs uint32 (B, W).  G: the
// segment length (ops/segments.py): G >= L is one segment, else a multiple
// of 32 of at least 32.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a G the kernel cannot split by); 0 = launched.
int step_scan_launch(const void* tokens, const void* lengths,
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
  auto s = static_cast<cudaStream_t>(stream);
  if (nseg > 1) {   // the units OR their matches into match_out
    const size_t words = (size_t)B * W * sizeof(uint32_t);
    const cudaError_t err =
        match_in ? cudaMemcpyAsync(match_out, match_in, words,
                                   cudaMemcpyDeviceToDevice, s)
                 : cudaMemsetAsync(match_out, 0, words, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((W + kWordsPerBlock - 1) / kWordsPerBlock, (int)blocks);
  const dim3 block(kUnitsPerBlock * 32);
  step_scan_kernel<<<grid, block, smem_bytes(k1), s>>>(
      static_cast<const uint8_t*>(tokens),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(byte_class),
      static_cast<const uint32_t*>(class_tiles), k1,
      static_cast<const uint32_t*>(init_mask),
      static_cast<const uint32_t*>(final_mask),
      static_cast<const uint32_t*>(state_in),
      static_cast<const uint32_t*>(match_in),
      static_cast<uint32_t*>(match_out), static_cast<uint32_t*>(state_out),
      B, L, W, G, nseg);
  return (int)cudaGetLastError();
}

#ifdef SCAN_CHECK
// The checked build's failures since the last call: counts[16] gets
// them by code (scan_common.cuh CheckCode), first[4] the first one's
// code, blockIdx.x, blockIdx.y and detail; resets them.  Returns their
// total, or -1 when a CUDA call fails.
long long step_scan_check_errors(unsigned long long* counts, int* first) {
  return scan_common::check_errors(counts, first);
}
#endif

}  // extern "C"
