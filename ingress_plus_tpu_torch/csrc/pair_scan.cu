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
// Words carry no bits into each other, so one thread owns one (row, word)
// pair and keeps S and M in registers; the serial pair chain runs inside
// the thread, in place of the TPU kernel's sequential grid axis.
//
// What bounds it on the H100: integer ALU work and shared-memory lookups in
// the serial chain.  Per (row, word, pair) the recurrence needs 2 class-table
// reads and 8 integer instructions once the bitwise parts fuse into LOP3:
// 3 shifts (S<<1, S<<2, R1<<1; these may issue on the FMA pipe as IMAD.SHL)
// and 5 LOP3 ((S<<1|I)&R1, M|(x&F), (R1<<1|I)&R2, (S<<2|IOR)&r, M|(S&F)),
// which only the 64-lane ALU pipe runs.  Device memory is not the limit:
// the kernel reads B*L token bytes and writes 2*B*W*4 bytes.  What the
// design does about it:
//   * the class table slice for the block's 32 words lives in shared
//     memory, laid out [class][lane] so a warp's 32 reads of one class row
//     hit 32 distinct banks; the LUT and the staged class ids of a chunk of
//     the row are read by all lanes at one address (a broadcast);
//   * the LUT is applied once per byte while a warp stages a chunk of its
//     row into shared memory, not once per (byte, word);
//   * the TPU's one-hot MXU product and bf16 byte planes are gone: they
//     exist only because per-lane gathers are slow on a TPU.  By the
//     composition identity planes_byte[b] == planes_class[byte_class[b]],
//     the LUT lookup followed by the class-table lookup gives the same
//     reach rows.
//
// Layout: block = 8 warps; warp r handles row blockIdx.y*8 + r, lane l
// handles word blockIdx.x*32 + l.  Each row stops at its own length.  An
// odd length ends with a half pair whose second byte is the dead class
// (zero reach), so S becomes 0 and no stale data is read.  The returned
// state follows scan_pairs: 0 for every row shorter than L.
//
// Launch contract: no memory is allocated here; the caller passes every
// buffer and the stream, and reads the return value (cudaGetLastError()).
// pair_scan_init() runs once before the first launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordsPerBlock = 32;   // one word per lane
constexpr int kRowsPerBlock = 8;     // one row per warp
constexpr int kChunk = 1024;         // positions staged per chunk (even)
constexpr int kLutEntries = 257;     // 256 bytes + the dead index
constexpr int kMaxK1 = 257;          // the raw byte table + the dead class

__host__ __device__ inline size_t smem_bytes(int k1, bool bytes) {
  return (size_t)k1 * kWordsPerBlock * sizeof(uint32_t) +
         (bytes ? 260 * sizeof(int) : 0) +
         (size_t)kRowsPerBlock * kChunk * sizeof(uint16_t);
}

template <bool kBytes>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
pair_scan_kernel(const void* __restrict__ tokens,
                 const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ byte_class,
                 const uint32_t* __restrict__ class_table, int k1,
                 const uint32_t* __restrict__ init_mask,
                 const uint32_t* __restrict__ final_mask,
                 const uint32_t* __restrict__ state_in,
                 const uint32_t* __restrict__ match_in,
                 uint32_t* __restrict__ match_out,
                 uint32_t* __restrict__ state_out, int B, int L, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  int* lut = reinterpret_cast<int*>(tbl + (size_t)k1 * kWordsPerBlock);
  uint16_t* staged = reinterpret_cast<uint16_t*>(lut + (kBytes ? 260 : 0));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kWordsPerBlock;
  const int w = w0 + lane;
  const int row = blockIdx.y * kRowsPerBlock + warp;
  const int dead = k1 - 1;

  // the class table slice of this block's words; words past W read as
  // zero reach (their lanes write nothing)
  for (int i = threadIdx.x; i < k1 * kWordsPerBlock; i += blockDim.x) {
    const int c = i / kWordsPerBlock;
    const int ww = w0 + (i % kWordsPerBlock);
    tbl[i] = ww < W ? class_table[(size_t)c * W + ww] : 0u;
  }
  if (kBytes) {
    for (int i = threadIdx.x; i < kLutEntries; i += blockDim.x) {
      const int c = byte_class[i];
      lut[i] = (unsigned)c < (unsigned)k1 ? c : dead;
    }
  }
  __syncthreads();
  if (row >= B) return;   // whole warp leaves; no block barrier follows

  const bool active = w < W;
  const size_t out_at = (size_t)row * W + w;
  const uint32_t I = active ? init_mask[w] : 0u;
  const uint32_t F = active ? final_mask[w] : 0u;
  const uint32_t IOR = (I << 1) | I;
  uint32_t S = (active && state_in) ? state_in[out_at] : 0u;
  uint32_t M = (active && match_in) ? match_in[out_at] : 0u;

  int n = lengths[row];
  n = n < 0 ? 0 : (n > L ? L : n);
  uint16_t* mine = staged + warp * kChunk;
  const uint32_t* my_tbl = tbl + lane;

  for (int base = 0; base < n; base += kChunk) {
    const int cnt = min(kChunk, n - base);
    __syncwarp();
    if (kBytes) {
      const uint8_t* src =
          static_cast<const uint8_t*>(tokens) + (size_t)row * L + base;
      for (int j = lane; j < cnt; j += 32) mine[j] = (uint16_t)lut[src[j]];
    } else {
      const int32_t* src =
          static_cast<const int32_t*>(tokens) + (size_t)row * L + base;
      for (int j = lane; j < cnt; j += 32) {
        const int c = src[j];
        mine[j] = (uint16_t)((unsigned)c < (unsigned)k1 ? c : dead);
      }
    }
    __syncwarp();
    int j = 0;
#pragma unroll 4
    for (; j + 1 < cnt; j += 2) {
      const uint32_t R1 = my_tbl[mine[j] * kWordsPerBlock];
      const uint32_t R2 = my_tbl[mine[j + 1] * kWordsPerBlock];
      M |= ((S << 1) | I) & (R1 & F);
      S = ((S << 2) | IOR) & (((R1 << 1) | I) & R2);
      M |= S & F;
    }
    if (j < cnt) {
      // odd length: the half pair's second byte is the dead class
      const uint32_t R1 = my_tbl[mine[j] * kWordsPerBlock];
      M |= ((S << 1) | I) & (R1 & F);
      S = 0u;
    }
  }
  if (n < L) S = 0u;   // scan_pairs contract: dead padding kills the state
  if (active) {
    match_out[out_at] = M;
    state_out[out_at] = S;
  }
}

template <bool kBytes>
int launch(const void* tokens, const int32_t* lengths,
           const int32_t* byte_class, const uint32_t* class_table, int k1,
           const uint32_t* init_mask, const uint32_t* final_mask,
           const uint32_t* state_in, const uint32_t* match_in,
           uint32_t* match_out, uint32_t* state_out, int B, int L, int W,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(k1, kBytes);
  const dim3 grid((W + kWordsPerBlock - 1) / kWordsPerBlock,
                  (B + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  pair_scan_kernel<kBytes><<<grid, block, smem, stream>>>(
      tokens, lengths, byte_class, class_table, k1, init_mask, final_mask,
      state_in, match_in, match_out, state_out, B, L, W);
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
      (int)smem_bytes(kMaxK1, true));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      pair_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxK1, false));
}

// tokens: uint8 (B, L) when byte_class is given (raw-byte configuration),
// else int32 class ids (B, L).  state_in / match_in may be null (zeros).
// Returns cudaGetLastError() after the launch; 0 = launched.
int pair_scan_launch(const void* tokens, const void* lengths,
                     const void* byte_class, const void* class_table, int k1,
                     const void* init_mask, const void* final_mask,
                     const void* state_in, const void* match_in,
                     void* match_out, void* state_out, int B, int L, int W,
                     void* stream) {
  if (B == 0 || W == 0) return 0;
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto* ct = static_cast<const uint32_t*>(class_table);
  const auto* im = static_cast<const uint32_t*>(init_mask);
  const auto* fm = static_cast<const uint32_t*>(final_mask);
  const auto* si = static_cast<const uint32_t*>(state_in);
  const auto* mi = static_cast<const uint32_t*>(match_in);
  auto* mo = static_cast<uint32_t*>(match_out);
  auto* so = static_cast<uint32_t*>(state_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (byte_class != nullptr) {
    return launch<true>(tokens, len, static_cast<const int32_t*>(byte_class),
                        ct, k1, im, fm, si, mi, mo, so, B, L, W, s);
  }
  return launch<false>(tokens, len, nullptr, ct, k1, im, fm, si, mi, mo, so,
                       B, L, W, s);
}

}  // extern "C"
