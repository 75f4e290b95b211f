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
// and match.  What the design does about it:
//   * one thread owns one (row, word) and keeps S and M in registers; words
//     carry no bits into each other, so the serial byte chain runs inside
//     the thread, in place of the TPU kernel's sequential grid axis and its
//     per-step validity mask;
//   * the block's 32-word slice of the class table lives in shared memory,
//     laid out [class][lane] so a warp's 32 reads of one class row hit 32
//     distinct banks.  The raw 256-row byte table of the bundled pack
//     (256 x 225 x 4 B, about 230 KB) would not fit beside the staging
//     buffer; since byte_table[b] == class_table[byte_class[b]], the LUT
//     followed by the class-table read gives the same reach rows;
//   * a warp stages a chunk of its row into shared memory as class-row
//     offsets (class * 32), applying the LUT once per byte, not once per
//     (byte, word); every lane then reads the same staged offset (a
//     broadcast);
//   * the TPU's one-hot MXU product over bf16 byte planes is gone: it
//     exists only because per-lane gathers are slow on a TPU.
// Words are int32 bit patterns on the PyTorch side; here they are uint32,
// so << is a logical shift whatever the top bit.
//
// Layout: block = 8 warps; warp r handles row blockIdx.y*8 + r, lane l
// handles word blockIdx.x*32 + l.  Lanes past W compute on zero reach and
// write nothing.
//
// Launch contract: no memory is allocated here; the caller passes every
// buffer and the stream, and reads the return value (cudaGetLastError()).
// step_scan_init() runs once per device before the first launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordsPerBlock = 32;   // one word per lane
constexpr int kRowsPerBlock = 8;     // one row per warp
constexpr int kChunk = 1024;         // bytes staged per chunk of a row
constexpr int kLutEntries = 257;     // 256 bytes + the dead index
constexpr int kLutPadded = 260;      // keeps the staging buffer 16 B aligned
constexpr int kMaxK1 = 257;          // the raw byte table + the dead class

__host__ __device__ inline size_t smem_bytes(int k1) {
  return (size_t)k1 * kWordsPerBlock * sizeof(uint32_t) +
         kLutPadded * sizeof(int) +
         (size_t)kRowsPerBlock * kChunk * sizeof(uint16_t);
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
step_scan_kernel(const uint8_t* __restrict__ tokens,
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
  uint16_t* staged = reinterpret_cast<uint16_t*>(lut + kLutPadded);

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
  // byte -> offset of its class row; ids outside [0, k1) read as dead
  for (int i = threadIdx.x; i < kLutEntries; i += blockDim.x) {
    const int c = byte_class[i];
    lut[i] = ((unsigned)c < (unsigned)k1 ? c : dead) * kWordsPerBlock;
  }
  __syncthreads();
  if (row >= B) return;   // whole warp leaves; no block barrier follows

  const bool active = w < W;
  const size_t at = (size_t)row * W + w;
  const uint32_t I = active ? init_mask[w] : 0u;
  const uint32_t F = active ? final_mask[w] : 0u;
  uint32_t S = (active && state_in) ? state_in[at] : 0u;
  uint32_t M = (active && match_in) ? match_in[at] : 0u;

  int n = lengths[row];
  n = n < 0 ? 0 : (n > L ? L : n);
  uint16_t* mine = staged + warp * kChunk;
  const uint32_t* my_tbl = tbl + lane;
  const uint8_t* src = tokens + (size_t)row * L;

  for (int base = 0; base < n; base += kChunk) {
    const int cnt = min(kChunk, n - base);
    __syncwarp();
    for (int j = lane; j < cnt; j += 32) {
      mine[j] = (uint16_t)lut[src[base + j]];
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      S = ((S << 1) | I) & my_tbl[mine[j]];
      M |= S & F;
    }
  }
  if (active) {
    match_out[at] = M;
    state_out[at] = S;
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

// tokens: uint8 (B, L); lengths: int32 (B,); byte_class: int32 (257,);
// class_table: uint32 (k1, W); init/final: uint32 (W,); state_in /
// match_in: uint32 (B, W) or null (zeros); outputs uint32 (B, W).
// Returns cudaGetLastError() after the launch; 0 = launched.
int step_scan_launch(const void* tokens, const void* lengths,
                     const void* byte_class, const void* class_table, int k1,
                     const void* init_mask, const void* final_mask,
                     const void* state_in, const void* match_in,
                     void* match_out, void* state_out, int B, int L, int W,
                     void* stream) {
  if (B == 0 || W == 0) return 0;
  const dim3 grid((W + kWordsPerBlock - 1) / kWordsPerBlock,
                  (B + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * 32);
  step_scan_kernel<<<grid, block, smem_bytes(k1),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tokens),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(byte_class),
      static_cast<const uint32_t*>(class_table), k1,
      static_cast<const uint32_t*>(init_mask),
      static_cast<const uint32_t*>(final_mask),
      static_cast<const uint32_t*>(state_in),
      static_cast<const uint32_t*>(match_in),
      static_cast<uint32_t*>(match_out), static_cast<uint32_t*>(state_out),
      B, L, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
