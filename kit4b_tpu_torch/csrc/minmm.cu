// Max-match kernel of the exhaustive K-mer Hamming engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_minmm_kernel` of kit4b_tpu/kmer/hammings_mxu.py
// (launched by `_minmm_pallas`). Every genome K-mer window is a one-hot int8
// row of width Cw = 128*ceil(5K/128), so the number of matching bases of two
// windows is the int8 dot product of their rows. For each own row i:
//
//   out[i] = max over partner columns j in [col_lo, col_hi) of W_own[i] . W_part[j]
//
// where the self pair (row_base + i == j) counts as -2^20 when `diag` is set.
// The caller turns it into the minimum Hamming distance K - out[i].
//
// What bounds it: int8 multiply-accumulates, 2*R*span*Cw operations per
// orientation (R own rows, span partner columns). The [R, span] pair matrix
// never leaves registers.
//
// Design. The TPU ran its span axis in order and carried the running max
// from one grid step to the next in the output block. Here blocks run in
// parallel, so a block owns 128 own rows, keeps them in shared memory, and
// walks the whole partner range itself in tiles of 128 columns: the running
// max stays in registers and no block needs another's result. Each of the 8
// warps multiplies its 16 rows by the tile with mma.sync m16n8k32 (s8 in,
// s32 accumulate), masks the diagonal and folds the tile into its running
// max; only tiles that cross the diagonal pay for the mask. Shared-memory
// rows are padded by 16 bytes, so the 8 rows that one fragment load
// touches fall on distinct banks. Tiles are loaded
// synchronously: TMA, wgmma and a pipeline of tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // own rows per block (8 warps x 16), also partner columns per tile
constexpr int kThreads = 256;
constexpr int kPad = 16;       // bytes of padding after each shared-memory row
constexpr int kNeg = -(1 << 20);

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x32 s8, row major) * b (32x8 s8, column major), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies kRows consecutive rows of cw bytes from src into dst (row pitch ld).
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* src,
                                          int cw, int ld) {
  const int chunks = cw / 16;
  for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * ld + c * 16) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * cw + c * 16);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
minmm_kernel(const int8_t* __restrict__ w_own, const int8_t* __restrict__ w_part,
             int cw, long long col_lo, long long col_hi, int diag,
             long long row_base, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ld = cw + kPad;
  uint8_t* s_own = smem;
  uint8_t* s_part = smem + kRows * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma groupID, threadID_in_group
  const long long r0 = (long long)blockIdx.x * kRows;

  load_tile(s_own, w_own + r0 * cw, cw, ld);
  // This thread's A fragment rows are g and g + 8 of its warp's 16 rows;
  // its B fragment column is g of each 8-column n-tile.
  const uint8_t* a_lo = s_own + (warp * 16 + g) * ld + t * 4;
  const uint8_t* a_hi = a_lo + 8 * ld;
  const uint8_t* b_base = s_part + g * ld + t * 4;
  const long long row = row_base + r0 + warp * 16 + g;   // global row of a_lo
  const long long block_row = row_base + r0;             // global row of s_own[0]
  int best_lo = kNeg, best_hi = kNeg;

  for (long long c0 = col_lo; c0 < col_hi; c0 += kRows) {
    // Only a tile whose columns overlap this block's rows holds self pairs.
    const bool on_diag = diag && c0 < block_row + kRows && block_row < c0 + kRows;
    __syncthreads();   // the previous tile is consumed; s_own is complete
    load_tile(s_part, w_part + c0 * cw, cw, ld);
    __syncthreads();
    int acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k = 0; k < cw; k += 32) {
      const uint32_t a[4] = {lds32(a_lo + k), lds32(a_hi + k),
                             lds32(a_lo + k + 16), lds32(a_hi + k + 16)};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint8_t* b = b_base + j * 8 * ld + k;
        mma_s8(acc[j], a, lds32(b), lds32(b + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // acc[j][0..1] are (row, col + 0..1); acc[j][2..3] are (row + 8, col + 0..1)
      const long long col = c0 + j * 8 + t * 2;
      int v0 = acc[j][0], v1 = acc[j][1], v2 = acc[j][2], v3 = acc[j][3];
      if (on_diag) {
        if (row == col) v0 = kNeg;
        if (row == col + 1) v1 = kNeg;
        if (row + 8 == col) v2 = kNeg;
        if (row + 8 == col + 1) v3 = kNeg;
      }
      best_lo = max(best_lo, max(v0, v1));
      best_hi = max(best_hi, max(v2, v3));
    }
  }
  // The four threads of a group hold the same two rows.
  for (int m = 1; m < 4; m <<= 1) {
    best_lo = max(best_lo, __shfl_xor_sync(0xffffffffu, best_lo, m));
    best_hi = max(best_hi, __shfl_xor_sync(0xffffffffu, best_hi, m));
  }
  if (t == 0) {
    out[r0 + warp * 16 + g] = best_lo;
    out[r0 + warp * 16 + g + 8] = best_hi;
  }
}

}  // namespace

// Launches the kernel on `stream` of `device`. rows and col_hi - col_lo are
// multiples of 128, cw is a multiple of 128 of at most 768, and all pointers
// are device pointers (the Python wrapper checks). Returns the CUDA error of
// the launch, 0 on success.
extern "C" int minmm_launch(int device, const void* w_own, const void* w_part,
                            long long rows, int cw, long long col_lo,
                            long long col_hi, int diag, long long row_base,
                            void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = 2 * kRows * (cw + kPad);
  err = cudaFuncSetAttribute(minmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  minmm_kernel<<<(unsigned)(rows / kRows), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(w_own), static_cast<const int8_t*>(w_part), cw,
      col_lo, col_hi, diag, row_base, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
