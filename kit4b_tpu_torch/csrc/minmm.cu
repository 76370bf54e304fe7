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
// What bounds it: the int8 tensor rate. A launch does 2*R*span*Cw operations
// (R own rows, span partner columns) on R*Cw + span*Cw input bytes; the
// [R, span] pair matrix never leaves registers, so bytes are negligible.
//
// Design. The TPU ran its span axis in order and carried the running max
// from one grid step to the next. Here blocks run in parallel: a block owns
// 256 own rows (128 at Cw = 768), keeps them in shared memory for its whole
// life, and walks the partner range itself, so the running max stays in
// registers and no block needs another's result.
// - Operands. Both matrices are K-major (a window's Cw bytes are contiguous),
//   which is the only layout 8-bit `wgmma` takes, and one 128-byte K-chunk
//   is one 128-byte swizzle atom. TMA copies each K-chunk of a tile into
//   shared memory in that swizzle (tensor maps built on the host per launch),
//   and `wgmma` reads both operands from there through descriptors.
// - Warp specialisation. Warpgroup 0 is the producer: `setmaxnreg` drops its
//   registers and one thread issues the TMA loads, first the block's own rows
//   (zero-filled past R), then 128-column x 128-byte partner chunks into a
//   ring of stages guarded by full/empty mbarriers. Warpgroups 1 and 2 are
//   consumers, 128 own rows each (two m64 groups; one at Cw = 768):
//   `wgmma.mma_async m64n128k32 s32.s8.s8` over the chunks of a tile, the
//   first k-step with scale-d = 0 in place of zeroed registers, then an
//   epilogue that folds the 128x128 tile into four running row maxima with
//   the DPX three-way max. The two consumers run independently, so one's
//   epilogue overlaps the other's `wgmma`; each warp of both arrives on a
//   stage's empty barrier when its products are done.
// - The self-pair mask costs only on tiles that cross the block's diagonal.
// - At the end a quad shuffle-max leaves each row's maximum in one thread,
//   which stores it.
// Wider rows (Cw = 256 ... 768) are compile-time instantiations of the same
// kernel over the number of K-chunks, with the own rows and ring stages sized
// to fit a block's 227 KB of shared memory.
#include <cuda.h>            // CUtensorMap and its enums; the driver entry point is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kTile = 128;                   // partner columns per tile
constexpr int kChunk = 128;                  // bytes of one K-chunk: one 128-byte swizzle atom
constexpr int kStageBytes = kTile * kChunk;  // one ring stage: a tile's K-chunk
constexpr int kThreads = 384;                // producer warpgroup + two consumer warpgroups
constexpr int kDataBudget = 224 * 1024;      // own rows + ring; barriers and alignment take the rest

template <int CH>   // K-chunks per row: Cw = 128 * CH
struct Cfg {
  static constexpr int kGroups = CH <= 5 ? 2 : 1;          // m64 row groups per consumer
  static constexpr int kOwnRows = 2 * kGroups * 64;
  static constexpr int kOwnBytes = kOwnRows * CH * kChunk;
  static constexpr int kFit = (kDataBudget - kOwnBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = 1024 + kOwnBytes + kStages * kStageBytes + 256;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of the 2-D map at (x bytes along a row, y rows) into dst;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), layout type 1. A k-step of 32
// bytes inside the atom moves the start address; the atom is 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
       | (uint64_t)(16 >> 4) << 16          // LBO: unused for swizzled K-major
       | (uint64_t)(1024 >> 4) << 32        // SBO
       | (uint64_t)1 << 62;                 // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the accumulators so that no read of them moves across a wgmma fence
// or wait.
__device__ __forceinline__ void pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64x128 s32) = a (64x32 s8) * b (128x32 s8)^T + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
minmm_kernel(const __grid_constant__ CUtensorMap own_map,
             const __grid_constant__ CUtensorMap part_map, int rows,
             int col_lo, int ntiles, int diag, long long row_base,
             int* __restrict__ out) {
  using C = Cfg<CH>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_own = smem;                    // CH chunks of [kOwnRows, 128] bytes
  uint8_t* s_ring = smem + C::kOwnBytes;    // kStages of [128, 128] bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ring + C::kStages * kStageBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* own_full = empty + C::kStages;
  const int wg = threadIdx.x / 128;
  const int row0 = blockIdx.x * C::kOwnRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // each warp of the two consumers
    }
    mbar_init(own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // --- producer: one thread keeps the ring full ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(own_full, C::kOwnBytes);
      for (int c = 0; c < CH; ++c)
        tma_load(s_own + c * C::kOwnRows * kChunk, &own_map, own_full,
                 c * kChunk, row0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < CH; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load(s_ring + stage * kStageBytes, &part_map, &full[stage],
                   c * kChunk, col_lo + t * kTile);
          if (++stage == C::kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // --- consumers: 128 own rows each (kGroups x m64) ------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cons = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    // accumulator i of group g holds (row warp*16 + lane/4 + 8*((i>>1)&1),
    // column (i>>2)*8 + (lane&3)*2 + (i&1)) of the group's 64x128 tile
    const int lrow = cons * C::kGroups * 64 + warp * 16 + (lane >> 2);  // row in the block
    const long long grow = row_base + row0 + lrow;                      // global own row
    const long long block_lo = row_base + row0;
    int acc[C::kGroups][64];
    int best[C::kGroups][2];
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) best[g][0] = best[g][1] = kNeg;
    const uint8_t* a_base = s_own + (cons * C::kGroups) * 64 * kChunk;

    mbar_wait(own_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      for (int c = 0; c < CH; ++c) {
        mbar_wait(&full[stage], phase);
        const uint8_t* b = s_ring + stage * kStageBytes;
        const uint8_t* a = a_base + c * C::kOwnRows * kChunk;
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) pin(acc[g]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 32; ++k) {
#pragma unroll
          for (int g = 0; g < C::kGroups; ++g)
            wgmma_s8(acc[g], sw128_desc(a + g * 64 * kChunk + k * 32),
                     sw128_desc(b + k * 32), (c | k) != 0);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) pin(acc[g]);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
      // fold the tile into the running maxima
      const long long c0 = (long long)col_lo + (long long)t * kTile;
      if (diag && c0 < block_lo + C::kOwnRows && block_lo < c0 + kTile) {
        // the tile holds self pairs: row == column counts as kNeg
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) {
          const int d = (int)(grow + g * 64 - c0) - (lane & 3) * 2;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int v0 = d == j * 8 ? kNeg : acc[g][4 * j];
            const int v1 = d == j * 8 + 1 ? kNeg : acc[g][4 * j + 1];
            const int v2 = d + 8 == j * 8 ? kNeg : acc[g][4 * j + 2];
            const int v3 = d + 8 == j * 8 + 1 ? kNeg : acc[g][4 * j + 3];
            best[g][0] = __vimax3_s32(best[g][0], v0, v1);
            best[g][1] = __vimax3_s32(best[g][1], v2, v3);
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            best[g][0] = __vimax3_s32(best[g][0], acc[g][4 * j], acc[g][4 * j + 1]);
            best[g][1] = __vimax3_s32(best[g][1], acc[g][4 * j + 2], acc[g][4 * j + 3]);
          }
        }
      }
    }
    // the four threads of a quad hold the same rows
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = best[g][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int r = row0 + lrow + g * 64 + h * 8;
        if ((lane & 3) == 0 && r < rows) out[r] = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (CUDA 12.5 or
// later): the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over `nrows` rows of `cw` int8 bytes, read in boxes of
// 128 bytes x box_rows rows with the 128-byte swizzle; rows past nrows read 0.
CUresult make_map(CUtensorMap* map, const void* base, long long nrows, int cw,
                  int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cw, (cuuint64_t)nrows};
  const cuuint64_t strides[1] = {(cuuint64_t)cw};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int CH>
int launch(const void* w_own, const void* w_part, long long rows,
           long long part_rows, long long col_lo, long long col_hi, int diag,
           long long row_base, void* out, cudaStream_t stream) {
  using C = Cfg<CH>;
  CUtensorMap own_map, part_map;
  if (make_map(&own_map, w_own, rows, CH * kChunk, C::kOwnRows) != CUDA_SUCCESS ||
      make_map(&part_map, w_part, part_rows, CH * kChunk, kTile) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      minmm_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + C::kOwnRows - 1) / C::kOwnRows);
  minmm_kernel<CH><<<grid, kThreads, C::kSmem, stream>>>(
      own_map, part_map, (int)rows, (int)col_lo,
      (int)((col_hi - col_lo) / kTile), diag, row_base, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of `device`. rows and col_hi - col_lo are
// multiples of 128, cw is a multiple of 128 of at most 768, W_part holds
// part_rows rows, and all pointers are device pointers (the Python wrapper
// checks). Returns the CUDA error of the launch, 0 on success;
// cudaErrorInvalidValue where a tensor map cannot be built.
extern "C" int minmm_launch(int device, const void* w_own, const void* w_part,
                            long long rows, long long part_rows, int cw,
                            long long col_lo, long long col_hi, int diag,
                            long long row_base, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  if (rows >= (1LL << 31) || part_rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // TMA coordinates are 32-bit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw / kChunk) {
    case 1: return launch<1>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    case 2: return launch<2>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    case 3: return launch<3>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    case 4: return launch<4>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    case 5: return launch<5>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    case 6: return launch<6>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
