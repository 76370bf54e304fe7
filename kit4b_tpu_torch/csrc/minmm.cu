// Max-match kernel of the exhaustive K-mer Hamming engine, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_minmm_kernel` of kit4b_tpu/kmer/hammings_mxu.py
// (launched by `_minmm_pallas`). Every genome K-mer window is a one-hot int8
// row of width Cw = 128*ceil(5K/128), so the number of matching bases of two
// windows is the int8 dot product of their rows. For each own row i:
//
//   out[i] = max over partner rows j in [col_lo, col_hi) of W_own[i] . W_part[j]
//
// where the self pair (row_base + i == col_base + j: own row i is global row
// row_base + i, partner row j global column col_base + j) counts as -2^20
// when `diag` is set. The bases are 64-bit, so a launch may sit anywhere in a
// genome past 2^31; the rows of one launch and of one partner map stay below
// 2^31 (TMA coordinates are 32-bit). The caller turns the result into the
// minimum Hamming distance K - out[i].
//
// Why the own rows are 2:4. Channel 5k + b of a window is 1 when base k has
// code b: a base owns 5 consecutive channels and holds at most one 1 among
// them, so an aligned group of 4 channels touches at most 2 bases and holds
// at most 2 ones (padding channels and invalid rows are 0). That is the 2:4
// structured sparsity of `wgmma.mma_async.sp`, whose A operand (the own
// rows) it takes compressed at twice the dense int8 rate; the integer dot
// products are the same, bit for bit: only zero channels are skipped.
//
// What bounds it: the 2:4-sparse int8 tensor rate, and the bytes shared
// memory delivers a clock. A launch does 2*R*span*Cw logical operations (R
// own rows, span partner columns); the [R, span] pair matrix never leaves
// registers. Each m64 step reads its N x 64-byte B tile from shared memory,
// so at the sparse rate B alone needs 128 bytes a clock and SM, twice the
// dense kernel's; A's compressed bytes from shared memory and TMA's writes
// of the partner tiles come on top (16 bytes a clock each at Cw 128). The
// probe (tools/probe_minmm_sp.py: the consumer loop, B resident, on an
// H100) reaches 99.4 % of the sparse peak with B alone, 88.5 % with A from
// shared memory too.
//
// Design. Blocks run in parallel: a block owns kOwnRows own rows (512 at
// Cw 128, 128 wider), keeps them for its whole life, and walks the partner
// range itself, so the running max stays in registers and no block needs
// another's result.
// - Operands. Both matrices are K-major (a window's Cw bytes are contiguous)
//   and one 128-byte K-chunk is one 128-byte swizzle atom. TMA copies each
//   K-chunk of the own rows and of a 256-column partner tile into shared
//   memory in that swizzle (tensor maps built on the host per launch).
// - Where the compressed operand lives. After the own rows land, each
//   consumer thread builds its metadata (1 register an m64 pass and k-step
//   of 64 channels, wgmma_sp.cuh `sp_meta`; rows of 3 chunks or more park
//   theirs in shared memory) from them once; then the
//   consumer writes the kept values (`sp_vals`) over its dense rows in
//   shared memory, in place and in the same swizzle (`compress_in_place`),
//   and wgmma reads them through descriptors. A in registers (4 a pass and
//   k-step, 32 at Cw 128) beside the 128 accumulators does not fit the 168
//   registers ptxas gives a consumer here, which `setmaxnreg` does not
//   raise; without a producer warpgroup (255 a thread) it spilled and ran
//   1.3-1.9 % slower at both cells' shapes.
// - The violation count. A group of 4 own-row channels with more than two
//   non-zeros cannot be compressed: the kernel adds the number of such
//   groups, counted once each while the metadata is built, to `faults`, a
//   device int the wrapper passes in, and the caller raises where it is not
//   0 at its next sync (kernels/minmm.py). The result is then wrong and is
//   never returned.
// - Warp specialisation. Warpgroup 0 is the producer: `setmaxnreg` drops its
//   registers and one thread issues the TMA loads, first the block's own
//   rows (zero-filled past R), then 256-column x 128-byte partner chunks
//   into a ring of stages guarded by full/empty mbarriers. Warpgroups 1 and
//   2 are consumers, kOwnRows / 2 own rows each, in kPasses m64 passes over
//   every tile: `wgmma.mma_async.sp m64n256k64 s32.s8.s8`, the first k-step
//   with scale-d = 0, commit and wait, then a fold of the 64 x 256 tile
//   into two running row maxima with the DPX three-way max. The two
//   consumers run independently, so one's fold overlaps the other's
//   products; each warp of both arrives on a stage's empty barrier when its
//   last products from it are done.
// - Geometry. N 256 with one accumulator set of 128 registers: in the
//   probe it beat N 128 with two sets (the dense kernel's geometry) for
//   either source of A on every card it ran on (88.5-89.3 % against
//   64-80 % on one). At Cw 128 a 256-column tile is one stage, which
//   stays while a consumer runs its 4 passes, so a block holds 512 own rows
//   and each partner byte that TMA brings from L2 serves 512 rows: 16 bytes
//   a clock and SM at the sparse rate, what the dense kernel drew at the
//   dense one. Wider rows stream a tile's CH chunks through the ring in one
//   pass of 128 own rows.
// - The self-pair mask, and the mask of columns past the span in a last
//   tile of 128 columns, cost only on the tiles that need them.
// - At the end a quad shuffle-max leaves each row's maximum in one thread,
//   which stores it.
// Wider rows (Cw = 256 ... 768) are compile-time instantiations of the same
// kernel over the number of K-chunks, with the own rows and ring stages sized
// to fit a block's 227 KB of shared memory.
#include <cuda.h>            // CUtensorMap and its enums; the driver entry point is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sp.cuh"

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kFar = 1 << 29;                // a row-to-column distance no tile holds
constexpr int kTile = 256;                   // partner columns per tile (the wgmma's N)
constexpr int kChunk = 128;                  // bytes of one K-chunk: one 128-byte swizzle atom
constexpr int kStageBytes = kTile * kChunk;  // one ring stage: a tile's K-chunk
constexpr int kBox = 256;                    // most rows of one TMA box
constexpr int kThreads = 384;                // producer warpgroup + two consumer warpgroups
constexpr int kDataBudget = 224 * 1024;      // own rows + ring; barriers and alignment take the rest

template <int CH>   // K-chunks per row: Cw = 128 * CH
struct Cfg {
  static constexpr int kPasses = CH == 1 ? 4 : 1;           // m64 passes a consumer and tile
  static constexpr int kSteps = 2 * CH;                      // k-steps of 64 channels a row
  static constexpr int kOwnRows = 2 * kPasses * 64;
  static constexpr int kOwnBytes = kOwnRows * CH * kChunk;
  static constexpr int kFit = (kDataBudget - kOwnBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = 1024 + kOwnBytes + kStages * kStageBytes + 256;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");
  static_assert(kOwnRows % kBox == 0 || kOwnRows < kBox, "own rows load in whole boxes");
  // rows of 3 chunks or more keep their metadata in shared memory (from
  // registers ptxas spilled it at Cw 768)
  static constexpr bool kMetaInSmem = CH >= 3;
  static_assert(!kMetaInSmem || kSteps * 128 * 4 <= 64 * kChunk,
                "a consumer's metadata fits its rows of a free chunk");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of the 2-D map at (x bytes along a row, y rows) into dst;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Folds one consumer's 64 x 256 tile of products into its two running row
// maxima (rows lane/4 and lane/4 + 8 of each warp's 16). Accumulator i holds
// (row warp*16 + lane/4 + 8*((i>>1)&1), column (i>>2)*8 + (lane&3)*2 + (i&1)).
// With `masked`, columns from `lim` on, and the column d of the row's self
// pair (d + 8 for the second row; kFar where the tile holds none), read kNeg.
__device__ __forceinline__ void fold(const int (&acc)[128], int (&best)[2],
                                     bool masked, int lim, int d, int lane) {
  if (masked) {
    const int lc = lim - (lane & 3) * 2;
    d -= (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = j * 8;
      const int v0 = c >= lc || d == c ? kNeg : acc[4 * j];
      const int v1 = c + 1 >= lc || d == c + 1 ? kNeg : acc[4 * j + 1];
      const int v2 = c >= lc || d + 8 == c ? kNeg : acc[4 * j + 2];
      const int v3 = c + 1 >= lc || d + 8 == c + 1 ? kNeg : acc[4 * j + 3];
      best[0] = __vimax3_s32(best[0], v0, v1);
      best[1] = __vimax3_s32(best[1], v2, v3);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      best[0] = __vimax3_s32(best[0], acc[4 * j], acc[4 * j + 1]);
      best[1] = __vimax3_s32(best[1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Compresses one consumer warpgroup's ROWS / 2 own rows from `row0` of a
// block's CH dense K-chunks (chunk c at own + c * ROWS * 128) in place
// (thread `tid` of 128, named barrier `bar`): dense chunks 2cc and 2cc + 1
// become compressed chunk cc, in cc's place, the values of dense chunk c at
// bytes 64 (c % 2) + [0, 64) of each row, so that k-step s of 64 channels
// is 32 bytes at 32 (s % 4) of compressed chunk s / 4. A round reads its
// chunks before it writes: cc's place holds dense chunk cc, read in round
// cc / 2 <= cc.
template <int ROWS, int CH>
__device__ __forceinline__ void compress_in_place(uint8_t* own, int row0,
                                                  int tid, int bar) {
  constexpr int kPieces = 16;                       // 8 dense bytes a piece
  constexpr int kMost = ROWS / 2 * 2 * kPieces / 128;
#pragma unroll
  for (int cc = 0; 2 * cc < CH; ++cc) {
    const int nch = 2 * cc + 1 < CH ? 2 : 1;
    const int n = ROWS / 2 * nch * kPieces / 128;   // pieces a thread
    uint32_t v[kMost];
#pragma unroll
    for (int k = 0; k < kMost; ++k) {
      const int q = tid + 128 * k, row = row0 + q / (nch * kPieces);
      const int c = 2 * cc + (q / kPieces) % nch;
      if (k < n) v[k] = sp_vals(own + c * ROWS * 128, row, 8 * (q % kPieces));
    }
    asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
#pragma unroll
    for (int k = 0; k < kMost; ++k) {
      const int q = tid + 128 * k, row = row0 + q / (nch * kPieces);
      const int c = 2 * cc + (q / kPieces) % nch;
      if (k < n)
        *reinterpret_cast<uint32_t*>(own + cc * ROWS * 128 +
                                     sw128(row, 64 * (c % 2) + 4 * (q % kPieces))) = v[k];
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" :: "r"(bar) : "memory");
}

template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
minmm_kernel(const __grid_constant__ CUtensorMap own_map,
             const __grid_constant__ CUtensorMap part_map, int rows,
             int col_lo, int ncols, int diag, long long row_base,
             long long col_base, int* __restrict__ out,
             int* __restrict__ faults) {
  using C = Cfg<CH>;
  constexpr int P = C::kPasses;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_own = smem;                    // CH chunks of [kOwnRows, 128] bytes
  uint8_t* s_ring = smem + C::kOwnBytes;    // kStages of [256, 128] bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ring + C::kStages * kStageBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* own_full = empty + C::kStages;
  const int row0 = blockIdx.x * C::kOwnRows;
  const int ntiles = (ncols + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // each warp of the two consumers
    }
    mbar_init(own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // --- producer: one thread keeps the ring full ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      constexpr int box = C::kOwnRows < kBox ? C::kOwnRows : kBox;
      mbar_expect_tx(own_full, C::kOwnBytes);
      for (int c = 0; c < CH; ++c)
        for (int r = 0; r < C::kOwnRows; r += box)
          tma_load(s_own + (c * C::kOwnRows + r) * kChunk, &own_map, own_full,
                   c * kChunk, row0 + r);
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
    // --- consumers: kPasses m64 passes of own rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cons = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int lrow = cons * P * 64 + warp * 16 + (lane >> 2);   // pass 0's row in the block
    const long long grow = row_base + row0 + lrow;              // its global own row
    const long long block_lo = row_base + row0;
    const long long col0 = col_base + col_lo;                   // global column of tile 0

    // the compressed own rows, once: the metadata of each pass and k-step
    // into registers (wgmma_sp.cuh gives the layout; rows of 3 chunks or
    // more in a rolled loop, through local memory, since unrolled ptxas
    // spilled at Cw 768), then the kept values over the dense rows in place
    mbar_wait(own_full, 0);
    uint32_t e[P][C::kSteps];
    int bad = 0;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll(C::kMetaInSmem ? 1 : C::kSteps)
      for (int s = 0; s < C::kSteps; ++s)
        e[p][s] = sp_meta(s_own + (s / 2) * C::kOwnRows * kChunk,
                          lrow + p * 64 + 8 * (lane & 1),
                          64 * (s % 2) + 32 * ((lane >> 1) & 1), bad);
    if (bad) atomicAdd(faults, bad);
    compress_in_place<C::kOwnRows, CH>(s_own, cons * P * 64, tid, 1 + cons);
    // Rows of 3 chunks or more keep their metadata (kSteps words) in the
    // place of dense chunk (CH + 1) / 2, free once compressed, within this
    // consumer's own rows; each thread reads back only what it wrote.
    uint32_t* s_meta = reinterpret_cast<uint32_t*>(
        s_own + ((CH + 1) / 2 * C::kOwnRows + cons * 64) * kChunk);
    if constexpr (C::kMetaInSmem) {
#pragma unroll 1
      for (int s = 0; s < C::kSteps; ++s) s_meta[s * 128 + tid] = e[0][s];
    }
    // pass 0's metadata of k-step s
    const auto meta = [&](int s) -> uint32_t {
      if constexpr (C::kMetaInSmem) return s_meta[s * 128 + tid];
      else return e[0][s];
    };

    // descriptor of pass p's compressed rows at k-step s (32 bytes of
    // compressed chunk s / 4), and of k-step h of a ring stage: a base
    // descriptor plus the offset's 16-byte units in its address field
    const uint64_t a_desc0 = sw128_desc(s_own + cons * P * 64 * kChunk);
    const uint64_t b_desc0 = sw128_desc(s_ring);
    const auto a_desc = [&](int p, int s) {
      return a_desc0 + (uint64_t)(((s / 4) * C::kOwnRows * kChunk +
                                   p * 64 * kChunk + 32 * (s % 4)) >> 4);
    };
    const auto b_desc = [&](int stage, int h) {
      return b_desc0 + (uint64_t)((stage * kStageBytes + 64 * h) >> 4);
    };
    int acc[128];
    int best[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) best[p][0] = best[p][1] = kNeg;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      const long long c0 = col0 + (long long)t * kTile;
      const int lim = min(kTile, ncols - t * kTile);
      const bool cross = diag && c0 < block_lo + C::kOwnRows && block_lo < c0 + kTile;
      const bool masked = cross || lim < kTile;
      if constexpr (P == 1) {
        // CH chunks of the tile stream through the ring, one pass
#pragma unroll(C::kMetaInSmem ? 1 : CH)
        for (int c = 0; c < CH; ++c) {
          mbar_wait(&full[stage], phase);
          pin(acc);
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_sp_ss(acc, a_desc(0, 2 * c + h), b_desc(stage, h),
                        meta(2 * c + h), (c | h) != 0);
          wgmma_commit();
          wgmma_wait_all();
          pin(acc);
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == C::kStages) { stage = 0; phase ^= 1; }
        }
        fold(acc, best[0], masked, lim, cross ? (int)(grow - c0) : kFar, lane);
      } else {
        // the tile's one chunk stays in its stage for the P passes
        mbar_wait(&full[stage], phase);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          pin(acc);
          wgmma_fence();
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_sp_ss(acc, a_desc(p, h), b_desc(stage, h), e[p][h], h);
          wgmma_commit();
          wgmma_wait_all();
          pin(acc);
          if (p == P - 1 && lane == 0) mbar_arrive(&empty[stage]);
          fold(acc, best[p], masked, lim,
               cross ? (int)(grow + p * 64 - c0) : kFar, lane);
        }
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    // the four threads of a quad hold the same rows
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = best[p][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int r = row0 + lrow + p * 64 + h * 8;
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
           long long row_base, long long col_base, void* out, void* faults,
           cudaStream_t stream) {
  using C = Cfg<CH>;
  CUtensorMap own_map, part_map;
  const int own_box = C::kOwnRows < kBox ? C::kOwnRows : kBox;
  if (make_map(&own_map, w_own, rows, CH * kChunk, own_box) != CUDA_SUCCESS ||
      make_map(&part_map, w_part, part_rows, CH * kChunk, kTile) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      minmm_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + C::kOwnRows - 1) / C::kOwnRows);
  minmm_kernel<CH><<<grid, kThreads, C::kSmem, stream>>>(
      own_map, part_map, (int)rows, (int)col_lo, (int)(col_hi - col_lo), diag,
      row_base, col_base, static_cast<int*>(out), static_cast<int*>(faults));
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` of `device`. rows and col_hi - col_lo are
// multiples of 128, cw is a multiple of 128 of at most 768, W_part holds
// part_rows rows, 0 <= col_lo <= col_hi <= part_rows, and all pointers are
// device pointers (the Python wrapper checks). row_base and col_base are the
// global row of W_own's first row and the global column of W_part's first
// row. `faults` is a device int to which the kernel adds the own-row groups
// of 4 channels that hold more than two non-zeros. Returns the CUDA error of
// the launch, 0 on success; cudaErrorInvalidValue where a tensor map cannot
// be built or a launch's rows or the partner map's rows reach 2^31.
extern "C" int minmm_launch(int device, const void* w_own, const void* w_part,
                            long long rows, long long part_rows, int cw,
                            long long col_lo, long long col_hi, int diag,
                            long long row_base, long long col_base, void* out,
                            void* faults, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  if (rows >= (1LL << 31) || part_rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;   // TMA coordinates are 32-bit
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cw / kChunk) {
    case 1: return launch<1>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    case 2: return launch<2>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    case 3: return launch<3>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    case 4: return launch<4>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    case 5: return launch<5>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    case 6: return launch<6>(w_own, w_part, rows, part_rows, col_lo, col_hi, diag, row_base, col_base, out, faults, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
