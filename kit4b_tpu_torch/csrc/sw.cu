// Banded affine-gap Smith-Waterman for Hopper (sm_90a): the row scan and
// the traceback of kit4b_tpu_torch/pacbio/sswd.py's banded_sw_batch.
//
// sw_scan_kernel replaces the XLA pass `_sw_scan` of
// kit4b_tpu/pacbio/sswd.py:48 (a lax.scan over the padded probe rows, the
// in-row gap run resolved by an associative max scan); sw_traceback_kernel
// replaces `_traceback_dev` (sswd.py:122, a vmapped while_loop over the
// resident pointer bytes). kernels/sw.py holds both specs as plain PyTorch
// (sw_scan_plain, traceback_plain) and its docstring the pointer byte.
//
// The scan. Row i, band index k is target column c = diag0 + i + k - W/2,
// so the diagonal neighbour is the previous row's H[k] and the up
// neighbour its H[k+1] and E[k+1] (NEG past the band's edge):
//
//   sub  = match | mismatch where i < plen, probe[i] < 4, 0 <= c < tlen,
//          target[clip(c)] < 4; else NEG
//   E    = max(H[k+1] + open, E[k+1] + ext)      eext = (e_ext >= e_open)
//   H0   = max(H[k] + sub, E, 0)                 dirb = 0 | 1 | 2
//   X[k] = H0 + open - (k+1) * ext
//   F[k] = max_{m<k} X[m] + k * ext              (NEG at k = 0)
//   fext = max_{m<k} X[m] > X[k-1]               usedf = F > H0
//   H    = max(H0, F)                            carried with E
//   the best cell is the first row's first k that holds the largest H;
//   (0, 0, 0) when no cell is positive.
//
// What bounds the scan on this card: operations, 35 int32 operations a cell
// (chip_smoke.py's SW_CELL_OPS) against one pointer byte written a cell,
// and a serial chain a row: F needs the maximum of X over every column to
// the left, so a row of a pair cannot start before the row above is whole.
// With B 32 a block a pair fills 32 of the 132 SMs; a row's latency, not
// the SMs' rate, sets the time. This design:
//
// - A pair runs on P blocks (P = 1 to 8, a cluster on neighbouring SMs
//   launched with cudaLaunchKernelEx), from kernels/sw.py's scan_layout:
//   B x P blocks on the SMs and at least 1,000 columns a block (measured:
//   at W 3,000 three blocks a pair beat two and four to eight).
//   The pair's warps (32 at most) own the band in order, 32 x C
//   consecutive columns a warp and C (2, 4 or 8) a thread, so a
//   thread's H, E and target codes stay in registers from row to row.
// - One exchange a row. Each warp publishes one 16-byte slot: its X
//   maximum (__reduce_max_sync), its last X, and the H0 and E of its first
//   column. With P > 1, lane r sends it to block r with st.async, which
//   counts its bytes on that block's mbarrier for the row's parity; every
//   thread waits on its own block's mbarrier (no cluster barrier a row: one
//   costs about 0.39 µs on this card, chip_smoke.py phase 15b). With P 1
//   the slot goes to shared memory and the block's barrier. While the
//   slots travel, the warp runs its own exclusive max scan of X (shuffles)
//   and writes the previous row's pointer bytes and best cells; then each
//   lane reads one slot, and one __reduce_max_sync gives the maximum of X
//   over the warps to its left. Slots and mbarriers are double-buffered by
//   row parity: a block writes row i + 2's slots only after every warp's
//   row i + 1 slot, which each warp sends after it has read row i's.
// - The up neighbour of a warp's (or thread's) last column is the next
//   column's H = max(H0, F): the next warp publishes its H0 and E, and F
//   there is this thread's running maximum of X plus that column's offset,
//   so one exchange a row is enough.
// - No per-row peak: each thread keeps its own best cell, moved only on a
//   strictly greater H (rows in order, its columns in order, so it keeps
//   its first cell), and the cluster reduces once at the end: the largest
//   value, then the least row, then the least column.
// - DPX: __vibmax_s32 gives E with its eext bit, H = max(H0, F) with
//   usedf, the running maximum of X with the next column's fext, and the
//   best cell's update; __vimax_s32_relu gives H0 = max(diag, E, 0).
// - A thread writes its C pointer bytes of a row in one store.
//
// The traceback: one warp a pair. From cell (i, k), R steps of the walk
// stay inside rows [i-R, i] and band columns [k-R, k+R]: M keeps k, D moves
// to k+1 and I to k-1. The warp stages a tile of 32 rows and 128 band
// columns of pointer bytes into shared memory (cp.async, 4-byte words with
// zero fill past the array's end, each row's alignment shift kept), and
// prefetches the 32 rows below it into a second buffer while lane 0 walks
// the first. A step loads its pointer byte and then one table entry (the
// folded state machine of kernels/sw.py's _walk_tables: next state, op,
// stop, the row and column it consumes, and the move of the byte's offset
// where every row of a tile has the same alignment, B x W a multiple of
// 4). A walk that leaves a tile at its bottom inside the prefetched tile
// swaps buffers and prefetches the next; one that leaves through a side
// restages where it stands. Its bound is bytes (a pointer byte a
// step), but each step depends on the one before, so it runs at the
// latency of a shared-memory load and the decode a step. Matches and
// mismatches are counted after the walk by the whole warp, 32 ops at a
// time, from the ops written (ballots give each op's row and column).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNeg = -(1 << 24);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxWarps = 32;           // a pair's warps: one slot a lane
constexpr int kMaxBlockThreads = 512;   // 128 registers a thread at most

struct Scores {
  int32_t match, mismatch, open, ext;
};

// the .aligned forms need the warp converged: __syncwarp after any branch
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of shared-memory address `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into shared-memory address `addr` of a block of the cluster,
// counted as 16 bytes done on that block's mbarrier at `bar`
__device__ __forceinline__ void st_async(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// this thread's arrival on the mbarrier, expecting `bytes` more of async
// stores in the current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n"
        "}"
        :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, int4 v) {
  asm volatile("st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// target code of column c: 0xFF outside [0, tlen), else target[clip(c)]
__device__ __forceinline__ uint32_t tcode(const uint8_t* target, int c,
                                          int tlen, int Lt) {
  return (c >= 0 && c < tlen) ? (uint32_t)__ldg(target + min(c, Lt - 1))
                              : 0xFFu;
}

// the lexicographic best cell: the larger value, then the least row, then
// the least column
__device__ __forceinline__ bool better(int32_t v, int32_t i, int32_t k,
                                       int32_t v0, int32_t i0, int32_t k0) {
  return v > v0 || (v == v0 && (i < i0 || (i == i0 && k < k0)));
}

template <int C>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint32_t* w,
                                            int n, bool whole) {
  if (whole) {
    if (C == 2) *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w[0];
    if (C == 4) *reinterpret_cast<uint32_t*>(dst) = w[0];
    if (C == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (j < n) dst[j] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
  }
}

// kCluster: the pair spans P > 1 blocks, and a row's slots travel as
// st.async counted on each block's mbarrier; else one block's barrier
template <int C, bool kCluster>
__global__ void __launch_bounds__(kMaxBlockThreads)
sw_scan_kernel(const uint8_t* __restrict__ probes,
               const uint8_t* __restrict__ targets,
               const int32_t* __restrict__ plens,
               const int32_t* __restrict__ tlens,
               const int32_t* __restrict__ diag0, int B, int Lp, int Lt,
               int W, int P, Scores s, uint8_t* __restrict__ ptrs,
               int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
               int32_t* __restrict__ bk_out) {
  // each row parity: every warp's {max X, last X, first H0, first E}, and
  // the mbarrier that counts their bytes in
  __shared__ int4 slots[2][kMaxWarps];
  __shared__ __align__(8) uint64_t filled[2];
  __shared__ int4 peaks[kMaxWarps];      // rank 0's: the warps' best cells
  constexpr int NWORD = (C + 3) / 4;
  const uint32_t rank = cluster_rank();
  const int b = blockIdx.x / P;
  const int lane = threadIdx.x & 31;
  const int nw = P * (blockDim.x >> 5);              // the pair's warps
  const int g = rank * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int k0 = (g * 32 + lane) * C;
  const bool edge = k0 + C >= W;   // the column after this thread's is NEG
  const bool tail = k0 + C > W;    // this thread holds columns past W - 1
  const bool whole = W % C == 0;   // its C bytes of a row are aligned
  const uint8_t* probe = probes + (size_t)b * Lp;
  const uint8_t* target = targets + (size_t)b * Lt;
  const int plen = plens[b], tlen = tlens[b];
  const int base = diag0[b] - W / 2 + k0;   // target column of (0, k0)

  int32_t H[C], E[C], xoff[C], koff[C];
  uint32_t tb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int k = k0 + j;
    koff[j] = k * s.ext;
    xoff[j] = s.open - (k + 1) * s.ext;
    H[j] = k < W ? 0 : kNeg;
    E[j] = kNeg;
    tb[j] = tcode(target, base + j, tlen, Lt);
  }
  int32_t Hn = edge ? kNeg : 0, En = kNeg;
  int32_t best = 0, bi = 0, bk = 0;
  uint32_t pb_next = __ldg(probe);
  uint32_t tb_next = tcode(target, base + C, tlen, Lt);
  const uint32_t slot_to = lane < P ? map_rank(smem_addr(&slots[0][0]),
                                               lane) : 0u;
  const uint32_t filled_at = lane < P ? map_rank(smem_addr(&filled[0]),
                                                 lane) : 0u;
  const uint32_t my_filled = smem_addr(&filled[0]);
  if (kCluster && threadIdx.x == 0) {
    mbar_init(my_filled, 1);
    mbar_init(my_filled + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive();   // every block has started and set its mbarriers
  cluster_wait();
  // a row's pointer bytes and the best cell's update from its H, done while
  // the next row's slots are in flight; rows are flushed in order
  uint32_t wrow[NWORD];
  uint8_t* out_row = ptrs != nullptr && k0 < W ? ptrs + (size_t)b * W + k0
                                                : nullptr;
  const size_t row_step = (size_t)B * W;
  auto flush = [&](int r) {
    if (out_row != nullptr) {
      store_bytes<C>(out_row, wrow, W - k0, whole && !tail);
      out_row += row_step;
    }
    int32_t top = H[0];   // the row's peak here; the best cell moves rarely
#pragma unroll
    for (int j = 1; j < C; ++j) top = max(top, H[j]);
    if (top > best) {
      best = top;
      bi = r;
#pragma unroll
      for (int j = C - 1; j >= 0; --j)
        if (H[j] == top) bk = k0 + j;   // the first column that holds it
    }
  };

  for (int i = 0; i < Lp; ++i) {
    const int par = i & 1;
    if (kCluster && threadIdx.x == 0)   // a slot from every warp
      mbar_expect(my_filled + 8 * par, 16u * nw);
    const uint32_t pb = pb_next;
    if (i + 1 < Lp) pb_next = __ldg(probe + i + 1);
    const bool row_ok = i < plen && pb < 4;
    const uint32_t pbx = row_ok ? pb : 0x100u;  // equals no code
    const uint32_t lim = row_ok ? 4u : 0u;
    // E, H0 and X of this thread's columns
    int32_t H0[C], Ec[C], X[C];
    uint32_t w[NWORD];
#pragma unroll
    for (int q = 0; q < NWORD; ++q) w[q] = 0;
    int32_t tmax = INT32_MIN;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int32_t hup = j + 1 < C ? H[j + 1] : Hn;
      const int32_t eup = j + 1 < C ? E[j + 1] : En;
      const int32_t sub = tb[j] == pbx ? s.match
                          : tb[j] < lim ? s.mismatch : kNeg;
      bool eext;
      Ec[j] = __vibmax_s32(eup + s.ext, hup + s.open, &eext);
      const int32_t diag = H[j] + sub;
      H0[j] = __vimax_s32_relu(diag, Ec[j]);
      const uint32_t d = H0[j] == 0 ? 0u : H0[j] == diag ? 1u : 2u;
      w[j / 4] |= (d | (eext ? 8u : 0u)) << (8 * (j % 4));
      X[j] = H0[j] + xoff[j];
      tmax = max(tmax, X[j]);
    }
    // this warp's slot into every block of the cluster
    const int32_t agg = __reduce_max_sync(kFull, tmax);
    const int32_t wlast = __shfl_sync(kFull, X[C - 1], 31);
    const int32_t wh0 = __shfl_sync(kFull, H0[0], 0);
    const int32_t we = __shfl_sync(kFull, Ec[0], 0);
    if (kCluster && lane < P)
      st_async(slot_to + (uint32_t)(par * kMaxWarps + g) * sizeof(int4),
               make_int4(agg, wlast, wh0, we), filled_at + 8 * par);
    if (!kCluster && lane == 0)
      slots[par][g] = make_int4(agg, wlast, wh0, we);
    // meanwhile: the previous row's pointer bytes and best cells
    if (i > 0) flush(i - 1);
    // meanwhile, the warp's own exclusive scan and its neighbours' values
    int32_t incl = tmax;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int32_t excl = __shfl_up_sync(kFull, incl, 1);
    int32_t prev_x = __shfl_up_sync(kFull, X[C - 1], 1);
    int32_t nh0 = __shfl_down_sync(kFull, H0[0], 1);
    int32_t ne = __shfl_down_sync(kFull, Ec[0], 1);
    if (kCluster)
      mbar_wait(my_filled + 8 * par, (i >> 1) & 1);
    else
      __syncthreads();
    const int4 sl = slots[par][lane];
    const int32_t before = __reduce_max_sync(kFull, lane < g ? sl.x : kNeg);
    const int32_t left_x = __shfl_sync(kFull, sl.y, (g + 31) & 31);
    const int32_t right_h0 = __shfl_sync(kFull, sl.z, (g + 1) & 31);
    const int32_t right_e = __shfl_sync(kFull, sl.w, (g + 1) & 31);
    if (lane == 0) {
      excl = before;
      prev_x = g > 0 ? left_x : kNeg;
    } else {
      excl = max(excl, before);
    }
    if (lane == 31) {
      nh0 = right_h0;
      ne = right_e;
    }
    // F, H, the pointer bytes
    int32_t run = excl;
    bool fext = run > prev_x;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      bool h0_ge;
      H[j] = __vibmax_s32(H0[j], run + koff[j], &h0_ge);
      w[j / 4] |= ((h0_ge ? 0u : 4u) | (fext ? 16u : 0u)) << (8 * (j % 4));
      bool x_ge;
      run = __vibmax_s32(X[j], run, &x_ge);
      fext = !x_ge;
      E[j] = Ec[j];
    }
#pragma unroll
    for (int q = 0; q < NWORD; ++q) wrow[q] = w[q];
    // the next row's up neighbour of the last column: H = max(H0, F)
    Hn = edge ? kNeg : max(nh0, run + (k0 + C) * s.ext);
    En = edge ? kNeg : ne;
    if (tail) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (k0 + j >= W) H[j] = E[j] = kNeg;
    }
    // the next row's target codes: one column to the right
#pragma unroll
    for (int j = 0; j + 1 < C; ++j) tb[j] = tb[j + 1];
    tb[C - 1] = tb_next;
    tb_next = tcode(target, base + i + 2 + C - 1, tlen, Lt);
  }
  flush(Lp - 1);
  // the pair's best cell: warp, then the cluster's warps in rank 0
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int32_t v = __shfl_down_sync(kFull, best, o);
    const int32_t ii = __shfl_down_sync(kFull, bi, o);
    const int32_t kk = __shfl_down_sync(kFull, bk, o);
    if (better(v, ii, kk, best, bi, bk)) {
      best = v;
      bi = ii;
      bk = kk;
    }
  }
  if (lane == 0)
    st_cluster(map_rank(smem_addr(&peaks[g]), 0),
               make_int4(best, bi, bk, 0));
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && threadIdx.x < 32) {
    const int4 p = lane < nw ? peaks[lane] : make_int4(-1, 0, 0, 0);
    best = p.x;
    bi = p.y;
    bk = p.z;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int32_t v = __shfl_down_sync(kFull, best, o);
      const int32_t ii = __shfl_down_sync(kFull, bi, o);
      const int32_t kk = __shfl_down_sync(kFull, bk, o);
      if (better(v, ii, kk, best, bi, bk)) {
        best = v;
        bi = ii;
        bk = kk;
      }
    }
    if (lane == 0) {
      best_out[b] = best;
      bi_out[b] = bi;
      bk_out[b] = bk;
    }
  }
}

cudaLaunchConfig_t scan_config(int B, int P, int threads, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * P);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// threads a block of the scan: the pair's warps spread over P blocks
int scan_threads(int W, int P, int C) {
  const int nw = (W + 32 * C - 1) / (32 * C);
  return (nw + P - 1) / P * 32;
}

bool scan_layout_ok(int W, int P, int C) {
  if (!(C == 2 || C == 4 || C == 8)) return false;
  if (P < 1 || P > kMaxCluster) return false;
  const int threads = scan_threads(W, P, C);
  return threads <= kMaxBlockThreads && P * threads / 32 <= kMaxWarps;
}

template <int C, bool kCluster>
cudaError_t launch_scan(int P, cudaStream_t st, const uint8_t* probes,
                        const uint8_t* targets, const int32_t* plens,
                        const int32_t* tlens, const int32_t* diag0, int B,
                        int Lp, int Lt, int W, Scores s, uint8_t* ptrs,
                        int32_t* best, int32_t* bi, int32_t* bk) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      scan_config(B, P, scan_threads(W, P, C), st, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, sw_scan_kernel<C, kCluster>, probes,
                                       targets, plens, tlens, diag0, B, Lp,
                                       Lt, W, P, s, ptrs, best, bi, bk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCluster>
cudaError_t launch_scan_c(int C, int P, cudaStream_t st,
                          const uint8_t* probes, const uint8_t* targets,
                          const int32_t* plens, const int32_t* tlens,
                          const int32_t* diag0, int B, int Lp, int Lt, int W,
                          Scores s, uint8_t* ptrs, int32_t* best, int32_t* bi,
                          int32_t* bk) {
  switch (C) {
    case 2:
      return launch_scan<2, kCluster>(P, st, probes, targets, plens, tlens, diag0,
                               B, Lp, Lt, W, s, ptrs, best, bi, bk);
    case 4:
      return launch_scan<4, kCluster>(P, st, probes, targets, plens, tlens, diag0,
                               B, Lp, Lt, W, s, ptrs, best, bi, bk);
    default:
      return launch_scan<8, kCluster>(P, st, probes, targets, plens, tlens, diag0,
                               B, Lp, Lt, W, s, ptrs, best, bi, bk);
  }
}

template <int C>
cudaError_t scan_clusters(int B, int W, int P, int* n) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      scan_config(B, P, scan_threads(W, P, C), 0, attr);
  return P == 1
      ? cudaOccupancyMaxActiveClusters(n, sw_scan_kernel<C, false>, &cfg)
      : cudaOccupancyMaxActiveClusters(n, sw_scan_kernel<C, true>, &cfg);
}

// --- the traceback --------------------------------------------------------

constexpr int kTileRows = 32;               // a row a lane
constexpr int kTileCols = 128;              // band columns of a tile
constexpr int kTileWords = kTileCols / 4 + 1;   // with the alignment shift
constexpr int kTileStride = 4 * kTileWords;     // bytes a tile row
constexpr int kTileBytes = kTileRows * kTileStride;

// one step of _traceback_dev's state machine (0 H, 1 H0, 2 E, 3 F; ops 1
// M, 2 D, 3 I) from `state` on pointer byte `byte`, with the steps that
// neither emit nor move folded into the step after them, which reads the
// same byte (kernels/sw.py's _walk_tables). The entry: the next state in
// bits 0-1, stop in bit 2, the op in bits 3-4, the row and column it
// consumes in bits 5 and 6, and from bit 8 (signed) the move of the
// byte's offset in a tile whose rows share one alignment shift.
__device__ int32_t walk_entry(int state, int byte) {
  const int d = byte & 3;
  if (state == 0) state = (byte & 4) ? 3 : 1;
  if (state == 1 && d == 2) state = 2;
  int next, op;
  bool stop = false;
  if (state == 1) {
    next = 0;
    op = d == 1 ? 1 : 0;
    stop = d == 0;
  } else if (state == 2) {
    next = (byte & 8) ? 2 : 0;
    op = 2;
  } else {
    next = (byte & 16) ? 3 : 1;
    op = 3;
  }
  const int di = op == 1 || op == 2, dc = op == 1 || op == 3;
  const int dx = di * kTileStride + di - dc;   // M a row down, D and a
  return next | stop << 2 | op << 3 | di << 5 | dc << 6 | dx * 256;
}

struct Tile {
  int top, k_lo;   // rows [top - 31, top], band columns [k_lo, k_lo + 128)
  int shift;       // the low two bits of row top's offset of column k_lo
  __device__ bool holds(int i, int k) const {
    return i <= top && i > top - kTileRows && k >= k_lo &&
           k < k_lo + kTileCols;
  }
};

// the byte offset of band column k_lo of row r of pair b in the pointer
// array; a tile row holds the aligned words from there, shifted by its
// low two bits
__device__ __forceinline__ long long row_offset(int r, int b, int B, int W,
                                                int k_lo) {
  return ((long long)r * B + b) * W + k_lo;
}

__device__ __forceinline__ Tile tile_at(int top, int k_lo, int b, int B,
                                        int W) {
  return Tile{top, k_lo, (int)(row_offset(top, b, B, W, k_lo) & 3)};
}

// every lane: cp.async of the tile's 32 x 33 words (lane l takes word l of
// each row and word 32 of row l), zero-filled outside [0, total)
__device__ __forceinline__ void stage(uint8_t* buf, const uint8_t* ptrs,
                                      long long total, Tile t, int b, int B,
                                      int W, int lane) {
  for (int rr = 0; rr <= kTileRows; ++rr) {
    const int row = rr < kTileRows ? rr : lane;
    const int word = rr < kTileRows ? lane : kTileWords - 1;
    const long long off =
        (row_offset(t.top - row, b, B, W, t.k_lo) & ~3LL) + 4LL * word;
    const long long left = total - off;
    const int n = off < 0 ? 0 : left >= 4 ? 4 : left > 0 ? (int)left : 0;
    const uint8_t* src = ptrs + (n ? off : 0);
    const uint32_t dst = smem_addr(buf + row * kTileStride + 4 * word);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_staged(bool keep_newest) {
  if (keep_newest)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
}

// kAligned: B x W is a multiple of 4, so every row of a tile has the same
// alignment shift and a step moves the byte's offset by a constant
template <bool kAligned>
__global__ void __launch_bounds__(32)
sw_traceback_kernel(
    const uint8_t* __restrict__ ptrs, const uint8_t* __restrict__ probes,
    const uint8_t* __restrict__ targets, const int32_t* __restrict__ best,
    const int32_t* __restrict__ bi, const int32_t* __restrict__ bk,
    const int32_t* __restrict__ diag0, int B, int Lp, int Lq, int Lt, int W,
    int L_OPS, int8_t* __restrict__ ops, int32_t* __restrict__ n_out,
    int32_t* __restrict__ ps, int32_t* __restrict__ ts,
    int32_t* __restrict__ nm_out, int32_t* __restrict__ nmm_out) {
  __shared__ __align__(16) uint8_t tiles[2][kTileBytes];
  __shared__ int32_t table[128];   // walk_entry of state * 32 + byte
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int e = lane; e < 128; e += 32) table[e] = walk_entry(e >> 5, e & 31);
  const int d0 = diag0[b], half = W / 2;
  const long long total = (long long)Lp * B * W;
  int8_t* out = ops + (size_t)b * L_OPS;
  const int i0 = bi[b];
  const int c0 = d0 + i0 + bk[b] - half;
  int i = i0, c = c0, k = bk[b];
  int state = 0, n = 0;                // state 0 H, 1 H0, 2 E, 3 F
  bool stop = best[b] <= 0;
  int cur = 0;
  const int bw3 = (int)(((long long)B * W) & 3);   // a row's step, mod 4
  Tile t = tile_at(-1, 0, b, B, W), next = t;
  bool pending = false;                // `next` is staged or in flight
  __syncwarp();                        // the table is written
  for (;;) {
    // lane 0 walks the current tile until the walk ends or leaves it
    bool done = false;
    if (lane == 0) {
      const uint8_t* tile = &tiles[cur][0];
      const int i_lo = max(t.top - kTileRows + 1, 0);
      const int k_lo = max(t.k_lo, 0), k_hi = min(t.k_lo + kTileCols, W);
      int rr = t.top - i;
      int x = rr * kTileStride + ((t.shift - rr * bw3) & 3) + (k - t.k_lo);
      int at = state * 32;
      while (!stop && i >= i_lo && i <= t.top && k >= k_lo && k < k_hi &&
             c >= 0 && n < L_OPS) {
        const int e = table[at + tile[x]];
        at = (e & 3) * 32;
        stop = e & 4;
        const int op = (e >> 3) & 3;
        out[n] = (int8_t)op;        // a stop writes its 0 over a 0
        n += op != 0;
        const int di = (e >> 5) & 1, dc = (e >> 6) & 1;
        i -= di;
        c -= dc;
        k += di - dc;
        if (kAligned) {
          x += e >> 8;
        } else {
          rr = t.top - i;
          x = rr * kTileStride + ((t.shift - rr * bw3) & 3) + (k - t.k_lo);
        }
      }
      state = at / 32;
      done = stop || i < 0 || c < 0 || k < 0 || k >= W || n >= L_OPS;
    }
    done = __shfl_sync(kFull, done, 0);
    if (done) break;
    i = __shfl_sync(kFull, i, 0);
    k = __shfl_sync(kFull, k, 0);
    // restage: the prefetched tile if it holds the walk, else where it is
    if (pending && next.holds(i, k)) {
      wait_staged(false);
      cur ^= 1;
      t = next;
    } else {
      if (pending) wait_staged(false);
      t = tile_at(i, k - kTileCols / 2, b, B, W);
      stage(&tiles[cur][0], ptrs, total, t, b, B, W, lane);
    }
    next = tile_at(t.top - kTileRows, k - kTileCols / 2, b, B, W);
    pending = next.top >= 0;
    if (pending)
      stage(&tiles[cur ^ 1][0], ptrs, total, next, b, B, W, lane);
    wait_staged(pending);
  }
  if (pending) wait_staged(false);
  n = __shfl_sync(kFull, n, 0);
  i = __shfl_sync(kFull, i, 0);
  c = __shfl_sync(kFull, c, 0);
  __syncwarp();   // lane 0's op codes are visible to the warp
  // matches and mismatches of the M ops, 32 ops at a time
  const unsigned lower = (1u << lane) - 1u;
  int di = 0, dc = 0, nm = 0, nmm = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int op = j0 + lane < n ? out[j0 + lane] : 0;
    const unsigned mi = __ballot_sync(kFull, op == 1 || op == 2);
    const unsigned mc = __ballot_sync(kFull, op == 1 || op == 3);
    bool hit = false;
    if (op == 1) {
      const int ii = i0 - di - __popc(mi & lower);
      const int cc = c0 - dc - __popc(mc & lower);
      hit = probes[(size_t)b * Lq + min(ii, Lq - 1)] ==
            targets[(size_t)b * Lt + min(cc, Lt - 1)];
    }
    nm += __popc(__ballot_sync(kFull, op == 1 && hit));
    nmm += __popc(__ballot_sync(kFull, op == 1 && !hit));
    di += __popc(mi);
    dc += __popc(mc);
  }
  if (lane == 0) {
    n_out[b] = n;
    ps[b] = i + 1;
    ts[b] = c + 1;
    nm_out[b] = nm;
    nmm_out[b] = nmm;
  }
}

// --- the cluster's own costs ----------------------------------------------

// `iters` cluster barriers (arrive + wait), then `iters` dependent loads
// from the last block's shared memory and `iters` from its own by thread 0
// of block 0; writes the nanoseconds of each run (%globaltimer) to out[0],
// out[1] and out[2]
__global__ void cluster_probe_kernel(int iters, long long* out) {
  __shared__ int chain[64];
  const uint32_t rank = cluster_rank();
  for (int j = threadIdx.x; j < 64; j += blockDim.x) chain[j] = (j + 1) & 63;
  cluster_arrive();
  cluster_wait();
  unsigned long long t0, t1, t2, t3;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int it = 0; it < iters; ++it) {
    cluster_arrive();
    cluster_wait();
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  uint32_t nblocks;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nblocks));
  if (rank == 0 && threadIdx.x == 0) {
    const uint32_t remote = map_rank(smem_addr(chain), nblocks - 1);
    int idx = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t2));
    for (int it = 0; it < iters; ++it) {
      int v;
      asm volatile("ld.shared::cluster.s32 %0, [%1];"
                   : "=r"(v) : "r"(remote + 4u * idx) : "memory");
      idx = v;
    }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t3));
    const uint32_t local = smem_addr(chain);
    unsigned long long t4, t5;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t4));
    for (int it = 0; it < iters; ++it) {
      int v;
      asm volatile("ld.shared.s32 %0, [%1];"
                   : "=r"(v) : "r"(local + 4u * idx) : "memory");
      idx = v;
    }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t5));
    out[0] = (long long)(t1 - t0);
    out[1] = (long long)(t3 - t2);
    out[2] = (long long)(t5 - t4);
    out[3] = idx;   // keeps the chains live
  }
  cluster_arrive();   // no block leaves while block 0 reads the last one
  cluster_wait();
}

}  // namespace

// Launches the scan on `stream` of `device`: B pairs, probes [B, Lp] and
// targets [B, Lt] uint8, plens, tlens, diag0 [B] int32; writes best, bi,
// bk [B] int32 and, where `ptrs` is not null, the [Lp, B, W] pointer
// bytes. Each pair runs on a cluster of P blocks with C columns a thread
// (kernels/sw.py's scan_layout). W must be in [1, 8192] and (P, C) a
// layout that fits (at most 32 warps a pair, 512 threads a block). Returns
// the CUDA error of the launch, 0 on success.
extern "C" int sw_scan_launch(int device, const void* probes,
                              const void* targets, const void* plens,
                              const void* tlens, const void* diag0, int B,
                              int Lp, int Lt, int W, int match, int mismatch,
                              int gap_open, int gap_ext, int P, int C,
                              void* ptrs, void* best, void* bi, void* bk,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Lp == 0) return 0;
  if (W < 1 || W > 8 * 32 * kMaxWarps || !scan_layout_ok(W, P, C))
    return (int)cudaErrorInvalidValue;
  const Scores s{match, mismatch, gap_open, gap_ext};
  const auto* p = static_cast<const uint8_t*>(probes);
  const auto* t = static_cast<const uint8_t*>(targets);
  const auto* pl = static_cast<const int32_t*>(plens);
  const auto* tl = static_cast<const int32_t*>(tlens);
  const auto* d0 = static_cast<const int32_t*>(diag0);
  auto* pt = static_cast<uint8_t*>(ptrs);
  auto* bs = static_cast<int32_t*>(best);
  auto* i0 = static_cast<int32_t*>(bi);
  auto* k0 = static_cast<int32_t*>(bk);
  auto st = (cudaStream_t)stream;
  if (P == 1)   // one block a pair: its own barrier
    return (int)launch_scan_c<false>(C, P, st, p, t, pl, tl, d0, B, Lp,
                                             Lt, W, s, pt, bs, i0, k0);
  return (int)launch_scan_c<true>(C, P, st, p, t, pl, tl, d0, B, Lp, Lt,
                                       W, s, pt, bs, i0, k0);
}

// Writes into `n` how many clusters of the scan at layout (P, C) for band W
// the card holds at once (cudaOccupancyMaxActiveClusters). Returns the
// CUDA error, 0 on success.
extern "C" int sw_scan_clusters(int device, int B, int W, int P, int C,
                                int* n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W < 1 || W > 8 * 32 * kMaxWarps || !scan_layout_ok(W, P, C))
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 2: return (int)scan_clusters<2>(B, W, P, n);
    case 4: return (int)scan_clusters<4>(B, W, P, n);
    default: return (int)scan_clusters<8>(B, W, P, n);
  }
}

// Launches the traceback on `stream` of `device`: pointer bytes [Lp, B, W]
// uint8 (starting on a 4-byte boundary), probes [B, Lq] and targets [B, Lt]
// uint8, best, bi, bk, diag0 [B] int32; writes the first n of each pair's
// L_OPS op codes into `ops` (which the caller zero-fills) and n, ps, ts,
// nm, nmm [B] int32. Returns the CUDA error of the launch, 0 on success.
extern "C" int sw_traceback_launch(int device, const void* ptrs,
                                   const void* probes, const void* targets,
                                   const void* best, const void* bi,
                                   const void* bk, const void* diag0, int B,
                                   int Lp, int Lq, int Lt, int W, int L_OPS,
                                   void* ops, void* n, void* ps, void* ts,
                                   void* nm, void* nmm, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if (reinterpret_cast<uintptr_t>(ptrs) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  auto kernel = ((long long)B * W) % 4 == 0 ? sw_traceback_kernel<true>
                                             : sw_traceback_kernel<false>;
  kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(ptrs), static_cast<const uint8_t*>(probes),
      static_cast<const uint8_t*>(targets), static_cast<const int32_t*>(best),
      static_cast<const int32_t*>(bi), static_cast<const int32_t*>(bk),
      static_cast<const int32_t*>(diag0), B, Lp, Lq, Lt, W, L_OPS,
      static_cast<int8_t*>(ops), static_cast<int32_t*>(n),
      static_cast<int32_t*>(ps), static_cast<int32_t*>(ts),
      static_cast<int32_t*>(nm), static_cast<int32_t*>(nmm));
  return (int)cudaGetLastError();
}

// Times, on `device`, one cluster of P blocks of 32 threads: `iters`
// cluster barriers, `iters` dependent DSMEM loads (block 0 from block
// P - 1) and `iters` dependent loads of block 0's own shared memory.
// Writes the nanoseconds of each run into out[0..2] (device memory, 4
// int64). Returns the CUDA error, 0 on success.
extern "C" int sw_cluster_probe(int device, int P, int iters, void* out,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P < 1 || P > kMaxCluster || iters < 1)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, iters,
                           static_cast<long long*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
