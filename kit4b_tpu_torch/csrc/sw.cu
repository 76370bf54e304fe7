// Banded affine-gap Smith-Waterman for Hopper (sm_90a): the row scan and
// the traceback of kit4b_tpu_torch/pacbio/sswd.py's banded_sw_batch.
//
// sw_scan_kernel replaces the XLA pass `_sw_scan` of
// kit4b_tpu/pacbio/sswd.py (a lax.scan over the padded probe rows, the
// in-row gap run resolved by an associative max scan); sw_traceback_kernel
// replaces `_traceback_dev` (a vmapped while_loop over the resident
// pointer bytes). kernels/sw.py holds both specs as plain PyTorch
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
//   the row peak is the first k of max H; the best cell moves on a
//   strictly greater peak only.
//
// One block a pair, all Lp rows, the previous row's H and E in shared
// memory (8 bytes a column: 24 KB at W 3,000, dynamic shared memory with
// its attribute past 48 KB). A thread owns C consecutive columns (C = 1, 2,
// 4 or 8, the least that lets at most 1,024 threads cover W), so F's max
// scan is serial over a thread's columns, then __shfl_up_sync across the
// warp, then the warps' totals through shared memory. Two __syncthreads a
// row: after the reads of the previous row (the warps' totals are then
// ready), and after the new row is written (the row peak's warp maxima
// are then ready for warp 0, which folds them while the other warps start
// the next row).
//
// What bounds it: operations. The recurrence costs about 35 int32
// operations a cell (chip_smoke.py's SW_OPS_PER_CELL lists them), against
// one pointer byte written a cell: at 16.7e12 int32 operations a second
// (132 SMs x 64 INT32 lanes x 1.98 GHz) and 3.35e12 bytes a second, the
// operations take 5 times as long as the bytes. This first design runs one
// block a pair, so a batch of 32 pairs fills 32 of the card's 132 SMs, and
// pays two block-wide barriers a row; both are what a redesign would cut
// (several pairs a block, or a pair's rows split into diagonal tiles).
//
// The traceback: one thread a pair walks its lane's pointer bytes with the
// state machine of _traceback_dev (H, H0, E, F), writing the op codes in
// reverse order. Bound by bytes on paper (a pointer byte and two codes a
// step), but each step's read depends on the one before, so the walk runs
// at the latency of a dependent read, far below that bound; a redesign
// would stage the band's rows through shared memory ahead of the walk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNeg = -(1 << 24);
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int32_t match, mismatch, open, ext;
};

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
sw_scan_kernel(const uint8_t* __restrict__ probes,
               const uint8_t* __restrict__ targets,
               const int32_t* __restrict__ plens,
               const int32_t* __restrict__ tlens,
               const int32_t* __restrict__ diag0, int B, int Lp, int Lt,
               int W, Scores s, uint8_t* __restrict__ ptrs,
               int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
               int32_t* __restrict__ bk_out) {
  extern __shared__ int32_t smem[];
  int32_t* Hs = smem;             // [W + 1]: the previous row's H, NEG at W
  int32_t* Es = smem + (W + 1);   // [W + 1]: the previous row's E, NEG at W
  __shared__ int32_t warp_max[32], warp_last[32], peak_v[32], peak_k[32];

  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = t * C;
  const uint8_t* probe = probes + (size_t)b * Lp;
  const uint8_t* target = targets + (size_t)b * Lt;
  const int plen = plens[b], tlen = tlens[b];
  const int base = diag0[b] - W / 2;
  for (int k = t; k <= W; k += blockDim.x) {
    Hs[k] = k < W ? 0 : kNeg;
    Es[k] = kNeg;
  }
  int32_t best = 0, bi = 0, bk = 0;    // thread 0's
  __syncthreads();

  for (int i = 0; i < Lp; ++i) {
    const int pb = __ldg(probe + i);
    const bool row_ok = i < plen && pb < 4;
    int32_t H0[C], E[C];
    uint32_t bits[C];
    int32_t tmax = kNeg, last_x = kNeg;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int k = k0 + j;
      H0[j] = 0;
      E[j] = kNeg;
      bits[j] = 0;
      if (k < W) {
        const int c = base + i + k;
        const int tb = __ldg(target + min(max(c, 0), Lt - 1));
        const bool ok = row_ok && c >= 0 && c < tlen && tb < 4;
        const int32_t sub = ok ? (pb == tb ? s.match : s.mismatch) : kNeg;
        const int32_t e_open = Hs[k + 1] + s.open;
        const int32_t e_ext = Es[k + 1] + s.ext;
        E[j] = max(e_open, e_ext);
        const int32_t diag = Hs[k] + sub;
        H0[j] = max(max(diag, E[j]), 0);
        bits[j] = (H0[j] == 0 ? 0u : (H0[j] == diag ? 1u : 2u)) |
                  (e_ext >= e_open ? 8u : 0u);
        last_x = H0[j] + s.open - (k + 1) * s.ext;
        tmax = max(tmax, last_x);
      }
    }
    // inclusive max scan of the threads' maxima across the warp
    int32_t incl = tmax;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int32_t excl = __shfl_up_sync(kFull, incl, 1);     // lanes 1..31
    int32_t prev_x = __shfl_up_sync(kFull, last_x, 1);
    if (lane == 31) {
      warp_max[warp] = incl;
      warp_last[warp] = last_x;
    }
    __syncthreads();   // the previous row's Hs and Es are read
    // the maxima of the warps before this one
    int32_t wv = lane < nwarps ? warp_max[lane] : kNeg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(kFull, wv, o);
      if (lane >= o) wv = max(wv, v);
    }
    const int32_t before = __shfl_sync(kFull, wv, (warp + 31) & 31);
    if (lane == 0) {
      excl = warp > 0 ? before : kNeg;
      prev_x = warp > 0 ? warp_last[warp - 1] : kNeg;
    } else if (warp > 0) {
      excl = max(excl, before);
    }
    // F, the pointer bytes, the new row, this thread's first peak
    int32_t run = excl, pv = INT32_MIN, pk = 0;
    uint8_t* row = ptrs ? ptrs + ((size_t)i * B + b) * W : nullptr;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int k = k0 + j;
      if (k < W) {
        const int32_t x = H0[j] + s.open - (k + 1) * s.ext;
        const int32_t F = run + k * s.ext;
        const int32_t Hf = max(H0[j], F);
        if (row)
          row[k] = (uint8_t)(bits[j] | (F > H0[j] ? 4u : 0u) |
                             (run > prev_x ? 16u : 0u));
        if (Hf > pv) {
          pv = Hf;
          pk = k;
        }
        Hs[k] = Hf;
        Es[k] = E[j];
        run = max(run, x);
        prev_x = x;
      }
    }
    // first-index max across the warp
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int32_t v = __shfl_down_sync(kFull, pv, o);
      const int32_t kk = __shfl_down_sync(kFull, pk, o);
      if (v > pv || (v == pv && kk < pk)) {
        pv = v;
        pk = kk;
      }
    }
    if (lane == 0) {
      peak_v[warp] = pv;
      peak_k[warp] = pk;
    }
    __syncthreads();   // the new row and the warps' peaks are written
    if (warp == 0) {
      int32_t v = lane < nwarps ? peak_v[lane] : INT32_MIN;
      int32_t kk = lane < nwarps ? peak_k[lane] : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int32_t v2 = __shfl_down_sync(kFull, v, o);
        const int32_t k2 = __shfl_down_sync(kFull, kk, o);
        if (v2 > v || (v2 == v && k2 < kk)) {
          v = v2;
          kk = k2;
        }
      }
      if (lane == 0 && v > best) {
        best = v;
        bi = i;
        bk = kk;
      }
    }
  }
  if (t == 0) {
    best_out[b] = best;
    bi_out[b] = bi;
    bk_out[b] = bk;
  }
}

template <int C>
cudaError_t launch_scan(int threads, size_t smem, cudaStream_t stream,
                        const uint8_t* probes, const uint8_t* targets,
                        const int32_t* plens, const int32_t* tlens,
                        const int32_t* diag0, int B, int Lp, int Lt, int W,
                        Scores s, uint8_t* ptrs, int32_t* best, int32_t* bi,
                        int32_t* bk) {
  cudaError_t err = cudaFuncSetAttribute(
      sw_scan_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sw_scan_kernel<C><<<B, threads, smem, stream>>>(
      probes, targets, plens, tlens, diag0, B, Lp, Lt, W, s, ptrs, best, bi,
      bk);
  return cudaGetLastError();
}

__global__ void sw_traceback_kernel(
    const uint8_t* __restrict__ ptrs, const uint8_t* __restrict__ probes,
    const uint8_t* __restrict__ targets, const int32_t* __restrict__ best,
    const int32_t* __restrict__ bi, const int32_t* __restrict__ bk,
    const int32_t* __restrict__ diag0, int B, int Lp, int Lq, int Lt, int W,
    int L_OPS, int8_t* __restrict__ ops, int32_t* __restrict__ n_out,
    int32_t* __restrict__ ps, int32_t* __restrict__ ts,
    int32_t* __restrict__ nm_out, int32_t* __restrict__ nmm_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int d0 = diag0[b], half = W / 2;
  const uint8_t* probe = probes + (size_t)b * Lq;
  const uint8_t* target = targets + (size_t)b * Lt;
  int8_t* out = ops + (size_t)b * L_OPS;
  int i = bi[b];
  int c = d0 + i + bk[b] - half;
  int state = 0, n = 0, nm = 0, nmm = 0;   // state 0 H, 1 H0, 2 E, 3 F
  bool stop = best[b] <= 0;
  for (;;) {
    const int k = c - i - d0 + half;
    if (stop || i < 0 || c < 0 || k < 0 || k >= W || n >= L_OPS) break;
    const int byte =
        ptrs[((size_t)min(i, Lp - 1) * B + b) * W + k];
    const int d = byte & 3;
    int op = 0, next;
    switch (state) {
      case 0:
        next = (byte & 4) ? 3 : 1;
        break;
      case 1:
        next = d == 1 ? 0 : 2;
        if (d == 0) stop = true;
        else if (d == 1) op = 1;
        break;
      case 2:
        next = (byte & 8) ? 2 : 0;
        op = 2;
        break;
      default:
        next = (byte & 16) ? 3 : 1;
        op = 3;
        break;
    }
    if (op) {
      if (op == 1) {
        const bool match = probe[min(i, Lq - 1)] == target[min(c, Lt - 1)];
        nm += match;
        nmm += !match;
      }
      out[n++] = (int8_t)op;
      if (op != 3) --i;     // M and D consume a probe base
      if (op != 2) --c;     // M and I consume a target base
    }
    state = next;
  }
  n_out[b] = n;
  ps[b] = i + 1;
  ts[b] = c + 1;
  nm_out[b] = nm;
  nmm_out[b] = nmm;
}

}  // namespace

// Launches the scan on `stream` of `device`: B pairs, probes [B, Lp] and
// targets [B, Lt] uint8, plens, tlens, diag0 [B] int32; writes best, bi,
// bk [B] int32 and, where `ptrs` is not null, the [Lp, B, W] pointer
// bytes. W must be in [1, 8192]. Returns the CUDA error of the launch, 0 on
// success.
extern "C" int sw_scan_launch(int device, const void* probes,
                              const void* targets, const void* plens,
                              const void* tlens, const void* diag0, int B,
                              int Lp, int Lt, int W, int match, int mismatch,
                              int gap_open, int gap_ext, void* ptrs,
                              void* best, void* bi, void* bk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Lp == 0) return 0;
  if (W < 1 || W > 8 * kMaxThreads) return (int)cudaErrorInvalidValue;
  const int C = W <= kMaxThreads ? 1 : W <= 2 * kMaxThreads ? 2
                : W <= 4 * kMaxThreads ? 4 : 8;
  const int threads = ((W + C - 1) / C + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)(W + 1) * sizeof(int32_t);
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
  switch (C) {
    case 1:
      err = launch_scan<1>(threads, smem, st, p, t, pl, tl, d0, B, Lp, Lt, W,
                           s, pt, bs, i0, k0);
      break;
    case 2:
      err = launch_scan<2>(threads, smem, st, p, t, pl, tl, d0, B, Lp, Lt, W,
                           s, pt, bs, i0, k0);
      break;
    case 4:
      err = launch_scan<4>(threads, smem, st, p, t, pl, tl, d0, B, Lp, Lt, W,
                           s, pt, bs, i0, k0);
      break;
    default:
      err = launch_scan<8>(threads, smem, st, p, t, pl, tl, d0, B, Lp, Lt, W,
                           s, pt, bs, i0, k0);
      break;
  }
  return (int)err;
}

// Launches the traceback on `stream` of `device`: pointer bytes [Lp, B, W]
// uint8, probes [B, Lq] and targets [B, Lt] uint8, best, bi, bk, diag0 [B]
// int32; writes the first n of each lane's L_OPS op codes into `ops` (which
// the caller zero-fills) and n, ps, ts, nm, nmm [B] int32. Returns the CUDA
// error of the launch, 0 on success.
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
  constexpr int kLanes = 32;
  sw_traceback_kernel<<<(B + kLanes - 1) / kLanes, kLanes, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(ptrs), static_cast<const uint8_t*>(probes),
      static_cast<const uint8_t*>(targets), static_cast<const int32_t*>(best),
      static_cast<const int32_t*>(bi), static_cast<const int32_t*>(bk),
      static_cast<const int32_t*>(diag0), B, Lp, Lq, Lt, W, L_OPS,
      static_cast<int8_t*>(ops), static_cast<int32_t*>(n),
      static_cast<int32_t*>(ps), static_cast<int32_t*>(ts),
      static_cast<int32_t*>(nm), static_cast<int32_t*>(nmm));
  return (int)cudaGetLastError();
}
