// Offset-sweep kernel of the legacy exhaustive K-mer Hamming engine, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_sweep_kernel` of kit4b_tpu/kmer/hammings_kernel.py
// (launched by `_run_sweep`). For every own window start i and every offset
// d in [d_lo, d_hi):
//
//   out[i] = min over d of  sum_{k<K} [own[i+k] != part[i+d+k]]
//
// over the pairs whose own and partner windows hold no sentinel (code >= 5)
// and end before own_lim and part_lim. The caller fills out with 9999 (no
// pair); blocks fold into it with atomicMin, which gives the same result in
// any order.
//
// What bounds it: integer instruction throughput. The sweep scores every
// pair of windows, ~N^2/2 pairs for each of the engine's four sweeps, and
// reads only the genome's codes, so bytes never matter; what matters is how
// many instructions one pair costs (a direct K-term sum of byte compares is
// ~3K).
//
// Design. A block stages its own tile (1,024 window starts) and the
// partner codes its 2,048 offsets reach in shared memory as bit planes: for
// every 32 positions, three words with bits 0-2 of the codes (enough to
// tell 0-4 apart) and a word whose bit b says that the K-window starting
// there holds no sentinel and ends inside the array. A warp's lane owns one
// word of own starts and walks the warp's share of the offsets; for each
// offset it builds the 32+32 mismatch bits its windows read with three
// funnel shifts, XORs and ORs per word, and then scores each of its 32
// windows as one popcount of a K-bit field. A pair costs about five
// instructions. Each lane keeps its 32 running minima in registers; the
// eight warps meet in shared memory at the end and the block folds into
// the output once. Blocks whose offsets all lie past the last window that
// fits (the triangle's empty half) return at once. The TPU kernel's roll,
// 512-alignment and sequential span axis have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 32;                         // own words per block: one per lane
constexpr int kTile = 32 * kWords;                 // own window starts per block
constexpr int kSpan = 2048;                        // offsets per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwnWords = kWords + 1;              // a lane reads own words w and w + 1
constexpr int kPartWords = (kTile + kSpan) / 32 + 2;  // ... and partner words q .. q + 2
constexpr int kBig = 9999;

// 32 consecutive positions: bits 0-2 of their codes and, bit b of ok, the
// validity of the K-window that starts at position b.
struct __align__(16) Word {
  uint32_t b0, b1, b2, ok;
};

// Stages positions [p0, p0 + 32 * nw) of codes as bit-plane words; positions
// at or past lim read as a sentinel. sent is scratch of nw + 1 words.
__device__ void stage(Word* w, uint32_t* sent, const uint8_t* __restrict__ codes,
                      long long lim, long long p0, int nw, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = warp; u <= nw; u += kWarps) {
    const long long pos = p0 + 32LL * u + lane;
    const unsigned c = pos < lim ? codes[pos] : 0x0Fu;
    const uint32_t b0 = __ballot_sync(0xffffffffu, c & 1u);
    const uint32_t b1 = __ballot_sync(0xffffffffu, c & 2u);
    const uint32_t b2 = __ballot_sync(0xffffffffu, c & 4u);
    const uint32_t s = __ballot_sync(0xffffffffu, c >= 5u);
    if (lane == 0) {
      if (u < nw) {
        w[u].b0 = b0;
        w[u].b1 = b1;
        w[u].b2 = b2;
      }
      sent[u] = s;
    }
  }
  __syncthreads();
  // a window of K <= 25 positions from bit b of word u ends in word u + 1
  for (int u = threadIdx.x; u < nw; u += kThreads) {
    uint32_t any = 0;
    for (int k = 0; k < K; ++k) any |= __funnelshift_r(sent[u], sent[u + 1], k);
    w[u].ok = ~any;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint8_t* __restrict__ own, long long own_lim,
             const uint8_t* __restrict__ part, long long part_lim, int K,
             long long d_lo, long long d_hi, long long span0,
             int* __restrict__ out) {
  __shared__ Word s_own[kOwnWords];
  __shared__ Word s_part[kPartWords];
  __shared__ uint32_t s_sent[kPartWords + 1];
  __shared__ int s_min[32 * 33];   // [bit][lane], padded: no bank conflicts

  const long long base = (long long)blockIdx.y * kTile;   // first own start
  const long long d0 = span0 + (long long)blockIdx.x * kSpan;
  // The last partner window that fits starts at part_lim - K.
  const long long lo = max(d_lo, d0);
  const long long hi = min(min(d0 + kSpan, d_hi), part_lim - K - base + 1);
  if (lo >= hi) return;   // uniform across the block

  for (int j = threadIdx.x; j < 32 * 33; j += kThreads) s_min[j] = kBig;
  stage(s_own, s_sent, own, own_lim, base, kOwnWords, K);
  stage(s_part, s_sent, part, part_lim, base + d0, kPartWords, K);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Word oa = s_own[lane], ob = s_own[lane + 1];
  const uint32_t kmask = (1u << K) - 1;   // K <= 25
  int mn[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) mn[b] = kBig;

  const int dd_hi = (int)(hi - d0);
  for (int dd = (int)(lo - d0) + warp; dd < dd_hi; dd += kWarps) {
    // The partner start of this lane's bit 0 is base + d0 + 32 * q + s, so
    // __funnelshift_r(p[q], p[q + 1], s) lines partner bits up with own bits.
    const int q = lane + (dd >> 5), s = dd & 31;
    const Word p0 = s_part[q], p1 = s_part[q + 1], p2 = s_part[q + 2];
    const uint32_t v = oa.ok & __funnelshift_r(p0.ok, p1.ok, s);
    if (v == 0) continue;
    const uint32_t m0 = (oa.b0 ^ __funnelshift_r(p0.b0, p1.b0, s)) |
                        (oa.b1 ^ __funnelshift_r(p0.b1, p1.b1, s)) |
                        (oa.b2 ^ __funnelshift_r(p0.b2, p1.b2, s));
    const uint32_t m1 = (ob.b0 ^ __funnelshift_r(p1.b0, p2.b0, s)) |
                        (ob.b1 ^ __funnelshift_r(p1.b1, p2.b1, s)) |
                        (ob.b2 ^ __funnelshift_r(p1.b2, p2.b2, s));
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int ws = __popc(__funnelshift_r(m0, m1, b) & kmask);
      if (v & (1u << b)) mn[b] = min(mn[b], ws);
    }
  }

#pragma unroll
  for (int b = 0; b < 32; ++b)
    if (mn[b] < kBig) atomicMin(&s_min[b * 33 + lane], mn[b]);
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int m = s_min[(j & 31) * 33 + (j >> 5)];   // start base + j: lane j/32, bit j%32
    if (m < kBig) atomicMin(out + base + j, m);   // a valid start: base + j < own_lim
  }
}

}  // namespace

// Launches the kernel on `stream` of `device` for offsets [d_lo, d_hi).
// own_lim and part_lim are the lengths of own and part that count (codes past
// them read as sentinels), 1 <= K <= 25, own_lim <= 65535 * 1024, out holds
// at least own_lim ints filled with 9999, and all pointers are device
// pointers (the Python wrapper checks). Returns the CUDA error of the launch,
// 0 on success.
extern "C" int sweep_launch(int device, const void* own, long long own_lim,
                            const void* part, long long part_lim, int K,
                            long long d_lo, long long d_hi, void* out,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_win = own_lim - K + 1;   // own starts whose window fits
  if (n_win <= 0 || d_lo >= d_hi) return 0;
  const long long span0 = d_lo - d_lo % kSpan;
  const dim3 grid((unsigned)((d_hi - span0 + kSpan - 1) / kSpan),
                  (unsigned)((n_win + kTile - 1) / kTile));
  sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(own), own_lim, static_cast<const uint8_t*>(part),
      part_lim, K, d_lo, d_hi, span0, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
