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
// What bounds it: integer instruction rate. The sweep scores every pair of
// windows, ~N^2/2 pairs for each of the engine's four sweeps, and reads only
// the genome's codes, so bytes never matter; what matters is how many
// instructions one pair costs. An SM starts 64 shifts or three-input logic
// operations a clock but only 16 popcounts, so a popcount a pair (with the
// shift, mask and compare-and-min around it) cannot go below ~2/16 of a
// clock a pair. This kernel has no popcount and no per-pair instruction at
// all: it counts in bit planes, 32 pairs to every instruction.
//
// Design. A block stages its own tile (4,096 window starts) and the
// partner codes its 2,048 offsets reach in shared memory as bit planes: for
// every 32 positions, three words with bits 0-2 of the codes (enough to
// tell 0-4 apart) and a word whose bit b says that the K-window starting
// there holds no sentinel and ends inside the array. A lane owns four
// consecutive words of own starts; a warp walks a contiguous eighth of the
// block's offsets, so the partner words a lane needs change only every 32
// offsets and stay in registers between. In every word, bit b belongs to own
// start b. For one offset a lane
//   1. builds the mismatch words of its own words and the one after (three
//      funnel shifts and three gates each);
//   2. sums five neighbours into three planes (`five`: two full adders and
//      two gates a word), as the TPU kernel's 5+5 shifted adds do;
//   3. adds K / 5 shifted copies of those planes and K % 5 single mismatch
//      words by carry-save full adders into the five planes of the window
//      sums (`window_sums`; K = 25: 12 funnel shifts and 23 gates a word);
//   4. folds them into its running minimum, also five planes
//      (`slice_min`: the borrow of c - mn, one majority a plane, gated by
//      the validity word, then one select a plane). All planes set (31,
//      which no sum of K <= 25 reaches) means no pair yet, so 9999 never
//      enters the planes.
// A full adder is two LOP3 (a^b^c and the majority). At K = 25 a step of 128
// pairs is 272 shifts and gates, 2.1 a pair (a lane's words share the
// mismatch words and five-sums at their seams, so more words a lane cost
// less a pair and more registers: 119 at four). K is a template parameter: the
// network of every K in 1..25 is laid out at compile time. At the end the
// eight warps meet in shared memory as planes, are merged by the same
// sliced minimum, and each start's five bits are unpacked once for the
// block's atomicMin. Blocks whose offsets all lie past the last window that
// fits (the triangle's empty half) return at once, and a warp skips 32
// offsets where every lane's own words, or the partner words they meet,
// hold no valid window at all. The TPU kernel's roll,
// 512-alignment and sequential span axis have no counterpart here.
//
// tests/test_torch_sweep_words.py holds a numpy model of this file, function
// by function under the same names, to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLaneWords = 4;                      // own words per lane
constexpr int kWords = 32 * kLaneWords;            // own words per block
constexpr int kTile = 32 * kWords;                 // own window starts per block
constexpr int kSpan = 2048;                        // offsets per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwnWords = kWords + 1;              // a lane reads one word past its own
constexpr int kPartWords = kWords + kSpan / 32 + 1;   // ... and partner words q .. q + kLaneWords + 1
constexpr int kPerWord = kThreads / kWords;        // threads that unpack one word
constexpr int kNone = 31;                          // all planes set: no pair yet
static_assert(kThreads % kWords == 0 && 32 % kPerWord == 0, "unpack split");

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

// One LOP3: any function of three words, given as its truth table
// f(0xF0, 0xCC, 0xAA). Written as PTX so that every gate below is one
// instruction whatever the optimiser would make of the expression.
template <int kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  return lop3<0x96>(a, b, c);   // a ^ b ^ c
}

__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return lop3<0xE8>(a, b, c);   // (a & b) | (a & c) | (b & c)
}

// Sum of five one-bit words as three planes: two full adders, two gates.
__device__ __forceinline__ void five(uint32_t (&s5)[3], uint32_t a, uint32_t b,
                                     uint32_t c, uint32_t d, uint32_t e) {
  const uint32_t s1 = xor3(a, b, c), c1 = maj(a, b, c);
  const uint32_t s2 = xor3(s1, d, e), c2 = maj(s1, d, e);
  s5[0] = s2;
  s5[1] = c1 ^ c2;
  s5[2] = c1 & c2;
}

// Words the network puts into column p (weight 2^p) itself: K / 5 shifted
// copies of the three planes of the five-sum, K % 5 single mismatch words.
__host__ __device__ constexpr int direct(int K, int p) {
  return p == 0 ? K / 5 + K % 5 : p < 3 ? K / 5 : 0;
}

// Words column p holds: its own and the carries of column p - 1.
__host__ __device__ constexpr int entries(int K, int p) {
  return p == 0 ? direct(K, 0) : direct(K, p) + entries(K, p - 1) / 2;
}

__host__ __device__ constexpr int planes(int K) {
  return K < 2 ? 1 : K < 4 ? 2 : K < 8 ? 3 : K < 16 ? 4 : 5;
}

// Adds column p's words: full adders on three at a time, a half adder on a
// last pair, carries into column p + 1. The top plane of a sum <= K never
// carries, so it only XORs; planes past it are zero.
template <int K, int p>
__device__ __forceinline__ uint32_t column(uint32_t (&e)[6][8]) {
  constexpr int n = entries(K, p);
  constexpr bool top = p == planes(K) - 1;
  constexpr int up = direct(K, p + 1);
  if constexpr (n == 0 || p >= planes(K)) {
    return 0;
  } else {
    uint32_t acc = e[p][0];
#pragma unroll
    for (int i = 1; i < n; i += 2) {
      if (i + 1 < n) {
        const uint32_t x = e[p][i], y = e[p][i + 1];
        if constexpr (!top) e[p + 1][up + i / 2] = maj(acc, x, y);
        acc = xor3(acc, x, y);
      } else {
        const uint32_t x = e[p][i];
        if constexpr (!top) e[p + 1][up + i / 2] = acc & x;
        acc ^= x;
      }
    }
    return acc;
  }
}

// Five planes c[0..4]: bit b of c[p] is bit p of sum_{k<K} m[b + k], where m
// is the 64 mismatch bits (m_hi:m_lo) and s5lo / s5hi the planes of
// m[j] + ... + m[j + 4] at positions 0-31 and 32-63.
template <int K>
__device__ __forceinline__ void window_sums(uint32_t (&c)[5],
                                            const uint32_t (&s5lo)[3],
                                            const uint32_t (&s5hi)[3],
                                            uint32_t m_lo, uint32_t m_hi) {
  constexpr int q = K / 5, r = K % 5;
  uint32_t e[6][8];
#pragma unroll
  for (int t = 0; t < q; ++t) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
      e[p][t] = t == 0 ? s5lo[p] : __funnelshift_r(s5lo[p], s5hi[p], 5 * t);
  }
#pragma unroll
  for (int j = 0; j < r; ++j)
    e[0][q + j] = 5 * q + j == 0 ? m_lo : __funnelshift_r(m_lo, m_hi, 5 * q + j);
  c[0] = column<K, 0>(e);
  c[1] = column<K, 1>(e);
  c[2] = column<K, 2>(e);
  c[3] = column<K, 3>(e);
  c[4] = column<K, 4>(e);
}

// mn = v and c < mn ? c : mn, per bit position: the borrow of c - mn from
// plane 0 up (one majority a plane), gated by v, then one select a plane.
// Equal is not less.
__device__ __forceinline__ void slice_min(uint32_t (&mn)[5],
                                          const uint32_t (&c)[5], uint32_t v) {
  uint32_t bw = ~c[0] & mn[0];
#pragma unroll
  for (int p = 1; p < 5; ++p) bw = lop3<0x8E>(c[p], mn[p], bw);   // maj(~c, mn, bw)
  const uint32_t lt = bw & v;
#pragma unroll
  for (int p = 0; p < 5; ++p) mn[p] = lop3<0xCA>(lt, c[p], mn[p]);   // lt ? c : mn
}

// One offset: the lane scores its own words o[0..kLaneWords) against the
// partner words p[0..kLaneWords + 1] shifted by s, and folds into mn.
template <int K>
__device__ __forceinline__ void step(const Word (&o)[kLaneWords + 1],
                                     const Word (&p)[kLaneWords + 2], int s,
                                     uint32_t (&mn)[kLaneWords][5]) {
  constexpr int q = K / 5;
  uint32_t m[kLaneWords + 1];
#pragma unroll
  for (int j = 0; j <= kLaneWords; ++j)
    m[j] = lop3<0xBE>(   // (a ^ b) | c, twice
        o[j].b2, __funnelshift_r(p[j].b2, p[j + 1].b2, s),
        lop3<0xBE>(o[j].b1, __funnelshift_r(p[j].b1, p[j + 1].b1, s),
                   o[j].b0 ^ __funnelshift_r(p[j].b0, p[j + 1].b0, s)));
  uint32_t s5[kLaneWords + 1][3] = {};
  if constexpr (q >= 1) {
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j)
      five(s5[j], m[j], __funnelshift_r(m[j], m[j + 1], 1),
           __funnelshift_r(m[j], m[j + 1], 2), __funnelshift_r(m[j], m[j + 1], 3),
           __funnelshift_r(m[j], m[j + 1], 4));
  }
  if constexpr (q >= 2) {   // only its low 20 positions are read: plain shifts do
    constexpr int j = kLaneWords;
    five(s5[j], m[j], m[j] >> 1, m[j] >> 2, m[j] >> 3, m[j] >> 4);
  }
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) {
    const uint32_t v = o[j].ok & __funnelshift_r(p[j].ok, p[j + 1].ok, s);
    uint32_t c[5];
    window_sums<K>(c, s5[j], s5[j + 1], m[j], m[j + 1]);
    slice_min(mn[j], c, v);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint8_t* __restrict__ own, long long own_lim,
             const uint8_t* __restrict__ part, long long part_lim,
             long long d_lo, long long d_hi, long long span0,
             int* __restrict__ out) {
  __shared__ Word s_own[kOwnWords];
  __shared__ Word s_part[kPartWords];
  __shared__ uint32_t s_sent[kPartWords + 1];
  __shared__ uint32_t s_mn[kWarps][5][kWords];   // every warp's minima, as planes

  const long long base = (long long)blockIdx.y * kTile;   // first own start
  const long long d0 = span0 + (long long)blockIdx.x * kSpan;
  // The last partner window that fits starts at part_lim - K.
  const long long lo = max(d_lo, d0);
  const long long hi = min(min(d0 + kSpan, d_hi), part_lim - K - base + 1);
  if (lo >= hi) return;   // uniform across the block

  stage(s_own, s_sent, own, own_lim, base, kOwnWords, K);
  stage(s_part, s_sent, part, part_lim, base + d0, kPartWords, K);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Word o[kLaneWords + 1];
#pragma unroll
  for (int j = 0; j <= kLaneWords; ++j) o[j] = s_own[kLaneWords * lane + j];
  uint32_t mn[kLaneWords][5];
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j)
#pragma unroll
    for (int p = 0; p < 5; ++p) mn[j][p] = 0xffffffffu;

  // this warp's share of the block's offsets: a contiguous run
  const int dd_lo = (int)(lo - d0), dd_hi = (int)(hi - d0);
  const int per = (dd_hi - dd_lo + kWarps - 1) / kWarps;
  int dd = dd_lo + warp * per;
  const int dd_end = min(dd + per, dd_hi);
  while (dd < dd_end) {
    // The partner start of bit 0 of this lane's own word j is
    // base + d0 + 32 * (kLaneWords * lane + j + qq) + s, so
    // __funnelshift_r(p[j], p[j + 1], s) lines partner bits up with own bits.
    const int qq = dd >> 5;
    const int s_end = min(32, dd_end - 32 * qq);
    Word p[kLaneWords + 2];
#pragma unroll
    for (int j = 0; j < kLaneWords + 2; ++j) p[j] = s_part[kLaneWords * lane + qq + j];
    // A pair of own word j is valid only where o[j].ok meets a bit of
    // p[j + 1].ok : p[j].ok shifted by s, so for no s while either is zero.
    bool reach = false;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j)
      reach |= o[j].ok != 0 && (p[j].ok | p[j + 1].ok) != 0;
    if (__any_sync(0xffffffffu, reach)) {   // else no lane has a valid pair in these 32
      for (int s = dd & 31; s < s_end; ++s) step<K>(o, p, s, mn);
    }
    dd = 32 * qq + s_end;
  }

#pragma unroll
  for (int j = 0; j < kLaneWords; ++j)
#pragma unroll
    for (int p = 0; p < 5; ++p) s_mn[warp][p][kLaneWords * lane + j] = mn[j][p];
  __syncthreads();
  // kPerWord threads merge the warps' planes of one word and unpack a share
  // of its 32 minima each
  const int word = threadIdx.x / kPerWord;
  uint32_t r[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) r[p] = s_mn[0][p][word];
  for (int w = 1; w < kWarps; ++w) {
    uint32_t c[5];
#pragma unroll
    for (int p = 0; p < 5; ++p) c[p] = s_mn[w][p][word];
    slice_min(r, c, 0xffffffffu);
  }
  constexpr int kBits = 32 / kPerWord;
  const int b0 = (threadIdx.x % kPerWord) * kBits;
#pragma unroll
  for (int b = b0; b < b0 + kBits; ++b) {
    int val = 0;
#pragma unroll
    for (int p = 0; p < 5; ++p) val |= (int)((r[p] >> b) & 1u) << p;
    // a start with a pair is a valid start: base + 32 * word + b < own_lim
    if (val != kNone) atomicMin(out + base + 32 * word + b, val);
  }
}

template <int K>
cudaError_t launch(int k, dim3 grid, cudaStream_t stream, const uint8_t* own,
                   long long own_lim, const uint8_t* part, long long part_lim,
                   long long d_lo, long long d_hi, long long span0, int* out) {
  if (k == K) {
    sweep_kernel<K><<<grid, kThreads, 0, stream>>>(own, own_lim, part, part_lim,
                                                   d_lo, d_hi, span0, out);
    return cudaGetLastError();
  }
  if constexpr (K > 1) {
    return launch<K - 1>(k, grid, stream, own, own_lim, part, part_lim, d_lo,
                         d_hi, span0, out);
  } else {
    return cudaErrorInvalidValue;
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
  return (int)launch<25>(K, grid, (cudaStream_t)stream,
                         static_cast<const uint8_t*>(own), own_lim,
                         static_cast<const uint8_t*>(part), part_lim, d_lo, d_hi,
                         span0, static_cast<int*>(out));
}
