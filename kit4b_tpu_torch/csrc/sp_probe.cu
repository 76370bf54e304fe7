// Probe of the 2:4-sparse int8 warpgroup product on Hopper (sm_90a), the
// instruction the max-match kernel (minmm.cu) runs on.
//
// `sp_probe_check` runs one warpgroup's product of a 64 x 128 2:4 int8 A
// (compressed by wgmma_sp.cuh's `sp_meta`/`sp_vals`, A from registers or
// from shared memory) by an N x 128 B, two k-steps of 64, and writes the
// 64 x N int32 result, for the caller to hold to a plain product.
//
// `sp_probe_time` runs the consumer loop of the kernel without its producer:
// 2 consumer warpgroups a block, one block an SM, each walking `tiles`
// tiles of N partner columns x 128 channels that stay in shared memory, with
// the kernel's fence, k-steps, commit and wait a tile, and (with `epi`) its
// fold of the tile into running row maxima. N 128: 2 m64 row groups a
// consumer; N 256: 1. What it shows is the instruction's attainable rate
// for each A source and N, with B's bytes read from shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sp.cuh"

namespace {

constexpr int kCheckN = 256;   // widest B of the check

template <bool RS, int N>
__global__ void __launch_bounds__(128, 1)
sp_check_kernel(const int8_t* __restrict__ a_dense, const int8_t* __restrict__ b,
                int* __restrict__ d, int* __restrict__ bad_out) {
  constexpr int NA = N / 2;
  __shared__ __align__(1024) uint8_t s_a[64 * 128];
  __shared__ __align__(1024) uint8_t s_c[64 * 128];
  __shared__ __align__(1024) uint8_t s_b[kCheckN * 128];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < 64 * 128; i += 128)
    s_a[sw128(i / 128, i % 128)] = (uint8_t)a_dense[i];
  for (int i = tid; i < N * 128; i += 128)
    s_b[sw128(i / 128, i % 128)] = (uint8_t)b[i];
  __syncthreads();
  int bad = 0;
  uint32_t e[2], a[2][4];
  const int mrow = warp * 16 + (lane >> 2) + 8 * (lane & 1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    e[s] = sp_meta(s_a, mrow, 64 * s + 32 * ((lane >> 1) & 1), bad);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[s][i] = sp_vals(s_a, warp * 16 + (lane >> 2) + 8 * (i & 1),
                        64 * s + 8 * (lane & 3) + 32 * (i >> 1));
  }
  // the compressed rows for A from shared memory: k-step s at byte 32 s
  for (int q = tid; q < 64 * 16; q += 128) {
    const int row = q / 16, p = q % 16;
    *reinterpret_cast<uint32_t*>(s_c + sw128(row, 4 * p)) = sp_vals(s_a, row, 8 * p);
  }
  fence_proxy_async();
  __syncthreads();
  int acc[NA];
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if constexpr (RS)
      wgmma_sp_rs(acc, a[s], sw128_desc(s_b + 64 * s), e[s], s);
    else
      wgmma_sp_ss(acc, sw128_desc(s_c + 32 * s), sw128_desc(s_b + 64 * s), e[s], s);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
  // accumulator i: row warp*16 + lane/4 + 8*((i>>1)&1), column
  // (i>>2)*8 + (lane&3)*2 + (i&1)
#pragma unroll
  for (int i = 0; i < NA; ++i)
    d[(warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1)) * N + (i >> 2) * 8 +
      (lane & 3) * 2 + (i & 1)] = acc[i];
  if (bad) atomicAdd(bad_out, bad);
}

template <bool RS, int N, bool EPI>
__global__ void __launch_bounds__(256, 1)
sp_time_kernel(long long tiles, int* __restrict__ sink) {
  constexpr int G = N == 128 ? 2 : 1;   // m64 row groups a consumer
  constexpr int NA = N / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_b = smem;                  // N rows x 128 bytes
  uint8_t* s_c = smem + N * 128;        // 2 consumers x G x 64 rows x 128 bytes
  const int tid = threadIdx.x & 127, cons = threadIdx.x >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = threadIdx.x; i < N * 128; i += 256)
    s_b[i] = (uint8_t)((i * 7 + (i >> 7)) % 5 == 0);
  for (int i = threadIdx.x; i < 2 * G * 64 * 128; i += 256)
    s_c[i] = (uint8_t)((i * 3) % 4 == 0);
  fence_proxy_async();
  __syncthreads();
  uint32_t a[G][2][4], e[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      e[g][s] = 0x44444444u;            // indices 0 and 1 of every group
#pragma unroll
      for (int i = 0; i < 4; ++i) a[g][s][i] = 0x00010100u >> (8 * ((i + lane) & 1));
    }
  const uint8_t* c_base = s_c + cons * G * 64 * 128;
  int acc[G][NA];
  int best[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) best[g][0] = best[g][1] = -(1 << 20);
  for (long long t = 0; t < tiles; ++t) {
#pragma unroll
    for (int g = 0; g < G; ++g) pin(acc[g]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (RS)
          wgmma_sp_rs(acc[g], a[g][s], sw128_desc(s_b + 64 * s), e[g][s], s);
        else
          wgmma_sp_ss(acc[g], sw128_desc(c_base + g * 64 * 128 + 32 * s),
                      sw128_desc(s_b + 64 * s), e[g][s], s);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int g = 0; g < G; ++g) pin(acc[g]);
    if constexpr (EPI) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          best[g][0] = __vimax3_s32(best[g][0], acc[g][4 * j], acc[g][4 * j + 1]);
          best[g][1] = __vimax3_s32(best[g][1], acc[g][4 * j + 2], acc[g][4 * j + 3]);
        }
    } else {
      best[0][0] += acc[0][0];
    }
  }
  int v = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) v += best[g][0] + best[g][1];
  sink[blockIdx.x * 256 + threadIdx.x] = v;
}

template <bool RS, int N, bool EPI>
int time_one(long long tiles, int blocks, int* sink, cudaStream_t s) {
  constexpr int G = N == 128 ? 2 : 1;
  constexpr int smem = 1024 + N * 128 + 2 * G * 64 * 128;
  cudaError_t err = cudaFuncSetAttribute(
      sp_time_kernel<RS, N, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sp_time_kernel<RS, N, EPI><<<blocks, 256, smem, s>>>(tiles, sink);
  return (int)cudaGetLastError();
}

template <bool RS, int N>
int check_one(const void* a, const void* b, void* d, void* bad, cudaStream_t s) {
  sp_check_kernel<RS, N><<<1, 128, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int*>(d), static_cast<int*>(bad));
  return (int)cudaGetLastError();
}

}  // namespace

// One warpgroup's product of a 2:4 A (64 x 128 int8, row-major, device) by
// B (n x 128 int8, row-major, device) into d (64 x n int32, row-major);
// groups of A with more than two non-zeros are added to *bad. rs: A from
// registers, else from shared memory; n 128 or 256. Returns the CUDA error.
extern "C" int sp_probe_check(int device, int rs, int n, const void* a,
                              const void* b, void* d, void* bad, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 128) return rs ? check_one<true, 128>(a, b, d, bad, s) : check_one<false, 128>(a, b, d, bad, s);
  if (n == 256) return rs ? check_one<true, 256>(a, b, d, bad, s) : check_one<false, 256>(a, b, d, bad, s);
  return (int)cudaErrorInvalidValue;
}

// The consumer loop on `blocks` blocks of 2 warpgroups, `tiles` tiles each
// (2 * 128 * N * 128 logical int8 multiply-adds a tile and block); sink
// holds blocks * 256 ints. Returns the CUDA error of the launch.
extern "C" int sp_probe_time(int device, int rs, int n, int epi,
                             long long tiles, int blocks, void* sink,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* k = static_cast<int*>(sink);
  const int key = (rs ? 4 : 0) | (n == 256 ? 2 : 0) | (epi ? 1 : 0);
  if (n != 128 && n != 256) return (int)cudaErrorInvalidValue;
  switch (key) {
    case 0: return time_one<false, 128, false>(tiles, blocks, k, s);
    case 1: return time_one<false, 128, true>(tiles, blocks, k, s);
    case 2: return time_one<false, 256, false>(tiles, blocks, k, s);
    case 3: return time_one<false, 256, true>(tiles, blocks, k, s);
    case 4: return time_one<true, 128, false>(tiles, blocks, k, s);
    case 5: return time_one<true, 128, true>(tiles, blocks, k, s);
    case 6: return time_one<true, 256, false>(tiles, blocks, k, s);
    default: return time_one<true, 256, true>(tiles, blocks, k, s);
  }
}
