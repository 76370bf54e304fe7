// Table gather of the gather profiler, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_take` of
// tools/archive/profile_pallas_gather.py (launched by `pallas_take`), which
// held the table in VMEM and ran jnp.take(table, idx, axis=0):
//
//   out[k] = table[idx[k]]          for 0 <= idx[k] < n_table
//   out[k] = table[idx[k] + n_table] for -n_table <= idx[k] < 0
//   out[k] = INT32_MIN              otherwise (jnp.take's fill for int32)
//
// What bounds it: bytes on paper (each index costs 4 bytes read, 4 written
// and 4 of the table; 5.2 MB in all at the profiler's shape of 524,288
// indices into a 1 MB table, 1.6 us at the card's memory rate), but the
// table reads are random 4-byte reads, each of which moves a 32-byte sector
// out of L2: 16.8 MB of sectors for 2 MB of data. That rate of random
// sector reads, not bytes and not latency, sets the time: on an H100 this
// kernel and the one-index-a-thread kernel it replaced both take 5.4 us,
// and variants with two or eight reads in flight a thread or other block
// sizes took as long or longer (tools/profile_gather.py measures the device
// time and how it grows with the number of indices and the table's size).
//
// Design. A thread takes four consecutive indices as one 16-byte load,
// resolves wrap and range for each, starts its four table reads through the
// read-only path (__ldg) before it uses any of them, and writes one 16-byte
// store (__stcs: the output is written once and not read here; written as
// an intrinsic because a plain int4 assignment was split into four 4-byte
// stores 16 bytes apart, which was slower). One thread for every four
// indices, no loop. A thread whose four lie partly past n, and every thread
// of a launch whose `idx` or `out` is not 16-byte aligned (a view such as
// idx[1:]), gathers its indices one by one.
//
// Holding the table in a cluster's distributed shared memory, as the TPU
// held it in VMEM, does not pay here: 16 clusters of 8 blocks would each
// copy the whole 1 MB table out of L2 (16 MB of L2 reads) to serve 2 MB of
// random reads, as much as the sectors cost now.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // indices per thread: 16 bytes

__device__ __forceinline__ int32_t take1(const int32_t* __restrict__ table,
                                         long long n_table, int32_t idx) {
  long long i = idx;
  if (i < 0) i += n_table;
  return (i >= 0 && i < n_table) ? __ldg(table + i) : INT32_MIN;
}

// `aligned`: idx and out are both 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
take_kernel(const int32_t* __restrict__ table, long long n_table,
            const int32_t* __restrict__ idx, int32_t* __restrict__ out,
            long long n, bool aligned) {
  const long long k = kVec * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (aligned && k + kVec <= n) {
    const int4 ix = __ldg(reinterpret_cast<const int4*>(idx + k));
    int4 r;
    r.x = take1(table, n_table, ix.x);
    r.y = take1(table, n_table, ix.y);
    r.z = take1(table, n_table, ix.z);
    r.w = take1(table, n_table, ix.w);
    __stcs(reinterpret_cast<int4*>(out + k), r);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (k + j < n) out[k + j] = take1(table, n_table, idx[k + j]);
}

}  // namespace

// Launches the kernel on `stream` of `device`: n int32 indices into an int32
// table of n_table entries, all pointers device pointers aligned to 4 bytes
// (the Python wrapper checks). Returns the CUDA error of the launch, 0 on
// success.
extern "C" int take_launch(int device, const void* table, long long n_table,
                           const void* idx, void* out, long long n,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long per_block = (long long)kVec * kThreads;
  take_kernel<<<(unsigned)((n + per_block - 1) / per_block), kThreads, 0,
                (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(table), n_table,
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), n, aligned);
  return (int)cudaGetLastError();
}
