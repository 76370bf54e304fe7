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
// What bounds it: memory latency of the random table reads. Each index costs
// 4 bytes read, 4 written and one random 4-byte table read; the profiler's
// 1 MB table sits in the 50 MB L2, so the table reads stay on chip after
// their first touch.
//
// Design. One thread per index, a coalesced index load and output store,
// and the table read through the read-only path (__ldg). Holding the table
// in a cluster's distributed shared memory, as the TPU held it in VMEM, is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
take_kernel(const int32_t* __restrict__ table, long long n_table,
            const int32_t* __restrict__ idx, int32_t* __restrict__ out,
            long long n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  long long i = idx[k];
  if (i < 0) i += n_table;
  out[k] = (i >= 0 && i < n_table) ? __ldg(table + i) : INT32_MIN;
}

}  // namespace

// Launches the kernel on `stream` of `device`: n int32 indices into an int32
// table of n_table entries, all pointers device pointers (the Python wrapper
// checks). Returns the CUDA error of the launch, 0 on success.
extern "C" int take_launch(int device, const void* table, long long n_table,
                           const void* idx, void* out, long long n,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  take_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(table), n_table,
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
