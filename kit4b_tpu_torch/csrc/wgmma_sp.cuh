// 2:4-sparse int8 warpgroup products for Hopper (sm_90a), shared by the
// max-match kernel (minmm.cu) and its probe (sp_probe.cu).
//
// `wgmma.mma_async.sp ... m64nNk64.s32.s8.s8` multiplies a 64 x 64 int8 A
// tile that holds at most two non-zeros in every aligned group of 4
// channels by a dense N x 64 B tile from shared memory, at twice the dense
// instruction's rate. A is given compressed: the two kept values of each
// group (64 x 32 bytes, from registers or from shared memory through a
// descriptor) and 4 bits of metadata a group, the two kept indices, lower
// first, one 32-bit register a thread:
//   metadata register of lane l of warp w: row 16w + (l >> 2) + 8(l & 1)
//   of the m64 tile, channels 32((l >> 1) & 1) + [0, 32), the group of
//   channels 4j .. 4j + 3 of that range in bits 4j .. 4j + 3;
//   value register i (A from registers): row 16w + (l >> 2) + 8(i & 1),
//   compressed bytes 4(l & 3) + 16(i >> 1) + [0, 4), i.e. channels
//   8(l & 3) + 32(i >> 1) + [0, 8);
// (CUTLASS's SM90 sparse GMMA traits, ELayout_64x64 and ALayout_64x64).
// Operands in shared memory are K-major in the 128-byte swizzle: a row of
// 128 bytes, its 16-byte unit u stored at unit u ^ (row & 7), 8-row groups
// 1024 bytes apart.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, byte) in a 128-byte-swizzled K-major tile
__device__ __forceinline__ int sw128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// wgmma descriptor of a K-major operand in 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), layout type 1. A k-step inside
// the atom moves the start address; the atom is 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
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
// orders this thread's generic stores to shared memory before later reads
// of the async proxy (wgmma's descriptors)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Pins the accumulators so that no read of them moves across a wgmma fence
// or wait.
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// The 2:4 form of one group of 4 int8 channels, channel j in byte j of w:
// bits 0-15 the two kept values (the lower index's first), bits 16-19 the
// metadata nibble (the lower index in bits 16-17). The indices are distinct
// and ascending: the non-zeros' own, filled from 0 (then 1) where the group
// holds fewer than two. A group with more than two non-zeros adds one to
// `bad` and keeps its first two.
__device__ __forceinline__ uint32_t sp_group(uint32_t w, int& bad) {
  uint32_t t = __vcmpne4(w, 0u) & 0x08040201u;
  uint32_t m = (t | t >> 8 | t >> 16 | t >> 24) & 0xFu;
  const int n = __popc(m);
  if (n > 2) {
    ++bad;
    const uint32_t lo = m & (0u - m);
    const uint32_t rest = m ^ lo;
    m = lo | (rest & (0u - rest));
  } else if (n < 2) {
    m |= 1u;
    if (m == 1u) m |= 2u;
  }
  const uint32_t i0 = __ffs(m) - 1, i1 = 31 - __clz(m);
  return (__byte_perm(w, 0u, i0 | i1 << 4) & 0xFFFFu) | (i0 | i1 << 2) << 16;
}

// Metadata of 32 channels, bytes [byte0, byte0 + 32) of `row` of a
// swizzled tile (byte0 a multiple of 32): 8 nibbles.
__device__ __forceinline__ uint32_t sp_meta(const uint8_t* tile, int row,
                                            int byte0, int& bad) {
  uint32_t e = 0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint4 q = *reinterpret_cast<const uint4*>(tile + sw128(row, byte0 + 16 * u));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) e |= (sp_group(w[j], bad) >> 16) << (4 * (4 * u + j));
  }
  return e;
}

// Kept values of 8 channels (two groups), bytes [byte0, byte0 + 8) of `row`
// of a swizzled tile (byte0 a multiple of 8): 4 compressed bytes.
__device__ __forceinline__ uint32_t sp_vals(const uint8_t* tile, int row,
                                            int byte0) {
  const uint2 q = *reinterpret_cast<const uint2*>(tile + sw128(row, byte0));
  int unused = 0;
  return (sp_group(q.x, unused) & 0xFFFFu) | sp_group(q.y, unused) << 16;
}

#define D8(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
    "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define D64(d) D8(d, 0), D8(d, 8), D8(d, 16), D8(d, 24), D8(d, 32), D8(d, 40), \
    D8(d, 48), D8(d, 56)
#define D128(d) D64(d), D8(d, 64), D8(d, 72), D8(d, 80), D8(d, 88), D8(d, 96), \
    D8(d, 104), D8(d, 112), D8(d, 120)

// d (64 x N s32) = A (64 x 64 s8, 2:4: values a, metadata e) * b (N x 64 s8)^T
//                  + (accumulate ? d : 0); N = 2 * the accumulators
__device__ __forceinline__ void wgmma_sp_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          uint32_t e, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n128k64.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, %69, 0, p;\n}\n"
      : D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(e), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_sp_ss(int (&d)[64], uint64_t a, uint64_t b,
                                          uint32_t e, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n128k64.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, %66, 0, p;\n}\n"
      : D64(d)
      : "l"(a), "l"(b), "r"(e), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_sp_rs(int (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                          uint32_t e, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n256k64.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, %133, 0, p;\n}\n"
      : D128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(e), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_sp_ss(int (&d)[128], uint64_t a, uint64_t b,
                                          uint32_t e, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sp.sync.aligned.m64n256k64.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, %130, 0, p;\n}\n"
      : D128(d)
      : "l"(a), "l"(b), "r"(e), "r"(accumulate));
}
#undef D8
#undef D64
#undef D128
