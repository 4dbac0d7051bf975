// Helpers of the tile kernels (the row gather, the grouped gather, the
// assignment's staging): a division by a runtime constant, cp.async into
// shared memory, and the TMA bulk store from shared memory to device
// memory (cp.async.bulk, Hopper), with the fences and waits they need.
#pragma once

#include <cuda_runtime.h>

// x / d for x < 2^31 as one multiply-high, an add and a shift (Granlund and
// Montgomery's round-up method): mul = floor(2^32 (2^shift - d) / d) + 1
// with shift = ceil(log2 d).
struct FastDiv {
  unsigned int mul;
  unsigned int shift;
};

inline FastDiv make_fastdiv(unsigned int d) {
  unsigned int shift = 0;
  while ((1ull << shift) < d) ++shift;
  const unsigned long long mul =
      ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return FastDiv{static_cast<unsigned int>(mul), shift};
}

__device__ __forceinline__ unsigned int fdiv(unsigned int x, FastDiv f) {
  return (__umulhi(x, f.mul) + x) >> f.shift;
}

__device__ __forceinline__ unsigned int smem_u32addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// cp.async of kBytes (4, 8 or 16); with valid == false nothing is read and
// the destination is zero-filled (src-size 0).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32addr(dst)),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_none() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc,
                                           unsigned int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gdst),
      "r"(smem_u32addr(ssrc)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every store committed has read shared memory.
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The stores committed before the most recent one have read shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the TMA unit.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
