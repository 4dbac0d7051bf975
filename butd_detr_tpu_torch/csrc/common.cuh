// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>

// Squared distance accumulated as (dx^2 + dy^2) + dz^2 with every product
// and sum rounded on its own (no fused multiply-add). This is the order of
// the JAX reference (ops/pointcloud.py and the Pallas kernels); nvcc would
// otherwise contract a*a + b*b into an FMA, and then FPS and ball-query
// indices drift from the reference on near-ties.
__device__ __forceinline__ float sqdist_rn(float ax, float ay, float az,
                                           float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3"): a counter-based generator, so any thread can draw the bits of
// any position without state. ops/attention.py:philox4x32 is the same
// function in PyTorch integer arithmetic.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr unsigned int kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned int kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned int hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const unsigned int hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// The random bits of attention dropout for the four keys 4 g .. 4 g + 3 of
// query row `row` in (batch * heads + head) slice `bh`. The counter is the
// ABSOLUTE position, so the forward kernel, both backward kernels and the
// mask writer draw the same bits whatever their tiling. A probability is
// kept iff its bits >= the threshold min(int(p * 2^32), 2^32 - 1).
__device__ __forceinline__ uint4 dropout_bits(unsigned long long seed, int bh,
                                              int row, int g) {
  return philox4x32_10(
      make_uint4(static_cast<unsigned int>(g), static_cast<unsigned int>(row),
                 static_cast<unsigned int>(bh), 0u),
      make_uint2(static_cast<unsigned int>(seed),
                 static_cast<unsigned int>(seed >> 32)));
}

// Copy unit `k` of a row, or write zeros when the row has no source
// (`src_row == nullptr`). A unit is 16, 4 or 2 bytes; the wrapper picks the
// largest that divides the row's bytes and the three base pointers, so every
// access is aligned. The copy moves bits, never values: -0.0, NaN payloads
// and denormals arrive unchanged whatever the element type.
__device__ __forceinline__ void copy_row_unit(void* dst_row,
                                              const void* src_row, int unit,
                                              unsigned int k) {
  if (unit == 16) {
    const uint4 v = src_row ? __ldg(static_cast<const uint4*>(src_row) + k)
                            : make_uint4(0u, 0u, 0u, 0u);
    static_cast<uint4*>(dst_row)[k] = v;
  } else if (unit == 4) {
    const unsigned int v =
        src_row ? __ldg(static_cast<const unsigned int*>(src_row) + k) : 0u;
    static_cast<unsigned int*>(dst_row)[k] = v;
  } else {
    const unsigned short v =
        src_row ? __ldg(static_cast<const unsigned short*>(src_row) + k)
                : static_cast<unsigned short>(0);
    static_cast<unsigned short*>(dst_row)[k] = v;
  }
}

#define BUTD_ERROR_STRING(prefix)                                 \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
