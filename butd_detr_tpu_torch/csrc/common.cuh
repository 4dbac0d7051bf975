// Shared device helpers for the point-cloud kernels.
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

#define BUTD_ERROR_STRING(prefix)                                  \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
