// Row scatter-add for Hopper (sm_90a):
//   out[b, j, :] = sum over m with idx[b, m] == j of g[b, m, :]
// with an f32 accumulator; entries with idx >= n (or < 0) are dropped.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_scatter.py:
// scatter_rows_add_pallas, the backward of the row gathers (gather_points,
// group_points, group_points_split, three_interpolate). The TPU builds a
// one-hot tile and multiplies on the MXU, with a 3-way bf16 split of f32
// rows, because it has no scatter; neither is carried over. The card has
// atomics in L2, so there is also no limit on n.
//
// What bounds it on this card: the bytes (g read once, out written once);
// M * C additions are far below the f32 rate. This kernel is bound by the
// atomic throughput of L2 where many rows hit one output row (a ball
// query's neighbours share centres), else by the read of g.
//
// Design: one thread per (row m, group of 4 channels). It loads 4 channels
// (16 bytes of f32 or 8 bytes of bf16, widened), and adds them to the
// zeroed out row with one vector atomic (red.global.add.v4.f32) where
// C % 4 == 0, else with scalar atomics per channel. The order of the
// atomic additions is not fixed, so the f32 sums may differ in their last
// bits from run to run.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void add4(float* dst, float a, float b, float c,
                                     float d) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
#else
  atomicAdd(dst + 0, a);
  atomicAdd(dst + 1, b);
  atomicAdd(dst + 2, c);
  atomicAdd(dst + 3, d);
#endif
}

// C % 4 == 0: a thread per (row, 4 channels)
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add_vec4_kernel(const T* __restrict__ g,
                             const int* __restrict__ idx,
                             float* __restrict__ out, long long rows, int m,
                             int c, int n) {
  const int groups = c >> 2;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * groups) return;
  const long long row = t / groups;  // b * m + i
  const int ch = static_cast<int>(t % groups) << 2;
  const int j = idx[row];
  if (j < 0 || j >= n) return;
  const long long b = row / m;
  const T* src = g + row * c + ch;
  float* dst = out + (b * n + j) * c + ch;
  add4(dst, widen(src[0]), widen(src[1]), widen(src[2]), widen(src[3]));
}

// any C: a thread per (row, channel)
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_add_scalar_kernel(const T* __restrict__ g,
                               const int* __restrict__ idx,
                               float* __restrict__ out, long long rows, int m,
                               int c, int n) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows * c) return;
  const long long row = t / c;
  const int ch = static_cast<int>(t % c);
  const int j = idx[row];
  if (j < 0 || j >= n) return;
  const long long b = row / m;
  atomicAdd(out + (b * n + j) * c + ch, widen(g[row * c + ch]));
}

template <typename T>
int launch(const T* g, const int* idx, float* out, int batch, int m, int c,
           int n, cudaStream_t st) {
  const long long rows = static_cast<long long>(batch) * m;
  if (rows == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (c % 4 == 0) {
    const long long threads = rows * (c >> 2);
    const unsigned int blocks =
        static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
    scatter_rows_add_vec4_kernel<T>
        <<<blocks, kThreads, 0, st>>>(g, idx, out, rows, m, c, n);
  } else {
    const long long threads = rows * c;
    const unsigned int blocks =
        static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
    scatter_rows_add_scalar_kernel<T>
        <<<blocks, kThreads, 0, st>>>(g, idx, out, rows, m, c, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (batch, m, c) contiguous, f32 (is_bf16 == 0) or bf16; idx: (batch, m)
// int32; out: (batch, n, c) f32, zeroed by the caller.
extern "C" int scatter_launch(const void* g, const int* idx, float* out,
                              int batch, int m, int c, int n, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(g), idx, out, batch, m, c,
                  n, st);
  }
  return launch(static_cast<const float*>(g), idx, out, batch, m, c, n, st);
}

BUTD_ERROR_STRING(scatter)
