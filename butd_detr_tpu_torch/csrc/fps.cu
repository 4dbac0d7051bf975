// Furthest-point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_fps.py:_fps_kernel
// (through furthest_point_sample_pallas). Semantics are the reference's
// (pointnet2 sampling_gpu.cu, kept by ops/pointcloud.py:
// furthest_point_sample_xla), bit for bit:
//   * index 0 is selected first; the running distance starts at 1e10;
//   * a point with |p|^2 <= 1e-3 is never chosen: its running distance is
//     set to -1 once, and min(temp, d) with d >= 0 keeps it there, so it
//     wins only when no point is valid (then every score ties at -1 and
//     the lowest index, 0, is returned);
//   * the distance is (dx^2 + dy^2) + dz^2 without FMA (common.cuh);
//   * argmax ties go to the lower index.
//
// What bounds it on this card: the npoint - 1 steps are serially
// dependent; each reads every point and ends in a block-wide argmax (two
// barriers and a shuffle tree). Counted over the whole call the bytes and
// operations are tiny (tens of microseconds at the card's rates), so the
// floor is steps x per-step latency. This design pays more: the 50k-point
// cloud (600 KB) does not fit one SM, so every step re-reads it from L2 at
// one SM's L2 rate: on an H100 SXM (chip_smoke.py) about 7.6 us per step
// at N = 50000, against about 1 us at N = 2048 and 0.8 us at N = 512,
// where the per-step latency floor shows. A later design keeps the cloud in the distributed shared
// memory of a thread-block cluster.
//
// Design: one block of 1024 threads per cloud. Each thread owns points
// tid, tid + 1024, ... and their running distances, which live in
// dynamic shared memory (N <= kMaxSmemPoints, i.e. every tier of the
// 50k-point model) or in a global scratch row otherwise. Per step a
// thread updates its points and keeps its own (value, index) best; a warp
// shuffle argmax and one pass through shared memory reduce the block; the
// winner's coordinates are a broadcast load.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemPoints = 55000;  // 220,000 bytes of dynamic smem

__device__ __forceinline__ void argmax_merge(float& best, int& besti,
                                             float ov, int oi) {
  if (ov > best || (ov == best && oi < besti)) {
    best = ov;
    besti = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& best, int& besti) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, besti, off);
    argmax_merge(best, besti, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint,
           int* __restrict__ out, float* __restrict__ scratch,
           int use_smem) {
  extern __shared__ float smem_temp[];
  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_best;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* temp = use_smem ? smem_temp : scratch + static_cast<size_t>(b) * n;
  int* o = out + static_cast<size_t>(b) * npoint;

  for (int i = tid; i < n; i += kThreads) {
    const float mag = sqdist_rn(p[3 * i], p[3 * i + 1], p[3 * i + 2],
                                0.f, 0.f, 0.f);
    temp[i] = mag > 1e-3f ? 1e10f : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  int old = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float cx = p[3 * old], cy = p[3 * old + 1], cz = p[3 * old + 2];
    float best = -2.0f;
    int besti = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float d = sqdist_rn(p[3 * i], p[3 * i + 1], p[3 * i + 2],
                                cx, cy, cz);
      const float t = fminf(temp[i], d);
      temp[i] = t;
      if (t > best) {  // i ascends: the first of equal values is kept
        best = t;
        besti = i;
      }
    }
    warp_argmax(best, besti);
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = red_val[lane];
      besti = red_idx[lane];
      warp_argmax(best, besti);
      if (lane == 0) {
        s_best = besti;
        o[j] = besti;
      }
    }
    __syncthreads();
    old = s_best;
  }
}

}  // namespace

extern "C" int fps_launch(const float* xyz, int batch, int n, int npoint,
                          int* out, float* scratch, void* stream) {
  const int use_smem = n <= kMaxSmemPoints;
  const size_t smem = use_smem ? static_cast<size_t>(n) * sizeof(float) : 0;
  if (use_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, n, npoint, out, scratch, use_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fps_max_smem_points() { return kMaxSmemPoints; }

BUTD_ERROR_STRING(fps)
