// Ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_ball_query.py:
// _ball_select_kernel (through ball_query_select_pallas, which the XLA
// prep _ball_query_pruned_pallas feeds). Semantics are the reference's
// (pointnet2 ball_query_gpu.cu, kept by ops/pointcloud.py:_ball_query_scan)
// bit for bit: for each center, the first `nsample` candidates in index
// order with d^2 < r^2; a short row is padded with its first hit; a row
// with no hit is all 0. d^2 is (dx^2 + dy^2) + dz^2 without FMA
// (common.cuh), and r2 arrives as the float32 of the host's double
// radius * radius, the value the reference compares against.
//
// The TPU kernel's Hilbert pruning, butterfly compaction and bitonic merge
// exist because a TPU core has no cheap scatter and no data-dependent
// exit; none of them is ported.
//
// What bounds it on this card: reading candidate coordinates. A center
// stops as soon as it has `nsample` hits, so the bytes a center reads
// depend on where its hits fall in index order; in the worst case (fewer
// than nsample neighbours) it reads all N x 12 bytes, from L2 since every
// center of a cloud shares them.
//
// Design: one warp per center. The warp scans 32 candidates at a time in
// index order; __ballot_sync gives the hit mask, __popc of the lanes below
// gives each hit its slot, and the warp leaves the scan once `nsample`
// hits are placed.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int batch, int n, int m,
                  int nsample, float r2, int* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= batch * m) return;  // warp-uniform
  const int b = row / m;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const float cx = centers[3 * static_cast<size_t>(row)];
  const float cy = centers[3 * static_cast<size_t>(row) + 1];
  const float cz = centers[3 * static_cast<size_t>(row) + 2];
  int* o = out + static_cast<size_t>(row) * nsample;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < n && cnt < nsample; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < n) {
      hit = sqdist_rn(cx, cy, cz, p[3 * i], p[3 * i + 1], p[3 * i + 2]) < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask) {
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int slot = cnt + __popc(mask & ((1u << lane) - 1u));
      if (hit && slot < nsample) o[slot] = i;
      cnt += __popc(mask);
    }
  }
  if (cnt > nsample) cnt = nsample;
  for (int s = cnt + lane; s < nsample; s += 32) o[s] = first;
}

}  // namespace

extern "C" int ball_query_launch(const float* xyz, const float* centers,
                                 int batch, int n, int m, int nsample,
                                 float r2, int* out, void* stream) {
  const int rows = batch * m;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        xyz, centers, batch, n, m, nsample, r2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

BUTD_ERROR_STRING(ball_query)
