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
// dependent; each reads every point and ends in an argmax over the cloud.
// Counted over the whole call the bytes and operations are tiny (tens of
// microseconds at the card's rates), so the floor is steps x the latency
// of one step's update, reduction and exchange.
//
// Design (fps_resident_kernel): the cloud stays on chip. Up to 8192 points
// it is one block; up to 65536 a cluster of 8 blocks (the portable size)
// on 8 SMs, grid (8, B), one cluster a cloud. Block r holds the contiguous
// slice [r s, (r + 1) s), s = ceil(N / 8), read from global memory once:
// each thread keeps 8 points and their running distances in registers
// (the fewest threads that hold the slice), and the slice's coordinates
// sit in shared memory for the winner's lookup. One step: each thread
// updates its points and keeps its first best; two warp reductions
// (redux.sync: the largest value, then the lowest index holding it) and
// one pass through shared memory give the block's winner; warp 0 sends it
// with its coordinates to every block of the cluster through distributed
// shared memory (lane r to block r), into a slot of the step's parity; one
// cluster barrier; then every block takes the largest of the 8 keys
// (ordered value bits << 32 | ~index: the larger value, ties on the lower
// index) and so the same winner, with no global load on the dependency
// chain. The slots are double-buffered by parity, so one barrier a step
// suffices. A block alone replaces the barrier by __syncthreads. On an
// H100 SXM ("NVIDIA H100 80GB HBM3, 700.00 W",
// scripts/profile_torch_fps_attention.py) a step takes about 1.9 us at
// N = 50000 (the one-block design, which re-read the cloud from L2 at
// every step: 7.6 us) and 0.5 us at N = 2048 .. 512; at B = 8 the eight
// clusters run side by side. Point-to-point mbarrier arrivals in place of
// the cluster barrier measured no faster.
//
// Clouds of more than 65536 points (fps_scratch_kernel): one block of 1024
// threads, the running distances in a global scratch row, the
// coordinates read from global memory at every step.

#include <cooperative_groups.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                         // points in registers
constexpr int kCtaPoints = kThreads * kPerThread;     // one block's 8192
constexpr int kCluster = 8;                           // portable cluster size
constexpr int kMaxResident = kCluster * kCtaPoints;   // 65536

// How a cloud of n points is laid out: one block (n <= kCtaPoints) or a
// cluster of kCluster blocks, each holding a contiguous slice; the fewest
// threads that hold a slice at kPerThread points each.
struct FpsPlan {
  int csize, slice, threads;
};

FpsPlan fps_plan(int n) {
  const int csize = n > kCtaPoints ? kCluster : 1;
  const int slice = (n + csize - 1) / csize;
  const int per = (slice + kPerThread - 1) / kPerThread;
  return {csize, slice, std::max(32, (per + 31) / 32 * 32)};
}

// A block's candidate, sent to every block of the cluster.
struct alignas(16) Candidate {
  unsigned long long key;  // ordered(value) << 32 | (0xFFFFFFFF - index)
  float x, y, z;
};

// The float's order as an unsigned integer: a > b iff ordered(a) >
// ordered(b) (no NaN). Every score maps above 0, which marks no point.
__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads, 1)
fps_resident_kernel(const float* __restrict__ xyz, int n, int npoint,
                    int slice, int* __restrict__ out) {
  extern __shared__ float coords[];  // x, y, z of the slice: the lookups
  __shared__ unsigned int red_v[kWarps], red_i[kWarps];
  __shared__ Candidate msg[2][kCluster];  // by step parity, by sender

  const int csize = gridDim.x;  // the cluster: every block of a cloud
  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = rank * slice;
  const int count = min(slice, n - base);
  float* xs = coords;
  float* ys = xs + slice;
  float* zs = ys + slice;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * npoint;

  // the thread's points tid + k * nthreads of the slice, in registers; a
  // slot past the slice scores -inf and never wins
  float px[kPerThread], py[kPerThread], pz[kPerThread], temp[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int li = tid + k * nthreads;
    px[k] = py[k] = pz[k] = 0.f;
    temp[k] = -CUDART_INF_F;
    if (li < count) {
      const float* q = p + 3 * static_cast<size_t>(base + li);
      px[k] = q[0];
      py[k] = q[1];
      pz[k] = q[2];
      xs[li] = px[k];
      ys[li] = py[k];
      zs[li] = pz[k];
      const float mag = sqdist_rn(px[k], py[k], pz[k], 0.f, 0.f, 0.f);
      temp[k] = mag > 1e-3f ? 1e10f : -1.0f;
    }
  }
  float cx = p[0], cy = p[1], cz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster runs before the first remote store
  if (csize > 1) cluster.sync();

  for (int j = 1; j < npoint; ++j) {
    // 1. the slice's update and the thread's argmax (ascending index: the
    //    first of equal values is kept)
    float best = -CUDART_INF_F;
    int bk = -1;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float t = fminf(temp[k], sqdist_rn(px[k], py[k], pz[k], cx, cy,
                                                cz));
      temp[k] = t;
      if (t > best) {
        best = t;
        bk = k;
      }
    }
    const unsigned int v = bk >= 0 ? ordered(best) : 0u;
    const unsigned int gi = static_cast<unsigned int>(base + tid +
                                                      bk * nthreads);
    // the warp's and then the block's largest value, lowest index
    unsigned int wv = __reduce_max_sync(0xffffffffu, v);
    unsigned int wi = __reduce_min_sync(0xffffffffu, v == wv ? gi : UINT_MAX);
    if (lane == 0) {
      red_v[warp] = wv;
      red_i[warp] = wi;
    }
    __syncthreads();
    const int par = j & 1;
    if (warp == 0) {
      const bool has = lane < (nthreads >> 5);
      const unsigned int cv = has ? red_v[lane] : 0u;
      wv = __reduce_max_sync(0xffffffffu, cv);
      wi = __reduce_min_sync(0xffffffffu,
                             has && cv == wv ? red_i[lane] : UINT_MAX);
      // 2. the block's winner, with its coordinates, to every block of
      //    the cluster (lane r writes block r's slot)
      if (lane < csize) {
        const int li = static_cast<int>(wi) - base;
        Candidate c;
        c.key = (static_cast<unsigned long long>(wv) << 32) |
                (0xFFFFFFFFu - wi);
        c.x = xs[li];
        c.y = ys[li];
        c.z = zs[li];
        Candidate* dst = &msg[par][rank];
        if (csize > 1) dst = cluster.map_shared_rank(dst, lane);
        *dst = c;
      }
    }
    // 3. one barrier: the slots of parity `par` are complete; those of
    //    the other parity are free again only after the next one
    if (csize > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    // 4. the largest key of the cluster's candidates: the largest value,
    //    ties on the lowest index; every block finds the same winner
    int w = 0;
    unsigned long long key = msg[par][0].key;
    for (int r = 1; r < csize; ++r) {
      const unsigned long long kr = msg[par][r].key;
      if (kr > key) {
        key = kr;
        w = r;
      }
    }
    cx = msg[par][w].x;
    cy = msg[par][w].y;
    cz = msg[par][w].z;
    if (rank == 0 && tid == 0) {
      o[j] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key));
    }
  }
}

// Clouds of more than kMaxResident points: one block, the running
// distances in a global scratch row, the coordinates read from global
// memory (L2) at every step.
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
fps_scratch_kernel(const float* __restrict__ xyz, int n, int npoint,
                   int* __restrict__ out, float* __restrict__ scratch) {
  __shared__ float red_val[kWarps];
  __shared__ int red_idx[kWarps];
  __shared__ int s_best;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* temp = scratch + static_cast<size_t>(b) * n;
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

// The resident kernel's launch configuration for n points: a cluster of
// plan.csize blocks (none when 1) and the slice's coordinates as dynamic
// shared memory, raised once per device to the largest slice's.
cudaError_t resident_config(int device, int n, int batch, cudaStream_t st,
                            cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
  constexpr size_t kMaxSmem = 3 * sizeof(float) * kCtaPoints;
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  const bool known = device >= 0 && device < kDevices;
  if (!known || !smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    if (known) smem_set[device] = true;
  }
  const FpsPlan plan = fps_plan(n);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(plan.csize, batch);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = 3 * sizeof(float) * plan.slice;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = plan.csize > 1 ? 1 : 0;
  return cudaSuccess;
}

}  // namespace

// xyz: (B, N, 3) f32 contiguous; out: (B, npoint) int32; scratch: (B, N)
// f32 when N > fps_max_resident_points(), else null.
extern "C" int fps_launch(int device, const float* xyz, int batch, int n,
                          int npoint, int* out, float* scratch,
                          void* stream) {
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kMaxResident) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_scratch_kernel<<<batch, kThreads, 0, st>>>(xyz, n, npoint, out,
                                                   scratch);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(device, n, batch, st, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fps_resident_kernel, xyz, n, npoint,
                           fps_plan(n).slice, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fps_max_resident_points() { return kMaxResident; }

// The blocks a cloud of n points takes: 1, or a cluster of kCluster.
extern "C" int fps_cluster_size(int n) {
  return n > kMaxResident ? 1 : fps_plan(n).csize;
}

// How many of the clusters (or blocks) that a cloud of n points takes can
// be resident on the device at once (cudaOccupancyMaxActiveClusters); a
// batch of more clouds runs in waves. Negative: the CUDA error.
extern "C" int fps_max_active_clusters(int device, int n) {
  if (n > kMaxResident) return -static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope on(device);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = resident_config(device, n, 1, nullptr, cfg, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int clusters = 0;
  if (cfg.numAttrs == 0) {  // no cluster: resident blocks
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fps_resident_kernel, cfg.blockDim.x, cfg.dynamicSmemBytes);
    int sms = 0;
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    clusters = per_sm * sms;
  } else {
    err = cudaOccupancyMaxActiveClusters(&clusters, fps_resident_kernel,
                                         &cfg);
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

BUTD_PACKED(fps_launch)
BUTD_ERROR_STRING(fps)
