// Row scatter-add for Hopper (sm_90a), reproducible bit for bit:
//   out[b, j, :] = sum over m with idx[b, m] == j of g[b, m, :]
// accumulated in f32 in ascending m; entries with idx >= n or idx < 0 are
// dropped.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_scatter.py:
// scatter_rows_add_pallas, the backward of the row gathers (gather_points,
// group_points, group_points_split, three_interpolate). The TPU builds a
// one-hot tile and multiplies on the MXU, with a 3-way bf16 split of f32
// rows, because it has no scatter; neither is carried over.
//
// What bounds it on this card: the bytes (g and idx read once, out
// written once); M * C additions are far below the f32 rate.
//
// Design: the inverse map is built on the device, then each output row is
// reduced in a fixed order, so that no float atomic decides an order:
//   1. CSR (one block a batch element): rows per j with integer atomics
//      (exact; in shared memory where n fits, else in the scratch), their
//      exclusive scan in place, then each row m takes a place in its
//      segment with an integer atomic on the segment's start: a CSR of
//      source rows whose order inside a segment is not fixed;
//   2. reduce: one warp per output row. A segment of up to kSortCap rows
//      is sorted (in registers up to 32, by ranks in shared memory up to
//      kSortCap), and the warp adds its rows in
//      ascending m, each lane carrying 4 channels (or 1 where C % 4 != 0):
//      the order of a sequential index_add_ on the CPU, so the sums are
//      that of the plain version run on the CPU, bit for bit. A longer
//      segment (many rows on one index) walks the batch element's index
//      in order, 32 entries a ballot, and adds the matching rows in the
//      same ascending order. Every output row is written, an empty one as
//      0, so the output needs no zeroing.
// The index is read in the caller's type, int32 or int64 (instantiated for
// both), so no cast runs before it. The two kernels are enqueued by one C
// call; the scratch (segment ends, the CSR) is one caller-allocated buffer
// sized by (B, M, n).

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCountThreads = 1024;
constexpr int kSharedCounts = 12000;  // n counted in shared memory (47 KB)
constexpr int kWarps = 8;             // reduce: warps (output rows) a block
constexpr int kSortCap = 256;         // longest segment sorted in shared
constexpr int kAhead = 8;             // rows loaded ahead of their sums
constexpr int kBatchLoads = 8;        // CSR: indices a thread loads at once
constexpr int kUnitsPerLane = 2;      // reduce: channel units a lane sums

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One unit of 4 channels as loaded (16 bytes of f32, 8 of bf16) and
// widened to f32.
template <typename T>
struct Unit4;
template <>
struct Unit4<float> {
  using type = float4;
};
template <>
struct Unit4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 widen4(const float4 v) { return v; }
__device__ __forceinline__ float4 widen4(const uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// acc[q] += unit u + 32 q (those below `units`) of the rows list[0, len)
// of g, in that order; kAhead rows' loads are in flight before their
// additions, which stay in order.
template <typename T>
__device__ __forceinline__ void add_rows4(float4 (&acc)[kUnitsPerLane],
                                          const T* g, int c, int u,
                                          int units, const int* list,
                                          int len) {
  using U = typename Unit4<T>::type;
  const U* at = reinterpret_cast<const U*>(g) + u;
  const size_t stride = static_cast<size_t>(c) / 4;
  bool in[kUnitsPerLane];
#pragma unroll
  for (int q = 0; q < kUnitsPerLane; ++q) in[q] = u + 32 * q < units;
  int r = 0;
  for (; r + kAhead <= len; r += kAhead) {
    U v[kAhead][kUnitsPerLane];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const U* row = at + list[r + k] * stride;
#pragma unroll
      for (int q = 0; q < kUnitsPerLane; ++q) {
        if (in[q]) v[k][q] = row[32 * q];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
#pragma unroll
      for (int q = 0; q < kUnitsPerLane; ++q) {
        if (in[q]) add4(acc[q], widen4(v[k][q]));
      }
    }
  }
  for (; r < len; ++r) {
    const U* row = at + list[r] * stride;
#pragma unroll
    for (int q = 0; q < kUnitsPerLane; ++q) {
      if (in[q]) add4(acc[q], widen4(row[32 * q]));
    }
  }
}

// acc += channel u of the rows list[0, len) of g, in that order.
template <typename T>
__device__ __forceinline__ void add_rows1(float& acc, const T* g, int c,
                                          int u, const int* list, int len) {
#pragma unroll 4
  for (int r = 0; r < len; ++r) {
    acc += widen(g[static_cast<size_t>(list[r]) * c + u]);
  }
}

// grid (batch), one block a batch element: the CSR of its rows. The
// counts of the rows per j (integer atomics), their exclusive scan in
// place (the segment starts), then each row takes a place in its segment
// with an atomic on the segment's start, so that afterwards ends[j] is
// segment j's end (and j's start is ends[j - 1], or 0). kShared: the
// counters live in shared memory (n <= kSharedCounts) and are copied out
// at the end; else they live in `ends`.
template <typename Index, bool kShared>
__global__ void __launch_bounds__(kCountThreads)
scatter_rows_add_csr_kernel(const Index* __restrict__ idx, int m, int n,
                            int* __restrict__ ends, int* __restrict__ rows) {
  __shared__ int shared_ends[kShared ? kSharedCounts : 1];
  __shared__ int warp_sums[kCountThreads / 32];
  const size_t b = blockIdx.x;
  int* e = kShared ? shared_ends : ends + b * n;
  for (int j = threadIdx.x; j < n; j += kCountThreads) e[j] = 0;
  __syncthreads();
  const Index* ib = idx + b * m;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // kBatchLoads indices in registers before their atomics: the compiler
  // does not move a load past an atomic, so a loop of load-then-add would
  // wait for every load in turn
  constexpr int kStride = kCountThreads * kBatchLoads;
  for (int i0 = threadIdx.x; i0 < m; i0 += kStride) {
    long long j[kBatchLoads];
#pragma unroll
    for (int k = 0; k < kBatchLoads; ++k) {
      const int i = i0 + k * kCountThreads;
      j[k] = i < m ? static_cast<long long>(ib[i]) : -1;
    }
#pragma unroll
    for (int k = 0; k < kBatchLoads; ++k) {
      if (j[k] >= 0 && j[k] < n) atomicAdd(e + j[k], 1);
    }
  }
  __syncthreads();
  // exclusive scan in place: a contiguous chunk a thread
  const int per = (n + kCountThreads - 1) / kCountThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += e[j];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  int start = incl - sum;
  for (int k = 0; k < w; ++k) start += warp_sums[k];
  for (int j = lo; j < hi; ++j) {
    const int v = e[j];
    e[j] = start;
    start += v;
  }
  __syncthreads();
  int* out_rows = rows + b * m;
  for (int i0 = threadIdx.x; i0 < m; i0 += kStride) {
    long long j[kBatchLoads];
#pragma unroll
    for (int k = 0; k < kBatchLoads; ++k) {
      const int i = i0 + k * kCountThreads;
      j[k] = i < m ? static_cast<long long>(ib[i]) : -1;
    }
#pragma unroll
    for (int k = 0; k < kBatchLoads; ++k) {
      if (j[k] >= 0 && j[k] < n) {
        out_rows[atomicAdd(e + j[k], 1)] = i0 + k * kCountThreads;
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kCountThreads) {
      ends[b * n + j] = e[j];
    }
  }
}

// Ascending bitonic sort of the warp's 32 values, one a lane.
__device__ __forceinline__ int warp_sort32(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(0xffffffffu, v, j);
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      v = keep_min ? min(v, other) : max(v, other);
    }
  }
  return v;
}

// One warp per output row (b, j), `units` channel units of `width` (4 or
// 1) channels each. Its segment's rows in ascending m go to list[w]: up
// to 32 sorted in registers, up to kSortCap ranked in shared memory; a
// longer
// segment is gathered kSortCap rows of the batch element at a time from
// the index itself, in order.
template <typename T, typename Index>
__global__ void __launch_bounds__(kWarps * 32)
scatter_rows_add_reduce_kernel(const T* __restrict__ g,
                               const Index* __restrict__ idx,
                               const int* __restrict__ ends,
                               const int* __restrict__ rows,
                               float* __restrict__ out, int batch, int m,
                               int c, int n, int width) {
  __shared__ int lists[kWarps][kSortCap];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // output rows j-major (all batch elements' row 0 first): the long
  // segments, low indices that head many rows, start in the first wave
  const long long at = static_cast<long long>(blockIdx.x) * kWarps + w;
  if (at >= static_cast<long long>(batch) * n) return;  // warp-uniform
  int* list = lists[w];
  const int j = static_cast<int>(at / batch);
  const long long b = at - static_cast<long long>(j) * batch;
  const long long row = b * n + j;
  const int begin = j > 0 ? ends[row - 1] : 0;
  const int len = ends[row] - begin;
  const T* gb = g + b * m * c;
  float* o = out + row * c;
  const int units = c / width;
  const int* seg = rows + b * m + begin;

  if (len <= 32) {
    list[lane] = warp_sort32(lane < len ? seg[lane] : INT_MAX, lane);
  } else if (len <= kSortCap) {  // ranks by counting: the m are distinct
    int v[kSortCap / 32], rank[kSortCap / 32];
#pragma unroll
    for (int q = 0; q < kSortCap / 32; ++q) {
      const int s = lane + 32 * q;
      v[q] = s < len ? seg[s] : INT_MAX;
      list[s] = v[q];
      rank[q] = 0;
    }
    __syncwarp();
    for (int r = 0; r < len; ++r) {
      const int x = list[r];
#pragma unroll
      for (int q = 0; q < kSortCap / 32; ++q) rank[q] += x < v[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kSortCap / 32; ++q) {
      if (lane + 32 * q < len) list[rank[q]] = v[q];
    }
  }
  __syncwarp();
  const Index* ib = idx + b * m;
  const int per_pass = width == 4 ? 32 * kUnitsPerLane : 32;
  for (int u0 = 0; u0 < units; u0 += per_pass) {
    const int u = u0 + lane;
    float4 acc4[kUnitsPerLane];
#pragma unroll
    for (int q = 0; q < kUnitsPerLane; ++q) {
      acc4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc1 = 0.f;
    for (int base = 0; base < (len <= kSortCap ? 1 : m); base += kSortCap) {
      int cnt = len;
      if (len > kSortCap) {  // the next kSortCap rows of the index, in order
        cnt = 0;
#pragma unroll
        for (int k = 0; k < kSortCap; k += 32) {
          const int i = base + k + lane;
          const bool hit = i < m && ib[i] == j;
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (hit) list[cnt + __popc(mask & ((1u << lane) - 1u))] = i;
          cnt += __popc(mask);
        }
        __syncwarp();
      }
      if (width == 4) {
        add_rows4(acc4, gb, c, u, units, list, cnt);
      } else if (u < units) {
        add_rows1(acc1, gb, c, u, list, cnt);
      }
      __syncwarp();
    }
    if (width == 4) {
#pragma unroll
      for (int q = 0; q < kUnitsPerLane; ++q) {
        if (u + 32 * q < units) {
          *reinterpret_cast<float4*>(o + 4 * (u + 32 * q)) = acc4[q];
        }
      }
    } else if (u < units) {
      o[u] = acc1;
    }
  }
}

template <typename T, typename Index>
int launch(const T* g, const Index* idx, void* scratch, float* out,
           int batch, int m, int c, int n, cudaStream_t st) {
  int* ends = static_cast<int*>(scratch);
  int* rows = ends + static_cast<size_t>(batch) * n;
  if (n <= kSharedCounts) {
    scatter_rows_add_csr_kernel<Index, true>
        <<<batch, kCountThreads, 0, st>>>(idx, m, n, ends, rows);
  } else {
    scatter_rows_add_csr_kernel<Index, false>
        <<<batch, kCountThreads, 0, st>>>(idx, m, n, ends, rows);
  }
  const long long out_rows = static_cast<long long>(batch) * n;
  const unsigned int blocks =
      static_cast<unsigned int>((out_rows + kWarps - 1) / kWarps);
  scatter_rows_add_reduce_kernel<T, Index><<<blocks, kWarps * 32, 0, st>>>(
      g, idx, ends, rows, out, batch, m, c, n, c % 4 == 0 ? 4 : 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_index(const T* g, const void* idx, int idx64, void* scratch,
                 float* out, int batch, int m, int c, int n,
                 cudaStream_t st) {
  if (idx64) {
    return launch(g, static_cast<const int64_t*>(idx), scratch, out, batch,
                  m, c, n, st);
  }
  return launch(g, static_cast<const int32_t*>(idx), scratch, out, batch, m,
                c, n, st);
}

}  // namespace

// g: (batch, m, c) contiguous, f32 (is_bf16 == 0) or bf16, 16-byte aligned
// where c % 4 == 0; idx: (batch, m) int32 or, with idx64, int64;
// scratch: batch * (n + m) int32; out: (batch, n, c) f32, every entry
// written. batch * m < 2^31 and batch * n < 2^31.
extern "C" int scatter_launch(int device, const void* g, const void* idx,
                              int idx64, void* scratch, float* out,
                              int batch, int m, int c, int n, int is_bf16,
                              void* stream) {
  if (batch == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_index(static_cast<const __nv_bfloat16*>(g), idx, idx64,
                        scratch, out, batch, m, c, n, st);
  }
  return launch_index(static_cast<const float*>(g), idx, idx64, scratch,
                      out, batch, m, c, n, st);
}

BUTD_PACKED(scatter_launch)
BUTD_ERROR_STRING(scatter)
