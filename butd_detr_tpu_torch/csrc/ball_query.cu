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
// Two kernels, chosen by shape in ops/ball_query.py, as the JAX package
// chooses (ops/pointcloud.py:752-754: N >= 16384 and m >= 64 take the
// pruned kernel, i.e. sa1):
//
// * The index-order scan (small tiers). One warp per center scans 128
//   candidates at a time in index order (4 a lane, their loads in flight
//   together); __ballot_sync gives the hit mask,
//   __popc of the lanes below each hit's slot, and the warp leaves once
//   `nsample` hits are placed. Bound by reading candidates: a center with
//   fewer than nsample neighbours reads all N x 12 bytes (from L2). At
//   N <= 2048 that is at most 16 iterations.
//
// * The hashed grid (large tiers). A center with few neighbours would scan
//   all 50,000 points; a ball of r = 0.2 holds tens of them. So the points
//   are binned into cells a little larger than r, and a center tests only
//   the points of the 27 cells around its own:
//   1. count: each point's cell floor(x * inv_edge) per axis, in double
//      (the product of two floats is exact there), clamped to +-2^20 so an
//      outlier cannot overflow; clamping is monotone, so a neighbour stays
//      within one cell. A point with a NaN coordinate can never be a hit
//      and goes to no cell. The cell is hashed into a table of T (a power
//      of two >= 2N) slots per cloud; integer atomics count each slot.
//   2. scan: an exclusive scan of the counts, 32 tiles a cloud, one block
//      a tile; each tile's total goes to `tiles`, and a reader adds the
//      prefix of the tiles before its slot (one warp scan of 32 values).
//   3. fill: a counting sort of the points by slot into float4 rows (x, y,
//      z, the original index's bits); the order inside a slot follows the
//      atomics and does not matter, because step 4 selects by index.
//   4. query: one warp per center; lane k < 27 takes the k-th neighbour
//      cell. Two cells may hash to one slot (__match_any_sync), and such a
//      slot is visited once, so no point is tested twice; a point of
//      another cell in a visited slot is only an extra candidate. The
//      warp walks the slots' points as one list, 128 at a time (4 loads
//      a lane in flight: a warp's walk is bound by their latency),
//      collects the hits' indices in shared memory, sorts them
//      (bitonic), and writes the first `nsample`, padded and zeroed as
//      the contract says.
//   Why the 27 cells hold every hit: the edge is r (1 + 2^-10); two cells
//   apart means |px - cx| > edge exactly, and then the rounded d^2 on that
//   axis alone already exceeds r2 (each rounding costs 2^-24 relative,
//   far less than the margin).
//   Exactness guard, per center and on the device: a center with more
//   hits than its buffer holds (kCap) runs the index-order scan for itself
//   (the JAX kernel's lax.cond guard, made per center). Such a center is
//   dense, so its scan stops early.
//   All five steps are enqueued by one C call; the scratch (sorted points,
//   counts, slot ends, tile totals) is one caller-allocated buffer whose
//   size depends on (B, N, T) only, so the call can be captured in a CUDA
//   graph.
//
// `stats` (optional, (B*m, 2) int32): per center the candidates tested
// and whether it took the guard, for the smoke report and the card tests.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTiles = 32;        // scan tiles per cloud, one warp's width
constexpr int kMinTableBits = 15; // scan: a multiple of 4 slots a thread
constexpr int kCap = 512;         // hits one warp holds before the guard
constexpr int kPerLane = 4;       // candidates a lane tests an iteration
constexpr double kCellClamp = 1048576.0;  // 2^20

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// One center's index-order scan (the small tiers' kernel, and the guard).
// A lane tests kPerLane candidates an iteration, their loads in flight
// together; the ballots then place the hits in index order. Writes
// o[0, nsample) and returns the candidates it tested.
__device__ int scan_center(const float* __restrict__ p, int n, float cx,
                           float cy, float cz, int nsample, float r2,
                           int* __restrict__ o, int lane) {
  int cnt = 0;
  int first = 0;
  int base = 0;
  for (; base < n && cnt < nsample; base += 32 * kPerLane) {
    bool hit[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int i = base + 32 * k + lane;
      hit[k] = i < n && sqdist_rn(cx, cy, cz, p[3 * i], p[3 * i + 1],
                                  p[3 * i + 2]) < r2;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const unsigned mask = __ballot_sync(0xffffffffu, hit[k]);
      if (mask) {
        const int at = base + 32 * k;
        if (cnt == 0) first = at + __ffs(mask) - 1;
        const int slot = cnt + __popc(mask & lanes_below(lane));
        if (hit[k] && slot < nsample) o[slot] = at + lane;
        cnt += __popc(mask);
      }
    }
  }
  if (cnt > nsample) cnt = nsample;
  for (int s = cnt + lane; s < nsample; s += 32) o[s] = first;
  return base < n ? base : n;
}

__device__ __forceinline__ void put_stats(int* stats, long long row,
                                          int tested, int guard, int lane) {
  if (stats != nullptr && lane == 0) {
    stats[2 * row] = tested;
    stats[2 * row + 1] = guard;
  }
}

__global__ void __launch_bounds__(kThreads)
ball_query_scan_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ centers, int batch, int n,
                       int m, int nsample, float r2, int* __restrict__ stats,
                       int* __restrict__ out) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= batch * m) return;  // warp-uniform
  const int b = row / m;
  const float* c = centers + 3 * static_cast<size_t>(row);
  const int tested =
      scan_center(xyz + static_cast<size_t>(b) * n * 3, n, c[0], c[1], c[2],
                  nsample, r2, out + static_cast<size_t>(row) * nsample,
                  lane);
  put_stats(stats, row, tested, 0, lane);
}

// ------------------------------------------------------------ the grid

__device__ __forceinline__ int cell_of(float x, float inv_edge) {
  double v = floor(static_cast<double>(x) * static_cast<double>(inv_edge));
  v = fmin(fmax(v, -kCellClamp), kCellClamp);
  return static_cast<int>(v);
}

__device__ __forceinline__ unsigned slot_of(int ix, int iy, int iz,
                                            unsigned mask) {
  unsigned h = static_cast<unsigned>(ix) * 0x9E3779B1u ^
               static_cast<unsigned>(iy) * 0x85EBCA77u ^
               static_cast<unsigned>(iz) * 0xC2B2AE3Du;
  h ^= h >> 16;  // finalizer: the low bits take every input bit
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h & mask;
}

// The exclusive prefix of cloud b's tile totals, lane k holding tile k's.
__device__ __forceinline__ int tile_prefix(const int* __restrict__ tiles,
                                           int b, int lane) {
  const int own = tiles[b * kTiles + lane];
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  return incl - own;
}

__global__ void __launch_bounds__(kThreads)
ball_query_grid_count_kernel(const float* __restrict__ xyz, int n,
                             float inv_edge, unsigned mask,
                             int* __restrict__ counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  const float* p = xyz + (static_cast<size_t>(b) * n + i) * 3;
  const float x = p[0], y = p[1], z = p[2];
  if (isnan(x) || isnan(y) || isnan(z)) return;
  const unsigned s = slot_of(cell_of(x, inv_edge), cell_of(y, inv_edge),
                             cell_of(z, inv_edge), mask);
  atomicAdd(counts + (static_cast<size_t>(b) * (mask + 1u)) + s, 1);
}

// grid (kTiles, batch): the block of tile t scans slots [t T/32, (t+1) T/32)
// of its cloud into `ends` (tile-local exclusive prefixes).
__global__ void __launch_bounds__(kThreads)
ball_query_grid_scan_kernel(const int* __restrict__ counts, int table,
                            int* ends, int* __restrict__ tiles) {
  __shared__ int warp_sums[kWarpsPerBlock];
  const int b = blockIdx.y;
  const int per_thread = table / kTiles / kThreads;
  const size_t at = static_cast<size_t>(b) * table +
                    static_cast<size_t>(blockIdx.x) * (table / kTiles) +
                    static_cast<size_t>(threadIdx.x) * per_thread;
  const int* c = counts + at;
  int* e = ends + at;
  // per_thread is a multiple of 4 (table >= 2^15 on this path): 16-byte
  // loads, unrolled so that they are in flight together
  const int4* c4 = reinterpret_cast<const int4*>(c);
  int sum = 0;
#pragma unroll 4
  for (int k = 0; k < per_thread / 4; ++k) {
    const int4 v = c4[k];
    sum += (v.x + v.y) + (v.z + v.w);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int k = 0; k < w; ++k) run += warp_sums[k];
  int4* e4 = reinterpret_cast<int4*>(e);
#pragma unroll 4
  for (int k = 0; k < per_thread / 4; ++k) {
    const int4 v = c4[k];
    int4 o;
    o.x = run;
    o.y = o.x + v.x;
    o.z = o.y + v.y;
    o.w = o.z + v.z;
    run = o.w + v.w;
    e4[k] = o;
  }
  if (threadIdx.x == kThreads - 1) tiles[b * kTiles + blockIdx.x] = run;
}

// After this kernel, ends[s] is the tile-local END of slot s.
__global__ void __launch_bounds__(kThreads)
ball_query_grid_fill_kernel(const float* __restrict__ xyz, int n,
                            float inv_edge, unsigned mask, int tile_shift,
                            int* __restrict__ ends,
                            const int* __restrict__ tiles,
                            float4* __restrict__ sorted) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int prefix = tile_prefix(tiles, b, lane);
  float x = 0.f, y = 0.f, z = 0.f;
  bool valid = false;
  unsigned s = 0;
  if (i < n) {
    const float* p = xyz + (static_cast<size_t>(b) * n + i) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
    valid = !(isnan(x) || isnan(y) || isnan(z));
    if (valid) {
      s = slot_of(cell_of(x, inv_edge), cell_of(y, inv_edge),
                  cell_of(z, inv_edge), mask);
    }
  }
  const int base = __shfl_sync(0xffffffffu, prefix,
                               static_cast<int>(s >> tile_shift));
  if (!valid) return;
  const int pos =
      base + atomicAdd(ends + static_cast<size_t>(b) * (mask + 1u) + s, 1);
  sorted[static_cast<size_t>(b) * n + pos] =
      make_float4(x, y, z, __int_as_float(i));
}

// Ascending bitonic sort of v[0, p) by one warp; p is a power of two.
__device__ __forceinline__ void warp_bitonic_sort(int* v, int p, int lane) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const int a = v[i], c = v[l];
          if ((a > c) == ((i & k) == 0)) {
            v[i] = c;
            v[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ball_query_grid_query_kernel(
    const float* __restrict__ xyz, const float* __restrict__ centers,
    int batch, int n, int m, int nsample, float r2, float inv_edge,
    unsigned mask, int tile_shift, const int* __restrict__ counts,
    const int* __restrict__ ends, const int* __restrict__ tiles,
    const float4* __restrict__ sorted, int* __restrict__ stats,
    int* __restrict__ out) {
  __shared__ int hits[kWarpsPerBlock][kCap];
  __shared__ int flat_end[kWarpsPerBlock][32];
  __shared__ int flat_at[kWarpsPerBlock][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + w;
  if (row >= batch * m) return;  // warp-uniform
  const int b = row / m;
  const float* c = centers + 3 * static_cast<size_t>(row);
  const float cx = c[0], cy = c[1], cz = c[2];
  int* o = out + static_cast<size_t>(row) * nsample;
  const size_t table = static_cast<size_t>(mask) + 1u;

  // lane k < 27: neighbour cell (k % 3 - 1, k / 3 % 3 - 1, k / 9 - 1)
  const int prefix = tile_prefix(tiles, b, lane);
  unsigned s = 0xffffffffu;
  if (lane < 27) {
    s = slot_of(cell_of(cx, inv_edge) + lane % 3 - 1,
                cell_of(cy, inv_edge) + lane / 3 % 3 - 1,
                cell_of(cz, inv_edge) + lane / 9 - 1, mask);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  const bool visit = lane < 27 && __ffs(peers) - 1 == lane;
  const int base = __shfl_sync(0xffffffffu, prefix,
                               visit ? static_cast<int>(s >> tile_shift) : 0);
  int len = 0, begin = 0;
  if (visit) {
    len = counts[b * table + s];
    begin = base + ends[b * table + s] - len;
  }
  // the visited slots' points as one list: list position t of slot k is
  // sorted row flat_at[k] + t
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  flat_end[w][lane] = incl;
  flat_at[w][lane] = begin - (incl - len);
  __syncwarp();

  const float4* pts = sorted + static_cast<size_t>(b) * n;
  int found = 0;
  for (int t0 = 0; t0 < total; t0 += 32 * kPerLane) {
    bool hit[kPerLane];
    int id[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int t = t0 + 32 * k + lane;
      hit[k] = false;
      id[k] = 0;
      if (t < total) {
        int lo = 0, hi = 31;  // the first slot whose list ends after t
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (flat_end[w][mid] > t) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        const float4 q = pts[flat_at[w][lo] + t];
        hit[k] = sqdist_rn(cx, cy, cz, q.x, q.y, q.z) < r2;
        id[k] = __float_as_int(q.w);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const unsigned hm = __ballot_sync(0xffffffffu, hit[k]);
      const int slot = found + __popc(hm & lanes_below(lane));
      if (hit[k] && slot < kCap) hits[w][slot] = id[k];
      found += __popc(hm);
    }
    if (found > kCap) break;  // warp-uniform
  }

  if (found > kCap) {  // the guard: this center alone scans in index order
    const int scanned =
        scan_center(xyz + static_cast<size_t>(b) * n * 3, n, cx, cy, cz,
                    nsample, r2, o, lane);
    put_stats(stats, row, total + scanned, 1, lane);
    return;
  }
  int p = 1;
  while (p < found) p <<= 1;
  for (int i = found + lane; i < p; i += 32) hits[w][i] = INT_MAX;
  __syncwarp();
  warp_bitonic_sort(hits[w], p, lane);
  const int cnt = found < nsample ? found : nsample;
  const int first = found > 0 ? hits[w][0] : 0;
  for (int i = lane; i < nsample; i += 32) o[i] = i < cnt ? hits[w][i] : first;
  put_stats(stats, row, total, 0, lane);
}

}  // namespace

// xyz (batch, n, 3), centers (batch, m, 3) f32 contiguous; out (batch, m,
// nsample) int32. scratch == nullptr: the index-order scan. Otherwise the
// hashed grid with a table of 2^table_bits slots a cloud; scratch holds
// batch * (16 n + 8 * 2^table_bits + 4 * 32) bytes, 16-byte aligned.
// stats: nullptr, or (batch * m, 2) int32.
extern "C" int ball_query_launch(int device, const float* xyz,
                                 const float* centers, int batch, int n,
                                 int m, int nsample, float r2,
                                 float inv_edge, int table_bits,
                                 void* scratch, int* stats, int* out,
                                 void* stream) {
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * m;
  if (rows == 0 || nsample == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (scratch == nullptr) {
    ball_query_scan_kernel<<<blocks, kThreads, 0, st>>>(
        xyz, centers, batch, n, m, nsample, r2, stats, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (table_bits < kMinTableBits || table_bits > 30 || nsample > kCap ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t table = size_t{1} << table_bits;
  const unsigned mask = static_cast<unsigned>(table - 1);
  const int tile_shift = table_bits - 5;  // log2(table / kTiles)
  char* at = static_cast<char*>(scratch);
  float4* sorted = reinterpret_cast<float4*>(at);
  at += static_cast<size_t>(batch) * n * sizeof(float4);
  int* counts = reinterpret_cast<int*>(at);
  at += static_cast<size_t>(batch) * table * sizeof(int);
  int* ends = reinterpret_cast<int*>(at);
  at += static_cast<size_t>(batch) * table * sizeof(int);
  int* tiles = reinterpret_cast<int*>(at);

  cudaError_t err = cudaMemsetAsync(
      counts, 0, static_cast<size_t>(batch) * table * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 per_point((n + kThreads - 1) / kThreads, batch);
  ball_query_grid_count_kernel<<<per_point, kThreads, 0, st>>>(
      xyz, n, inv_edge, mask, counts);
  ball_query_grid_scan_kernel<<<dim3(kTiles, batch), kThreads, 0, st>>>(
      counts, static_cast<int>(table), ends, tiles);
  ball_query_grid_fill_kernel<<<per_point, kThreads, 0, st>>>(
      xyz, n, inv_edge, mask, tile_shift, ends, tiles, sorted);
  ball_query_grid_query_kernel<<<blocks, kThreads, 0, st>>>(
      xyz, centers, batch, n, m, nsample, r2, inv_edge, mask, tile_shift,
      counts, ends, tiles, sorted, stats, out);
  return static_cast<int>(cudaGetLastError());
}

BUTD_PACKED(ball_query_launch)
BUTD_ERROR_STRING(ball_query)
