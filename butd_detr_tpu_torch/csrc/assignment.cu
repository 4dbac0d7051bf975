// Batched linear sum assignment for Hopper (sm_90a): the Hungarian
// matching of the loss, solved where the costs live.
//
// Replaces butd_detr_tpu/losses/matcher.py:_lsa_single (vmapped by
// batched_linear_sum_assignment), a Jonker-Volgenant shortest augmenting
// path solver that the JAX package runs on its chip under lax.while_loop.
// It has no Pallas kernel: XLA runs the loops. The port's earlier path
// copied every cost matrix to the host for scipy, a synchronisation in
// every training step.
//
// The arithmetic is the JAX solver's, step for step and in its f32 order
// (ops/assignment.py lists the steps; batched_linear_sum_assignment_plain
// is the same function in PyTorch). The solver has no multiply, so no
// fused multiply-add can change a bit: the assignment equals the plain
// version's exactly.
//
// What bounds it on this card: neither bytes nor operations. A matrix's
// valid rows are read once (6 x 256 f32 at a training step) and the work is
// a few thousand additions a path step; what takes the time is the serial
// chain of rows x path steps x one argmin over the columns, each step
// waiting on the last.
//
// Design: one warp a matrix, so that a path step needs no block barrier;
// up to kWarps matrices a block, as few as spread a call over every SM (the
// staging's bytes then meet the fewest warps an SM), and every matrix of a
// call runs at once: B = 8's 56 matrices take 56 blocks of one warp, B =
// 24's 168 take 84 of two, on the card's 132 SMs.
//   * Each lane owns the columns lane, lane + 32, ... (K = ceil(Q / 32) of
//     them, 8 at Q 256) and keeps their v, the path's shortest cost spc,
//     its predecessor and whether the column is still to scan (a bit mask)
//     in registers.
//   * The argmin: each lane takes its first minimum over its own columns
//     (a tree whose left half holds the lower columns), then the warp takes
//     the least key (redux.sync), NaN first, as jnp.argmin, and the lowest
//     column holding it (redux.sync), and the winner's value by a shuffle:
//     every lane ends with the winner, so the path's control flow stays
//     uniform in the warp and a step synchronises nothing.
//   * The warp's slice of shared memory (a quarter of a block's 227 KB)
//     holds the row state (u, col4row), row4col, the path's predecessors
//     once it ends (for the augmentation), the rows the path visited with
//     the spc of the column that led to each (for the dual update: that
//     spc is final once the path takes the column, and is the step's
//     min_val), and the staged costs: the first min(n_valid, R) rows, each
//     of 32 K + 1 floats, R the rows that fit beside the rest (52 at (132,
//     256), so a training step's 1-6 valid targets are staged, and a
//     scene's up to 52), n_valid read on the device. They are copied in
//     with cp.async, the first kEarlyRows while n_valid is read: the costs
//     arrive as (M, G, Q) views of the matcher's (M, Q, G) tensor, so a
//     column's valid costs are contiguous and the lanes walk them fastest;
//     the odd row pitch keeps the transposing stores off one bank. NaN and
//     infinite costs are mapped once, in place. A row past R is read from
//     device memory (and mapped) at each step that visits it.
//   * The dual update runs a visited row a lane; the augmentation walks
//     back serially on lane 0, one step for each row the path visited.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr float kInf = 1e9f;  // JAX's INF
constexpr int kWarps = 4;     // matrices a block
// What a block may take on sm_90 (the 227 KB opt-in limit), and so a warp.
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSliceBytes = kMaxSmem / kWarps;
constexpr int kMaxColumns = 1024;
// Rows staged before the valid-row count is read (it is read meanwhile).
constexpr int kEarlyRows = 8;

// torch.nan_to_num(x, nan=1e6, posinf=1e6, neginf=-1e6), as the JAX
// matcher maps its costs before it solves.
__device__ __forceinline__ float guarded(float x) {
  if (x != x) return 1e6f;
  if (x == INFINITY) return 1e6f;
  if (x == -INFINITY) return -1e6f;
  return x;
}

// a comes before b (a the lower column) in jnp.argmin's order: NaN first,
// then the smaller value; a tie keeps a.
__device__ __forceinline__ bool after(float a, float b) {
  return b < a || (b != b && a == a);
}

// jnp.argmin's order of values as unsigned keys: NaN first (0), then by
// value, -0.0 equal to +0.0; ties go to the lower column.
__device__ __forceinline__ unsigned int order_key(float x) {
  if (x != x) return 0u;
  const unsigned int u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Columns a lane holds at q: ceil(q / 32) rounded up to a power of two.
__host__ __device__ inline int lane_columns(int q) {
  int k = 1;
  while (32 * k < q) k *= 2;
  return k;
}

// A warp's slice of shared memory, in bytes from its start: the staged
// costs first, R rows of P + 1 floats (P = 32 K: every column a lane holds,
// those past Q never read), R the most that fit a quarter of a block's
// 227 KB beside the rest of the warp's state: each column's predecessor on
// the path and its row, each row's u and column, and the rows a path
// visited with the spc of the column that led to each.
// ops/assignment.py:assignment_plan mirrors it.
struct Slice {
  int staged_rows;  // R
  int pitch;        // floats a staged row: P + 1
  size_t path, row4col, u, col4row, vis_row, vis_spc, bytes;
};

__host__ __device__ inline Slice slice(int g, int q) {
  const int rows = g < q ? g : q;  // the rows that can be solved
  const size_t p = 32 * static_cast<size_t>(lane_columns(q));
  const size_t per_row = align16(4 * static_cast<size_t>(rows));
  const size_t state = 2 * align16(4 * p) + 4 * per_row;
  const size_t row_bytes = 4 * (p + 1);
  int r = state + row_bytes + 16 <= kSliceBytes
              ? static_cast<int>((kSliceBytes - state - 16) / row_bytes)
              : 1;
  r = r > rows ? rows : r;
  r = r < 1 ? 1 : r;
  Slice s;
  s.staged_rows = r;
  s.pitch = static_cast<int>(p + 1);
  s.path = align16(static_cast<size_t>(r) * row_bytes);
  s.row4col = s.path + align16(4 * p);
  s.u = s.row4col + align16(4 * p);
  s.col4row = s.u + per_row;
  s.vis_row = s.col4row + per_row;
  s.vis_spc = s.vis_row + per_row;
  s.bytes = s.vis_spc + per_row;
  return s;
}

// Issue the cp.async copies of rows [i0, i1) of a (G, Q) matrix into the
// tile, element (i, j) at tile[i * pitch + j].
__device__ __forceinline__ void stage_rows(float* tile, int pitch,
                                           const float* mat, long long sg,
                                           long long sq, int i0, int i1,
                                           int Q, int lane) {
  const int nr = i1 - i0;
  if (nr <= 0) return;
  if (sg == 1) {  // a column's costs contiguous: walk the rows fastest
    int i = lane % nr, j = lane / nr;
    const int di = 32 % nr, dj = 32 / nr;
    float* dst = tile + (i0 + i) * pitch + j;
    const float* src = mat + (i0 + i) + j * sq;
    // one element on: di rows and dj columns; a carry moves a column on
    // and nr rows back
    const long long step_src = di + dj * sq, carry_src = sq - nr;
    const int step_dst = di * pitch + dj, carry_dst = 1 - nr * pitch;
    for (int e = lane; e < nr * Q; e += 32) {
      cp_async_zfill<4>(dst, src, true);
      i += di;
      dst += step_dst;
      src += step_src;
      if (i >= nr) {
        i -= nr;
        dst += carry_dst;
        src += carry_src;
      }
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      for (int j = lane; j < Q; j += 32) {
        cp_async_zfill<4>(tile + i * pitch + j, mat + i * sg + j * sq, true);
      }
    }
  }
}

template <int K, typename Count>
__global__ void __launch_bounds__(kWarps * 32)
assignment_kernel(const float* __restrict__ cost, long long sm, long long sg,
                  long long sq, const Count* __restrict__ n_valid,
                  int* __restrict__ out, int M, int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice S = slice(G, Q);
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= M) return;  // a whole warp: nothing below waits on the block
  unsigned char* base = smem + (threadIdx.x >> 5) * S.bytes;
  float* tile = reinterpret_cast<float*>(base);
  int* path_s = reinterpret_cast<int*>(base + S.path);
  int* row4col = reinterpret_cast<int*>(base + S.row4col);
  float* u = reinterpret_cast<float*>(base + S.u);
  int* col4row = reinterpret_cast<int*>(base + S.col4row);
  int* vis_row = reinterpret_cast<int*>(base + S.vis_row);
  float* vis_spc = reinterpret_cast<float*>(base + S.vis_spc);

  const float* mat = cost + static_cast<long long>(m) * sm;
  const int rows = G < Q ? G : Q;
  const int pitch = S.pitch;
  // the count is read while the first rows are staged
  const long long nv = static_cast<long long>(n_valid[m]);
  const int early = S.staged_rows < kEarlyRows ? S.staged_rows : kEarlyRows;
  stage_rows(tile, pitch, mat, sg, sq, 0, early, Q, lane);
  for (int g = lane; g < rows; g += 32) {
    u[g] = 0.f;
    col4row[g] = -1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) row4col[lane + 32 * k] = -1;
  const int n = nv < 0 ? 0 : (nv > rows ? rows : static_cast<int>(nv));
  const int staged = n < S.staged_rows ? n : S.staged_rows;
  stage_rows(tile, pitch, mat, sg, sq, early, staged, Q, lane);
  cp_async_commit();
  cp_async_wait_none();
  __syncwarp();
  // NaN and infinite costs mapped once, in place (rows past R: when read)
  for (int i = 0; i < staged; ++i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float* c = tile + i * pitch + lane + 32 * k;
      if (lane + 32 * k < Q) *c = guarded(*c);
    }
  }
  __syncwarp();

  unsigned int have = 0;  // bit k: column lane + 32 k exists
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < Q) have |= 1u << k;
  }
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;

  for (int cur = 0; cur < n; ++cur) {
    // --- the shortest augmenting path from row `cur`
    float spc[K];
    int path[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      spc[k] = kInf;
      path[k] = 0;
    }
    unsigned int remaining = have;  // a column past Q is never left
    float min_val = 0.f;
    int i = cur, sink = -1, visited = 0;
    for (int it = 0; sink < 0 && it < Q; ++it) {
      const float ui = u[i];
      float c[K];
      if (i < staged) {  // columns past Q read the row's spare floats
        const float* row = tile + i * pitch + lane;
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = row[32 * k];
      } else {
        const float* row = mat + i * sg + lane * sq;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = (have >> k) & 1u ? guarded(__ldg(row + 32 * k * sq)) : 0.f;
        }
      }
      float val[K];
      int col[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float r = min_val + c[k] - ui - v[k];
        const bool left = (remaining >> k) & 1u;
        if (r < spc[k] && left) {
          path[k] = i;
          spc[k] = r;
        }
        val[k] = left ? spc[k] : kInf;
        col[k] = lane + 32 * k;
      }
      // the lane's first minimum (a tree: the left half holds the lower
      // columns, so it keeps a tie), then the warp's: the least key, then
      // the lowest column holding it, and its value from its lane
#pragma unroll
      for (int w = 1; w < K; w *= 2) {
#pragma unroll
        for (int k = 0; k + w < K; k += 2 * w) {
          if (after(val[k], val[k + w])) {
            val[k] = val[k + w];
            col[k] = col[k + w];
          }
        }
      }
      const unsigned int key = order_key(val[0]);
      const unsigned int least = __reduce_min_sync(0xffffffffu, key);
      const int bj = __reduce_min_sync(0xffffffffu,
                                       key == least ? col[0] : 0x7fffffff);
      min_val = __shfl_sync(0xffffffffu, val[0], bj & 31);
      const int taken = row4col[bj];
      if (taken < 0) {
        sink = bj;
      } else {
        // the path visits row `taken` through column bj, whose spc is
        // final now (it leaves the scan) and equals min_val
        if (lane == 0) {
          vis_row[visited] = taken;
          vis_spc[visited] = min_val;
        }
        ++visited;
        i = taken;
      }
      if ((bj & 31) == lane) remaining &= ~(1u << (bj >> 5));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) path_s[lane + 32 * k] = path[k];
    __syncwarp();
    // --- the dual updates: spc[col4row[g]] of a visited row g is the spc
    // its column had when the path took it
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((have & ~remaining) >> k) & 1u) v[k] = v[k] - (min_val - spc[k]);
    }
    for (int t = lane; t < visited; t += 32) {
      const int g = vis_row[t];
      u[g] = u[g] + min_val - vis_spc[t];
    }
    if (lane == 0) u[cur] = u[cur] + min_val;
    // --- augment along the path, back to row `cur`
    if (lane == 0 && sink >= 0) {
      int jj = sink;
      for (int it = 0; it <= G && jj >= 0; ++it) {
        const int ii = path_s[jj];
        row4col[jj] = ii;
        const int prev = col4row[ii];
        col4row[ii] = jj;
        jj = prev;
        if (ii == cur) break;
      }
    }
    __syncwarp();
  }

  int* row_out = out + static_cast<long long>(m) * G;
  for (int g = lane; g < G; g += 32) {
    const int c = g < rows ? col4row[g] : -1;
    row_out[g] = c > 0 ? c : 0;
  }
}

// f(std::integral_constant<int, K>()) with K = ceil(q / 32) rounded up to
// a power of two: the instantiation for q columns.
template <typename F>
auto by_columns(int q, F&& f) {
  const int k = lane_columns(q);
  if (k <= 1) return f(std::integral_constant<int, 1>());
  if (k <= 2) return f(std::integral_constant<int, 2>());
  if (k <= 4) return f(std::integral_constant<int, 4>());
  if (k <= 8) return f(std::integral_constant<int, 8>());
  if (k <= 16) return f(std::integral_constant<int, 16>());
  return f(std::integral_constant<int, 32>());
}

// Lets `kernel` take `smem` bytes of shared memory on the current device:
// the limit is a property of a kernel on a device, raised once for each
// instantiation on each device, and only past the default 48 KB.
template <int K, typename Count>
cudaError_t allow_smem(int device, size_t smem) {
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        assignment_kernel<K, Count>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  return cudaSuccess;
}

// Matrices (warps) a block for a call of m matrices on `device`: as few as
// spread the call over every SM, at most kWarps, so that the staging's
// bytes meet as few warps an SM as they can. 0 on an error.
int warps_for(int device, int m) {
  constexpr int kDevices = 64;
  static int sms[kDevices] = {};
  if (device < 0 || device >= kDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return 0;
  }
  const int w = (m + sms[device] - 1) / sms[device];
  return w < 1 ? 1 : (w > kWarps ? kWarps : w);
}

template <typename Count>
cudaError_t dispatch(int device, const float* cost, long long sm,
                     long long sg, long long sq, const Count* n_valid,
                     int* out, int m, int g, int q, cudaStream_t st) {
  const int warps = warps_for(device, m);
  if (warps == 0) return cudaErrorInvalidDevice;
  const size_t smem = warps * slice(g, q).bytes;
  return by_columns(q, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const cudaError_t err = allow_smem<K, Count>(device, smem);
    if (err != cudaSuccess) return err;
    assignment_kernel<K, Count><<<(m + warps - 1) / warps, warps * 32, smem,
                                  st>>>(cost, sm, sg, sq, n_valid, out, m, g,
                                        q);
    return cudaGetLastError();
  });
}

}  // namespace

// cost: f32 (m, g, q) with element strides (sm, sg, sq); n_valid: (m,)
// int32, or int64 with count64; out: (m, g) int32, the column of each row
// (0 for the rows past min(n_valid, q)). Returns kRefused, launching
// nothing, where q is above 1024 or the block's slices do not fit its shared
// memory; nothing is launched for m == 0 or g == 0.
extern "C" int assignment_launch(int device, const float* cost, long long sm,
                                 long long sg, long long sq,
                                 const void* n_valid, int count64, int* out,
                                 int m, int g, int q, void* stream) {
  if (m <= 0 || g <= 0) return static_cast<int>(cudaSuccess);
  if (q > kMaxColumns || kWarps * slice(g, q).bytes > kMaxSmem) {
    return kRefused;
  }
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      count64 ? dispatch(device, cost, sm, sg, sq,
                         static_cast<const int64_t*>(n_valid), out, m, g, q,
                         st)
              : dispatch(device, cost, sm, sg, sq,
                         static_cast<const int32_t*>(n_valid), out, m, g, q,
                         st);
  return static_cast<int>(err);
}

// Bytes of shared memory a warp's slice takes at (g, q): a matrix's.
extern "C" int assignment_slice_bytes(int g, int q) {
  return static_cast<int>(slice(g, q).bytes);
}

// R: the rows of a matrix staged in shared memory at (g, q).
extern "C" int assignment_staged_rows(int g, int q) {
  return slice(g, q).staged_rows;
}

// Matrices (warps) a block in a call of m matrices on `device`.
extern "C" int assignment_warps(int device, int m) {
  return warps_for(device, m);
}

// Blocks resident on an SM of `device` in a call of m (g, q) matrices, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor for the instantiation that
// a call with int64 counts launches, or -1 on an error.
extern "C" int assignment_resident_blocks(int device, int m, int g, int q) {
  const int warps = warps_for(device, m);
  if (q < 1 || q > kMaxColumns || warps == 0) return -1;
  const DeviceScope on(device);
  const size_t smem = warps * slice(g, q).bytes;
  return by_columns(q, [&](auto k) {
    constexpr int K = decltype(k)::value;
    int blocks = 0;
    if (allow_smem<K, int64_t>(device, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, assignment_kernel<K, int64_t>, warps * 32, smem) !=
            cudaSuccess) {
      return -1;
    }
    return blocks;
  });
}

BUTD_PACKED(assignment_launch)
BUTD_ERROR_STRING(assignment)
