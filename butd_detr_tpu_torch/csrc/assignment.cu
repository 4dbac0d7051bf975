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
// What bounds it on this card: neither bytes nor operations. A matrix is
// read once (at most 132 x 256 f32, 135 KB) and the work is a few thousand
// additions a path step; what takes the time is the serial chain of rows x
// path steps x one block-wide argmin, each step waiting on the last.
//
// Design: one block a matrix (M = 7 B blocks: the 7 loss prefixes of B
// scenes), one thread a column, blockDim = Q rounded up to 32.
//   * The block stages its first n_valid rows into shared memory once,
//     NaN-guarded, rows of Q + 1 floats: the costs arrive as (M, G, Q)
//     views of the matcher's (M, Q, G) tensor, so the staging walks the
//     targets fastest (coalesced reads) and the odd row pitch keeps those
//     transposing stores free of bank conflicts. A path step then reads
//     one shared row, consecutive threads consecutive words. Where the
//     tile does not fit (min(G, Q) (Q + 1) floats over what a block may
//     take), each step reads its row from device memory instead.
//   * Column state lives in registers: v, the path's shortest cost spc,
//     its predecessor and whether the column is still to scan. The row
//     state (u, col4row, the rows the path visited) and row4col are shared.
//   * The argmin: a butterfly of warp shuffles (value, then the lower
//     index), then every thread reduces the warps' winners from shared
//     memory. Two buffers of winners alternate, so a step needs one
//     barrier.
//   * The augmentation walks back serially on thread 0, one step for each
//     row the path visited.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kInf = 1e9f;  // JAX's INF
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// What a block may take on sm_90 (the 227 KB opt-in limit).
constexpr size_t kMaxSmem = 232448;

// torch.nan_to_num(x, nan=1e6, posinf=1e6, neginf=-1e6), as the JAX
// matcher maps its costs before it solves.
__device__ __forceinline__ float guarded(float x) {
  if (x != x) return 1e6f;
  if (x == INFINITY) return 1e6f;
  if (x == -INFINITY) return -1e6f;
  return x;
}

// a comes before b in jnp.argmin's order: NaN first, then the smaller
// value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

// The shared-memory layout of a block, in bytes from its start.
// The cost tile, when staged, comes first.
struct Layout {
  size_t u, col4row, row4col, spc, path, sr, red_v, red_j, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline Layout layout(int g, int q, bool staged) {
  const int rows = g < q ? g : q;
  Layout l;
  l.u = staged ? align16(static_cast<size_t>(rows) * (q + 1) * 4) : 0;
  l.col4row = align16(l.u + 4 * static_cast<size_t>(g));
  l.row4col = align16(l.col4row + 4 * static_cast<size_t>(g));
  l.spc = align16(l.row4col + 4 * static_cast<size_t>(q));
  l.path = align16(l.spc + 4 * static_cast<size_t>(q));
  l.sr = align16(l.path + 4 * static_cast<size_t>(q));
  l.red_v = align16(l.sr + static_cast<size_t>(g));
  l.red_j = l.red_v + 2 * 4 * kMaxWarps;
  l.total = l.red_j + 2 * 4 * kMaxWarps;
  return l;
}

template <bool STAGED, typename Count>
__global__ void __launch_bounds__(kMaxThreads)
assignment_kernel(const float* __restrict__ cost, long long sm, long long sg,
                  long long sq, const Count* __restrict__ n_valid,
                  int* __restrict__ out, int G, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, Q, STAGED);
  float* tile = reinterpret_cast<float*>(smem);
  float* u = reinterpret_cast<float*>(smem + L.u);
  int* col4row = reinterpret_cast<int*>(smem + L.col4row);
  int* row4col = reinterpret_cast<int*>(smem + L.row4col);
  float* spc_s = reinterpret_cast<float*>(smem + L.spc);
  int* path_s = reinterpret_cast<int*>(smem + L.path);
  unsigned char* sr = smem + L.sr;
  float* red_v = reinterpret_cast<float*>(smem + L.red_v);
  int* red_j = reinterpret_cast<int*>(smem + L.red_j);

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* mat = cost + static_cast<long long>(m) * sm;
  long long nv = static_cast<long long>(n_valid[m]);
  const int cap = G < Q ? G : Q;
  const int n = nv < 0 ? 0 : (nv > cap ? cap : static_cast<int>(nv));
  const int pitch = Q + 1;

  for (int g = tid; g < G; g += nthreads) {
    u[g] = 0.f;
    col4row[g] = -1;
    sr[g] = 0;
  }
  for (int j = tid; j < Q; j += nthreads) row4col[j] = -1;
  if (STAGED) {
    const int total = n * Q;
    if (sg == 1) {  // targets contiguous: walk them fastest
      for (int e = tid; e < total; e += nthreads) {
        const int j = e / n, i = e - j * n;
        tile[i * pitch + j] = guarded(mat[i + j * sq]);
      }
    } else {
      for (int e = tid; e < total; e += nthreads) {
        const int i = e / Q, j = e - i * Q;
        tile[i * pitch + j] = guarded(mat[i * sg + j * sq]);
      }
    }
  }
  __syncthreads();

  const int j = tid;  // this thread's column
  const bool column = j < Q;
  float v = 0.f;
  int parity = 0;
  for (int cur = 0; cur < n; ++cur) {
    // --- the shortest augmenting path from row `cur`
    float spc = kInf, min_val = 0.f;
    int path = 0, i = cur, sink = -1;
    bool remaining = column;
    for (int it = 0; sink < 0 && it < Q; ++it) {
      if (tid == 0) sr[i] = 1;
      float masked = kInf;
      if (column) {
        const float c = STAGED ? tile[i * pitch + j]
                               : guarded(mat[i * sg + j * sq]);
        const float r = min_val + c - u[i] - v;
        if (r < spc && remaining) {
          path = i;
          spc = r;
        }
        if (remaining) masked = spc;
      }
      float best = masked;
      int bj = column ? j : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (before(ov, oj, best, bj)) {
          best = ov;
          bj = oj;
        }
      }
      float* rv = red_v + parity * kMaxWarps;
      int* rj = red_j + parity * kMaxWarps;
      parity ^= 1;
      if (lane == 0) {
        rv[warp] = best;
        rj[warp] = bj;
      }
      __syncthreads();
      best = rv[0];
      bj = rj[0];
      for (int w = 1; w < nwarps; ++w) {
        if (before(rv[w], rj[w], best, bj)) {
          best = rv[w];
          bj = rj[w];
        }
      }
      min_val = best;
      const int taken = row4col[bj];
      if (taken < 0) {
        sink = bj;
      } else {
        i = taken;
      }
      if (j == bj) remaining = false;
    }
    if (column) {
      spc_s[j] = spc;
      path_s[j] = path;
    }
    __syncthreads();
    // --- the dual updates
    if (column && !remaining) v = v - (min_val - spc);
    for (int g = tid; g <= cur; g += nthreads) {
      if (sr[g]) {
        if (g != cur) {
          const int c = col4row[g];
          const float s = c >= 0 ? spc_s[c] : 0.f;
          u[g] = u[g] + min_val - s;
        }
        sr[g] = 0;
      }
    }
    if (tid == 0) u[cur] = u[cur] + min_val;
    __syncthreads();
    // --- augment along the path, back to row `cur`
    if (tid == 0 && sink >= 0) {
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
    __syncthreads();
  }

  int* row_out = out + static_cast<long long>(m) * G;
  for (int g = tid; g < G; g += nthreads) {
    const int c = col4row[g];
    row_out[g] = c > 0 ? c : 0;
  }
}

template <bool STAGED, typename Count>
cudaError_t launch_solver(int device, const float* cost, long long sm,
                          long long sg, long long sq, const Count* n_valid,
                          int* out, int m, int g, int q, cudaStream_t st) {
  auto kernel = assignment_kernel<STAGED, Count>;
  const size_t smem = layout(g, q, STAGED).total;
  // The limit is a property of a kernel on a device: raise it once for
  // this instantiation on each device, to the most a block may take.
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  const bool known = device >= 0 && device < kDevices;
  if (!known || !smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    if (known) smem_set[device] = true;
  }
  const int threads = q < 32 ? 32 : (q + 31) / 32 * 32;
  kernel<<<m, threads, smem, st>>>(cost, sm, sg, sq, n_valid, out, g, q);
  return cudaGetLastError();
}

template <typename Count>
cudaError_t dispatch(int device, const float* cost, long long sm,
                     long long sg, long long sq, const Count* n_valid,
                     int* out, int m, int g, int q, cudaStream_t st) {
  if (layout(g, q, true).total <= kMaxSmem) {
    return launch_solver<true>(device, cost, sm, sg, sq, n_valid, out, m, g,
                               q, st);
  }
  if (layout(g, q, false).total > kMaxSmem) return cudaErrorInvalidValue;
  return launch_solver<false>(device, cost, sm, sg, sq, n_valid, out, m, g,
                              q, st);
}

}  // namespace

// cost: f32 (m, g, q) with element strides (sm, sg, sq); n_valid: (m,)
// int32, or int64 with count64; out: (m, g) int32, the column of each row
// (0 for the rows past min(n_valid, q)). q <= 1024.
extern "C" int assignment_launch(int device, const float* cost, long long sm,
                                 long long sg, long long sq,
                                 const void* n_valid, int count64, int* out,
                                 int m, int g, int q, void* stream) {
  if (m == 0 || g == 0) return static_cast<int>(cudaSuccess);
  if (q > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
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

// Bytes of shared memory a block takes at (g, q), and whether the costs
// are staged there (1) or read from device memory (0).
extern "C" int assignment_smem_bytes(int g, int q) {
  const size_t staged = layout(g, q, true).total;
  return static_cast<int>(staged <= kMaxSmem ? staged
                                             : layout(g, q, false).total);
}

BUTD_PACKED(assignment_launch)
BUTD_ERROR_STRING(assignment)
