// Grouped row gather of one or two payloads under ONE index, for Hopper
// (sm_90a):
//   out_a[b, j, k, :] = a[b, idx[b, j, k], :]
//   out_b[b, j, k, :] = p[b, idx[b, j, k], :]      (when there is a second)
// bit-exact copies, each payload in its own element type; an index outside
// [0, n) writes zero rows.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_window_gather.py:
// _window_extract_pallas (kernel _extract_kernel), reached through
// windowed_group_points and, for xyz + features under a shared index
// preparation, ops/pointcloud.py:_group_points_split_vjp. The TPU sorts the
// centres, lists the 128-point chunks each tile of 8 centres touches,
// gathers those chunk slabs and selects rows and lanes with one-hot
// products, falling back to a plain gather when a tile touches more chunks
// than its budget: all of it a way around a gather that costs per row.
// The card loads a row by its address, so none of that is carried over;
// what is kept is the function (both payloads from one read of the index,
// xyz in f32, the features in their own type, no concatenation and no cast)
// and its exactness.
//
// What bounds it on this card: the bytes (idx read once, each gathered row
// read, each output row written). At the first set-abstraction tier the
// source (50,000 points x 18 bytes a scene) stays in L2 and the output (64
// neighbours x 2048 centres x 18 bytes a scene) is what moves.
//
// Design: one thread per unit of OUTPUT of either payload. A row has
// units_a units of unit_a bytes of the first payload and units_b of unit_b
// of the second (a unit is 16, 4 or 2 bytes, picked by the wrapper per
// payload), and threads 0 .. units_a + units_b - 1 of a row take one each.
// Two regimes fall out of the one kernel. Tier 1: 12 bytes of xyz and 6 of
// bf16 colour are 3 + 3 threads, a warp covers five rows, the index loads
// of a warp are one transaction and the stores of each payload are
// contiguous. Tiers 2-4: 256 or 512 bytes of bf16 features are 16 or 32
// threads of 16 bytes beside 3 of xyz, close to a warp per row.
// blockIdx.y is the batch element, so the per-element thread count stays in
// 32 bits and the row is one 32-bit division.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
group_gather_kernel(const char* __restrict__ a, const char* __restrict__ p,
                    const int* __restrict__ idx, char* __restrict__ out_a,
                    char* __restrict__ out_b, int n, unsigned int rows,
                    unsigned int units_a, int unit_a, unsigned int units_b,
                    int unit_b) {
  const unsigned int per_row = units_a + units_b;
  const unsigned int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * per_row) return;
  const unsigned int row = t / per_row;
  const unsigned int k = t - row * per_row;
  const long long b = blockIdx.y;
  const int j = idx[b * rows + row];
  const bool inside = j >= 0 && j < n;
  if (k < units_a) {
    const long long row_bytes = static_cast<long long>(units_a) * unit_a;
    copy_row_unit(out_a + (b * rows + row) * row_bytes,
                  inside ? a + (b * n + j) * row_bytes : nullptr, unit_a, k);
  } else {
    const long long row_bytes = static_cast<long long>(units_b) * unit_b;
    copy_row_unit(out_b + (b * rows + row) * row_bytes,
                  inside ? p + (b * n + j) * row_bytes : nullptr, unit_b,
                  k - units_a);
  }
}

}  // namespace

// a: (batch, n, row_a) and p: (batch, n, row_b) contiguous (p and out_b may
// be null with units_b == 0), idx: (batch, rows) int32 with rows = m * ns,
// out_a: (batch, rows, row_a), out_b: (batch, rows, row_b). A row of a
// payload is `units_x` units of `unit_x` bytes (16, 4 or 2) and its base
// pointers are multiples of `unit_x`. rows * (units_a + units_b) < 2^31,
// batch <= 65535.
extern "C" int group_gather_launch(const void* a, const void* p,
                                   const int* idx, void* out_a, void* out_b,
                                   int batch, int n, int rows, int units_a,
                                   int unit_a, int units_b, int unit_b,
                                   void* stream) {
  if (batch == 0 || rows == 0 || units_a + units_b == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const unsigned int total = static_cast<unsigned int>(rows) *
                             static_cast<unsigned int>(units_a + units_b);
  const dim3 grid((total + kThreads - 1) / kThreads, batch);
  group_gather_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(a), static_cast<const char*>(p), idx,
      static_cast<char*>(out_a), static_cast<char*>(out_b), n,
      static_cast<unsigned int>(rows), static_cast<unsigned int>(units_a),
      unit_a, static_cast<unsigned int>(units_b), unit_b);
  return static_cast<int>(cudaGetLastError());
}

BUTD_ERROR_STRING(group_gather)
