// Row gather for Hopper (sm_90a):
//   out[b, m, :] = src[b, idx[b, m], :]
// a bit-exact copy of rows; an index outside [0, n) writes a zero row.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_scatter.py:
// gather_rows_pallas (kernel _make_gather_kernel), the forward of
// gather_points, group_points and three_interpolate. The TPU has no per-row
// load, so it builds a (rows, n) one-hot tile and multiplies on the MXU,
// with a 3-way bf16 split of f32 rows to stay exact, and caps n at what the
// tile can hold. None of that is carried over: the card loads a row by its
// address, so the copy is exact by construction and n has no limit.
//
// What bounds it on this card: the bytes (idx read, each gathered row read,
// each output row written); there is no arithmetic.
//
// Design: one thread per unit of OUTPUT, a unit being 16, 4 or 2 bytes (the
// wrapper picks the largest that the row's bytes and the base pointers
// allow). Consecutive threads write consecutive units, so stores coalesce
// for any row width: a 288-channel f32 row is 72 threads of 16 bytes, a
// 3-channel row 3 threads of 4 bytes, and a warp then covers ten rows.
// The threads of one row read the same index (one transaction) and
// consecutive units of the source row. blockIdx.y is the batch element, so
// the per-element unit count stays in 32 bits and the row is one 32-bit
// division.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const char* __restrict__ src, const int* __restrict__ idx,
                   char* __restrict__ out, int n, unsigned int m,
                   unsigned int units, int unit) {
  const unsigned int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= m * units) return;
  const unsigned int row = t / units;
  const unsigned int k = t - row * units;
  const long long b = blockIdx.y;
  const long long row_bytes = static_cast<long long>(units) * unit;
  const int j = idx[b * m + row];
  const char* src_row =
      (j >= 0 && j < n) ? src + (b * n + j) * row_bytes : nullptr;
  copy_row_unit(out + (b * m + row) * row_bytes, src_row, unit, k);
}

}  // namespace

// src: (batch, n, row) contiguous, idx: (batch, m) int32, out: (batch, m,
// row); a row is `units` units of `unit` bytes (16, 4 or 2), and all three
// base pointers are multiples of `unit`. m * units < 2^31, batch <= 65535.
extern "C" int gather_launch(const void* src, const int* idx, void* out,
                             int batch, int n, int m, int units, int unit,
                             void* stream) {
  if (batch == 0 || m == 0 || units == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const unsigned int total =
      static_cast<unsigned int>(m) * static_cast<unsigned int>(units);
  const dim3 grid((total + kThreads - 1) / kThreads, batch);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), idx, static_cast<char*>(out), n,
      static_cast<unsigned int>(m), static_cast<unsigned int>(units), unit);
  return static_cast<int>(cudaGetLastError());
}

BUTD_ERROR_STRING(gather)
