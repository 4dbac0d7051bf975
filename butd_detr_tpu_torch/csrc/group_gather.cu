// Two kernels of the grouped gather, for Hopper (sm_90a):
//
// 1. group_gather_kernel: the row gather of one or two payloads under ONE
//    index,
//      out_a[b, j, k, :] = a[b, idx[b, j, k], :]
//      out_b[b, j, k, :] = p[b, idx[b, j, k], :]   (when there is a second)
//    bit-exact copies, each payload in its own element type.
// 2. group_gather_mlp_input_kernel: a set-abstraction tier's MLP input in
//    one pass (the bf16 backbone's grouping),
//      out[b, j, k, 0:3]     = bf16((xyz[b, i] - new_xyz[b, j]) * inv_r)
//      out[b, j, k, 3:3 + C] = feats[b, i]            (bf16 bits)
//    with i = idx[b, j, k], the subtract and the multiply in f32, each
//    rounded on its own, and the cast rounded to nearest even with every
//    NaN to 0x7FC0, c10's scalar rule (round_to_nearest_even) and the
//    plain version's (ops/gather.py:bf16_rn); the card's cvt.rn.bf16.f32,
//    behind PyTorch's CUDA cast, would give 0x7FFF.
// In both an index outside [0, n) reads a zero row (so the xyz channels of
// the second are bf16((0 - new_xyz) * inv_r)).
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_window_gather.py:
// _window_extract_pallas (kernel _extract_kernel), reached through
// windowed_group_points and, for xyz + features under a shared index
// preparation, ops/pointcloud.py:_group_points_split_vjp; beside that call
// XLA fuses the centre subtraction, the radius scale, the concatenation and
// the cast to the MLP's dtype into one loop, which kernel 2 does here. The
// TPU sorts the centres, lists the 128-point chunks each tile of 8 centres
// touches, gathers those chunk slabs and selects rows and lanes with
// one-hot products: all of it a way around a gather that costs per row. The
// card loads a row by its address, so none of that is carried over.
//
// What bounds both on this card: the bytes (idx read once, each distinct
// gathered row read, each output row written). At the first tier the
// source (50,000 points x 18 bytes a scene) stays in L2 and the output is
// what moves.
//
// Kernel 1: one thread per unit of OUTPUT of either payload. A row has
// units_a units of unit_a bytes of the first payload and units_b of unit_b
// of the second (a unit is 16, 4 or 2 bytes, picked by the wrapper per
// payload), and threads 0 .. units_a + units_b - 1 of a row take one each.
// blockIdx.y is the batch element, so the per-element thread count stays in
// 32 bits and the row is one 32-bit division.
//
// Kernel 2: the output rows, flattened over (b, j, k), are cut into tiles
// of R rows (R a multiple of 8 and, where it fits, of ns: a whole number of
// centres), so a tile is contiguous in the output and starts on a 16-byte
// boundary. A block walks its tiles with two stages of shared memory:
//   gather  each row's index is read once a copy unit; its 12 bytes of
//           xyz (3 x 4 bytes, any row stride) and its 2C bytes of features
//           (16-, 8- or 4-byte units where the row and the base allow, as
//           at sa2-sa4; 2-byte loads otherwise, as for sa1's 6-byte rows)
//           are copied into the stage with cp.async, zero-filled (src-size
//           0) for an index out of range;
//   epilogue the tile's (3 + C)-wide bf16 rows are written in shared
//           memory as 4-byte words: at sa2-sa4 a warp a row copies the
//           feature words (an aligned read, or two and a byte permute where
//           the row starts on a half word) and the one or two words that
//           hold an xyz element are computed alone; at sa1 (width 6) a
//           thread a row; an xyz element is the subtract, scale and round;
//   store   one TMA bulk copy (cp.async.bulk.global.shared::cta, after
//           fence.proxy.async) writes the tile; a tile whose size is not
//           a multiple of 16 bytes (the last one of a call, at most) has
//           its last bytes written by plain stores.
// The next tile's gather is issued before this tile's epilogue, and the
// bulk store of a tile is waited on (wait_group.read) only when its stage
// comes round again, so a tile's gather overlaps the previous tile's store.
// The epilogue's shared-memory work, not the bytes, sets the time
// (PERF.md, the K7 ablation).
// The index is read in the caller's type, int32 or int64, so no cast
// kernel runs before either kernel.

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
group_gather_kernel(const char* __restrict__ a, const char* __restrict__ p,
                    const Index* __restrict__ idx, char* __restrict__ out_a,
                    char* __restrict__ out_b, int n, unsigned int rows,
                    unsigned int units_a, int unit_a, unsigned int units_b,
                    int unit_b) {
  const unsigned int per_row = units_a + units_b;
  const unsigned int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * per_row) return;
  const unsigned int row = t / per_row;
  const unsigned int k = t - row * per_row;
  const long long b = blockIdx.y;
  const long long j = idx[b * rows + row];
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
// be null with units_b == 0), idx: (batch, rows) int32 or, with idx64,
// int64, with rows = m * ns, out_a: (batch, rows, row_a), out_b: (batch,
// rows, row_b). A row of a payload is `units_x` units of `unit_x` bytes (16,
// 4 or 2) and its base pointers are multiples of `unit_x`.
// rows * (units_a + units_b) < 2^31, batch <= 65535.
extern "C" int group_gather_launch(int device, const void* a, const void* p,
                                   const void* idx, int idx64, void* out_a,
                                   void* out_b, int batch, int n, int rows,
                                   int units_a, int unit_a, int units_b,
                                   int unit_b, void* stream) {
  if (batch == 0 || rows == 0 || units_a + units_b == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const DeviceScope on(device);
  const unsigned int total = static_cast<unsigned int>(rows) *
                             static_cast<unsigned int>(units_a + units_b);
  const dim3 grid((total + kThreads - 1) / kThreads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* ca = static_cast<const char*>(a);
  const char* cp = static_cast<const char*>(p);
  char* oa = static_cast<char*>(out_a);
  char* ob = static_cast<char*>(out_b);
  const unsigned int ur = static_cast<unsigned int>(rows);
  const unsigned int ua = static_cast<unsigned int>(units_a);
  const unsigned int ub = static_cast<unsigned int>(units_b);
  if (idx64) {
    group_gather_kernel<<<grid, kThreads, 0, st>>>(
        ca, cp, static_cast<const int64_t*>(idx), oa, ob, n, ur, ua, unit_a,
        ub, unit_b);
  } else {
    group_gather_kernel<<<grid, kThreads, 0, st>>>(
        ca, cp, static_cast<const int32_t*>(idx), oa, ob, n, ur, ua, unit_a,
        ub, unit_b);
  }
  return static_cast<int>(cudaGetLastError());
}

BUTD_PACKED(group_gather_launch)

// ------------------------------------------------- kernel 2: the MLP input

namespace {

constexpr int kTileThreads = 256;
// Output bytes a tile aims at, and the most a tile of whole centres may take.
constexpr int kTileTarget = 8192;
constexpr int kTileMax = 32768;
constexpr int kSmemMax = 227 * 1024;

// f32 -> bf16 bits, round to nearest even, every NaN to 0x7FC0: c10's
// scalar rule (c10::detail::round_to_nearest_even), denormals included.
__device__ __forceinline__ unsigned int bf16_bits_rn(float v) {
  const unsigned int u = __float_as_uint(v);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

struct MlpInputParams {
  const float* xyz;  // (batch, n, 3) f32 rows at any stride (elements)
  long long xyz_bstride, xyz_rstride;
  const float* centers;          // (batch * m, 3) f32
  const unsigned short* feats;   // (batch, n, c) bf16
  const void* idx;               // (batch * m * ns) int32 or int64
  unsigned short* out;           // (batch * m * ns, width) bf16
  float inv_r;
  int n, c, width;               // width = 3 + c
  unsigned int rows;             // batch * m * ns
  unsigned int tile_rows, tiles;
  unsigned int units;            // feature copy units a row
  unsigned int feat_stride;      // bytes of a staged feature row
  unsigned int out_bytes, feat_bytes, stage_bytes;  // a stage's parts
  FastDiv by_ns, by_batch_rows, by_width, by_row_units;
};

// Issue the copies of tile `tile` into `stage`.
template <typename Index, int kUnit>
__device__ __forceinline__ void mlp_input_gather(const MlpInputParams& p,
                                                 unsigned int tile,
                                                 unsigned char* stage) {
  const unsigned int row0 = tile * p.tile_rows;
  const unsigned int nrows = min(p.tile_rows, p.rows - row0);
  const unsigned int per_row = 3 + p.units;
  unsigned char* feat_s = stage + p.out_bytes;
  float* xyz_s = reinterpret_cast<float*>(stage + p.out_bytes + p.feat_bytes);
  const Index* idx = static_cast<const Index*>(p.idx);
  for (unsigned int u = threadIdx.x; u < nrows * per_row; u += kTileThreads) {
    const unsigned int r = fdiv(u, p.by_row_units);
    const unsigned int k = u - r * per_row;
    const unsigned int gr = row0 + r;
    const long long i = idx[gr];
    const long long b = fdiv(gr, p.by_batch_rows);
    const bool valid = i >= 0 && i < p.n;
    if (k < 3) {
      const float* src =
          valid ? p.xyz + b * p.xyz_bstride + i * p.xyz_rstride + k : p.xyz;
      cp_async_zfill<4>(xyz_s + r * 3 + k, src, valid);
    } else if constexpr (kUnit >= 4) {
      const unsigned int f = k - 3;
      const unsigned char* src =
          valid ? reinterpret_cast<const unsigned char*>(
                      p.feats + (b * p.n + i) * p.c) +
                      f * kUnit
                : reinterpret_cast<const unsigned char*>(p.feats);
      cp_async_zfill<kUnit>(feat_s + r * p.feat_stride + f * kUnit, src,
                            valid);
    } else {
      const unsigned int f = k - 3;
      reinterpret_cast<unsigned short*>(feat_s + r * p.feat_stride)[f] =
          valid ? __ldg(p.feats + (b * p.n + i) * p.c + f)
                : static_cast<unsigned short>(0);
    }
  }
}

// One element (flat index e of the tile) of the output, as bf16 bits.
__device__ __forceinline__ unsigned int mlp_input_element(
    const MlpInputParams& p, unsigned int row0, const unsigned char* stage,
    unsigned int e) {
  const unsigned int r = fdiv(e, p.by_width);
  const unsigned int col = e - r * p.width;
  if (col < 3) {
    const float* xyz_s =
        reinterpret_cast<const float*>(stage + p.out_bytes + p.feat_bytes);
    const unsigned int centre = fdiv(row0 + r, p.by_ns);
    const float c = __ldg(p.centers + 3ll * centre + col);
    return bf16_bits_rn(__fmul_rn(__fsub_rn(xyz_s[r * 3 + col], c), p.inv_r));
  }
  return reinterpret_cast<const unsigned short*>(
      stage + p.out_bytes + r * p.feat_stride)[col - 3];
}

// The tile's output rows in shared memory, as 4-byte words of two bf16
// elements (the tile's bytes from 0). Three forms by the row's shape:

// Rows whose features were staged in 4-byte units or wider (sa2-sa4): the
// words holding two features of one row are copied by a warp a row, each
// one aligned 4-byte read or two and a byte permute (a row of odd width
// starts its features on a half word every other row); the few words that
// hold an xyz element, one a row or two, and a last half word, element by
// element.
__device__ __forceinline__ void epilogue_wide(const MlpInputParams& p,
                                              unsigned int row0,
                                              unsigned int nrows,
                                              unsigned char* stage) {
  unsigned int* out_w = reinterpret_cast<unsigned int*>(stage);
  const unsigned int W = p.width, C = p.c;
  const unsigned int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (unsigned int r = warp; r < nrows; r += kTileThreads / 32) {
    const unsigned int a = r * W + 3;  // half word of the row's feature 0
    const unsigned int* frow = reinterpret_cast<const unsigned int*>(
        stage + p.out_bytes + r * p.feat_stride);
    for (unsigned int k = (a + 1) / 2 + lane; k < (a + C) / 2; k += 32) {
      const unsigned int f = 2 * k - a;
      out_w[k] = (a & 1) ? __byte_perm(frow[f >> 1], frow[(f >> 1) + 1],
                                       0x5432)
                         : frow[f >> 1];
    }
  }
  for (unsigned int r = threadIdx.x; r < nrows; r += kTileThreads) {
    for (unsigned int k = r * W / 2; k <= (r * W + 2) / 2; ++k) {
      out_w[k] = mlp_input_element(p, row0, stage, 2 * k) |
                 (mlp_input_element(p, row0, stage, 2 * k + 1) << 16);
    }
  }
  const unsigned int elems = nrows * W;
  if (threadIdx.x == 0 && (elems & 1)) {
    out_w[elems / 2] = mlp_input_element(p, row0, stage, elems - 1);
  }
}

// Narrow rows of an even width (sa1: 3 + 3): a thread a row, its words
// whole.
__device__ __forceinline__ void epilogue_narrow(const MlpInputParams& p,
                                                unsigned int row0,
                                                unsigned int nrows,
                                                unsigned char* stage) {
  unsigned int* out_w = reinterpret_cast<unsigned int*>(stage);
  const unsigned int half = p.width / 2;
  const float* xyz_s =
      reinterpret_cast<const float*>(stage + p.out_bytes + p.feat_bytes);
  for (unsigned int r = threadIdx.x; r < nrows; r += kTileThreads) {
    const float* cs = p.centers + 3ll * fdiv(row0 + r, p.by_ns);
    unsigned int v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = bf16_bits_rn(
          __fmul_rn(__fsub_rn(xyz_s[r * 3 + c], __ldg(cs + c)), p.inv_r));
    }
    const unsigned short* fr = reinterpret_cast<const unsigned short*>(
        stage + p.out_bytes + r * p.feat_stride);
    unsigned int* ow = out_w + r * half;
    ow[0] = v[0] | (v[1] << 16);
    ow[1] = v[2] | (static_cast<unsigned int>(fr[0]) << 16);
    for (unsigned int q = 2; q < half; ++q) {
      ow[q] = fr[2 * q - 3] | (static_cast<unsigned int>(fr[2 * q - 2]) << 16);
    }
  }
}

// Any other shape: a word a thread, element by element.
__device__ __forceinline__ void epilogue_any(const MlpInputParams& p,
                                             unsigned int row0,
                                             unsigned int elems,
                                             unsigned char* stage) {
  unsigned int* out_w = reinterpret_cast<unsigned int*>(stage);
  for (unsigned int w = threadIdx.x; w < (elems + 1) / 2; w += kTileThreads) {
    const unsigned int e = 2 * w;
    const unsigned int lo = mlp_input_element(p, row0, stage, e);
    const unsigned int hi =
        e + 1 < elems ? mlp_input_element(p, row0, stage, e + 1) : 0u;
    out_w[w] = lo | (hi << 16);
  }
}

template <typename Index, int kUnit>
__global__ void __launch_bounds__(kTileThreads)
group_gather_mlp_input_kernel(const MlpInputParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int tile = blockIdx.x;
  if (tile >= p.tiles) return;
  mlp_input_gather<Index, kUnit>(p, tile, smem);
  cp_async_commit();
  for (unsigned int it = 0; tile < p.tiles; ++it) {
    const unsigned int next = tile + gridDim.x;
    unsigned char* stage = smem + (it & 1) * p.stage_bytes;
    if (next < p.tiles) {
      mlp_input_gather<Index, kUnit>(p, next,
                                     smem + ((it + 1) & 1) * p.stage_bytes);
    }
    cp_async_commit();  // possibly empty: the wait below stays uniform
    cp_async_wait_all_but_one();
    // the bulk store that last read this stage's output tile is done
    if (threadIdx.x == 0) bulk_wait_read_all_but_one();
    __syncthreads();

    const unsigned int row0 = tile * p.tile_rows;
    const unsigned int nrows = min(p.tile_rows, p.rows - row0);
    const unsigned int elems = nrows * p.width;
    if (kUnit >= 4) {
      epilogue_wide(p, row0, nrows, stage);
    } else if ((p.width & 1) == 0) {
      epilogue_narrow(p, row0, nrows, stage);
    } else {
      epilogue_any(p, row0, elems, stage);
    }
    fence_proxy_async_shared();
    __syncthreads();

    const unsigned int bytes = 2 * elems;
    const unsigned int bulk = bytes & ~15u;
    unsigned char* gdst = reinterpret_cast<unsigned char*>(p.out) +
                          2ll * row0 * p.width;
    if (threadIdx.x == 0 && bulk) bulk_store(gdst, stage, bulk);
    if (threadIdx.x < (bytes - bulk) / 2) {
      reinterpret_cast<unsigned short*>(gdst + bulk)[threadIdx.x] =
          reinterpret_cast<const unsigned short*>(stage + bulk)[threadIdx.x];
    }
    tile = next;
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

unsigned int round16(unsigned long long x) {
  return static_cast<unsigned int>((x + 15) / 16 * 16);
}

unsigned long long gcd_ull(unsigned long long a, unsigned long long b) {
  while (b) {
    const unsigned long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Rows a tile and the shared memory of one stage for rows of `width` bf16
// elements whose features are staged at `feat_stride` bytes a row.
void plan_tile(int ns, int width, unsigned int feat_stride,
               unsigned int* tile_rows, unsigned int* out_bytes,
               unsigned int* feat_bytes, unsigned int* stage_bytes) {
  const unsigned long long row_bytes = 2ull * width;
  unsigned long long base = 8 / gcd_ull(8, ns) * ns;  // lcm(ns, 8)
  if (base * row_bytes > kTileMax) base = 8;
  unsigned long long rows = base * (kTileTarget / (base * row_bytes) > 0
                                        ? kTileTarget / (base * row_bytes)
                                        : 1);
  for (;;) {
    *out_bytes = round16(rows * row_bytes);
    *feat_bytes = round16(rows * feat_stride);
    *stage_bytes = *out_bytes + *feat_bytes + round16(rows * 12);
    if (2ull * *stage_bytes <= kSmemMax || rows == 8) break;
    rows = 8;
  }
  *tile_rows = static_cast<unsigned int>(rows);
}

template <typename Index, int kUnit>
cudaError_t launch_mlp_input(const MlpInputParams& p, int device,
                             cudaStream_t st) {
  static int sms[64] = {0};
  static unsigned int smem_set[64] = {0};
  const unsigned int smem = 2 * p.stage_bytes;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  if (smem > 48 * 1024 && smem > smem_set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_gather_mlp_input_kernel<Index, kUnit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set[device] = smem;
  }
  // blocks resident on an SM by shared memory (1 KB reserved a block), at
  // most the 2048 threads an SM holds
  unsigned int per_sm = (228u * 1024) / (smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  const unsigned int grid =
      std::min(p.tiles, per_sm * static_cast<unsigned int>(sms[device]));
  group_gather_mlp_input_kernel<Index, kUnit>
      <<<grid, kTileThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename Index>
cudaError_t launch_mlp_input_unit(const MlpInputParams& p, int unit,
                                  int device, cudaStream_t st) {
  switch (unit) {
    case 16: return launch_mlp_input<Index, 16>(p, device, st);
    case 8: return launch_mlp_input<Index, 8>(p, device, st);
    case 4: return launch_mlp_input<Index, 4>(p, device, st);
    default: return launch_mlp_input<Index, 2>(p, device, st);
  }
}

}  // namespace

// xyz: (batch, n, 3) f32 with the last dimension contiguous, a batch stride
// and a row stride in elements; centers: (batch, m, 3) f32 contiguous;
// feats: (batch, n, c) bf16 contiguous, c >= 1; idx: (batch, m, ns) int32
// or, with idx64, int64, contiguous; out: (batch, m, ns, 3 + c) bf16,
// contiguous, 16-byte aligned. batch * m * ns < 2^31, n < 2^31. Returns
// cudaErrorInvalidValue when two stages of 8 rows exceed shared memory
// (c above about 3,500).
extern "C" int group_mlp_input_launch(int device, const void* xyz,
                                      long long xyz_bstride,
                                      long long xyz_rstride,
                                      const void* centers, const void* feats,
                                      const void* idx, int idx64, void* out,
                                      int batch, int n, int m, int ns, int c,
                                      float inv_r, void* stream) {
  const unsigned long long rows =
      static_cast<unsigned long long>(batch) * m * ns;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (c < 1 || rows >= (1ull << 31) ||
      reinterpret_cast<unsigned long long>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpInputParams p;
  p.xyz = static_cast<const float*>(xyz);
  p.xyz_bstride = xyz_bstride;
  p.xyz_rstride = xyz_rstride;
  p.centers = static_cast<const float*>(centers);
  p.feats = static_cast<const unsigned short*>(feats);
  p.idx = idx;
  p.out = static_cast<unsigned short*>(out);
  p.inv_r = inv_r;
  p.n = n;
  p.c = c;
  p.width = 3 + c;
  p.rows = static_cast<unsigned int>(rows);
  const unsigned long long row_feat = 2ull * c;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(feats);
  int unit = 2;
  for (int u : {16, 8, 4}) {
    if ((row_feat | addr) % u == 0) {
      unit = u;
      break;
    }
  }
  p.units = static_cast<unsigned int>(row_feat / unit);
  p.feat_stride = static_cast<unsigned int>(row_feat);
  plan_tile(ns, p.width, p.feat_stride, &p.tile_rows, &p.out_bytes,
            &p.feat_bytes, &p.stage_bytes);
  if (2ull * p.stage_bytes > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tiles = static_cast<unsigned int>((rows + p.tile_rows - 1) / p.tile_rows);
  p.by_ns = make_fastdiv(static_cast<unsigned int>(ns));
  p.by_batch_rows = make_fastdiv(static_cast<unsigned int>(m) * ns);
  p.by_width = make_fastdiv(static_cast<unsigned int>(p.width));
  p.by_row_units = make_fastdiv(3 + p.units);
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      idx64 ? launch_mlp_input_unit<int64_t>(p, unit, device, st)
            : launch_mlp_input_unit<int32_t>(p, unit, device, st));
}

BUTD_PACKED(group_mlp_input_launch)
BUTD_ERROR_STRING(group_gather)
