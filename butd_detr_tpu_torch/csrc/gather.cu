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
// each output row written); there is no arithmetic. At the main paths'
// shapes (12- to 1,152-byte rows, 132 to 3,072 rows a scene) a call moves
// kilobytes and its time is the host's; at the f32 backbone's groupings
// (rows of 524 and 1,036 bytes, 32,768 rows a scene) it writes 137 MB.
//
// Design: a block owns a tile, a run of consecutive output rows of one
// batch element (blockIdx.y), about 16 KB of output, so that the tile is one
// contiguous span of the output:
//   index   the tile's indices are read once, one coalesced load, and kept
//           in shared memory as the byte offsets of their source rows (-1
//           for an index out of range);
//   gather  the rows are copied into shared memory with cp.async in the
//           widest granule (16, 8 or 4 bytes) that the row's bytes and
//           the two base pointers allow, zero-filled (src-size 0) for an
//           index out of range; 2-byte granules (bf16 rows of an odd width)
//           are plain loads. The tile sits in shared memory at the same
//           offset modulo 16 as its span in the output;
//   store   the span's 16-byte-aligned middle is written by one TMA bulk
//           store (cp.async.bulk.global.shared::cta), whatever the row's
//           width; the head and tail before and after it (under 16 bytes
//           each) by single granule stores.
// The copy moves bits, never values: -0.0, NaN payloads and denormals arrive
// unchanged. The index is read in the caller's type, int32 or int64 (the
// kernel is instantiated for both), so no cast kernel runs before it.
// The C entry makes the host's integer work: the granule, the tile, the
// size limits; the wrapper passes the row's bytes and the pointers.

#include <cstdint>

#include "common.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kTileBytes = 16384;  // output bytes a tile aims at
constexpr unsigned int kMaxTileRows = 1024;
constexpr unsigned int kMaxSmem = 232448;   // the most a block may take
constexpr unsigned int kMaxBatch = 65535;   // gridDim.y

struct GatherParams {
  const unsigned char* src;  // (batch, n, row_bytes)
  const void* idx;           // (batch, m) int32 or int64
  unsigned char* out;        // (batch, m, row_bytes)
  long long n, m;
  unsigned int row_bytes;
  unsigned int tile_rows;
  unsigned int units;        // granules a row
  FastDiv by_units;
  unsigned int offsets_bytes;  // shared bytes of the tile's row offsets
};

__host__ __device__ inline unsigned int align16(unsigned long long x) {
  return static_cast<unsigned int>((x + 15) & ~15ull);
}

template <int kGranule>
__device__ __forceinline__ void store_granule(unsigned char* dst,
                                              const unsigned char* src) {
  if constexpr (kGranule == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (kGranule == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (kGranule == 4) {
    *reinterpret_cast<unsigned int*>(dst) =
        *reinterpret_cast<const unsigned int*>(src);
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        *reinterpret_cast<const unsigned short*>(src);
  }
}

template <typename Index, int kGranule>
__global__ void __launch_bounds__(kThreads)
gather_tile_kernel(const GatherParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* offsets = reinterpret_cast<long long*>(smem);
  unsigned char* tile = smem + p.offsets_bytes;
  const long long b = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * p.tile_rows;
  const long long left = p.m - r0;
  const unsigned int rows =
      left < p.tile_rows ? static_cast<unsigned int>(left) : p.tile_rows;

  // index: one coalesced read, kept as the source rows' byte offsets
  const Index* idx = static_cast<const Index*>(p.idx) + b * p.m + r0;
  for (unsigned int t = threadIdx.x; t < rows; t += kThreads) {
    const long long j = idx[t];
    offsets[t] = (j >= 0 && j < p.n)
                     ? (b * p.n + j) * static_cast<long long>(p.row_bytes)
                     : -1;
  }
  // the tile's span of the output, placed in shared memory at the same
  // offset modulo 16
  unsigned char* gdst =
      p.out + (b * p.m + r0) * static_cast<long long>(p.row_bytes);
  const unsigned long long g0 = reinterpret_cast<unsigned long long>(gdst);
  const unsigned int lead = static_cast<unsigned int>(g0 & 15);
  unsigned char* stage = tile + lead;
  __syncthreads();

  // gather
  const unsigned int total = rows * p.units;
  for (unsigned int u = threadIdx.x; u < total; u += kThreads) {
    const unsigned int t = fdiv(u, p.by_units);
    const unsigned int k = u - t * p.units;
    const long long off = offsets[t];
    unsigned char* dst = stage + t * p.row_bytes + k * kGranule;
    if constexpr (kGranule >= 4) {
      // an index out of range reads nothing (src-size 0) from a valid
      // address: the output's base, since the source may be empty
      cp_async_zfill<kGranule>(
          dst, off < 0 ? p.out : p.src + off + k * kGranule, off >= 0);
    } else {
      *reinterpret_cast<unsigned short*>(dst) =
          off < 0 ? static_cast<unsigned short>(0)
                  : __ldg(reinterpret_cast<const unsigned short*>(
                              p.src + off) + k);
    }
  }
  if constexpr (kGranule >= 4) {
    cp_async_commit();
    cp_async_wait_none();
  }
  fence_proxy_async_shared();
  __syncthreads();

  // store: the aligned middle [a0, a1) in one bulk store (thread 0), the
  // head [g0, a0) by warp 1 and the tail [a1, g1) by warp 2
  const unsigned long long g1 =
      g0 + static_cast<unsigned long long>(rows) * p.row_bytes;
  unsigned long long a0 = (g0 + 15) & ~15ull, a1 = g1 & ~15ull;
  if (a1 <= a0) a0 = a1 = g1;  // no aligned 16 bytes: all of it the head
  if (threadIdx.x == 0 && a1 > a0) {
    bulk_store(reinterpret_cast<void*>(a0), tile + (a0 - (g0 - lead)),
               static_cast<unsigned int>(a1 - a0));
  }
  const unsigned int head = static_cast<unsigned int>(a0 - g0) / kGranule;
  const unsigned int tail = static_cast<unsigned int>(g1 - a1) / kGranule;
  const unsigned int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w == 1 && lane < head) {
    const unsigned int o = lane * kGranule;
    store_granule<kGranule>(gdst + o, stage + o);
  } else if (w == 2 && lane < tail) {
    const unsigned int o = static_cast<unsigned int>(a1 - g0) +
                           lane * kGranule;
    store_granule<kGranule>(gdst + o, stage + o);
  }
  if (threadIdx.x == 0 && a1 > a0) bulk_wait_read_all();
}

template <typename Index, int kGranule>
cudaError_t launch_tiles(const GatherParams& p, int batch, int device,
                         unsigned int smem, cudaStream_t st) {
  auto kernel = gather_tile_kernel<Index, kGranule>;
  // The limit is a property of a kernel on a device: raised once for each
  // instantiation on each device, and only past the default 48 KB.
  constexpr int kDevices = 64;
  static unsigned int smem_set[kDevices] = {};
  if (smem > 48 * 1024) {
    if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
    if (smem_set[device] < kMaxSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmem));
      if (e != cudaSuccess) return e;
      smem_set[device] = kMaxSmem;
    }
  }
  const unsigned long long tiles =
      (static_cast<unsigned long long>(p.m) + p.tile_rows - 1) / p.tile_rows;
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(batch));
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename Index>
cudaError_t launch_granule(const GatherParams& p, int granule, int batch,
                           int device, unsigned int smem, cudaStream_t st) {
  switch (granule) {
    case 16: return launch_tiles<Index, 16>(p, batch, device, smem, st);
    case 8: return launch_tiles<Index, 8>(p, batch, device, smem, st);
    case 4: return launch_tiles<Index, 4>(p, batch, device, smem, st);
    default: return launch_tiles<Index, 2>(p, batch, device, smem, st);
  }
}

}  // namespace

// src: (batch, n, row) contiguous, idx: (batch, m) int32 or, with idx64,
// int64, contiguous, out: (batch, m, row) contiguous; a row is row_bytes
// bytes, and row_bytes and both pointers are even. Returns kRefused,
// launching nothing, where a limit is passed: batch above 65535, m above
// 2^31 - 1 tiles, or a row that does not fit a block's shared memory (about
// 227 KB); nothing is launched for an empty output.
extern "C" int gather_launch(int device, const void* src, const void* idx,
                             int idx64, void* out, int batch, long long n,
                             long long m, long long row_bytes, void* stream) {
  if (batch <= 0 || m <= 0 || row_bytes <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const unsigned long long bits =
      static_cast<unsigned long long>(row_bytes) |
      reinterpret_cast<unsigned long long>(src) |
      reinterpret_cast<unsigned long long>(out);
  const int granule = bits % 16 == 0 ? 16
                      : bits % 8 == 0 ? 8
                      : bits % 4 == 0 ? 4
                                      : 2;
  if (bits % 2 != 0 || batch > static_cast<int>(kMaxBatch) ||
      row_bytes + 16 + 16 > kMaxSmem) {
    return kRefused;
  }
  GatherParams p;
  p.src = static_cast<const unsigned char*>(src);
  p.idx = idx;
  p.out = static_cast<unsigned char*>(out);
  p.n = n;
  p.m = m;
  p.row_bytes = static_cast<unsigned int>(row_bytes);
  unsigned long long rows = kTileBytes / p.row_bytes;
  rows = rows < 1 ? 1 : (rows > kMaxTileRows ? kMaxTileRows : rows);
  if (rows > static_cast<unsigned long long>(m)) rows = m;
  // the offsets and the tile (16 bytes of slack for its lead) must fit
  while (align16(8 * rows) + rows * p.row_bytes + 16 > kMaxSmem) --rows;
  if ((static_cast<unsigned long long>(m) + rows - 1) / rows >= (1ull << 31)) {
    return kRefused;
  }
  p.tile_rows = static_cast<unsigned int>(rows);
  p.units = p.row_bytes / granule;
  p.by_units = make_fastdiv(p.units);
  p.offsets_bytes = align16(8 * rows);
  const unsigned int smem = align16(p.offsets_bytes + rows * p.row_bytes + 16);
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      idx64 ? launch_granule<int64_t>(p, granule, batch, device, smem, st)
            : launch_granule<int32_t>(p, granule, batch, device, smem, st));
}

BUTD_PACKED(gather_launch)
BUTD_ERROR_STRING(gather)
