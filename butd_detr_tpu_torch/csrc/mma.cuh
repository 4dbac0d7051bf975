// Tensor-core helpers of the attention kernels (attention.cu, forward;
// attention_bwd.cu, backward), in their default (bf16-operand) mode: a
// product is mma.sync.m16n8k16 with bf16 operands read from shared memory
// by ldmatrix and an f32 accumulator; tiles of f32 rows are staged by
// cp.async and rounded to bf16 in shared memory, tiles of bf16 rows are
// copied by cp.async into their bf16 tile as they are, the head dimension
// zero-padded to the mma depth DP (16, 32, 48 or 64).
#pragma once

#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

constexpr int kMaxD = 64;               // largest head dimension
constexpr float kMaskValue = -FLT_MAX;  // torch.finfo(float32).min

// A (B, H, L, Dh) f32 view: batch, head and row strides in elements; the
// head dimension has unit stride.
struct Strides {
  long long b, h, l;
};

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlockRows = 16 * kMmaWarps;  // rows (or keys) a block owns
constexpr int kTile = 64;                   // keys (or rows) a staged tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i of a lane holds its row lane / 4, columns
// 2 (lane % 4) and 2 (lane % 4) + 1 (.trans: that column pair's rows).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B (column
// fragment) and a 16x8 f32 accumulator. With g = lane / 4, t = lane % 4:
// a[0] = A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..],
// a[3] = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// d[0..1] = D[g][2t, 2t+1], d[2..3] = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, `lo` in the low half: the pair (2t, 2t + 1).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16x16 tile whose two 16x8 halves are accumulators:
// the accumulator layout of columns (2t, 2t + 1) is the A layout.
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4],
                                           const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// The next tile's loads are issued as cp.async copies of the f32 rows into
// a staging area of shared memory, so that they fly while this tile's
// products run without holding registers; after the products each thread
// waits for its own copies and rounds exactly the slots it copied to bf16
// (after scaling) into the other tile buffer, whose rows have a stride of
// DP + 8 (16-byte aligned rows whose ldmatrix phases hit distinct banks).
// A thread never reads another's staged slots, so the pipeline needs one
// barrier a tile. Rows >= len and columns >= dh arrive as zeros (cp.async
// zero-fills what its source size leaves out).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

template <int DP>
struct TileCopy {
  static constexpr int kSlots = kTile * DP / 4 / kMmaThreads;  // DP / 8

  // a thread's slot i: 4 consecutive columns of one row
  static __device__ __forceinline__ int row(int i) {
    return (threadIdx.x + i * kMmaThreads) / (DP / 4);
  }
  static __device__ __forceinline__ int col(int i) {
    return (threadIdx.x + i * kMmaThreads) % (DP / 4) * 4;
  }

  // `vec`: 16-byte copies (dh % 4 == 0 and every row 16-byte aligned),
  // else 4-byte copies
  static __device__ __forceinline__ void issue(float* stage,
                                               const float* base,
                                               long long ld, int r0, int len,
                                               int dh, bool vec) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = row(i), c = col(i);
      float* dst = stage + r * DP + c;
      const float* src = base + (r0 + r) * ld + c;
      const bool in = r0 + r < len;
      if (vec) {
        const bool ok = in && c < dh;
        cp_async16(dst, ok ? src : base, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && c + e < dh;
          cp_async4(dst + e, ok ? src + e : base, ok ? 4 : 0);
        }
      }
    }
  }

  static __device__ __forceinline__ void convert(const float* stage,
                                                 __nv_bfloat16* s,
                                                 float mul) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = row(i), c = col(i);
      const float4 x = *reinterpret_cast<const float4*>(stage + r * DP + c);
      uint2 w;
      w.x = pack_bf16(x.x * mul, x.y * mul);
      w.y = pack_bf16(x.z * mul, x.w * mul);
      *reinterpret_cast<uint2*>(s + r * (DP + 8) + c) = w;
    }
  }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// A tile of rows of element type T into its bf16 tile `s` (row stride
// DP + 8), scaled by `mul` on the way: issue() starts the loads, land()
// finishes them once the thread's copies have arrived (cp_async_wait_all).
// f32 rows pass through the f32 staging area and are rounded in land()
// (TileCopy). bf16 rows are copied into `s` as they are: 8 bytes (4
// columns) a cp.async where `vec` (dh % 4 == 0 and every row 8-byte
// aligned), else one plain load a column; land() rescales only where
// mul != 1 (q' = bf16(f32(q) * scale): the f32 path's bits for the same
// values). Rows >= len and columns >= dh arrive as zeros either way.
template <int DP, typename T>
struct TileLoad {
  static __device__ __forceinline__ void issue(float* stage,
                                               __nv_bfloat16* /*s*/,
                                               const T* base, long long ld,
                                               int r0, int len, int dh,
                                               bool vec) {
    TileCopy<DP>::issue(stage, base, ld, r0, len, dh, vec);
  }
  static __device__ __forceinline__ void land(const float* stage,
                                              __nv_bfloat16* s, float mul) {
    TileCopy<DP>::convert(stage, s, mul);
  }
};

template <int DP>
struct TileLoad<DP, __nv_bfloat16> {
  using Copy = TileCopy<DP>;  // the same slots: 4 columns of one row

  static __device__ __forceinline__ void issue(float* /*stage*/,
                                               __nv_bfloat16* s,
                                               const __nv_bfloat16* base,
                                               long long ld, int r0, int len,
                                               int dh, bool vec) {
#pragma unroll
    for (int i = 0; i < Copy::kSlots; ++i) {
      const int r = Copy::row(i), c = Copy::col(i);
      __nv_bfloat16* dst = s + r * (DP + 8) + c;
      const __nv_bfloat16* src = base + (r0 + r) * ld + c;
      const bool in = r0 + r < len;
      if (vec) {
        const bool ok = in && c < dh;
        cp_async8(dst, ok ? src : base, ok ? 8 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = in && c + e < dh ? src[e] : __float2bfloat16_rn(0.f);
        }
      }
    }
  }

  static __device__ __forceinline__ void land(const float* /*stage*/,
                                              __nv_bfloat16* s, float mul) {
    if (mul == 1.f) return;
#pragma unroll
    for (int i = 0; i < Copy::kSlots; ++i) {
      uint2* at = reinterpret_cast<uint2*>(s + Copy::row(i) * (DP + 8) +
                                           Copy::col(i));
      const uint2 w = *at;
      uint2 o;
      o.x = pack_bf16(__uint_as_float(w.x << 16) * mul,
                      __uint_as_float(w.x & 0xffff0000u) * mul);
      o.y = pack_bf16(__uint_as_float(w.y << 16) * mul,
                      __uint_as_float(w.y & 0xffff0000u) * mul);
      *at = o;
    }
  }
};

// Shared memory of a kernel of this family: a staging area for two f32
// tiles (none for bf16 operands), two buffers of two bf16 tiles, then the
// kernel's small arrays.
template <int DP, typename T = float>
struct MmaSmem {
  static constexpr int kStage =  // floats
      sizeof(T) == sizeof(float) ? 2 * kTile * DP : 0;
  static constexpr int kBf16 = 2 * 2 * kTile * (DP + 8);  // bf16 values
  static constexpr size_t kBytes =
      kStage * sizeof(float) + kBf16 * sizeof(__nv_bfloat16) + 2048;
};

// ldmatrix addresses of a lane, for a tile stored [row][col] at stride S:
// the A fragment of rows r0.., columns c0..c0+15;
__device__ __forceinline__ int a_offset(int lane, int r0, int c0, int S) {
  return (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8;
}
// the B fragments of two 8-wide n tiles n0, n0 + 8 over k = c0..c0+15
// when the tile is stored [n][k] (non-transposed load);
__device__ __forceinline__ int b_offset(int lane, int n0, int c0, int S) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * S + c0 +
         ((lane >> 3) & 1) * 8;
}
// the B fragments of n tiles c0, c0 + 8 over k = k0..k0+15 when the tile is
// stored [k][n] (transposed load).
__device__ __forceinline__ int bt_offset(int lane, int k0, int c0, int S) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + c0 +
         (lane >> 4) * 8;
}

// Whether a view's rows all start on a 16-byte boundary (the 16-byte
// cp.async path of f32 rows).
inline bool aligned16(const void* p, long long sb, long long sh,
                      long long sl) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && sl % 4 == 0;
}

// Whether every 4 columns of a bf16 view start on an 8-byte boundary (the
// 8-byte cp.async path of bf16 rows), given dh % 4 == 0.
inline bool aligned8_bf16(const void* p, long long sb, long long sh,
                          long long sl) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && sl % 4 == 0;
}

// The padded head dimension of the mma kernels: Dh 36 -> 48.
inline int mma_depth(int dh) { return (dh + 15) / 16 * 16; }

// MmaSmem's bytes at head dimension `dh`, f32 or (`bf16`) bf16 operands.
inline size_t mma_smem_bytes(int dh, int bf16) {
  switch (mma_depth(dh)) {
    case 16: return bf16 ? MmaSmem<16, __nv_bfloat16>::kBytes
                         : MmaSmem<16>::kBytes;
    case 32: return bf16 ? MmaSmem<32, __nv_bfloat16>::kBytes
                         : MmaSmem<32>::kBytes;
    case 48: return bf16 ? MmaSmem<48, __nv_bfloat16>::kBytes
                         : MmaSmem<48>::kBytes;
    default: return bf16 ? MmaSmem<64, __nv_bfloat16>::kBytes
                         : MmaSmem<64>::kBytes;
  }
}
