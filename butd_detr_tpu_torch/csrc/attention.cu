// Attention forward for Hopper (sm_90a): softmax(scale * Q K^T) V.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_attention.py:_fwd_kernel
// (through _attend_fwd / fused_attention). Semantics kept from it:
//   * padded keys get FINFO_MIN (not -inf), so a fully masked row comes
//     out uniform over the keys, as in torch nn.MultiheadAttention;
//   * q is scaled in f32 first; in the default mode the scaled q, k and v
//     are rounded to bf16, scores and the softmax are f32, and the
//     normalized P is rounded to bf16 before P V with f32 accumulation
//     (pallas_attention.py:270-278, :101-107); the precise mode keeps f32
//     throughout;
//   * dropout (training) acts on the NORMALIZED P, before its bf16
//     rounding: an entry is kept iff its random bits >= min(int(p * 2^32),
//     2^32 - 1) and kept entries are scaled by 1 / (1 - p)
//     (pallas_attention.py:84-107). The bits come from Philox4x32-10
//     (common.cuh), keyed by the seed and counted by the absolute
//     (batch * heads + head, query row, key / 4), not by a tile: the TPU
//     seeds its stateful generator per (B * H, q-block), which is not
//     carried over. The backward kernels (attention_bwd.cu) and
//     attention_dropout_mask_launch below regenerate the same mask.
// Unlike the TPU wrapper, the head dimension is not padded to 128 and the
// key length is not padded to a multiple of 128: Dh <= 64 is a runtime
// value and the last key tile is masked, so no padded key ever enters a
// softmax. Normalizing P before its rounding needs the row's max and sum
// first, so both designs walk the keys twice; a one-walk online rescale
// would round unnormalized values, which gives other numbers.
//
// What bounds it on this card: the bytes of the work (q, k, v read and out
// written once): at the serving shapes a few microseconds. A small call
// is bound by its wrapper's host time instead (tens of microseconds).
//
// Default mode (bf16 operands), attention_fwd_mma_kernel<DP, DROPOUT, T>:
// both products are exactly bf16 x bf16 products with f32 accumulation and
// run on the tensor cores (mma.sync.m16n8k16 from ldmatrix, mma.cuh). Grid
// (Lq / 64, B * H), 4 warps x 16 query rows. q' = bf16(scale q) is loaded
// once and kept in registers as mma A fragments. K and V pass in tiles of
// 64 keys, double-buffered. The operands' element type T is f32 or bf16
// (the bf16 model's projections): f32 rows pass through cp.async f32
// staging rounded to bf16 in shared memory (4-byte copies where a row is
// not 16-byte aligned), bf16 rows are copied by cp.async straight into
// their bf16 tile (8-byte copies; plain loads where a row is not 8-byte
// aligned), and q' is rounded from f32(q) * scale either way, so bf16
// operands give the bits of f32 operands holding the same values
// (mma.cuh:TileLoad). The head dimension is zero-padded to DP =
// 16/32/48/64. Walk 1 reads K only:
// S = q'K^T, and each thread keeps an online row max and sum over its
// columns, merged over the 4 threads of a row once, in a fixed order (two
// runs are bit-equal). Walk 2 recomputes S, forms P = e^(s - m) / l, drops
// it by the warp's keep bits (staged in shared memory, one Philox call per
// group of 4 keys), and turns the accumulator into the A operand of P V,
// with V the B operand by ldmatrix.trans; O accumulates in f32 registers
// and is stored into the (B, L, H, Dh) output buffer. On an H100 SXM
// ("NVIDIA H100 80GB HBM3, 700.00 W", scripts/profile_torch_fps_attention.py)
// visual self-attention 1024^2, Dh 36 takes 0.052 ms of device time at
// B = 1 (the CUDA-core design: 0.226 ms a call) and 0.21 ms at B = 8,
// against SDPA's 0.62.
//
// Precise mode (f32), attention_fwd_f32_kernel<DROPOUT>: CUDA cores (TF32
// would break its bound). Grid (Lq / 16, B * H), 4 warps x 4 query rows;
// tiles of 64 keys through shared memory; walk 1 keeps an online row max
// and sum (lanes split the keys, then a butterfly merge); walk 2
// recomputes each score, normalizes it and stages the tile's P row in
// shared memory, from which each lane accumulates its own output columns
// (d = lane, lane + 32) over the keys in order.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ============================================ default mode: tensor cores

template <int DP, bool DROPOUT, typename T>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const T* __restrict__ q, Strides qs,
                         const T* __restrict__ k, Strides ks,
                         const T* __restrict__ v, Strides vs,
                         const unsigned char* __restrict__ pad,
                         float* __restrict__ out, Strides os, int heads,
                         int lq, int lk, int dh, float scale, Dropout dr,
                         bool vec) {
  constexpr int S = DP + 8;
  constexpr int KD = DP / 16;  // k steps over the head dimension
  constexpr int ND = DP / 8;   // n tiles over the head dimension
  using Load = TileLoad<DP, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage_k = reinterpret_cast<float*>(smem);  // f32 operands only
  float* stage_v = stage_k + kTile * DP;
  __nv_bfloat16 (*kv_s)[2][kTile * S] =  // [buf][K, V]
      reinterpret_cast<__nv_bfloat16 (*)[2][kTile * S]>(
          stage_k + MmaSmem<DP, T>::kStage);
  unsigned int (*keep_s)[16][kTile / 32] =  // a bit a key
      reinterpret_cast<unsigned int (*)[16][kTile / 32]>(kv_s + 2);
  unsigned char (*pad_s)[kTile] =
      reinterpret_cast<unsigned char (*)[kTile]>(keep_s + kMmaWarps);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const unsigned char* padp = pad ? pad + static_cast<long long>(b) * lk
                                  : nullptr;

  // q' = bf16(scale q) of the block's rows, through buffer 1, kept as A
  // fragments
  Load::issue(stage_k, kv_s[1][0], qp, qs.l, q0, lq, dh, vec);
  cp_async_wait_all();
  Load::land(stage_k, kv_s[1][0], scale);
  unsigned char pad_r = 0;
  // the first walk reads only K; the second K and V. A tile is issued
  // towards buffer `buf` and lands there.
  auto issue_kv = [&](int t0, int buf, bool with_v) {
    Load::issue(stage_k, kv_s[buf][0], kp, ks.l, t0, lk, dh, vec);
    if (with_v) Load::issue(stage_v, kv_s[buf][1], vp, vs.l, t0, lk, dh, vec);
    if (tid < kTile) pad_r = (padp && t0 + tid < lk) ? padp[t0 + tid] : 0;
  };
  auto land_kv = [&](int buf, bool with_v) {
    cp_async_wait_all();
    Load::land(stage_k, kv_s[buf][0], 1.f);
    if (with_v) Load::land(stage_v, kv_s[buf][1], 1.f);
    if (tid < kTile) pad_s[buf][tid] = pad_r;
  };
  issue_kv(0, 0, false);
  land_kv(0, false);
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qa[kk], kv_s[1][0] + a_offset(lane, warp * 16, kk * 16, S));
  }
  __syncthreads();  // buffer 1 is free for the key tiles

  // rows g (index 0) and g + 8 (index 1) of the warp's 16
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_r[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // S of the warp's 16 rows x keys 16 c .. 16 c + 15 of the tile in
  // buffer `buf` (keys t0 ..): -inf past the last key (no weight),
  // FINFO_MIN on a padded key
  auto scores = [&](int buf, int t0, int c, float (&sc)[2][4]) {
    const __nv_bfloat16* ks_ = kv_s[buf][0];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, ks_ + b_offset(lane, c * 16, kk * 16, S));
      mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
      mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = c * 16 + nt * 8 + 2 * t;  // elements 0, 2; +1: 1, 3
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = col + (e & 1);
        if (t0 + cc >= lk) {
          sc[nt][e] = -CUDART_INF_F;
        } else if (pad_s[buf][cc]) {
          sc[nt][e] = kMaskValue;
        }
      }
    }
  };

  // ---- walk 1: each thread's online row max and sum over its columns
  const int n_tiles = (lk + kTile - 1) / kTile;
  for (int s = 0; s < n_tiles; ++s) {
    const int buf = s & 1;
    const bool last = s + 1 == n_tiles;  // then walk 2's first tile, with V
    issue_kv(last ? 0 : (s + 1) * kTile, buf ^ 1, last);
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      float sc[2][4];
      scores(buf, s * kTile, c, sc);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float cm = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                               fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
        const float mn = fmaxf(m_r[hr], cm);
        if (mn == -CUDART_INF_F) continue;  // no key of this row here yet
        float ls = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          ls += __expf(sc[nt][2 * hr] - mn);
          ls += __expf(sc[nt][2 * hr + 1] - mn);
        }
        l_r[hr] = l_r[hr] * __expf(m_r[hr] - mn) + ls;
        m_r[hr] = mn;
      }
    }
    land_kv(buf ^ 1, last);
    __syncthreads();
  }
  // merge the 4 threads of each row: the max, then the rescaled sums
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float m = m_r[hr];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = l_r[hr] * __expf(m_r[hr] - m);  // 0 for a thread with no key
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    m_r[hr] = m;
    inv_l[hr] = 1.f / l;
  }

  // ---- walk 2: P = e^(s - m) / l, dropped, rounded, times V
  for (int s = 0; s < n_tiles; ++s) {
    const int buf = (n_tiles + s) & 1;
    const int t0 = s * kTile;
    if (s + 1 < n_tiles) issue_kv(t0 + kTile, buf ^ 1, true);
    if (DROPOUT) {
      // the keep bits of the warp's 16 rows x the tile's 64 keys: lane
      // (r, half) draws word `half` (keys 32 half ..) of row r, 8 groups
      // of 4 keys
      const int r = lane & 15, half = lane >> 4;
      const int row = q0 + warp * 16 + r;
      unsigned int w = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w |= keep4(dr, bh, row, (t0 >> 2) + half * 8 + i) << (4 * i);
      }
      keep_s[warp][r][half] = w;
      __syncwarp();
    }
    const __nv_bfloat16* vs_ = kv_s[buf][1];
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      float sc[2][4];
      scores(buf, t0, c, sc);
      float p[2][4];  // the A operand of P V
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c * 16 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float x = __expf(sc[nt][e] - m_r[hr]) * inv_l[hr];
          if (DROPOUT) {
            const unsigned int bits =
                keep_s[warp][g + 8 * hr][col >> 5] >> ((col & 31) + (e & 1));
            x *= (bits & 1u) ? dr.inv_keep : 0.f;
          }
          p[nt][e] = x;
        }
      }
      uint32_t a[4];
      accum_to_a(a, p);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs_ + bt_offset(lane, c * 16, nd * 8, S));
        mma_bf16(acc[nd], a, bv[0], bv[1]);
        mma_bf16(acc[nd + 1], a, bv[2], bv[3]);
      }
    }
    if (s + 1 < n_tiles) land_kv(buf ^ 1, true);
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + warp * 16 + g + 8 * hr;
    if (row >= lq) continue;
    float* op = out + b * os.b + h * os.h + row * os.l;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < dh) op[col] = acc[nd][2 * hr];
      if (col + 1 < dh) op[col + 1] = acc[nd][2 * hr + 1];
    }
  }
}

// ============================================ precise mode: CUDA cores

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kTileK = 64;               // keys per shared-memory tile

template <bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_f32_kernel(const float* __restrict__ q, Strides qs,
                         const float* __restrict__ k, Strides ks,
                         const float* __restrict__ v, Strides vs,
                         const unsigned char* __restrict__ pad,
                         float* __restrict__ out, Strides os, int heads,
                         int lq, int lk, int dh, float scale, Dropout dr) {
  __shared__ float q_s[kBlockQ][kMaxD];
  __shared__ float k_s[kTileK][kMaxD + 1];  // odd stride: no bank conflicts
  __shared__ float v_s[kTileK][kMaxD];
  __shared__ float p_s[kWarps][kRows][kTileK];
  __shared__ float drop_s[kWarps][kRows][kTileK];  // 1 / (1 - p) or 0
  __shared__ unsigned char pad_s[kTileK];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const unsigned char* padp = pad ? pad + static_cast<long long>(b) * lk
                                  : nullptr;

  for (int idx = tid; idx < kBlockQ * dh; idx += kWarps * 32) {
    const int r = idx / dh, d = idx % dh;
    const int row = q0 + r;
    q_s[r][d] = row < lq ? qp[row * qs.l + d] * scale : 0.f;
  }

  auto load_tile = [&](int t0, bool with_v) {
    for (int idx = tid; idx < kTileK * dh; idx += kWarps * 32) {
      const int j = idx / dh, d = idx % dh;
      const int key = t0 + j;
      const bool in = key < lk;
      k_s[j][d] = in ? kp[key * ks.l + d] : 0.f;
      if (with_v) v_s[j][d] = in ? vp[key * vs.l + d] : 0.f;
    }
    for (int j = tid; j < kTileK; j += kWarps * 32) {
      const int key = t0 + j;
      pad_s[j] = (padp && key < lk) ? padp[key] : 0;
    }
  };

  // scores of this warp's rows against key jj of the staged tile
  auto scores = [&](int jj, float (&s)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kd = k_s[jj][d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += q_s[warp * kRows + r][d] * kd;
    }
    if (pad_s[jj]) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = kMaskValue;
    }
  };

  // ---- pass 1: row max and row sum (online, merged across lanes)
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  for (int t0 = 0; t0 < lk; t0 += kTileK) {
    __syncthreads();
    load_tile(t0, false);
    __syncthreads();
    for (int jj = lane; jj < kTileK && t0 + jj < lk; jj += 32) {
      float s[kRows];
      scores(jj, s);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mn = fmaxf(m_run[r], s[r]);
        const float keep =
            m_run[r] == -CUDART_INF_F ? 0.f : l_run[r] * expf(m_run[r] - mn);
        l_run[r] = keep + expf(s[r] - mn);
        m_run[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l_run[r], off);
      const float mn = fmaxf(m_run[r], mo);
      const float a =
          m_run[r] == -CUDART_INF_F ? 0.f : l_run[r] * expf(m_run[r] - mn);
      const float c = mo == -CUDART_INF_F ? 0.f : lo * expf(mo - mn);
      l_run[r] = a + c;
      m_run[r] = mn;
    }
  }

  // ---- pass 2: normalized P times V
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kTileK) {
    __syncthreads();
    load_tile(t0, true);
    __syncthreads();
    if (DROPOUT) {
      // the warp's 4 rows x 16 groups of 4 keys: two Philox draws a lane
      for (int pi = lane; pi < kRows * (kTileK / 4); pi += 32) {
        const int r = pi / (kTileK / 4), g = pi % (kTileK / 4);
        const unsigned int bits =
            keep4(dr, bh, q0 + warp * kRows + r, (t0 >> 2) + g);
        float* dst = &drop_s[warp][r][g * 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[i] = (bits >> i) & 1u ? dr.inv_keep : 0.f;
      }
      __syncwarp();
    }
    for (int jj = lane; jj < kTileK; jj += 32) {
      float s[kRows];
      scores(jj, s);
      const bool in = t0 + jj < lk;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float p = expf(s[r] - m_run[r]) / l_run[r];
        if (DROPOUT) p *= drop_s[warp][r][jj];
        p_s[warp][r][jj] = in ? p : 0.f;
      }
    }
    __syncwarp();
    const int nk = min(kTileK, lk - t0);
    for (int j = 0; j < nk; ++j) {
      const float v0 = v_s[j][lane];
      const float v1 = v_s[j][lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = p_s[warp][r][j];
        acc[r][0] += pj * v0;
        acc[r][1] += pj * v1;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= lq) continue;
    float* op = out + b * os.b + h * os.h + row * os.l;
    if (lane < dh) op[lane] = acc[r][0];
    if (lane + 32 < dh) op[lane + 32] = acc[r][1];
  }
}

// keep[bh, row, key] = 1 iff the dropout of (seed, threshold) keeps that
// probability: the mask the kernels regenerate, written out so that the
// plain versions can be fed the kernels' own mask. One thread per 4 keys.
__global__ void attention_dropout_mask_kernel(unsigned char* __restrict__ keep,
                                              int lq, int lk,
                                              unsigned int drop_thresh,
                                              unsigned long long seed) {
  const int groups = (lk + 3) >> 2;
  const int bh = blockIdx.y;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(lq) * groups) return;
  const int row = static_cast<int>(t / groups);
  const int g = static_cast<int>(t % groups);
  const uint4 bits = dropout_bits(seed, bh, row, g);
  const unsigned int b4[4] = {bits.x, bits.y, bits.z, bits.w};
  unsigned char* dst =
      keep + (static_cast<long long>(bh) * lq + row) * lk + g * 4;
  for (int i = 0; i < 4 && g * 4 + i < lk; ++i) {
    dst[i] = b4[i] >= drop_thresh ? 1 : 0;
  }
}

// The default mode's kernel for one padded head dimension and operand type.
template <int DP, bool DROPOUT, typename T>
cudaError_t launch_mma(int device, dim3 grid, cudaStream_t st,
                       const void* q, Strides qs, const void* k, Strides ks,
                       const void* v, Strides vs, const unsigned char* pad,
                       float* out, Strides os, int heads, int lq, int lk,
                       int dh, float scale, Dropout dr, bool vec) {
  constexpr size_t smem = MmaSmem<DP, T>::kBytes;  // over the 48 KB default
  auto kernel = attention_fwd_mma_kernel<DP, DROPOUT, T>;
  // The limit is a property of a kernel on a device: set it once for this
  // instantiation on each device (a driver call on every launch would cost
  // more than a small launch itself).
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  const bool known = device >= 0 && device < kDevices;
  if (!known || !smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (known) smem_set[device] = true;
  }
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const T*>(q), qs, static_cast<const T*>(k), ks,
      static_cast<const T*>(v), vs, pad, out, os, heads, lq, lk, dh, scale,
      dr, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attention_dropout_mask_launch(int device, unsigned char* keep,
                                             int batch_heads, int lq, int lk,
                                             unsigned int drop_thresh,
                                             unsigned long long seed,
                                             void* stream) {
  const DeviceScope on(device);
  const long long threads = static_cast<long long>(lq) * ((lk + 3) >> 2);
  const dim3 grid(static_cast<unsigned int>((threads + 255) / 256),
                  batch_heads);
  attention_dropout_mask_kernel<<<grid, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      keep, lq, lk, drop_thresh, seed);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v: (B, H, L, Dh) views with the given (batch, head, row) strides
// and a unit-stride head dimension, f32, or bf16 where `bf16` (the default
// mode only); out: such an f32 view; pad: (B, Lk) bytes or null.
// drop_thresh == 0 runs without dropout (the serving path); otherwise an
// entry of the normalized P is kept iff its Philox bits >= drop_thresh and
// scaled by inv_keep. `precise` picks the f32 mode, else the bf16-operand
// mode.
extern "C" int attention_fwd_launch(
    int device, const void* q, long long qsb, long long qsh, long long qsl,
    const void* k, long long ksb, long long ksh, long long ksl,
    const void* v, long long vsb, long long vsh, long long vsl,
    const unsigned char* pad, float* out, long long osb, long long osh,
    long long osl, int batch, int heads, int lq, int lk, int dh, float scale,
    int precise, int bf16, unsigned int drop_thresh, float inv_keep,
    unsigned long long seed, void* stream) {
  if (dh > kMaxD || dh < 1 || (precise && bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      os{osb, osh, osl};
  const Dropout dr{drop_thresh, inv_keep, seed};
  if (precise) {
    const dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch * heads);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    if (drop_thresh) {
      attention_fwd_f32_kernel<true><<<grid, kWarps * 32, 0, st>>>(
          qf, qs, kf, ks, vf, vs, pad, out, os, heads, lq, lk, dh, scale, dr);
    } else {
      attention_fwd_f32_kernel<false><<<grid, kWarps * 32, 0, st>>>(
          qf, qs, kf, ks, vf, vs, pad, out, os, heads, lq, lk, dh, scale, dr);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((lq + kBlockRows - 1) / kBlockRows, batch * heads);
  const auto rows_aligned = bf16 ? aligned8_bf16 : aligned16;
  const bool vec = dh % 4 == 0 && rows_aligned(q, qsb, qsh, qsl) &&
                   rows_aligned(k, ksb, ksh, ksl) &&
                   rows_aligned(v, vsb, vsh, vsl);
#define BUTD_MMA_T(DP, DROPOUT, T)                                         \
  launch_mma<DP, DROPOUT, T>(device, grid, st, q, qs, k, ks, v, vs, pad,  \
                             out, os, heads, lq, lk, dh, scale, dr, vec)
#define BUTD_MMA(DP, DROPOUT)                                   \
  (bf16 ? BUTD_MMA_T(DP, DROPOUT, __nv_bfloat16)                \
        : BUTD_MMA_T(DP, DROPOUT, float))
#define BUTD_MMA_DP(DP) \
  (drop_thresh ? BUTD_MMA(DP, true) : BUTD_MMA(DP, false))
  cudaError_t err;
  switch (mma_depth(dh)) {
    case 16: err = BUTD_MMA_DP(16); break;
    case 32: err = BUTD_MMA_DP(32); break;
    case 48: err = BUTD_MMA_DP(48); break;
    default: err = BUTD_MMA_DP(64); break;
  }
#undef BUTD_MMA_DP
#undef BUTD_MMA
#undef BUTD_MMA_T
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the default mode's kernel takes at head
// dimension `dh`, with f32 or (`bf16`) bf16 operands (ptxas reports only
// static shared memory).
extern "C" int attention_fwd_smem_bytes(int dh, int bf16) {
  return static_cast<int>(mma_smem_bytes(dh, bf16));
}

BUTD_PACKED(attention_dropout_mask_launch)
BUTD_PACKED(attention_fwd_launch)
BUTD_ERROR_STRING(attention)
