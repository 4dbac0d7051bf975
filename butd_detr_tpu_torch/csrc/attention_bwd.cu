// Attention backward for Hopper (sm_90a): dQ, dK, dV from dO.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_attention.py:_bwd_kernel
// (through _attend_bwd). Nothing but q, k, v, the key-padding mask and the
// dropout seed is saved by the forward; S, P and the dropout mask D (keep /
// (1 - p)) are recomputed here, in the TPU kernel's order of operations:
//   P   = softmax(q' K^T) with FINFO_MIN on padded keys (q' = scale * q)
//   dPt = D o (dO V^T)
//   dS  = P o (dPt - rowsum(dPt o P))
//   dQ' = dS K        dK = dS^T q'        dV = (D o P)^T dO
// In the default mode q', k, v and dO are rounded to bf16 on load, P and the
// row sums stay f32, and dS and D o P are rounded to bf16 before their
// products; every product accumulates in f32 (pallas_attention.py:131-133,
// 221-222). PRECISE keeps f32 throughout. q' is the scaled (and rounded) q,
// so the gradient of the caller's q is scale * dQ'; the dQ kernel applies
// that factor once, at its store. A fully masked row is uniform over its
// keys and has a gradient; the last key or query tile is masked, never
// padded into a softmax.
//
// What bounds it on this card: the bytes of the work (q, k, v, dO read, dQ,
// dK, dV written once); its five products are a few GFLOP at the training
// shapes, milliseconds' worth on CUDA cores but microseconds on the tensor
// cores. So the two modes are two designs:
//
// Default mode (bf16 operands): the five products are exactly bf16 x bf16
// products with f32 accumulation, and run on the tensor cores
// (mma.sync.m16n8k16, operands from shared memory by ldmatrix; the helpers
// and the tile staging are mma.cuh's, shared with the forward). What is
// left is the exp of every (row, key) pair, the Philox draws of the dropout
// mask and the traffic of the tiles.
//   1. attention_bwd_dq_mma_kernel, grid (Lq / 64, B * H), 4 warps x 16
//      query rows. q' and dO of the block are loaded once and kept in
//      registers as mma A fragments. K and V pass in tiles of 64 keys,
//      double-buffered: the f32 loads of the next tile are issued into
//      registers before the products of this one and rounded to bf16 as
//      they are stored to shared memory after them (cp.async would copy the
//      f32 bytes; the rounding has to pass through registers anyway). Two
//      walks over the keys: the first keeps, per thread, an online row max,
//      row sum and unnormalised sum of e^(s - m) dPt, rescaled with the max
//      like the sum, and merges them across the 4 threads of a row at the
//      end, which gives delta = rowsum(dPt o P) without a third walk; the
//      second recomputes S and dPt, forms dS and accumulates dS K, with dS
//      taken from the accumulator registers as the next mma's A operand.
//      It writes dQ and one (max, sum, delta) triple per query row.
//   2. attention_bwd_dkv_mma_kernel, grid (Lk / 64, B * H), 4 warps x 16
//      keys. K and V of the block are A fragments in registers; q', dO and
//      the row triples pass in double-buffered tiles of 64 rows. It computes
//      S^T = K q'^T and dPt^T = V dO^T, so that P^T, dS^T and (D o P)^T come
//      out of the accumulator in the register layout of the A operand of
//      dK += dS^T q' and dV += (D o P)^T dO (FlashAttention-2's reuse): no
//      trip through shared memory.
//   The head dimension is zero-padded in shared memory to the mma depth
//   (Dh 36 -> 48; the kernels are instantiated for 16, 32, 48, 64). Both
//   kernels take q, k, v and dO as f32 or as bf16 (the bf16 model's
//   operands, T): bf16 rows are copied into their bf16 tiles as they are,
//   with no f32 staging (mma.cuh:TileLoad), and give the bits of f32 rows
//   holding the same values. Dropout
//   bits: the counter's groups of 4 keys do not line up with a fragment,
//   where a thread holds 2 adjacent keys of 2 rows, so each warp stages its
//   own rows' keep bits for the tile in shared memory, one Philox call per
//   group of 4 keys (8 a lane a tile), instead of two threads drawing each
//   group. The mask is drawn once a call: the dQ kernel's first walk
//   stores the bits (1 bit a pair, 8 MB at the largest training shape) and
//   its second walk and the dK/dV kernel read them back, where drawing
//   them again took a third of the kernels' time.
// Precise mode (f32): the products stay on CUDA cores (TF32 would break its
// bound), in two kernels of the same split: attention_bwd_dq_f32_kernel,
// grid (Lq / 16, B * H), 4 warps x 4 query rows, three walks over keys in
// tiles of 32 (row max and sum; delta; dS staged and multiplied into K),
// and attention_bwd_dkv_f32_kernel, 4 warps x 4 keys, over query rows in
// tiles of 32.
// In both modes the dQ kernel and the dK/dV kernel each own their outputs,
// so there are no atomics and two runs are bit-equal.

#include <math_constants.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ============================================ default mode: tensor cores

// ------------------------------------------------------------------ dQ

template <int DP, bool DROPOUT, typename T>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const T* __restrict__ q, Strides qs,
                            const T* __restrict__ k, Strides ks,
                            const T* __restrict__ v, Strides vs,
                            const unsigned char* __restrict__ pad,
                            const T* __restrict__ dout, Strides dos,
                            float* __restrict__ dq, Strides dqs,
                            float* __restrict__ stats,
                            unsigned int* __restrict__ keep_bits, int heads,
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
  const T* dop = dout + b * dos.b + h * dos.h;
  const unsigned char* padp = pad ? pad + static_cast<long long>(b) * lk
                                  : nullptr;
  // the keep bits of the warp's rows: (B * H, Lq, words) 32-bit words
  const int words = (lk + 31) >> 5;
  unsigned int* keep_row =
      DROPOUT ? keep_bits + (static_cast<long long>(bh) * lq + q0 +
                             warp * 16) * words
              : nullptr;

  // q' and dO of the block's rows, through buffer 1, kept as A fragments
  Load::issue(stage_k, kv_s[1][0], qp, qs.l, q0, lq, dh, vec);
  Load::issue(stage_v, kv_s[1][1], dop, dos.l, q0, lq, dh, vec);
  cp_async_wait_all();
  Load::land(stage_k, kv_s[1][0], scale);
  Load::land(stage_v, kv_s[1][1], 1.f);
  unsigned char pad_r = 0;
  // a tile is issued towards buffer `buf` and lands there
  auto issue_kv = [&](int t0, int buf) {
    Load::issue(stage_k, kv_s[buf][0], kp, ks.l, t0, lk, dh, vec);
    Load::issue(stage_v, kv_s[buf][1], vp, vs.l, t0, lk, dh, vec);
    if (tid < kTile) pad_r = (padp && t0 + tid < lk) ? padp[t0 + tid] : 0;
  };
  auto land_kv = [&](int buf) {
    cp_async_wait_all();
    Load::land(stage_k, kv_s[buf][0], 1.f);
    Load::land(stage_v, kv_s[buf][1], 1.f);
    if (tid < kTile) pad_s[buf][tid] = pad_r;
  };
  issue_kv(0, 0);
  land_kv(0);
  __syncthreads();
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qa[kk], kv_s[1][0] + a_offset(lane, warp * 16, kk * 16, S));
    ldsm_x4(da[kk], kv_s[1][1] + a_offset(lane, warp * 16, kk * 16, S));
  }
  __syncthreads();  // buffer 1 is free for the key tiles

  // rows g (index 0) and g + 8 (index 1) of the warp's 16
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_r[2] = {0.f, 0.f}, u_r[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (lk + kTile - 1) / kTile;
  const int steps = 2 * n_tiles;  // walk 1 (statistics), walk 2 (dS K)
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool second = s >= n_tiles;
    const int t0 = (second ? s - n_tiles : s) * kTile;
    if (s + 1 < steps) issue_kv(((s + 1) % n_tiles) * kTile, buf ^ 1);
    if (s == n_tiles) {
      // merge the 4 threads of each row: max, then the rescaled sums
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = m_r[hr];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float a = __expf(m_r[hr] - m);  // 0 for a thread with no key
        float l = l_r[hr] * a, u = u_r[hr] * a;
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        u += __shfl_xor_sync(0xffffffffu, u, 1);
        u += __shfl_xor_sync(0xffffffffu, u, 2);
        m_r[hr] = m;
        l_r[hr] = l;
        inv_l[hr] = 1.f / l;
        delta[hr] = u / l;
      }
    }
    if (DROPOUT) {
      // the keep bits of the warp's 16 rows x the tile's 64 keys: lane
      // (r, half) owns word `half` (keys 32 half ..) of row r. The first
      // walk draws it (8 groups of 4 keys) and stores it for the second
      // walk and the dK/dV kernel, which read it back.
      const int r = lane & 15, half = lane >> 4;
      const int row = q0 + warp * 16 + r;
      const int word = (t0 >> 5) + half;
      const bool stored = row < lq && word < words;
      unsigned int w = 0;
      if (!second) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          w |= keep4(dr, bh, row, (t0 >> 2) + half * 8 + i) << (4 * i);
        }
        if (stored) keep_row[static_cast<long long>(r) * words + word] = w;
      } else if (stored) {
        w = keep_row[static_cast<long long>(r) * words + word];
      }
      keep_s[warp][r][half] = w;
      __syncwarp();
    }
    const __nv_bfloat16* ks_ = kv_s[buf][0];
    const __nv_bfloat16* vs_ = kv_s[buf][1];
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      // S and dPt of the warp's 16 rows x keys 16 c .. 16 c + 15
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bk[4], bv[4];
        const int off = b_offset(lane, c * 16, kk * 16, S);
        ldsm_x4(bk, ks_ + off);
        ldsm_x4(bv, vs_ + off);
        mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
        mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[0], da[kk], bv[0], bv[1]);
        mma_bf16(dp[1], da[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c * 16 + nt * 8 + 2 * t;  // elements 0, 2; +1: 1, 3
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + (e & 1);
          if (t0 + cc >= lk) {
            sc[nt][e] = -CUDART_INF_F;  // past the last key: no weight
          } else if (pad_s[buf][cc]) {
            sc[nt][e] = kMaskValue;
          }
        }
        if (DROPOUT) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const unsigned int bits =
                keep_s[warp][g + 8 * hr][col >> 5] >> (col & 31);
            dp[nt][2 * hr] *= (bits & 1u) ? dr.inv_keep : 0.f;
            dp[nt][2 * hr + 1] *= (bits & 2u) ? dr.inv_keep : 0.f;
          }
        }
      }
      if (!second) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float cm = fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                                 fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1]));
          const float mn = fmaxf(m_r[hr], cm);
          if (mn == -CUDART_INF_F) continue;  // no key of this row here yet
          const float a = __expf(m_r[hr] - mn);
          float ls = 0.f, us = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float x = __expf(sc[nt][e] - mn);
              ls += x;
              us += x * dp[nt][e];
            }
          }
          l_r[hr] = l_r[hr] * a + ls;
          u_r[hr] = u_r[hr] * a + us;
          m_r[hr] = mn;
        }
      } else {
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const float p = __expf(sc[nt][e] - m_r[hr]) * inv_l[hr];
            ds[nt][e] = p * (dp[nt][e] - delta[hr]);
          }
        }
        uint32_t a[4];
        accum_to_a(a, ds);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, ks_ + bt_offset(lane, c * 16, nd * 8, S));
          mma_bf16(acc[nd], a, bk[0], bk[1]);
          mma_bf16(acc[nd + 1], a, bk[2], bk[3]);
        }
      }
    }
    if (s + 1 < steps) land_kv(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + warp * 16 + g + 8 * hr;
    if (row >= lq) continue;
    float* op = dq + b * dqs.b + h * dqs.h + row * dqs.l;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < dh) op[col] = acc[nd][2 * hr] * scale;
      if (col + 1 < dh) op[col + 1] = acc[nd][2 * hr + 1] * scale;
    }
    if (t == 0) {
      float* st = stats + (static_cast<long long>(bh) * lq + row) * 3;
      st[0] = m_r[hr];
      st[1] = l_r[hr];
      st[2] = delta[hr];
    }
  }
}

// --------------------------------------------------------------- dK, dV

template <int DP, bool DROPOUT, typename T>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkv_mma_kernel(const T* __restrict__ q, Strides qs,
                             const T* __restrict__ k, Strides ks,
                             const T* __restrict__ v, Strides vs,
                             const unsigned char* __restrict__ pad,
                             const T* __restrict__ dout, Strides dos,
                             const float* __restrict__ stats,
                             const unsigned int* __restrict__ keep_bits,
                             float* __restrict__ dk, Strides dks,
                             float* __restrict__ dv, Strides dvs, int heads,
                             int lq, int lk, int dh, float scale, Dropout dr,
                             bool vec) {
  constexpr int S = DP + 8;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  using Load = TileLoad<DP, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage_q = reinterpret_cast<float*>(smem);  // f32 operands only
  float* stage_d = stage_q + kTile * DP;
  __nv_bfloat16 (*qd_s)[2][kTile * S] =  // [buf][q', dO]
      reinterpret_cast<__nv_bfloat16 (*)[2][kTile * S]>(
          stage_q + MmaSmem<DP, T>::kStage);
  float (*st_s)[kTile][3] =  // max, 1 / sum, delta of a row
      reinterpret_cast<float (*)[kTile][3]>(qd_s + 2);
  unsigned short (*keep_s)[kTile] =  // the warp's 16 keys
      reinterpret_cast<unsigned short (*)[kTile]>(st_s + 2);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * kBlockRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const T* dop = dout + b * dos.b + h * dos.h;
  const float* stp = stats + static_cast<long long>(bh) * lq * 3;

  // K and V of the block's keys, through buffer 1, kept as A fragments
  Load::issue(stage_q, qd_s[1][0], kp, ks.l, k0, lk, dh, vec);
  Load::issue(stage_d, qd_s[1][1], vp, vs.l, k0, lk, dh, vec);
  cp_async_wait_all();
  Load::land(stage_q, qd_s[1][0], 1.f);
  Load::land(stage_d, qd_s[1][1], 1.f);
  float st_r[3] = {0.f, 0.f, 0.f};
  // a tile of rows is issued towards buffer `buf` and lands there
  auto issue_qd = [&](int i0, int buf) {
    Load::issue(stage_q, qd_s[buf][0], qp, qs.l, i0, lq, dh, vec);
    Load::issue(stage_d, qd_s[buf][1], dop, dos.l, i0, lq, dh, vec);
    if (tid < kTile) {
      const int row = i0 + tid;
      if (row < lq) {
        st_r[0] = stp[row * 3 + 0];
        st_r[1] = 1.f / stp[row * 3 + 1];
        st_r[2] = stp[row * 3 + 2];
      } else {  // no row: P = 0
        st_r[0] = st_r[1] = st_r[2] = 0.f;
      }
    }
  };
  auto land_qd = [&](int buf) {
    cp_async_wait_all();
    Load::land(stage_q, qd_s[buf][0], scale);
    Load::land(stage_d, qd_s[buf][1], 1.f);
    if (tid < kTile) {
      st_s[buf][tid][0] = st_r[0];
      st_s[buf][tid][1] = st_r[1];
      st_s[buf][tid][2] = st_r[2];
    }
  };
  issue_qd(0, 0);
  land_qd(0);
  __syncthreads();
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(ka[kk], qd_s[1][0] + a_offset(lane, warp * 16, kk * 16, S));
    ldsm_x4(va[kk], qd_s[1][1] + a_offset(lane, warp * 16, kk * 16, S));
  }
  __syncthreads();  // buffer 1 is free for the row tiles

  // the thread's keys: g (index 0) and g + 8 (index 1) of the warp's 16
  bool in_k[2], pad_k[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + warp * 16 + g + 8 * hr;
    in_k[hr] = key < lk;
    pad_k[hr] = pad && in_k[hr] &&
                pad[static_cast<long long>(b) * lk + key] != 0;
  }
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  // the warp's 16 keys are one half of one word of each row's keep bits
  const int words = (lk + 31) >> 5;
  const int word = (k0 + warp * 16) >> 5, shift = (warp & 1) * 16;
  const unsigned int* keep_bh =
      DROPOUT ? keep_bits + static_cast<long long>(bh) * lq * words : nullptr;
  const int n_tiles = (lq + kTile - 1) / kTile;
  for (int s = 0; s < n_tiles; ++s) {
    const int buf = s & 1;
    const int i0 = s * kTile;
    if (s + 1 < n_tiles) issue_qd(i0 + kTile, buf ^ 1);
    if (DROPOUT) {
      // the dQ kernel's keep bits of rows lane and lane + 32 of the tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = lane + 32 * hr;
        const int row = i0 + rl;
        const unsigned int w =
            row < lq && word < words
                ? keep_bh[static_cast<long long>(row) * words + word]
                : 0u;
        keep_s[warp][rl] = static_cast<unsigned short>(w >> shift);
      }
      __syncwarp();
    }
    const __nv_bfloat16* qs_ = qd_s[buf][0];
    const __nv_bfloat16* ds_ = qd_s[buf][1];
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      // S^T and dPt^T of the warp's 16 keys x rows 16 c .. 16 c + 15
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bq[4], bd[4];
        const int off = b_offset(lane, c * 16, kk * 16, S);
        ldsm_x4(bq, qs_ + off);
        ldsm_x4(bd, ds_ + off);
        mma_bf16(sc[0], ka[kk], bq[0], bq[1]);
        mma_bf16(sc[1], ka[kk], bq[2], bq[3]);
        mma_bf16(dp[0], va[kk], bd[0], bd[1]);
        mma_bf16(dp[1], va[kk], bd[2], bd[3]);
      }
      float dst[2][4], pdt[2][4];  // dS^T, (D o P)^T
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const int rl = c * 16 + nt * 8 + 2 * t + (e & 1);
          const float m = st_s[buf][rl][0], il = st_s[buf][rl][1];
          const float s_ = pad_k[hr] ? kMaskValue : sc[nt][e];
          float p = in_k[hr] ? __expf(s_ - m) * il : 0.f;
          float dpt = dp[nt][e], pe = p;
          if (DROPOUT) {
            const float d = (keep_s[warp][rl] >> (g + 8 * hr)) & 1u
                                ? dr.inv_keep
                                : 0.f;
            dpt *= d;
            pe *= d;
          }
          dst[nt][e] = p * (dpt - st_s[buf][rl][2]);
          pdt[nt][e] = pe;
        }
      }
      uint32_t a_ds[4], a_pd[4];
      accum_to_a(a_ds, dst);
      accum_to_a(a_pd, pdt);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bq[4], bd[4];
        const int off = bt_offset(lane, c * 16, nd * 8, S);
        ldsm_x4_t(bq, qs_ + off);
        ldsm_x4_t(bd, ds_ + off);
        mma_bf16(dk_acc[nd], a_ds, bq[0], bq[1]);
        mma_bf16(dk_acc[nd + 1], a_ds, bq[2], bq[3]);
        mma_bf16(dv_acc[nd], a_pd, bd[0], bd[1]);
        mma_bf16(dv_acc[nd + 1], a_pd, bd[2], bd[3]);
      }
    }
    if (s + 1 < n_tiles) land_qd(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!in_k[hr]) continue;
    const int key = k0 + warp * 16 + g + 8 * hr;
    float* dkp = dk + b * dks.b + h * dks.h + key * dks.l;
    float* dvp = dv + b * dvs.b + h * dvs.h + key * dvs.l;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (col < dh) {
        dkp[col] = dk_acc[nd][2 * hr];
        dvp[col] = dv_acc[nd][2 * hr];
      }
      if (col + 1 < dh) {
        dkp[col + 1] = dk_acc[nd][2 * hr + 1];
        dvp[col + 1] = dv_acc[nd][2 * hr + 1];
      }
    }
  }
}

// ============================================ precise mode: CUDA cores

constexpr int kWarps = 4;
constexpr int kOwn = 4;                 // rows (or keys) a warp owns
constexpr int kBlock = kWarps * kOwn;   // rows (or keys) a block owns
constexpr int kF32Tile = 32;            // keys (or rows) per staged tile
constexpr int kStride = kMaxD + 1;      // odd: a lane per row, no conflicts

__device__ __forceinline__ void keep_scales(const Dropout& dr, int bh, int row,
                                            int group, float (&d)[4]) {
  const unsigned int bits = keep4(dr, bh, row, group);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = (bits >> i) & 1u ? dr.inv_keep : 0.f;
}

// ------------------------------------------------------------------ dQ

template <bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, Strides qs,
                            const float* __restrict__ k, Strides ks,
                            const float* __restrict__ v, Strides vs,
                            const unsigned char* __restrict__ pad,
                            const float* __restrict__ dout, Strides dos,
                            float* __restrict__ dq, Strides dqs,
                            float* __restrict__ stats, int heads, int lq,
                            int lk, int dh, float scale, Dropout dr) {
  __shared__ float q_s[kBlock][kMaxD];
  __shared__ float do_s[kBlock][kMaxD];
  __shared__ float k_s[kF32Tile][kStride];
  __shared__ float v_s[kF32Tile][kStride];
  __shared__ float ds_s[kWarps][kOwn][kF32Tile];
  __shared__ float drop_s[kWarps][kOwn][kF32Tile];
  __shared__ unsigned char pad_s[kF32Tile];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const unsigned char* padp = pad ? pad + static_cast<long long>(b) * lk
                                  : nullptr;

  for (int idx = tid; idx < kBlock * dh; idx += kWarps * 32) {
    const int r = idx / dh, d = idx % dh;
    const int row = q0 + r;
    const bool in = row < lq;
    q_s[r][d] = in ? qp[row * qs.l + d] * scale : 0.f;
    do_s[r][d] = in ? dop[row * dos.l + d] : 0.f;
  }

  auto load_tile = [&](int t0, bool with_v) {
    for (int idx = tid; idx < kF32Tile * dh; idx += kWarps * 32) {
      const int j = idx / dh, d = idx % dh;
      const int key = t0 + j;
      const bool in = key < lk;
      k_s[j][d] = in ? kp[key * ks.l + d] : 0.f;
      if (with_v) v_s[j][d] = in ? vp[key * vs.l + d] : 0.f;
    }
    if (tid < kF32Tile) {
      const int key = t0 + tid;
      pad_s[tid] = (padp && key < lk) ? padp[key] : 0;
    }
  };

  // scores of this warp's rows against this lane's key of the staged tile
  auto scores = [&](float (&s)[kOwn]) {
#pragma unroll
    for (int r = 0; r < kOwn; ++r) s[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kOwn; ++r) s[r] += q_s[warp * kOwn + r][d] * kd;
    }
    if (pad_s[lane]) {
#pragma unroll
      for (int r = 0; r < kOwn; ++r) s[r] = kMaskValue;
    }
  };

  // dO V^T of this warp's rows against this lane's key
  auto dout_v = [&](float (&dov)[kOwn]) {
#pragma unroll
    for (int r = 0; r < kOwn; ++r) dov[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float vd = v_s[lane][d];
#pragma unroll
      for (int r = 0; r < kOwn; ++r) dov[r] += do_s[warp * kOwn + r][d] * vd;
    }
  };

  // the keep scales of this warp's rows at this lane's key of tile t0:
  // lane (r, g) draws the bits of row r, keys 4 g .. 4 g + 3, and the
  // warp shares them through shared memory
  auto tile_scales = [&](int t0, float (&d)[kOwn]) {
    const int r = lane >> 3, g = lane & 7;
    float four[4];
    keep_scales(dr, bh, q0 + warp * kOwn + r, (t0 >> 2) + g, four);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) drop_s[warp][r][g * 4 + i] = four[i];
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < kOwn; ++rr) d[rr] = drop_s[warp][rr][lane];
  };

  // ---- pass 1: row max and row sum (online, merged across lanes)
  float m_run[kOwn], l_run[kOwn];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  for (int t0 = 0; t0 < lk; t0 += kF32Tile) {
    __syncthreads();
    load_tile(t0, false);
    __syncthreads();
    if (t0 + lane < lk) {
      float s[kOwn];
      scores(s);
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float mn = fmaxf(m_run[r], s[r]);
        const float keep =
            m_run[r] == -CUDART_INF_F ? 0.f : l_run[r] * expf(m_run[r] - mn);
        l_run[r] = keep + expf(s[r] - mn);
        m_run[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
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

  // ---- pass 2: delta = rowsum(dPt o P), with P normalized
  float delta[kOwn];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) delta[r] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kF32Tile) {
    __syncthreads();
    load_tile(t0, true);
    __syncthreads();
    float dsc[kOwn];
    if (DROPOUT) tile_scales(t0, dsc);
    if (t0 + lane < lk) {
      float s[kOwn], dov[kOwn];
      scores(s);
      dout_v(dov);
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float p = expf(s[r] - m_run[r]) / l_run[r];
        const float dpt = DROPOUT ? dsc[r] * dov[r] : dov[r];
        delta[r] += dpt * p;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], off);
    }
  }

  // ---- pass 3: dS times K
  float acc[kOwn][2];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kF32Tile) {
    __syncthreads();
    load_tile(t0, true);
    __syncthreads();
    float dsc[kOwn];
    if (DROPOUT) tile_scales(t0, dsc);
    {
      float s[kOwn], dov[kOwn];
      scores(s);
      dout_v(dov);
      const bool in = t0 + lane < lk;
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float p = expf(s[r] - m_run[r]) / l_run[r];
        const float dpt = DROPOUT ? dsc[r] * dov[r] : dov[r];
        ds_s[warp][r][lane] = in ? p * (dpt - delta[r]) : 0.f;
      }
    }
    __syncwarp();
    const int nk = min(kF32Tile, lk - t0);
    for (int j = 0; j < nk; ++j) {
      const float k0 = k_s[j][lane];
      const float k1 = k_s[j][lane + 32];
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float dsj = ds_s[warp][r][j];
        acc[r][0] += dsj * k0;
        acc[r][1] += dsj * k1;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const int row = q0 + warp * kOwn + r;
    if (row >= lq) continue;
    float* op = dq + b * dqs.b + h * dqs.h + row * dqs.l;
    if (lane < dh) op[lane] = acc[r][0] * scale;
    if (lane + 32 < dh) op[lane + 32] = acc[r][1] * scale;
    if (lane == 0) {
      float* st = stats + (static_cast<long long>(bh) * lq + row) * 3;
      st[0] = m_run[r];
      st[1] = l_run[r];
      st[2] = delta[r];
    }
  }
}

// --------------------------------------------------------------- dK, dV

template <bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q, Strides qs,
                             const float* __restrict__ k, Strides ks,
                             const float* __restrict__ v, Strides vs,
                             const unsigned char* __restrict__ pad,
                             const float* __restrict__ dout, Strides dos,
                             const float* __restrict__ stats,
                             float* __restrict__ dk, Strides dks,
                             float* __restrict__ dv, Strides dvs, int heads,
                             int lq, int lk, int dh, float scale, Dropout dr) {
  __shared__ float kb_s[kBlock][kMaxD];
  __shared__ float vb_s[kBlock][kMaxD];
  __shared__ float q_s[kF32Tile][kStride];
  __shared__ float do_s[kF32Tile][kStride];
  __shared__ float st_s[kF32Tile][3];
  __shared__ float ds_s[kWarps][kOwn][kF32Tile];
  __shared__ float dp_s[kWarps][kOwn][kF32Tile];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int key0 = k0 + warp * kOwn;  // a multiple of 4: one dropout group

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const float* dop = dout + b * dos.b + h * dos.h;
  const float* stp = stats + static_cast<long long>(bh) * lq * 3;

  for (int idx = tid; idx < kBlock * dh; idx += kWarps * 32) {
    const int j = idx / dh, d = idx % dh;
    const int key = k0 + j;
    const bool in = key < lk;
    kb_s[j][d] = in ? kp[key * ks.l + d] : 0.f;
    vb_s[j][d] = in ? vp[key * vs.l + d] : 0.f;
  }
  bool padded[kOwn];
#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    const int key = key0 + c;
    padded[c] = pad && key < lk &&
                pad[static_cast<long long>(b) * lk + key] != 0;
  }

  float dk_acc[kOwn][2], dv_acc[kOwn][2];
#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    dk_acc[c][0] = dk_acc[c][1] = 0.f;
    dv_acc[c][0] = dv_acc[c][1] = 0.f;
  }

  for (int i0 = 0; i0 < lq; i0 += kF32Tile) {
    __syncthreads();
    for (int idx = tid; idx < kF32Tile * dh; idx += kWarps * 32) {
      const int i = idx / dh, d = idx % dh;
      const int row = i0 + i;
      const bool in = row < lq;
      q_s[i][d] = in ? qp[row * qs.l + d] * scale : 0.f;
      do_s[i][d] = in ? dop[row * dos.l + d] : 0.f;
    }
    if (tid < kF32Tile) {
      const int row = i0 + tid;
      const bool in = row < lq;
      st_s[tid][0] = in ? stp[row * 3 + 0] : 0.f;
      st_s[tid][1] = in ? stp[row * 3 + 1] : 1.f;
      st_s[tid][2] = in ? stp[row * 3 + 2] : 0.f;
    }
    __syncthreads();

    const int row = i0 + lane;
    const bool row_in = row < lq;
    const float m = st_s[lane][0], l = st_s[lane][1], delta = st_s[lane][2];
    float dsc[4] = {1.f, 1.f, 1.f, 1.f};
    if (DROPOUT) keep_scales(dr, bh, row, key0 >> 2, dsc);
#pragma unroll
    for (int c = 0; c < kOwn; ++c) {
      float s = 0.f, dov = 0.f;
      for (int d = 0; d < dh; ++d) {
        s += q_s[lane][d] * kb_s[warp * kOwn + c][d];
        dov += do_s[lane][d] * vb_s[warp * kOwn + c][d];
      }
      if (padded[c]) s = kMaskValue;
      const float p = expf(s - m) / l;
      const float dpt = DROPOUT ? dsc[c] * dov : dov;
      const float dpe = DROPOUT ? dsc[c] * p : p;
      const bool in = row_in && key0 + c < lk;
      ds_s[warp][c][lane] = in ? p * (dpt - delta) : 0.f;
      dp_s[warp][c][lane] = in ? dpe : 0.f;
    }
    __syncwarp();
    const int ni = min(kF32Tile, lq - i0);
    for (int i = 0; i < ni; ++i) {
      const float qa = q_s[i][lane], qb = q_s[i][lane + 32];
      const float oa = do_s[i][lane], ob = do_s[i][lane + 32];
#pragma unroll
      for (int c = 0; c < kOwn; ++c) {
        const float dsi = ds_s[warp][c][i];
        const float dpi = dp_s[warp][c][i];
        dk_acc[c][0] += dsi * qa;
        dk_acc[c][1] += dsi * qb;
        dv_acc[c][0] += dpi * oa;
        dv_acc[c][1] += dpi * ob;
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int c = 0; c < kOwn; ++c) {
    const int key = key0 + c;
    if (key >= lk) continue;
    float* dkp = dk + b * dks.b + h * dks.h + key * dks.l;
    float* dvp = dv + b * dvs.b + h * dvs.h + key * dvs.l;
    if (lane < dh) {
      dkp[lane] = dk_acc[c][0];
      dvp[lane] = dv_acc[c][0];
    }
    if (lane + 32 < dh) {
      dkp[lane + 32] = dk_acc[c][1];
      dvp[lane + 32] = dv_acc[c][1];
    }
  }
}

// The default mode's two kernels for one padded head dimension and operand
// type.
template <int DP, bool DROPOUT, typename T>
cudaError_t launch_mma(int device, dim3 grid_q, dim3 grid_k, cudaStream_t st,
                       const void* qv, Strides qs, const void* kv,
                       Strides ks, const void* vv, Strides vs,
                       const unsigned char* pad, const void* doutv,
                       Strides dos, float* dq, Strides dqs, float* dk,
                       Strides dks, float* dv, Strides dvs, float* stats,
                       unsigned int* keep_bits, int heads, int lq, int lk,
                       int dh, float scale, Dropout dr, bool vec) {
  constexpr size_t smem = MmaSmem<DP, T>::kBytes;  // over the 48 KB default
  auto dq_kernel = attention_bwd_dq_mma_kernel<DP, DROPOUT, T>;
  auto dkv_kernel = attention_bwd_dkv_mma_kernel<DP, DROPOUT, T>;
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  const T* dout = static_cast<const T*>(doutv);
  cudaError_t err;
  // The limit is a property of a kernel on a device: set it once for this
  // instantiation's two kernels on each device (a driver call on every
  // launch would cost more than a small launch itself).
  constexpr int kDevices = 64;
  static bool smem_set[kDevices] = {};
  const bool known = device >= 0 && device < kDevices;
  if (!known || !smem_set[device]) {
    err = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err != cudaSuccess) return err;
    if (known) smem_set[device] = true;
  }
  dq_kernel<<<grid_q, kMmaThreads, smem, st>>>(
      q, qs, k, ks, v, vs, pad, dout, dos, dq, dqs, stats, keep_bits, heads,
      lq, lk, dh, scale, dr, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid_k, kMmaThreads, smem, st>>>(
      q, qs, k, ks, v, vs, pad, dout, dos, stats, keep_bits, dk, dks, dv, dvs,
      heads, lq, lk, dh, scale, dr, vec);
  return cudaGetLastError();
}

template <bool DROPOUT>
cudaError_t launch_f32(dim3 grid_q, dim3 grid_k, cudaStream_t st,
                       const float* q, Strides qs, const float* k, Strides ks,
                       const float* v, Strides vs, const unsigned char* pad,
                       const float* dout, Strides dos, float* dq, Strides dqs,
                       float* dk, Strides dks, float* dv, Strides dvs,
                       float* stats, int heads, int lq, int lk, int dh,
                       float scale, Dropout dr) {
  attention_bwd_dq_f32_kernel<DROPOUT><<<grid_q, kWarps * 32, 0, st>>>(
      q, qs, k, ks, v, vs, pad, dout, dos, dq, dqs, stats, heads, lq, lk, dh,
      scale, dr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_f32_kernel<DROPOUT><<<grid_k, kWarps * 32, 0, st>>>(
      q, qs, k, ks, v, vs, pad, dout, dos, stats, dk, dks, dv, dvs, heads, lq,
      lk, dh, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, H, L, Dh) views with the given (batch,
// head, row) strides and a unit-stride head dimension; q, k, v and dout
// f32, or bf16 where `bf16` (the default mode only), the gradients f32;
// pad: (B, Lk) bytes or null; stats: (B * H, Lq, 3) f32 scratch;
// keep_bits: with dropout in the default mode, (B * H, Lq, ceil(Lk / 32))
// 32-bit scratch for the mask, else null. drop_thresh == 0 runs without
// dropout. `precise` picks the f32 mode, else the bf16-operand mode.
extern "C" int attention_bwd_launch(
    int device,
    const void* q, long long qsb, long long qsh, long long qsl,
    const void* k, long long ksb, long long ksh, long long ksl,
    const void* v, long long vsb, long long vsh, long long vsl,
    const unsigned char* pad,
    const void* dout, long long dosb, long long dosh, long long dosl,
    float* dq, long long dqsb, long long dqsh, long long dqsl,
    float* dk, long long dksb, long long dksh, long long dksl,
    float* dv, long long dvsb, long long dvsh, long long dvsl,
    float* stats, unsigned int* keep_bits, int batch, int heads, int lq,
    int lk, int dh, float scale, int precise, int bf16,
    unsigned int drop_thresh, float inv_keep, unsigned long long seed,
    void* stream) {
  if (dh > kMaxD || dh < 1 || (precise && bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (drop_thresh && !precise && keep_bits == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope on(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      dos{dosb, dosh, dosl}, dqs{dqsb, dqsh, dqsl}, dks{dksb, dksh, dksl},
      dvs{dvsb, dvsh, dvsl};
  const Dropout dr{drop_thresh, inv_keep, seed};
  cudaError_t err;
  if (precise) {
    const dim3 grid_q((lq + kBlock - 1) / kBlock, batch * heads);
    const dim3 grid_k((lk + kBlock - 1) / kBlock, batch * heads);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
#define BUTD_F32(DROPOUT)                                                    \
  launch_f32<DROPOUT>(grid_q, grid_k, st, qf, qs, kf, ks, vf, vs, pad, df,   \
                      dos, dq, dqs, dk, dks, dv, dvs, stats, heads, lq, lk,  \
                      dh, scale, dr)
    err = drop_thresh ? BUTD_F32(true) : BUTD_F32(false);
#undef BUTD_F32
    return static_cast<int>(err);
  }
  const dim3 grid_q((lq + kBlockRows - 1) / kBlockRows, batch * heads);
  const dim3 grid_k((lk + kBlockRows - 1) / kBlockRows, batch * heads);
  const auto rows_aligned = bf16 ? aligned8_bf16 : aligned16;
  const bool vec = dh % 4 == 0 && rows_aligned(q, qsb, qsh, qsl) &&
                   rows_aligned(k, ksb, ksh, ksl) &&
                   rows_aligned(v, vsb, vsh, vsl) &&
                   rows_aligned(dout, dosb, dosh, dosl);
#define BUTD_MMA_T(DP, DROPOUT, T)                                           \
  launch_mma<DP, DROPOUT, T>(device, grid_q, grid_k, st, q, qs, k, ks, v,   \
                             vs, pad, dout, dos, dq, dqs, dk, dks, dv, dvs, \
                             stats, keep_bits, heads, lq, lk, dh, scale, dr, \
                             vec)
#define BUTD_MMA(DP, DROPOUT)                                   \
  (bf16 ? BUTD_MMA_T(DP, DROPOUT, __nv_bfloat16)                \
        : BUTD_MMA_T(DP, DROPOUT, float))
#define BUTD_MMA_DP(DP) \
  (drop_thresh ? BUTD_MMA(DP, true) : BUTD_MMA(DP, false))
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

// Dynamic shared memory a block of the default mode's kernels takes at
// head dimension `dh`, with f32 or (`bf16`) bf16 operands (ptxas reports
// only static shared memory).
extern "C" int attention_bwd_smem_bytes(int dh, int bf16) {
  return static_cast<int>(mma_smem_bytes(dh, bf16));
}

BUTD_PACKED(attention_bwd_launch)
BUTD_ERROR_STRING(attention_bwd)
