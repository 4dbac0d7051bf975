// Attention forward for Hopper (sm_90a): softmax(scale * Q K^T) V.
//
// Replaces the TPU kernel butd_detr_tpu/ops/pallas_attention.py:_fwd_kernel
// (through _attend_fwd / fused_attention). Semantics kept from it:
//   * padded keys get FINFO_MIN (not -inf), so a fully masked row comes
//     out uniform over the keys, as in torch nn.MultiheadAttention;
//   * q is scaled in f32 first; in the default mode the scaled q, k and v
//     are rounded to bf16, scores and the softmax are f32, and the
//     normalized P is rounded to bf16 before P V with f32 accumulation
//     (pallas_attention.py:270-278, :101-107). PRECISE keeps f32
//     throughout.
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
// softmax.
//
// What bounds it on this card: at the serving shapes the least time for
// the work is set by the bytes (q, k, v read and out written once; the
// products would take less on the tensor cores). This kernel is bound by
// its own instruction rate instead: per (row, key) pair it runs 2 Dh
// f32 multiply-adds for the scores (computed in both passes) and Dh for
// P V on CUDA cores, from shared memory. On an H100 SXM (chip_smoke.py)
// at L 1024, Dh 36 it takes about 1.7x torch's fused attention; at the
// short lengths it is on par.
//
// Design: grid (Lq / 16, B * H); 4 warps per block, 4 query rows per
// warp. K and V pass through shared memory in tiles of 64 keys. Two passes
// over K, as the TPU kernel's order needs: pass 1 keeps an online row max
// and row sum (lanes split the keys, then a butterfly merge); pass 2
// recomputes each score, normalizes it, rounds it (default mode) and
// stages the tile's P row in shared memory, from which each lane
// accumulates its own output columns (d = lane, lane + 32) over the keys
// in order. An online-softmax rescale in a single pass would round
// unnormalized values instead. Tensor cores (mma / wgmma) are later work.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxD = 64;
constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kTileK = 64;               // keys per shared-memory tile
constexpr float kMaskValue = -FLT_MAX;   // torch.finfo(float32).min

template <bool PRECISE>
__device__ __forceinline__ float operand(float x) {
  if (PRECISE) return x;
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Strides {
  long long b, h, l;
};

template <bool PRECISE, bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const float* __restrict__ q, Strides qs,
                     const float* __restrict__ k, Strides ks,
                     const float* __restrict__ v, Strides vs,
                     const unsigned char* __restrict__ pad,
                     float* __restrict__ out, Strides os, int heads, int lq,
                     int lk, int dh, float scale, unsigned int drop_thresh,
                     float inv_keep, unsigned long long seed) {
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
    q_s[r][d] = row < lq ? operand<PRECISE>(qp[row * qs.l + d] * scale)
                         : 0.f;
  }

  auto load_tile = [&](int t0, bool with_v) {
    for (int idx = tid; idx < kTileK * dh; idx += kWarps * 32) {
      const int j = idx / dh, d = idx % dh;
      const int key = t0 + j;
      const bool in = key < lk;
      k_s[j][d] = in ? operand<PRECISE>(kp[key * ks.l + d]) : 0.f;
      if (with_v) v_s[j][d] = in ? operand<PRECISE>(vp[key * vs.l + d]) : 0.f;
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

  // ---- pass 2: normalized (and, by default, bf16-rounded) P times V
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
        const uint4 bits =
            dropout_bits(seed, bh, q0 + warp * kRows + r, (t0 >> 2) + g);
        float* dst = &drop_s[warp][r][g * 4];
        dst[0] = bits.x >= drop_thresh ? inv_keep : 0.f;
        dst[1] = bits.y >= drop_thresh ? inv_keep : 0.f;
        dst[2] = bits.z >= drop_thresh ? inv_keep : 0.f;
        dst[3] = bits.w >= drop_thresh ? inv_keep : 0.f;
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
        p_s[warp][r][jj] = in ? operand<PRECISE>(p) : 0.f;
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

}  // namespace

extern "C" int attention_dropout_mask_launch(unsigned char* keep,
                                             int batch_heads, int lq, int lk,
                                             unsigned int drop_thresh,
                                             unsigned long long seed,
                                             void* stream) {
  const long long threads = static_cast<long long>(lq) * ((lk + 3) >> 2);
  const dim3 grid(static_cast<unsigned int>((threads + 255) / 256),
                  batch_heads);
  attention_dropout_mask_kernel<<<grid, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      keep, lq, lk, drop_thresh, seed);
  return static_cast<int>(cudaGetLastError());
}

// drop_thresh == 0 runs without dropout (the serving path); otherwise an
// entry of the normalized P is kept iff its Philox bits >= drop_thresh and
// scaled by inv_keep.
extern "C" int attention_fwd_launch(
    const float* q, long long qsb, long long qsh, long long qsl,
    const float* k, long long ksb, long long ksh, long long ksl,
    const float* v, long long vsb, long long vsh, long long vsl,
    const unsigned char* pad, float* out, long long osb, long long osh,
    long long osl, int batch, int heads, int lq, int lk, int dh, float scale,
    int precise, unsigned int drop_thresh, float inv_keep,
    unsigned long long seed, void* stream) {
  if (dh > kMaxD || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch * heads);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      os{osb, osh, osl};
#define BUTD_ATTENTION_FWD(PRECISE, DROPOUT)                               \
  attention_fwd_kernel<PRECISE, DROPOUT><<<grid, block, 0, st>>>(           \
      q, qs, k, ks, v, vs, pad, out, os, heads, lq, lk, dh, scale,          \
      drop_thresh, inv_keep, seed)
  if (precise) {
    if (drop_thresh) BUTD_ATTENTION_FWD(true, true);
    else BUTD_ATTENTION_FWD(true, false);
  } else {
    if (drop_thresh) BUTD_ATTENTION_FWD(false, true);
    else BUTD_ATTENTION_FWD(false, false);
  }
#undef BUTD_ATTENTION_FWD
  return static_cast<int>(cudaGetLastError());
}

BUTD_ERROR_STRING(attention)
