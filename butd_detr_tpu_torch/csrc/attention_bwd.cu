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
// keys and has a gradient; the last key tile is masked, never padded.
//
// What bounds it on this card: as for the forward, the bytes are the bound
// of the work (q, k, v, dO read, dQ, dK, dV written once; the five products
// would take less on the tensor cores). This kernel is bound by its own
// f32 instruction rate: per (row, key) pair it runs ten Dh-long
// multiply-add chains on CUDA cores.
//
// Design. The TPU accumulates dK and dV across q-blocks in a resident
// output block because its grid runs in order; here blocks run in parallel,
// so there are two kernels and no atomics, which makes the result
// deterministic:
//   1. attention_bwd_dq_kernel, grid (Lq / 16, B * H), 4 warps x 4 query
//      rows, K and V through shared memory in tiles of 32 keys (one key a
//      lane). Three passes over the keys: row max and row sum (as the
//      forward's pass 1); then rowsum(dPt o P), which every dS of the row
//      needs; then dS, staged in shared memory and multiplied into K. It
//      writes dQ and one (max, sum, rowsum) triple per query row.
//   2. attention_bwd_dkv_kernel, grid (Lk / 16, B * H), 4 warps x 4 keys.
//      It loops over the query rows in tiles of 32 (one row a lane), reads
//      the row triples, recomputes P, dS and D o P for its 16 keys, stages
//      them and accumulates dK and dV over the rows in order.
// A warp's 4 keys in kernel 2 are one group of 4 of the dropout counter, so
// a lane draws its row's bits with one Philox call; kernel 1 stages the
// bits of (4 rows x 8 groups) per tile, one call a lane.
// Tensor cores (mma / wgmma) are later work.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxD = 64;
constexpr int kWarps = 4;
constexpr int kOwn = 4;                 // rows (or keys) a warp owns
constexpr int kBlock = kWarps * kOwn;   // rows (or keys) a block owns
constexpr int kTile = 32;               // keys (or rows) per staged tile
constexpr int kStride = kMaxD + 1;      // odd: a lane per row, no conflicts
constexpr float kMaskValue = -FLT_MAX;  // torch.finfo(float32).min

template <bool PRECISE>
__device__ __forceinline__ float operand(float x) {
  if (PRECISE) return x;
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Strides {
  long long b, h, l;
};

struct Dropout {
  unsigned int thresh;
  float inv_keep;
  unsigned long long seed;
};

__device__ __forceinline__ void keep_scales(const Dropout& dr, int bh, int row,
                                            int group, float (&d)[4]) {
  const uint4 bits = dropout_bits(dr.seed, bh, row, group);
  d[0] = bits.x >= dr.thresh ? dr.inv_keep : 0.f;
  d[1] = bits.y >= dr.thresh ? dr.inv_keep : 0.f;
  d[2] = bits.z >= dr.thresh ? dr.inv_keep : 0.f;
  d[3] = bits.w >= dr.thresh ? dr.inv_keep : 0.f;
}

// ------------------------------------------------------------------ dQ

template <bool PRECISE, bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const float* __restrict__ q, Strides qs,
                        const float* __restrict__ k, Strides ks,
                        const float* __restrict__ v, Strides vs,
                        const unsigned char* __restrict__ pad,
                        const float* __restrict__ dout, Strides dos,
                        float* __restrict__ dq, Strides dqs,
                        float* __restrict__ stats, int heads, int lq, int lk,
                        int dh, float scale, Dropout dr) {
  __shared__ float q_s[kBlock][kMaxD];
  __shared__ float do_s[kBlock][kMaxD];
  __shared__ float k_s[kTile][kStride];
  __shared__ float v_s[kTile][kStride];
  __shared__ float ds_s[kWarps][kOwn][kTile];
  __shared__ float drop_s[kWarps][kOwn][kTile];
  __shared__ unsigned char pad_s[kTile];

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
    q_s[r][d] = in ? operand<PRECISE>(qp[row * qs.l + d] * scale) : 0.f;
    do_s[r][d] = in ? operand<PRECISE>(dop[row * dos.l + d]) : 0.f;
  }

  auto load_tile = [&](int t0, bool with_v) {
    for (int idx = tid; idx < kTile * dh; idx += kWarps * 32) {
      const int j = idx / dh, d = idx % dh;
      const int key = t0 + j;
      const bool in = key < lk;
      k_s[j][d] = in ? operand<PRECISE>(kp[key * ks.l + d]) : 0.f;
      if (with_v) v_s[j][d] = in ? operand<PRECISE>(vp[key * vs.l + d]) : 0.f;
    }
    if (tid < kTile) {
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
  for (int t0 = 0; t0 < lk; t0 += kTile) {
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

  // ---- pass 2: delta = rowsum(dPt o P), with P normalized and unrounded
  float delta[kOwn];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) delta[r] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kTile) {
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

  // ---- pass 3: dS (rounded in the default mode) times K
  float acc[kOwn][2];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int t0 = 0; t0 < lk; t0 += kTile) {
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
        ds_s[warp][r][lane] =
            in ? operand<PRECISE>(p * (dpt - delta[r])) : 0.f;
      }
    }
    __syncwarp();
    const int nk = min(kTile, lk - t0);
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

template <bool PRECISE, bool DROPOUT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_kernel(const float* __restrict__ q, Strides qs,
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
  __shared__ float q_s[kTile][kStride];
  __shared__ float do_s[kTile][kStride];
  __shared__ float st_s[kTile][3];
  __shared__ float ds_s[kWarps][kOwn][kTile];
  __shared__ float dp_s[kWarps][kOwn][kTile];

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
    kb_s[j][d] = in ? operand<PRECISE>(kp[key * ks.l + d]) : 0.f;
    vb_s[j][d] = in ? operand<PRECISE>(vp[key * vs.l + d]) : 0.f;
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

  for (int i0 = 0; i0 < lq; i0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * dh; idx += kWarps * 32) {
      const int i = idx / dh, d = idx % dh;
      const int row = i0 + i;
      const bool in = row < lq;
      q_s[i][d] = in ? operand<PRECISE>(qp[row * qs.l + d] * scale) : 0.f;
      do_s[i][d] = in ? operand<PRECISE>(dop[row * dos.l + d]) : 0.f;
    }
    if (tid < kTile) {
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
      ds_s[warp][c][lane] = in ? operand<PRECISE>(p * (dpt - delta)) : 0.f;
      dp_s[warp][c][lane] = in ? operand<PRECISE>(dpe) : 0.f;
    }
    __syncwarp();
    const int ni = min(kTile, lq - i0);
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

}  // namespace

// q, k, v, dout, dq, dk, dv: f32 (B, H, L, Dh) views with the given
// (batch, head, row) strides and a unit-stride head dimension; pad: (B, Lk)
// bytes or null; stats: (B * H, Lq, 3) f32 scratch. drop_thresh == 0 runs
// without dropout.
extern "C" int attention_bwd_launch(
    const float* q, long long qsb, long long qsh, long long qsl,
    const float* k, long long ksb, long long ksh, long long ksl,
    const float* v, long long vsb, long long vsh, long long vsl,
    const unsigned char* pad,
    const float* dout, long long dosb, long long dosh, long long dosl,
    float* dq, long long dqsb, long long dqsh, long long dqsl,
    float* dk, long long dksb, long long dksh, long long dksl,
    float* dv, long long dvsb, long long dvsh, long long dvsl,
    float* stats, int batch, int heads, int lq, int lk, int dh, float scale,
    int precise, unsigned int drop_thresh, float inv_keep,
    unsigned long long seed, void* stream) {
  if (dh > kMaxD || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid_q((lq + kBlock - 1) / kBlock, batch * heads);
  const dim3 grid_k((lk + kBlock - 1) / kBlock, batch * heads);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qsl}, ks{ksb, ksh, ksl}, vs{vsb, vsh, vsl},
      dos{dosb, dosh, dosl}, dqs{dqsb, dqsh, dqsl}, dks{dksb, dksh, dksl},
      dvs{dvsb, dvsh, dvsl};
  const Dropout dr{drop_thresh, inv_keep, seed};
#define BUTD_ATTENTION_BWD(PRECISE, DROPOUT)                                 \
  do {                                                                       \
    attention_bwd_dq_kernel<PRECISE, DROPOUT><<<grid_q, block, 0, st>>>(     \
        q, qs, k, ks, v, vs, pad, dout, dos, dq, dqs, stats, heads, lq, lk,  \
        dh, scale, dr);                                                      \
    const cudaError_t err = cudaGetLastError();                              \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    attention_bwd_dkv_kernel<PRECISE, DROPOUT><<<grid_k, block, 0, st>>>(    \
        q, qs, k, ks, v, vs, pad, dout, dos, stats, dk, dks, dv, dvs, heads, \
        lq, lk, dh, scale, dr);                                              \
  } while (0)
  if (precise) {
    if (drop_thresh) BUTD_ATTENTION_BWD(true, true);
    else BUTD_ATTENTION_BWD(true, false);
  } else {
    if (drop_thresh) BUTD_ATTENTION_BWD(false, true);
    else BUTD_ATTENTION_BWD(false, false);
  }
#undef BUTD_ATTENTION_BWD
  return static_cast<int>(cudaGetLastError());
}

BUTD_ERROR_STRING(attention_bwd)
