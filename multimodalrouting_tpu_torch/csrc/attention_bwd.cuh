// Self-attention backward kernels over the strided [N, T, H, dh] view of the
// packed [N, T, H*dh] layout, shared by K2 (packed_attention_bwd.cu) and the
// backward of K4 (flash_attention_bwd.cu). Given q (pre-scaled), k, v, the
// mask, the forward's per-row log-sum-exp lse [N, H, T] and the output
// cotangent do, they recompute the fp32 softmax p = exp(logit + mask term -
// lse) (mask terms as in attention_fwd.cuh) and return
//   dv = p^T do            (p rounded to the input type first),
//   dp = do v^T,
//   ds = p * (dp - delta),
//   dq = ds k, dk = ds^T q (ds rounded to the input type first),
// with fp32 accumulators and outputs in the input type. The scale of q is
// applied outside (autograd owns its gradient). delta is each row's
// rowsum(dp * p):
//   kKeyMask (K2): the dq kernel computes it in a first sweep over the key
//                  tiles, from p and dp as the TPU packed kernel does, and
//                  writes it to a scratch [N, H, T] for the dk/dv kernel;
//   kSegment (K4): the caller passes it in, di = rowsum(o * do) from the
//                  saved output, as the upstream flash backward takes it
//                  (flash_attention.py:273-275), so the dq kernel makes one
//                  sweep: 7 T x T x dh products against K2's 9.
//
// Two kernels, launched in order on one stream:
//   1. dq: one block per (64-query tile, head, chunk);
//   2. dk/dv: one block per (64-key tile, head, chunk). The block computes
//      S^T = K Q^T and dP^T = V dO^T with its keys as the rows, so p^T and
//      ds^T come out of the accumulators already in the A layout of the next
//      products dv += p^T do and dk += ds^T q.
// bf16 multiplies with mma.sync m16n8k16 (fp32 accumulators): the block's own
// rows stay in registers as A fragments, the streamed tiles sit row-major in
// shared memory, and B fragments that run down a column are read as two
// 16-bit loads (ld_col_pair), so no transposed copy is stored. The fp32 path
// is plain FMA, one key (or query) per lane.
//
// Key mask only: a row whose keys are all padding has every logit at exactly
// -1e30 in fp32, so its softmax is uniform, 1/T; its lse rounds to -1e30 and
// loses log T, so such rows (lse below -1e29) take p = 1/T explicitly. Under
// segment ids every row keeps its diagonal and no row needs this.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "mma_bf16.cuh"

namespace attn {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr float kAllPadLse = -1e29f;  // key mask, lse below this: every key of the row is padding

template <int MODE>
__device__ __forceinline__ float recompute_p(float logit, float lse, float inv_t) {
  if (MODE == kKeyMask && lse <= kAllPadLse) return inv_t;
  return expf(logit - lse);
}

// ---------------------------------------------------------------- bf16 path

constexpr int kTile = 64;  // a block's own rows: 4 warps x 16

// A fragments of 16 rows [r0, r0 + 8] x DH of a packed tensor, for the rows'
// whole dh (kept in registers).
template <int DH>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[DH / 16][4], const bf16* base, ll st,
                                            ll r0, int c2) {
  const ll r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int col = kk * 16 + c2;
    a[kk][0] = ld32(base + r0 * st + col);
    a[kk][1] = ld32(base + r1 * st + col);
    a[kk][2] = ld32(base + r0 * st + col + 8);
    a[kk][3] = ld32(base + r1 * st + col + 8);
  }
}

// rows [row0, row0 + ROWS) x DH of a packed tensor into a padded shared tile,
// 16-byte vector loads with consecutive threads along a row.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(bf16 (*dst)[DH + kPad], const bf16* base, ll st, int row0,
                                          int tid) {
  constexpr int kChunks = DH / 8;
  for (int i = tid; i < ROWS * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        *reinterpret_cast<const uint4*>(base + (ll)(row0 + r) * st + c);
  }
}

template <int DH>
__device__ __forceinline__ void store_rows(bf16* base, ll st, ll r0, int c2, const float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    const int col = dn * 8 + c2;
    *reinterpret_cast<uint32_t*>(base + r0 * st + col) = pack_bf16(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(base + (r0 + 8) * st + col) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

template <int DH, int MODE>
__global__ void __launch_bounds__(128) bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, float* __restrict__ delta, int t, ll q_sn, ll q_st, ll k_sn, ll k_st,
    ll v_sn, ll v_st, ll do_sn, ll do_st, ll g_sn, ll g_st) {
  __shared__ __align__(16) bf16 ks[kTile][DH + kPad];  // K tile [key][dim]
  __shared__ __align__(16) bf16 vs[kTile][DH + kPad];  // V tile [key][dim]
  __shared__ float keys[kTile];                        // key_term of each key

  const int n = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const ll hoff = (ll)head * DH;
  const bf16* kb = k + n * k_sn + hoff;
  const bf16* vb = v + n * v_sn + hoff;
  const float* mb = mask + (ll)n * t;
  const ll stat = ((ll)n * gridDim.y + head) * t;  // row offset into lse / delta

  const ll r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a_rows<DH>(qa, q + n * q_sn + hoff, q_st, r0, c2);
  load_a_rows<DH>(da, dout + n * do_sn + hoff, do_st, r0, c2);
  const float lse0 = lse[stat + r0], lse1 = lse[stat + r1];
  const float mq0 = mb[r0], mq1 = mb[r1];  // read by the segment test only
  const float inv_t = 1.f / t;

  float acc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  // segment ids: delta is the caller's di; key mask: pass 0 computes it
  float delta0 = MODE == kSegment ? delta[stat + r0] : 0.f;
  float delta1 = MODE == kSegment ? delta[stat + r1] : 0.f;

  for (int pass = MODE == kSegment ? 1 : 0; pass < 2; ++pass) {  // 0: delta; 1: dq = ds k
    for (int k0 = 0; k0 < t; k0 += kTile) {
      __syncthreads();
      load_tile<DH, kTile>(ks, kb, k_st, k0, tid);
      load_tile<DH, kTile>(vs, vb, v_st, k0, tid);
      if (tid < kTile) keys[tid] = key_term<MODE>(mb[k0 + tid]);
      __syncthreads();

      float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          mma_bf16(s[j], qa[kk], ld32(&ks[j * 8 + g][kk * 16 + c2]), ld32(&ks[j * 8 + g][kk * 16 + c2 + 8]));
          mma_bf16(dp[j], da[kk], ld32(&vs[j * 8 + g][kk * 16 + c2]), ld32(&vs[j * 8 + g][kk * 16 + c2 + 8]));
        }
        const float n0 = keys[j * 8 + c2], n1 = keys[j * 8 + c2 + 1];
        s[j][0] = recompute_p<MODE>(masked<MODE>(s[j][0], mq0, n0), lse0, inv_t);
        s[j][1] = recompute_p<MODE>(masked<MODE>(s[j][1], mq0, n1), lse0, inv_t);
        s[j][2] = recompute_p<MODE>(masked<MODE>(s[j][2], mq1, n0), lse1, inv_t);
        s[j][3] = recompute_p<MODE>(masked<MODE>(s[j][3], mq1, n1), lse1, inv_t);
      }
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          delta0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
          delta1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {  // ds = p * (dp - delta), in place of p
        s[j][0] *= dp[j][0] - delta0;
        s[j][1] *= dp[j][1] - delta0;
        s[j][2] *= dp[j][2] - delta1;
        s[j][3] *= dp[j][3] - delta1;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);  // ds rounded to bf16
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn) {
          mma_bf16(acc[dn], a, ld_col_pair(&ks[kk * 16 + c2][dn * 8 + g], DH + kPad),
                   ld_col_pair(&ks[kk * 16 + c2 + 8][dn * 8 + g], DH + kPad));
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        delta0 += __shfl_xor_sync(0xffffffffu, delta0, off);
        delta1 += __shfl_xor_sync(0xffffffffu, delta1, off);
      }
      if ((lane & 3) == 0) {
        delta[stat + r0] = delta0;
        delta[stat + r1] = delta1;
      }
    }
  }
  store_rows<DH>(dq + n * g_sn + hoff, g_st, r0, c2, acc);
}

template <int DH, int QT, int MODE>  // QT queries per shared tile
__global__ void __launch_bounds__(128) bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int t, ll q_sn,
    ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll do_sn, ll do_st, ll g_sn, ll g_st) {
  __shared__ __align__(16) bf16 qs[QT][DH + kPad];   // Q tile [query][dim]
  __shared__ __align__(16) bf16 dos[QT][DH + kPad];  // dO tile [query][dim]
  __shared__ float lses[QT], deltas[QT], mqs[QT];    // mqs: the queries' mask values (segment ids)

  const int n = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const ll hoff = (ll)head * DH;
  const bf16* qb = q + n * q_sn + hoff;
  const bf16* dob = dout + n * do_sn + hoff;
  const float* mb = mask + (ll)n * t;
  const ll stat = ((ll)n * gridDim.y + head) * t;

  // this thread's key rows r0, r1: the rows of S^T, dP^T, dk, dv
  const ll r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a_rows<DH>(ka, k + n * k_sn + hoff, k_st, r0, c2);
  load_a_rows<DH>(va, v + n * v_sn + hoff, v_st, r0, c2);
  const float key0 = key_term<MODE>(mb[r0]), key1 = key_term<MODE>(mb[r1]);
  const float inv_t = 1.f / t;

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int qq0 = 0; qq0 < t; qq0 += QT) {
    __syncthreads();
    load_tile<DH, QT>(qs, qb, q_st, qq0, tid);
    load_tile<DH, QT>(dos, dob, do_st, qq0, tid);
    if (tid < QT) {
      lses[tid] = lse[stat + qq0 + tid];
      deltas[tid] = delta[stat + qq0 + tid];
      if (MODE == kSegment) mqs[tid] = mb[qq0 + tid];
    }
    __syncthreads();

    float s[QT / 8][4], dp[QT / 8][4];  // S^T then p^T; dP^T then ds^T
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        mma_bf16(s[j], ka[kk], ld32(&qs[j * 8 + g][kk * 16 + c2]), ld32(&qs[j * 8 + g][kk * 16 + c2 + 8]));
        mma_bf16(dp[j], va[kk], ld32(&dos[j * 8 + g][kk * 16 + c2]), ld32(&dos[j * 8 + g][kk * 16 + c2 + 8]));
      }
      const int c = j * 8 + c2;  // the two query columns of this thread
      const float l0 = lses[c], l1 = lses[c + 1], d0 = deltas[c], d1 = deltas[c + 1];
      const float mq0 = MODE == kSegment ? mqs[c] : 0.f, mq1 = MODE == kSegment ? mqs[c + 1] : 0.f;
      s[j][0] = recompute_p<MODE>(masked<MODE>(s[j][0], mq0, key0), l0, inv_t);
      s[j][1] = recompute_p<MODE>(masked<MODE>(s[j][1], mq1, key0), l1, inv_t);
      s[j][2] = recompute_p<MODE>(masked<MODE>(s[j][2], mq0, key1), l0, inv_t);
      s[j][3] = recompute_p<MODE>(masked<MODE>(s[j][3], mq1, key1), l1, inv_t);
      dp[j][0] = s[j][0] * (dp[j][0] - d0);
      dp[j][1] = s[j][1] * (dp[j][1] - d1);
      dp[j][2] = s[j][2] * (dp[j][2] - d0);
      dp[j][3] = s[j][3] * (dp[j][3] - d1);
    }
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);    // p rounded to bf16
      acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);  // ds rounded to bf16
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        mma_bf16(dv_acc[dn], pa, ld_col_pair(&dos[kk * 16 + c2][dn * 8 + g], DH + kPad),
                 ld_col_pair(&dos[kk * 16 + c2 + 8][dn * 8 + g], DH + kPad));
        mma_bf16(dk_acc[dn], sa, ld_col_pair(&qs[kk * 16 + c2][dn * 8 + g], DH + kPad),
                 ld_col_pair(&qs[kk * 16 + c2 + 8][dn * 8 + g], DH + kPad));
      }
    }
  }
  store_rows<DH>(dk + n * g_sn + hoff, g_st, r0, c2, dk_acc);
  store_rows<DH>(dv + n * g_sn + hoff, g_st, r0, c2, dv_acc);
}

// ----------------------------------------------------------------- fp32 path

constexpr int kFR = 8;   // a block's own rows (4 warps x 2)
constexpr int kFT = 32;  // streamed rows per tile: one per lane

template <int DH, int MODE>
__global__ void __launch_bounds__(128) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ delta, int t, ll q_sn, ll q_st, ll k_sn, ll k_st,
    ll v_sn, ll v_st, ll do_sn, ll do_st, ll g_sn, ll g_st) {
  __shared__ float qs[kFR][DH], dos[kFR][DH];
  __shared__ float ks[kFT][DH + 1], vs[kFT][DH + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float keys[kFT];

  const int n = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kFR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const ll hoff = (ll)head * DH;
  const float* kb = k + n * k_sn + hoff;
  const float* vb = v + n * v_sn + hoff;
  const float* mb = mask + (ll)n * t;
  const ll stat = ((ll)n * gridDim.y + head) * t;
  for (int i = tid; i < kFR * DH; i += 128) {
    const ll r = q0 + i / DH;
    qs[i / DH][i % DH] = q[n * q_sn + hoff + r * q_st + i % DH];
    dos[i / DH][i % DH] = dout[n * do_sn + hoff + r * do_st + i % DH];
  }

  constexpr int kRows = kFR / 4;
  constexpr int kPer = DH / 32;
  const float inv_t = 1.f / t;
  float lse_r[kRows], delta_r[kRows], mq[kRows], acc[kRows][kPer];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const ll row = q0 + warp * kRows + rr;
    lse_r[rr] = lse[stat + row];
    delta_r[rr] = MODE == kSegment ? delta[stat + row] : 0.f;
    mq[rr] = mb[row];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[rr][e] = 0.f;
  }

  for (int pass = MODE == kSegment ? 1 : 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < t; k0 += kFT) {
      __syncthreads();
      for (int i = tid; i < kFT * DH; i += 128) {
        const int r = i / DH, c = i % DH;
        ks[r][c] = kb[(ll)(k0 + r) * k_st + c];
        vs[r][c] = vb[(ll)(k0 + r) * v_st + c];
      }
      if (tid < kFT) keys[tid] = key_term<MODE>(mb[k0 + tid]);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int row = warp * kRows + rr;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          s = fmaf(qs[row][d], ks[lane][d], s);
          dp = fmaf(dos[row][d], vs[lane][d], dp);
        }
        const float p = recompute_p<MODE>(masked<MODE>(s, mq[rr], keys[lane]), lse_r[rr], inv_t);
        if (pass == 0) {
          delta_r[rr] = fmaf(p, dp, delta_r[rr]);
          continue;
        }
        const float ds = p * (dp - delta_r[rr]);
        for (int j = 0; j < kFT; ++j) {
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[rr][e] = fmaf(dsj, ks[j][lane + 32 * e], acc[rr][e]);
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) delta_r[rr] += __shfl_xor_sync(0xffffffffu, delta_r[rr], off);
        if (lane == 0) delta[stat + q0 + warp * kRows + rr] = delta_r[rr];
      }
    }
  }
  float* gb = dq + n * g_sn + hoff;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const ll row = q0 + warp * kRows + rr;
#pragma unroll
    for (int e = 0; e < kPer; ++e) gb[row * g_st + lane + 32 * e] = acc[rr][e];
  }
}

template <int DH, int MODE>
__global__ void __launch_bounds__(128) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int t, ll q_sn,
    ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll do_sn, ll do_st, ll g_sn, ll g_st) {
  __shared__ float kks[kFR][DH], vvs[kFR][DH];  // the block's own keys
  __shared__ float qs[kFT][DH + 1], dos[kFT][DH + 1];
  __shared__ float lses[kFT], deltas[kFT], mqs[kFT];  // mqs: the queries' mask values (segment ids)

  const int n = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * kFR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const ll hoff = (ll)head * DH;
  const float* qb = q + n * q_sn + hoff;
  const float* dob = dout + n * do_sn + hoff;
  const float* mb = mask + (ll)n * t;
  const ll stat = ((ll)n * gridDim.y + head) * t;
  for (int i = tid; i < kFR * DH; i += 128) {
    const ll r = k0 + i / DH;
    kks[i / DH][i % DH] = k[n * k_sn + hoff + r * k_st + i % DH];
    vvs[i / DH][i % DH] = v[n * v_sn + hoff + r * v_st + i % DH];
  }

  constexpr int kRows = kFR / 4;
  constexpr int kPer = DH / 32;
  const float inv_t = 1.f / t;
  float key_r[kRows], dk_acc[kRows][kPer], dv_acc[kRows][kPer];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    key_r[rr] = key_term<MODE>(mb[k0 + warp * kRows + rr]);
#pragma unroll
    for (int e = 0; e < kPer; ++e) dk_acc[rr][e] = dv_acc[rr][e] = 0.f;
  }

  for (int qq0 = 0; qq0 < t; qq0 += kFT) {
    __syncthreads();
    for (int i = tid; i < kFT * DH; i += 128) {
      const int r = i / DH, c = i % DH;
      qs[r][c] = qb[(ll)(qq0 + r) * q_st + c];
      dos[r][c] = dob[(ll)(qq0 + r) * do_st + c];
    }
    if (tid < kFT) {
      lses[tid] = lse[stat + qq0 + tid];
      deltas[tid] = delta[stat + qq0 + tid];
      if (MODE == kSegment) mqs[tid] = mb[qq0 + tid];
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = warp * kRows + rr;  // this warp's key; the lane is a query
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qs[lane][d], kks[row][d], s);
        dp = fmaf(dos[lane][d], vvs[row][d], dp);
      }
      const float p = recompute_p<MODE>(masked<MODE>(s, mqs[lane], key_r[rr]), lses[lane], inv_t);
      const float ds = p * (dp - deltas[lane]);
      for (int j = 0; j < kFT; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          dv_acc[rr][e] = fmaf(pj, dos[j][lane + 32 * e], dv_acc[rr][e]);
          dk_acc[rr][e] = fmaf(dsj, qs[j][lane + 32 * e], dk_acc[rr][e]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const ll row = k0 + warp * kRows + rr;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      dk[n * g_sn + hoff + row * g_st + lane + 32 * e] = dk_acc[rr][e];
      dv[n * g_sn + hoff + row * g_st + lane + 32 * e] = dv_acc[rr][e];
    }
  }
}

// ----------------------------------------------------------------- launches

// The callers' wrappers have checked: t % 64 == 0, dh in {64, 128}, q/k/v/do
// with a contiguous head row and 16-byte aligned rows and base pointers, mask
// a contiguous fp32 [n, t], lse and delta contiguous fp32 [n, heads, t]
// (delta: K2's scratch, written by the dq kernel; K4's di, read), dq/dk/dv one
// contiguous layout (strides g_sn, g_st). Returns the first cudaError_t of
// the two launches.
template <int MODE>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const float* mask, const float* lse,
                    const void* dout, void* dq, void* dk, void* dv, float* delta, int n, int t, int heads,
                    int dh, ll q_sn, ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll do_sn, ll do_st,
                    ll g_sn, ll g_st, void* stream) {
  const dim3 grid(t / kTile, heads, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  if (dh == 64) {
    bwd_dq_bf16_kernel<64, MODE><<<grid, 128, 0, s>>>(qb, kb, vb, mask, lse, db, static_cast<bf16*>(dq), delta,
                                                      t, q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st,
                                                      g_sn, g_st);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bwd_dkdv_bf16_kernel<64, 64, MODE><<<grid, 128, 0, s>>>(qb, kb, vb, mask, lse, db, delta,
                                                            static_cast<bf16*>(dk), static_cast<bf16*>(dv), t,
                                                            q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st,
                                                            g_sn, g_st);
  } else if (dh == 128) {
    bwd_dq_bf16_kernel<128, MODE><<<grid, 128, 0, s>>>(qb, kb, vb, mask, lse, db, static_cast<bf16*>(dq), delta,
                                                       t, q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st,
                                                       g_sn, g_st);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bwd_dkdv_bf16_kernel<128, 32, MODE><<<grid, 128, 0, s>>>(qb, kb, vb, mask, lse, db, delta,
                                                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), t,
                                                             q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st,
                                                             g_sn, g_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_bwd_f32(const void* q, const void* k, const void* v, const float* mask, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* delta, int n, int t, int heads,
                   int dh, ll q_sn, ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll do_sn, ll do_st,
                   ll g_sn, ll g_st, void* stream) {
  const dim3 grid(t / kFR, heads, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dh == 64) {
    bwd_dq_f32_kernel<64, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, dqf, delta, t, q_sn, q_st, k_sn,
                                                     k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bwd_dkdv_f32_kernel<64, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, delta, dkf, dvf, t, q_sn, q_st,
                                                       k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st);
  } else if (dh == 128) {
    bwd_dq_f32_kernel<128, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, dqf, delta, t, q_sn, q_st, k_sn,
                                                      k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    bwd_dkdv_f32_kernel<128, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, delta, dkf, dvf, t, q_sn,
                                                        q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
