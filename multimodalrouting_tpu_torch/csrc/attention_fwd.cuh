// Self-attention forward kernels over the strided [N, T, H, dh] view of the
// projections' packed [N, T, H*dh] layout (q already scaled), shared by K1
// (packed_attention.cu) and K4 (flash_attention.cu). The two differ only in
// the mask term added to the fp32 logits, a template parameter:
//   kKeyMask (K1): (1 - m[key]) * -1e30, the TPU packed kernel's key mask; a
//                  query row whose keys are all padding gets uniform weights;
//   kSegment (K4): 0 where m[query] == m[key], else -0.7 * FLT_MAX, the
//                  upstream flash/splash kernels' segment ids (q = kv = the
//                  mask): a valid query attends the valid keys, a pad query
//                  the pad keys, an all-pad chunk all of its keys. Every row
//                  keeps its own diagonal, so no row is fully masked.
// fp32 softmax, p rounded to the input type before p @ v, fp32 accumulation,
// output in the input type and packed layout.
//
// Design. One block per (64-query tile, head, chunk); four warps, each owning
// 16 query rows. Row strides are arguments, so no transpose or copy is made
// around the kernel. Keys and values stream through shared memory in tiles of
// 64 with an online softmax (running max and sum per row in registers), so a
// block holds O(64 * dh) state whatever T is. The bf16 path multiplies with
// mma.sync m16n8k16 (fp32 accumulators): Q fragments stay in registers, the
// S = Q K^T accumulator fragments are re-packed in registers as the A operand
// of P V, and V is stored transposed in shared memory so that its B fragments
// are single 32-bit loads. The fp32 path is plain FMA, one key per lane.
//
// The online softmax rounds p to bf16 before it is normalised (relative to
// the running maximum); a plain version that normalises first differs from it
// by a few bf16 ulps of the output (the tolerance in the tests says so).
//
// Under a gradient the caller also asks for each row's log-sum-exp
// (lse = m + log l of the online softmax, fp32 [N, H, T]), which the backward
// kernels (attention_bwd.cuh) use to recompute p; serving passes a null
// pointer and writes nothing more.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace attn {

enum MaskMode : int { kKeyMask = 0, kSegment = 1 };

constexpr float kKeyMaskNeg = -1e30f;
constexpr float kSegmentNeg = -0.7f * FLT_MAX;

// What a block keeps for each key of a tile: the additive key term (K1), or
// the key's own mask value, its segment id (K4).
template <int MODE>
__device__ __forceinline__ float key_term(float m) {
  return MODE == kKeyMask ? (1.0f - m) * kKeyMaskNeg : m;
}

// A logit plus its mask term, for a query whose mask value is mq.
template <int MODE>
__device__ __forceinline__ float masked(float s, float mq, float key) {
  return MODE == kKeyMask ? s + key : s + (mq == key ? 0.f : kSegmentNeg);
}

// ---------------------------------------------------------------- bf16 path

constexpr int kBQ = 64;   // query rows per block (4 warps x 16)
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;   // bf16 padding per shared row: conflict-free fragment loads

template <int DH, int MODE>
__global__ void __launch_bounds__(128) attention_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int t, long long q_sn, long long q_st,
    long long k_sn, long long k_st, long long v_sn, long long v_st,
    long long o_sn, long long o_st) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][DH + kPad];   // K tile [key][dim]
  __shared__ __align__(16) __nv_bfloat16 vts[DH][kBK + kPad];  // V tile transposed [dim][key]
  __shared__ float keys[kBK];                                  // key_term of each key

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // fragment row group
  const int c2 = (lane & 3) * 2;  // fragment column pair

  const __nv_bfloat16* qb = q + n * q_sn + (long long)head * DH;
  const __nv_bfloat16* kb = k + n * k_sn + (long long)head * DH;
  const __nv_bfloat16* vb = v + n * v_sn + (long long)head * DH;
  const float* mb = mask + (long long)n * t;

  // A fragments of this warp's 16 query rows, resident for the whole sweep.
  const long long r0 = q0 + warp * 16 + g;
  const long long r1 = r0 + 8;
  const float mq0 = mb[r0], mq1 = mb[r1];  // read by the segment test only
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int col = kk * 16 + c2;
    qa[kk][0] = ld32(qb + r0 * q_st + col);
    qa[kk][1] = ld32(qb + r1 * q_st + col);
    qa[kk][2] = ld32(qb + r0 * q_st + col + 8);
    qa[kk][3] = ld32(qb + r1 * q_st + col + 8);
  }

  float o[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int k0 = 0; k0 < t; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed by every warp
    for (int i = tid; i < kBK * kChunks; i += 128) {
      const int r = i / kChunks;  // K: consecutive threads along a row (coalesced)
      const int c = (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(&ks[r][c]) =
          *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_st + c);
    }
    for (int i = tid; i < kBK * kChunks; i += 128) {
      const int r = i % kBK;  // V: consecutive threads along keys (conflict-free transpose)
      const int c = (i / kBK) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_st + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[c + j][r] = e[j];
    }
    if (tid < kBK) keys[tid] = key_term<MODE>(mb[k0 + tid]);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t b0 = ld32(&ks[j * 8 + g][kk * 16 + c2]);
        const uint32_t b1 = ld32(&ks[j * 8 + g][kk * 16 + c2 + 8]);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }

    // Online softmax; this thread holds rows g and g+8, 16 columns each.
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float n0 = keys[j * 8 + c2], n1 = keys[j * 8 + c2 + 1];
      s[j][0] = masked<MODE>(s[j][0], mq0, n0);
      s[j][1] = masked<MODE>(s[j][1], mq0, n1);
      s[j][2] = masked<MODE>(s[j][2], mq1, n0);
      s[j][3] = masked<MODE>(s[j][3], mq1, n1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float corr0 = expf(m_run[0] - mx0);  // 0 on the first tile (m_run = -inf)
    const float corr1 = expf(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l_run[0] = l_run[0] * corr0 + rs0;
    l_run[1] = l_run[1] * corr1 + rs1;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      o[dn][0] *= corr0;
      o[dn][1] *= corr0;
      o[dn][2] *= corr1;
      o[dn][3] *= corr1;
    }

    // O += P V: the accumulator layout of two S n-tiles is the A layout of one k-step.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        const uint32_t b0 = ld32(&vts[dn * 8 + g][kk * 16 + c2]);
        const uint32_t b1 = ld32(&vts[dn * 8 + g][kk * 16 + c2 + 8]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  __nv_bfloat16* ob = out + n * o_sn + (long long)head * DH;
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    const int col = dn * 8 + c2;
    *reinterpret_cast<uint32_t*>(ob + r0 * o_st + col) = pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + r1 * o_st + col) = pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
  }
  if (lse != nullptr && (lane & 3) == 0) {  // the quad holds one row's m and l
    float* lb = lse + ((long long)n * gridDim.y + head) * t;
    lb[r0] = m_run[0] + logf(l_run[0]);
    lb[r1] = m_run[1] + logf(l_run[1]);
  }
}

// ----------------------------------------------------------------- fp32 path

constexpr int kFQ = 16;  // query rows per block (4 warps x 4 rows)
constexpr int kFK = 32;  // keys per tile: one per lane

template <int DH, int MODE>
__global__ void __launch_bounds__(128) attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ lse, int t, long long q_sn, long long q_st,
    long long k_sn, long long k_st, long long v_sn, long long v_st,
    long long o_sn, long long o_st) {
  __shared__ float qs[kFQ][DH];
  __shared__ float ks[kFK][DH + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float vs[kFK][DH];
  __shared__ float keys[kFK];

  const int n = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kFQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qb = q + n * q_sn + (long long)head * DH;
  const float* kb = k + n * k_sn + (long long)head * DH;
  const float* vb = v + n * v_sn + (long long)head * DH;
  const float* mb = mask + (long long)n * t;

  for (int i = tid; i < kFQ * DH; i += 128) qs[i / DH][i % DH] = qb[(long long)(q0 + i / DH) * q_st + i % DH];

  constexpr int kRows = kFQ / 4;
  constexpr int kPer = DH / 32;
  float m_run[kRows], l_run[kRows], mq[kRows], acc[kRows][kPer];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
    mq[rr] = mb[q0 + warp * kRows + rr];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[rr][e] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kFK) {
    __syncthreads();
    for (int i = tid; i < kFK * DH; i += 128) {
      const int r = i / DH, c = i % DH;
      ks[r][c] = kb[(long long)(k0 + r) * k_st + c];
      vs[r][c] = vb[(long long)(k0 + r) * v_st + c];
    }
    if (tid < kFK) keys[tid] = key_term<MODE>(mb[k0 + tid]);
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = warp * kRows + rr;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
      s = masked<MODE>(s, mq[rr], keys[lane]);
      float mx = s;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(mx, m_run[rr]);
      const float corr = expf(m_run[rr] - mx);
      const float p = expf(s - mx);
      float sum = p;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * corr + sum;
      m_run[rr] = mx;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[rr][e] *= corr;
      for (int j = 0; j < kFK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[rr][e] = fmaf(pj, vs[j][lane + 32 * e], acc[rr][e]);
      }
    }
  }

  float* ob = out + n * o_sn + (long long)head * DH;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const long long row = q0 + warp * kRows + rr;
    const float inv = 1.f / l_run[rr];
#pragma unroll
    for (int e = 0; e < kPer; ++e) ob[row * o_st + lane + 32 * e] = acc[rr][e] * inv;
    if (lse != nullptr && lane == 0) {
      lse[((long long)n * gridDim.y + head) * t + row] = m_run[rr] + logf(l_run[rr]);
    }
  }
}

// ----------------------------------------------------------------- launches

// The callers' wrappers have checked: t % 64 == 0, dh in {64, 128}, inner
// dimension contiguous, row strides and base pointers 16-byte aligned, mask a
// contiguous fp32 [n, t]; lse is null or a contiguous fp32 [n, heads, t].
// Returns the cudaError_t of the launch.
template <int MODE>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
                    int n, int t, int heads, int dh, long long q_sn, long long q_st, long long k_sn,
                    long long k_st, long long v_sn, long long v_st, long long o_sn, long long o_st,
                    void* stream) {
  const dim3 grid(t / kBQ, heads, n);
  using B = __nv_bfloat16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    attention_fwd_bf16_kernel<64, MODE><<<grid, 128, 0, s>>>(
        static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v), mask,
        static_cast<B*>(out), lse, t, q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st);
  } else if (dh == 128) {
    attention_fwd_bf16_kernel<128, MODE><<<grid, 128, 0, s>>>(
        static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v), mask,
        static_cast<B*>(out), lse, t, q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_fwd_f32(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
                   int n, int t, int heads, int dh, long long q_sn, long long q_st, long long k_sn,
                   long long k_st, long long v_sn, long long v_st, long long o_sn, long long o_st,
                   void* stream) {
  const dim3 grid(t / kFQ, heads, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  if (dh == 64) {
    attention_fwd_f32_kernel<64, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, of, lse, t, q_sn, q_st,
                                                            k_sn, k_st, v_sn, v_st, o_sn, o_st);
  } else if (dh == 128) {
    attention_fwd_f32_kernel<128, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, of, lse, t, q_sn, q_st,
                                                             k_sn, k_st, v_sn, v_st, o_sn, o_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
