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
// fp32 logits and online softmax, p rounded to the input type unnormalised
// (relative to the running maximum) before p @ v, fp32 accumulation, output
// in the input type and the caller's layout. A plain version that normalises
// p first differs by a few bf16 ulps of the output (the TPU order's limits in
// chip_smoke.py); ops/flash.py's attention_fwd_tiled_reference is the plain
// version in this kernel's own order.
//
// Under a gradient the caller also asks for each row's log-sum-exp
// (lse = m + log l in natural log, fp32 [N, H, T]), which the backward
// kernels (attention_bwd.cuh) use to recompute p; serving passes a null
// pointer and writes nothing more.
//
// bf16 path (sm_90a; building blocks in sm90.cuh). Work items are
// (128-query tile, head, chunk); the grid is persistent, one block per SM,
// each taking every gridDim.x-th item. A block is two consumer warpgroups of
// 64 query rows each and one producer warpgroup, which lowers its registers
// to 24 (setmaxnreg) so that the consumers can raise theirs to 240. The
// producer's one thread loads each item's Q tile (two buffers, so the next
// item's Q lands while this one runs) and streams K and V tiles of BK keys
// (128 at dh 64, 64 at dh 128) through a ring of kFwdStages stages that runs
// on across items, by TMA in the 128-byte swizzle (4-D tensor maps over the
// caller's strides: the packed slices and K4's views are read in place),
// each K tile with its BK mask values by bulk copy. So the next item's loads
// are in flight while the consumers finish this one: at T = 512 an item is
// only 4 key tiles, and a block per item would pay its fill and drain each
// time. K and V have their own full
// barriers, so S = Q K^T starts before V lands; each stage's empty barrier
// (and each Q buffer's) takes one arrival from every consumer thread once
// its products on it have retired. Both consumers read every stage, so K
// and V are read from L2 once per 128 queries.
// Per tile a consumer issues S = Q K^T (wgmma, both operands K-major in
// shared memory) together with O += P V of the previous tile (wgmma with P
// in registers, the accumulator fragment of S packed to bf16 in place, and V
// read MN-major through the transpose flag: no transposed copy, and p never
// touches shared memory), then does the softmax of this tile while P V still
// runs. Two named barriers make the two consumers take turns at issuing
// (ping-pong), so that one's exponentials overlap the other's products.
// The softmax works in the log2 domain, x = s log2 e + mask term, with the
// hardware ex2; the segment mask term is -0.7 FLT_MAX itself (not times
// log2 e, which would overflow to -inf and make a fully masked tile's
// (-inf) - (-inf) correction NaN), so masked keys still weigh exactly 0
// against any unmasked key and exactly 1 against each other, as in the
// natural domain. Where a thread's two rows share a segment (all but the
// rows at a pad boundary), the segment test is made once per key. The
// epilogue scales O by 1 / l and stores bf16 rows.
//
// fp32 path: plain FMA, one key per lane (the tight check and fp32 serving);
// a warp's four rows advance together, so no spill.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn {

using bf16 = __nv_bfloat16;
using ll = long long;
using sm90::acc_to_a_frag;
using sm90::pack_bf16;

enum MaskMode : int { kKeyMask = 0, kSegment = 1 };

constexpr float kKeyMaskNeg = -1e30f;
constexpr float kSegmentNeg = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// The same in the log2 domain, from the key's raw mask value mk: one FMA.
// K1's term is scaled (-1.44e30, finite); K4's is kSegmentNeg unscaled (see
// the header note).
template <int MODE>
__device__ __forceinline__ float masked_log2(float s, float mq, float mk) {
  return MODE == kKeyMask ? fmaf(s, kLog2e, (1.0f - mk) * (kKeyMaskNeg * kLog2e))
                          : fmaf(s, kLog2e, mq == mk ? 0.f : kSegmentNeg);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 and r0 + 8 of a 64-column half accumulator into bf16 output rows.
__device__ __forceinline__ void store_half(bf16* base, ll st, ll r0, int col0, int c2, const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j * 8 + c2;
    *reinterpret_cast<uint32_t*>(base + r0 * st + col) = pack_bf16(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(base + (r0 + 8) * st + col) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ---------------------------------------------------------------- bf16 path

constexpr int kFwdConsumers = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kFwdBQ = 64 * kFwdConsumers;           // query rows per block
constexpr int kFwdThreads = 128 * (kFwdConsumers + 1);  // + one producer warpgroup
constexpr int kFwdStages = 3;                        // ring depth of the K/V tiles
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPingPong = 1;  // named barriers kPingPong + c, c = consumer warpgroup

template <int DH>
__host__ __device__ constexpr int fwd_block_k() {
  return DH == 64 ? 128 : 64;  // dh 128: 64 keys keep S, P and two O halves in registers
}

template <int DH>
constexpr int fwd_smem_bytes() {
  constexpr int kBK = fwd_block_k<DH>();
  // two Q tiles; K and V per stage; the stages' key mask values; barriers; alignment slack
  return 2 * kFwdBQ * DH * 2 + kFwdStages * 2 * kBK * DH * 2 + kFwdStages * kBK * 4 + (3 * kFwdStages + 4) * 8 +
         sm90::kAtomBytes;
}

// S = Q K^T for one consumer's 64 rows (qc) and the BK keys at ks, into sc
// (issued, not committed).
template <int DH, int BK>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[BK / 2], const uint8_t* qc, const uint8_t* ks) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int col = (kk % 4) * 32;
    sm90::wgmma_ss<BK>(sc, sm90::desc_kmajor(qc + (kk / 4) * kFwdBQ * 128 + col),
                       sm90::desc_kmajor(ks + (kk / 4) * BK * 128 + col), kk > 0);
  }
}

// O += P V for the BK values at vs (issued, not committed).
template <int KH, int BK>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[KH][32], const uint32_t (&pa)[BK / 16][4],
                                             const uint8_t* vs) {
#pragma unroll
  for (int h = 0; h < KH; ++h)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      sm90::wgmma_rs_n64_mn(o[h], pa[kk], sm90::desc_mnmajor(vs + h * BK * 128 + kk * 2 * sm90::kAtomBytes));
    }
}

// The online softmax of one tile's logits sc (mask values at kt) for rows
// r0, r1 (this thread's columns c2, c2 + 1 of every 8): p in place of s, the
// running maximum m (log2 domain) and this thread's part of the running sum
// l updated; corr is each row's correction of O and l.
template <int MODE, int BK>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BK / 2], const float* kt, int c2, float mq0, float mq1,
                                            float& m0, float& m1, float& l0, float& l1, float& corr0,
                                            float& corr1) {
  if (MODE == kSegment && mq0 == mq1) {  // both rows in one segment: one compare per key
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float2 mk = *reinterpret_cast<const float2*>(kt + jj * 8 + c2);
      const float tx = mk.x == mq0 ? 0.f : kSegmentNeg, ty = mk.y == mq0 ? 0.f : kSegmentNeg;
      sc[4 * jj + 0] = fmaf(sc[4 * jj + 0], kLog2e, tx);
      sc[4 * jj + 1] = fmaf(sc[4 * jj + 1], kLog2e, ty);
      sc[4 * jj + 2] = fmaf(sc[4 * jj + 2], kLog2e, tx);
      sc[4 * jj + 3] = fmaf(sc[4 * jj + 3], kLog2e, ty);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float2 mk = *reinterpret_cast<const float2*>(kt + jj * 8 + c2);
      sc[4 * jj + 0] = masked_log2<MODE>(sc[4 * jj + 0], mq0, mk.x);
      sc[4 * jj + 1] = masked_log2<MODE>(sc[4 * jj + 1], mq0, mk.y);
      sc[4 * jj + 2] = masked_log2<MODE>(sc[4 * jj + 2], mq1, mk.x);
      sc[4 * jj + 3] = masked_log2<MODE>(sc[4 * jj + 3], mq1, mk.y);
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * jj + 0], sc[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the quad's four lanes hold a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  corr0 = ex2(m0 - mx0);  // 0 on the first tile (m = -inf)
  corr1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj) {
    sc[4 * jj + 0] = ex2(sc[4 * jj + 0] - mx0);
    sc[4 * jj + 1] = ex2(sc[4 * jj + 1] - mx0);
    sc[4 * jj + 2] = ex2(sc[4 * jj + 2] - mx1);
    sc[4 * jj + 3] = ex2(sc[4 * jj + 3] - mx1);
    rs0 += sc[4 * jj + 0] + sc[4 * jj + 1];
    rs1 += sc[4 * jj + 2] + sc[4 * jj + 3];
  }
  l0 = l0 * corr0 + rs0;
  l1 = l1 * corr1 + rs1;
}

// p (fp32 in sc) rounded to bf16 as the register A operand of O += P V.
template <int BK>
__device__ __forceinline__ void fwd_pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) acc_to_a_frag(pa[kk], sc, kk);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(kFwdThreads, 1) attention_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask, bf16* __restrict__ out,
    float* __restrict__ lse, int t, int heads, int work, ll o_sn, ll o_st) {
  constexpr int kH = DH / 64;                  // 64-column halves per row
  constexpr int kBK = fwd_block_k<DH>();
  constexpr int kQHalf = kFwdBQ * 128;         // one 128-row half of Q
  constexpr int kQB = kH * kQHalf;             // one Q tile
  constexpr int kKVHalf = kBK * 128;           // one BK-row half of K or V
  constexpr int kKVB = kH * kKVHalf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align_1024(smem_raw);   // Q tiles of even and odd work items
  uint8_t* ring = q_s + 2 * kQB;               // stage s: K at s * 2 kKVB, V kKVB further
  float* keys_s = reinterpret_cast<float*>(ring + kFwdStages * 2 * kKVB);  // [kFwdStages][kBK] mask values
  uint64_t* kfull = reinterpret_cast<uint64_t*>(keys_s + kFwdStages * kBK);
  uint64_t* vfull = kfull + kFwdStages;
  uint64_t* empty = vfull + kFwdStages;
  uint64_t* qfull = empty + kFwdStages;        // [2]
  uint64_t* qempty = qfull + 2;                // [2]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles = t / kBK, qtiles = t / kFwdBQ;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], 128 * kFwdConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&qfull[b], 1);
      sm90::mbar_init(&qempty[b], 128 * kFwdConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Persistent: block b takes work items b, b + gridDim.x, ... (work item
  // w: query tile w % qtiles of head (w / qtiles) % heads of chunk
  // w / (qtiles heads)), so the producer loads the next item's Q and first
  // K/V stages while the consumers finish this one.
  if (wg == kFwdConsumers) {  // producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kFwdConsumers) {
      int c = 0;  // K/V tiles issued, over every work item of the block
      for (int w = blockIdx.x, i = 0; w < work; w += gridDim.x, ++i) {
        const int q0 = (w % qtiles) * kFwdBQ, head = (w / qtiles) % heads, n = w / (qtiles * heads);
        const int qb = i & 1;
        if (i >= 2) sm90::mbar_wait(&qempty[qb], ((i >> 1) - 1) & 1);
        sm90::mbar_expect_tx(&qfull[qb], kQB);
        for (int h = 0; h < kH; ++h) {
          sm90::tma_load_4d(q_s + qb * kQB + h * kQHalf, &tq, &qfull[qb], h * 64, head, q0, n);
        }
        for (int j = 0; j < tiles; ++j, ++c) {
          const int s = c % kFwdStages;
          if (c >= kFwdStages) sm90::mbar_wait(&empty[s], (c / kFwdStages - 1) & 1);
          uint8_t* ks = ring + s * 2 * kKVB;
          sm90::mbar_expect_tx(&kfull[s], kKVB + kBK * 4);
          for (int h = 0; h < kH; ++h) {
            sm90::tma_load_4d(ks + h * kKVHalf, &tk, &kfull[s], h * 64, head, j * kBK, n);
          }
          sm90::bulk_load(keys_s + s * kBK, mask + (ll)n * t + j * kBK, kBK * 4, &kfull[s]);
          sm90::mbar_expect_tx(&vfull[s], kKVB);
          for (int h = 0; h < kH; ++h) {
            sm90::tma_load_4d(ks + kKVB + h * kKVHalf, &tv, &vfull[s], h * 64, head, j * kBK, n);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each query tile
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int my_turn = kPingPong + wg, other_turn = kPingPong + (1 - wg);
    float o[kH][32], sc[kBK / 2];
    uint32_t pa[kBK / 16][4];  // P of the previous tile, the register A operand of O += P V
    float corr0, corr1;

    // Turns: consumer 0 issues first; each consumer's issue phase ends with
    // an arrival on the other's barrier, except consumer 1's very last one,
    // so that every arrival is consumed.
    if (wg == 1) sm90::named_arrive(other_turn, 256);
    int c = 0;  // K/V tiles consumed, in the producer's order
    for (int w = blockIdx.x, i = 0; w < work; w += gridDim.x, ++i) {
      const int q0 = (w % qtiles) * kFwdBQ, head = (w / qtiles) % heads, n = w / (qtiles * heads);
      const bool last_work = w + (int)gridDim.x >= work;
      const int qb = i & 1;
      const ll r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
      const float mq0 = mask[(ll)n * t + r0], mq1 = mask[(ll)n * t + r1];  // read by the segment test only
      const uint8_t* qc = q_s + qb * kQB + wg * 64 * 128;  // this warpgroup's 64 rows of each Q half
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running maximum (log2 domain) of rows r0, r1
      float l0 = 0.f, l1 = 0.f;              // running sum of this thread's columns

      sm90::mbar_wait(&qfull[qb], (i >> 1) & 1);
      const int s0 = c % kFwdStages;
      sm90::mbar_wait(&kfull[s0], (c / kFwdStages) & 1);
      sm90::named_sync(my_turn, 256);
#pragma unroll
      for (int h = 0; h < kH; ++h) sm90::fence_regs(o[h]);
      sm90::fence_regs(sc);
      sm90::wg_fence();
      fwd_issue_s<DH, kBK>(sc, qc, ring + s0 * 2 * kKVB);
      sm90::wg_commit();
      if (wg == 0 || !(last_work && tiles == 1)) sm90::named_arrive(other_turn, 256);
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      if (tiles == 1) sm90::mbar_arrive(&qempty[qb]);
      fwd_softmax<MODE, kBK>(sc, keys_s + s0 * kBK, c2, mq0, mq1, m0, m1, l0, l1, corr0, corr1);
      fwd_pack_p<kBK>(pa, sc);

      for (int j = 1; j < tiles; ++j) {
        const int cj = c + j, s = cj % kFwdStages, sp = (cj - 1) % kFwdStages;
        sm90::mbar_wait(&kfull[s], (cj / kFwdStages) & 1);
        sm90::mbar_wait(&vfull[sp], ((cj - 1) / kFwdStages) & 1);
        sm90::named_sync(my_turn, 256);
#pragma unroll
        for (int h = 0; h < kH; ++h) sm90::fence_regs(o[h]);
        sm90::fence_regs(sc);
        sm90::fence_regs(pa);
        sm90::wg_fence();
        fwd_issue_s<DH, kBK>(sc, qc, ring + s * 2 * kKVB);
        sm90::wg_commit();
        fwd_issue_pv<kH, kBK>(o, pa, ring + sp * 2 * kKVB + kKVB);
        sm90::wg_commit();
        if (wg == 0 || !(last_work && j == tiles - 1)) sm90::named_arrive(other_turn, 256);
        sm90::wg_wait<1>();  // S of this tile has landed; P V of the previous one may still run
        sm90::fence_regs(sc);
        if (j == tiles - 1) sm90::mbar_arrive(&qempty[qb]);  // the item's last read of Q
        fwd_softmax<MODE, kBK>(sc, keys_s + s * kBK, c2, mq0, mq1, m0, m1, l0, l1, corr0, corr1);
        sm90::wg_wait<0>();
#pragma unroll
        for (int h = 0; h < kH; ++h) sm90::fence_regs(o[h]);
        sm90::fence_regs(pa);
        sm90::mbar_arrive(&empty[sp]);
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            o[h][4 * jj + 0] *= corr0;
            o[h][4 * jj + 1] *= corr0;
            o[h][4 * jj + 2] *= corr1;
            o[h][4 * jj + 3] *= corr1;
          }
        fwd_pack_p<kBK>(pa, sc);
      }
      const int cl = c + tiles - 1, sl = cl % kFwdStages;
      sm90::mbar_wait(&vfull[sl], (cl / kFwdStages) & 1);
#pragma unroll
      for (int h = 0; h < kH; ++h) sm90::fence_regs(o[h]);
      sm90::fence_regs(pa);
      sm90::wg_fence();
      fwd_issue_pv<kH, kBK>(o, pa, ring + sl * 2 * kKVB + kKVB);
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int h = 0; h < kH; ++h) sm90::fence_regs(o[h]);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(&empty[sl]);
      c += tiles;

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          o[h][4 * jj + 0] *= inv0;
          o[h][4 * jj + 1] *= inv0;
          o[h][4 * jj + 2] *= inv1;
          o[h][4 * jj + 3] *= inv1;
        }
      bf16* ob = out + n * o_sn + (ll)head * DH;
#pragma unroll
      for (int h = 0; h < kH; ++h) store_half(ob, o_st, r0, h * 64, c2, o[h]);
      if (lse != nullptr && c2 == 0) {  // natural log: lse = (m + log2 l) ln 2
        float* lb = lse + ((ll)n * heads + head) * t;
        lb[r0] = m0 * kLn2 + logf(l0);
        lb[r1] = m1 * kLn2 + logf(l1);
      }
    }
  }
}

// ----------------------------------------------------------------- fp32 path

constexpr int kFQ = 16;  // query rows per block (4 warps x 4 rows)
constexpr int kFK = 32;  // keys per tile: one per lane

// Each warp's rows advance together: one read of a key's row (and of a
// value) serves all of them, so nothing loop-invariant is kept in registers
// across rows.
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

    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) s[rr] = fmaf(qs[warp * kRows + rr][d], kd, s[rr]);
    }
    float p[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float x = masked<MODE>(s[rr], mq[rr], keys[lane]);
      float mx = x;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(mx, m_run[rr]);
      const float corr = expf(m_run[rr] - mx);
      p[rr] = expf(x - mx);
      float sum = p[rr];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * corr + sum;
      m_run[rr] = mx;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[rr][e] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kFK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const float vj = vs[j][lane + 32 * e];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr][e] = fmaf(pj[rr], vj, acc[rr][e]);
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

template <int DH, int MODE>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse, int n,
                     int t, int heads, ll q_sn, ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll o_sn, ll o_st,
                     cudaStream_t s) {
  constexpr int kBK = fwd_block_k<DH>();
  CUtensorMap tq, tk, tv;
  int rc = 0;
  if ((rc = sm90::head_map(&tq, q, n, t, heads, DH, q_sn, q_st, kFwdBQ)) ||
      (rc = sm90::head_map(&tk, k, n, t, heads, DH, k_sn, k_st, kBK)) ||
      (rc = sm90::head_map(&tv, v, n, t, heads, DH, v_sn, v_st, kBK))) {
    return rc;
  }
  constexpr int kSmem = fwd_smem_bytes<DH>();
  // Set on every launch (about a microsecond): a flag kept in a static would
  // be one per process, where the attribute is one per function and device.
  if ((rc = static_cast<int>(cudaFuncSetAttribute(attention_fwd_wgmma_kernel<DH, MODE>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)))) {
    return rc;
  }
  int dev = 0, sms = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) ||
      (rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))) {
    return rc;
  }
  const int work = (t / kFwdBQ) * heads * n;  // query tiles
  attention_fwd_wgmma_kernel<DH, MODE><<<work < sms ? work : sms, kFwdThreads, kSmem, s>>>(
      tq, tk, tv, mask, static_cast<bf16*>(out), lse, t, heads, work, o_sn, o_st);
  return static_cast<int>(cudaGetLastError());
}

// The callers' wrappers have checked: t % 128 == 0, dh in {64, 128}, each
// head's row contiguous, row strides and base pointers 16-byte aligned (what
// TMA takes), mask a contiguous fp32 [n, t]; lse is null or a contiguous fp32
// [n, heads, t]. Returns the cudaError_t of the launch.
template <int MODE>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const float* mask, void* out, float* lse,
                    int n, int t, int heads, int dh, long long q_sn, long long q_st, long long k_sn,
                    long long k_st, long long v_sn, long long v_st, long long o_sn, long long o_st,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return launch_fwd_wgmma<64, MODE>(q, k, v, mask, out, lse, n, t, heads, q_sn, q_st, k_sn, k_st, v_sn, v_st,
                                      o_sn, o_st, s);
  }
  if (dh == 128) {
    return launch_fwd_wgmma<128, MODE>(q, k, v, mask, out, lse, n, t, heads, q_sn, q_st, k_sn, k_st, v_sn, v_st,
                                       o_sn, o_st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
