// Self-attention backward kernels over the strided [N, T, H, dh] view of the
// packed [N, T, H*dh] layout, shared by K2 (packed_attention_bwd.cu) and the
// backward of K4 (flash_attention_bwd.cu). Given q (pre-scaled), k, v, the
// mask, the forward's per-row log-sum-exp lse [N, H, T], its output o and the
// output cotangent do, they recompute the fp32 softmax p = exp(logit + mask
// term - lse) (mask terms as in attention_fwd.cuh) and return
//   dv = p^T do            (p rounded to the input type first),
//   dp = do v^T,
//   ds = p * (dp - delta),
//   dq = ds k, dk = ds^T q (ds rounded to the input type first),
// with fp32 accumulators and outputs in the input type. The scale of q is
// applied outside (autograd owns its gradient). delta is each row's
// rowsum(dp * p) = rowsum(o * do) (o = p v), taken in the order of the TPU
// kernel each entry point replaces: K4's upstream kernels take
// di = rowsum(o * do) from the saved output; the TPU packed kernel (K2) sums
// rowsum(dp * p) from fp32 p.
//
// Three kernels, launched in order on one stream by both entry points:
//   1. di: di[n, h, t] = sum_d o * do in fp32, 16-byte loads with
//      neighbouring lanes on a row's neighbouring bytes, a shuffle reduction
//      over the lanes of one head;
//   2. dq: one block per (64-query tile, head, chunk), one sweep over the
//      key tiles: S = Q K^T, dP = dO V^T, dQ += dS K with ds from di (3
//      products). Under the key mask (K2) the sweep also sums the TPU order's
//      delta = rowsum(dp * p) from its fp32 p and dp, and P K (a 4th
//      product); at the end dQ += (di - delta) P K, which moves dQ to the ds
//      of delta, and delta overwrites the block's rows of di. di alone is not
//      enough there: o is stored in bf16, and its rounding error is the same
//      for every key of a row, so it adds up coherently in dq = ds k and
//      dk = ds^T q (measured: twice the bf16 rounding of ds itself when
//      attention is peaked);
//   3. dk/dv: one block per (64-key tile, head, chunk), one sweep over the
//      query tiles: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q
//      (4 products). 7 T x T x dh products in all (8 under the key mask),
//      against the 5 the function needs; the other design, one kernel with
//      dq summed in fp32 across key tiles, saves 2 but adds an fp32 [N, T, D]
//      accumulator's zeroing, 8 reductions into it and a conversion (more
//      bytes than the two products' time at the flagship shape), and sums in
//      an order that changes from run to run. Here dq, dk and dv are the same
//      bits in every run.
//
// bf16 product kernels (sm_90a; building blocks in sm90.cuh). A block is
// one consumer warpgroup (128 threads, wgmma's 64 rows) and one producer
// warp. The producer's lane 0 loads the block's resident tiles once (Q and
// dO in the dq kernel, K and V in the dk/dv kernel) and streams the other
// two through a ring of kStages stages with TMA, in the 128-byte swizzle
// (4-D tensor maps over the caller's strides, so the packed and K4's views
// are read in place), together with the streamed rows' mask values (and
// lse, di in the dk/dv kernel) by bulk copy; mbarriers report each stage
// full and, once the warpgroup's products on it have retired, empty. The
// first two products of a tile are wgmma with both operands in shared
// memory (K-major); their fp32 accumulators become p and ds in registers,
// are packed to bf16 in place as the register A operand of the last
// product(s), whose B is the streamed tile itself read MN-major through
// wgmma's transpose flag, so no transposed copy is stored. dh = 128 is two
// 64-column halves per tile; its dk/dv kernel streams 32 queries per tile
// (m64n32 for S^T and dP^T), so that 2 x 64 accumulators of dK and dV fit
// beside them without spilling, and its key-mask dq kernel runs one block
// per SM (dQ and P K take 2 x 64 accumulators). The fp32 path is plain FMA,
// one key (or query) per lane, with di from the di kernel in both modes
// (o in fp32 carries no rounding that matters).
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
#include "sm90.cuh"

namespace attn {

constexpr float kAllPadLse = -1e29f;  // key mask, lse below this: every key of the row is padding

template <int MODE>
__device__ __forceinline__ float recompute_p(float logit, float lse, float inv_t) {
  if (MODE == kKeyMask && lse <= kAllPadLse) return inv_t;
  return expf(logit - lse);
}

// recompute_p for the bf16 kernels, as one FMA and the hardware exp2:
// p = 2^(logit log2 e - lse log2 e), with lse2 = lse * log2 e. Its error
// (~2^-22 relative) is far below the bf16 rounding p and ds take next; the
// full-precision expf is the larger part of these kernels' instructions.
template <int MODE>
__device__ __forceinline__ float recompute_p_ex2(float logit, float lse, float lse2, float inv_t) {
  if (MODE == kKeyMask && lse <= kAllPadLse) return inv_t;
  return ex2(fmaf(logit, kLog2e, -lse2));
}

// -------------------------------------------------------------------- di

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, const bf16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, const float*) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
  return fmaf(x[0], y[0], fmaf(x[1], y[1], fmaf(x[2], y[2], x[3] * y[3])));
}

constexpr int kDiThreads = 256;

// One thread per 16 bytes of o (and of do); the kLanes lanes of one head's
// row are neighbours in a warp, so the row is read in whole 32-byte sectors.
template <typename T, int DH>
__global__ void __launch_bounds__(kDiThreads) bwd_di_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                                            float* __restrict__ di, int t, int heads, ll o_sn,
                                                            ll o_st, ll do_sn, ll do_st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLanes = DH / kVec;  // 8 or 16 (bf16), 16 or 32 (fp32)
  const ll idx = (ll)blockIdx.x * kDiThreads + threadIdx.x;
  const int per_row = heads * kLanes;
  const ll row = idx / per_row;  // n * t + token
  const int j = (int)(idx % per_row);
  const int head = j / kLanes;
  const int col = head * DH + (j % kLanes) * kVec;
  const ll n = row / t, tok = row % t;
  const uint4 a = *reinterpret_cast<const uint4*>(out + n * o_sn + tok * o_st + col);
  const uint4 b = *reinterpret_cast<const uint4*>(dout + n * do_sn + tok * do_st + col);
  float s = dot16(a, b, out);
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (j % kLanes == 0) di[(n * heads + head) * t + tok] = s;
}

// The caller has checked: t % 128 == 0, dh in {64, 128}, o and do with a
// contiguous head row and 16-byte aligned rows and base; di a contiguous
// fp32 [n, heads, t]. Returns the cudaError_t of the launch.
template <typename T>
int launch_di(const void* out, const void* dout, float* di, int n, int t, int heads, int dh, ll o_sn, ll o_st,
              ll do_sn, ll do_st, cudaStream_t s) {
  const ll threads = (ll)n * t * heads * dh * (ll)sizeof(T) / 16;  // a multiple of kDiThreads
  const dim3 grid((unsigned)(threads / kDiThreads));
  const T* o = static_cast<const T*>(out);
  const T* d = static_cast<const T*>(dout);
  if (dh == 64) {
    bwd_di_kernel<T, 64><<<grid, kDiThreads, 0, s>>>(o, d, di, t, heads, o_sn, o_st, do_sn, do_st);
  } else if (dh == 128) {
    bwd_di_kernel<T, 128><<<grid, kDiThreads, 0, s>>>(o, d, di, t, heads, o_sn, o_st, do_sn, do_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 path

constexpr int kTile = 64;       // a warpgroup's own rows (wgmma M) and the dq kernel's key tile
constexpr int kStages = 2;      // ring depth of the streamed tiles
constexpr int kThreads = 160;   // one consumer warpgroup + one producer warp
constexpr int kDqBlocks = 2;    // dq blocks resident on one SM (register cap)
constexpr int kHalfBytes = kTile * 128;  // 64 rows x one 128-byte swizzle row

// Key mask (K2) takes the TPU kernel's order: rowsum(dp * p) from fp32 p and
// dp, summed in the dq kernel's sweep (see bwd_dq_wgmma_kernel). dh = 128
// with its correction accumulator does not fit two blocks' registers.
template <int DH, int MODE>
constexpr int dq_min_blocks() {
  return DH == 128 && MODE == kKeyMask ? 1 : kDqBlocks;
}

template <int DH>
constexpr int dq_smem_bytes() {
  // Q, dO resident; K, V per stage; the stages' key mask values; barriers; alignment slack
  return (2 + 2 * kStages) * kTile * DH * 2 + kStages * kTile * 4 + (2 * kStages + 1) * 8 + sm90::kAtomBytes;
}

template <int DH, int QT>
constexpr int dkdv_smem_bytes() {
  // K, V resident; Q, dO per stage; the stages' lse, di, mask; barriers; alignment slack
  return 2 * kTile * DH * 2 + 2 * kStages * QT * DH * 2 + kStages * 3 * QT * 4 + (2 * kStages + 1) * 8 +
         sm90::kAtomBytes;
}

template <int DH, int MODE>
__global__ void __launch_bounds__(kThreads, dq_min_blocks<DH, MODE>()) bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ mask, const float* __restrict__ lse, float* __restrict__ di,
    bf16* __restrict__ dq, int t, ll g_sn, ll g_st) {
  constexpr int kH = DH / 64;                 // 64-column halves per row
  constexpr int kTB = kH * kHalfBytes;        // one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align_1024(smem_raw);
  uint8_t* do_s = q_s + kTB;
  uint8_t* ring = do_s + kTB;                 // stage s: K at s * 2 kTB, V kTB further
  float* keys_s = reinterpret_cast<float*>(ring + kStages * 2 * kTB);  // [kStages][kTile] mask values
  uint64_t* full = reinterpret_cast<uint64_t*>(keys_s + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* resident = empty + kStages;

  const int n = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = t / kTile;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init(resident, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      sm90::mbar_expect_tx(resident, 2 * kTB);
      for (int h = 0; h < kH; ++h) {
        sm90::tma_load_4d(q_s + h * kHalfBytes, &tq, resident, h * 64, head, q0, n);
        sm90::tma_load_4d(do_s + h * kHalfBytes, &tdo, resident, h * 64, head, q0, n);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::mbar_wait(&empty[s], (j / kStages - 1) & 1);
        uint8_t* ks = ring + s * 2 * kTB;
        sm90::mbar_expect_tx(&full[s], 2 * kTB + kTile * 4);
        for (int h = 0; h < kH; ++h) {
          sm90::tma_load_4d(ks + h * kHalfBytes, &tk, &full[s], h * 64, head, j * kTile, n);
          sm90::tma_load_4d(ks + kTB + h * kHalfBytes, &tv, &full[s], h * 64, head, j * kTile, n);
        }
        sm90::bulk_load(keys_s + s * kTile, mask + (ll)n * t + j * kTile, kTile * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: this thread's query rows r0, r0 + 8
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const ll r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const ll stat = ((ll)n * gridDim.y + head) * t;
  const float lse0 = lse[stat + r0], lse1 = lse[stat + r1];
  const float l2_0 = lse0 * kLog2e, l2_1 = lse1 * kLog2e;
  const float di0 = di[stat + r0], di1 = di[stat + r1];
  const float mq0 = mask[(ll)n * t + r0], mq1 = mask[(ll)n * t + r1];  // read by the segment test only
  const float inv_t = 1.f / t;

  // Key mask: the TPU order's delta = rowsum(dp * p) of this thread's
  // columns (rs), and corr = P K, with which the ds of the di kernel's di is
  // moved to that delta at the end.
  constexpr bool kTpuDelta = MODE == kKeyMask;
  float rs0 = 0.f, rs1 = 0.f;
  float acc[kH][32], corr[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = corr[h][i] = 0.f;

  sm90::mbar_wait(resident, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* ks = ring + s * 2 * kTB;
    const uint8_t* vs = ks + kTB;

    float sc[32], dp[32];  // S then P; dP then dS
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      sm90::wgmma_ss_n64(sc, sm90::desc_kmajor(q_s + off), sm90::desc_kmajor(ks + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
      sm90::wgmma_ss_n64(dp, sm90::desc_kmajor(do_s + off), sm90::desc_kmajor(vs + off), kk > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    const float* keys = keys_s + s * kTile;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // p in place of s, ds = p * (dp - di) in place of dp
      const float n0 = key_term<MODE>(keys[jj * 8 + c2]), n1 = key_term<MODE>(keys[jj * 8 + c2 + 1]);
      sc[4 * jj + 0] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 0], mq0, n0), lse0, l2_0, inv_t);
      sc[4 * jj + 1] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 1], mq0, n1), lse0, l2_0, inv_t);
      sc[4 * jj + 2] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 2], mq1, n0), lse1, l2_1, inv_t);
      sc[4 * jj + 3] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 3], mq1, n1), lse1, l2_1, inv_t);
      if constexpr (kTpuDelta) {
        rs0 = fmaf(sc[4 * jj + 0], dp[4 * jj + 0], fmaf(sc[4 * jj + 1], dp[4 * jj + 1], rs0));
        rs1 = fmaf(sc[4 * jj + 2], dp[4 * jj + 2], fmaf(sc[4 * jj + 3], dp[4 * jj + 3], rs1));
      }
      dp[4 * jj + 0] = sc[4 * jj + 0] * (dp[4 * jj + 0] - di0);
      dp[4 * jj + 1] = sc[4 * jj + 1] * (dp[4 * jj + 1] - di0);
      dp[4 * jj + 2] = sc[4 * jj + 2] * (dp[4 * jj + 2] - di1);
      dp[4 * jj + 3] = sc[4 * jj + 3] * (dp[4 * jj + 3] - di1);
    }
    uint32_t a[4][4], pa[4][4];  // ds and (key mask) p rounded to bf16: A operands of dS K, P K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a_frag(a[kk], dp, kk);
      if constexpr (kTpuDelta) acc_to_a_frag(pa[kk], sc, kk);
    }

    sm90::wg_fence();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t kd = sm90::desc_mnmajor(ks + h * kHalfBytes + kk * 2 * sm90::kAtomBytes);
        sm90::wgmma_rs_n64_mn(acc[h], a[kk], kd);
        if constexpr (kTpuDelta) sm90::wgmma_rs_n64_mn(corr[h], pa[kk], kd);
      }
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      sm90::fence_regs(acc[h]);
      if constexpr (kTpuDelta) sm90::fence_regs(corr[h]);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  if constexpr (kTpuDelta) {
    // the quad's four lanes hold a row's columns: its delta, then
    // dq = sum_k ds_k k_k with ds from di, plus (di - delta) P K: the ds of
    // delta up to the bf16 rounding of ds. delta replaces di for the dk/dv
    // kernel; no other dq block reads these rows.
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    const float e0 = di0 - rs0, e1 = di1 - rs1;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[h][4 * j + 0] = fmaf(e0, corr[h][4 * j + 0], acc[h][4 * j + 0]);
        acc[h][4 * j + 1] = fmaf(e0, corr[h][4 * j + 1], acc[h][4 * j + 1]);
        acc[h][4 * j + 2] = fmaf(e1, corr[h][4 * j + 2], acc[h][4 * j + 2]);
        acc[h][4 * j + 3] = fmaf(e1, corr[h][4 * j + 3], acc[h][4 * j + 3]);
      }
    if (c2 == 0) {
      di[stat + r0] = rs0;
      di[stat + r1] = rs1;
    }
  }
  bf16* gb = dq + n * g_sn + (ll)head * DH;
#pragma unroll
  for (int h = 0; h < kH; ++h) store_half(gb, g_st, r0, h * 64, c2, acc[h]);
}

template <int DH, int QT, int MODE>  // QT queries per streamed tile
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int t, ll g_sn, ll g_st) {
  constexpr int kH = DH / 64;
  constexpr int kTB = kH * kHalfBytes;  // one 64-row tile (K, V)
  constexpr int kQHalf = QT * 128;      // one QT-row half (Q, dO)
  constexpr int kQB = kH * kQHalf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = sm90::align_1024(smem_raw);
  uint8_t* v_s = k_s + kTB;
  uint8_t* ring = v_s + kTB;  // stage s: Q at s * 2 kQB, dO kQB further
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kQB);  // [kStages][lse, di, mask][QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * 3 * QT);
  uint64_t* empty = full + kStages;
  uint64_t* resident = empty + kStages;

  const int n = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = t / QT;
  const ll stat = ((ll)n * gridDim.y + head) * t;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init(resident, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      sm90::mbar_expect_tx(resident, 2 * kTB);
      for (int h = 0; h < kH; ++h) {
        sm90::tma_load_4d(k_s + h * kHalfBytes, &tk, resident, h * 64, head, k0, n);
        sm90::tma_load_4d(v_s + h * kHalfBytes, &tv, resident, h * 64, head, k0, n);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::mbar_wait(&empty[s], (j / kStages - 1) & 1);
        uint8_t* qs = ring + s * 2 * kQB;
        float* st = stats + s * 3 * QT;
        sm90::mbar_expect_tx(&full[s], 2 * kQB + 3 * QT * 4);
        for (int h = 0; h < kH; ++h) {
          sm90::tma_load_4d(qs + h * kQHalf, &tq, &full[s], h * 64, head, j * QT, n);
          sm90::tma_load_4d(qs + kQB + h * kQHalf, &tdo, &full[s], h * 64, head, j * QT, n);
        }
        sm90::bulk_load(st, lse + stat + j * QT, QT * 4, &full[s]);
        sm90::bulk_load(st + QT, di + stat + j * QT, QT * 4, &full[s]);
        sm90::bulk_load(st + 2 * QT, mask + (ll)n * t + j * QT, QT * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: this thread's key rows r0, r0 + 8 (rows of S^T, dP^T, dK, dV)
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const ll r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const float key0 = key_term<MODE>(mask[(ll)n * t + r0]), key1 = key_term<MODE>(mask[(ll)n * t + r1]);
  const float inv_t = 1.f / t;

  float dk_acc[kH][32], dv_acc[kH][32];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[h][i] = dv_acc[h][i] = 0.f;

  sm90::mbar_wait(resident, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* qs = ring + s * 2 * kQB;
    const uint8_t* dos = qs + kQB;
    const float* lses = stats + s * 3 * QT;
    const float* dis = lses + QT;
    const float* mqs = lses + 2 * QT;

    float sc[QT / 2], dp[QT / 2];  // S^T then P^T; dP^T then dS^T
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int col = (kk % 4) * 32;
      sm90::wgmma_ss<QT>(sc, sm90::desc_kmajor(k_s + (kk / 4) * kHalfBytes + col),
                         sm90::desc_kmajor(qs + (kk / 4) * kQHalf + col), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int col = (kk % 4) * 32;
      sm90::wgmma_ss<QT>(dp, sm90::desc_kmajor(v_s + (kk / 4) * kHalfBytes + col),
                         sm90::desc_kmajor(dos + (kk / 4) * kQHalf + col), kk > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

#pragma unroll
    for (int jj = 0; jj < QT / 8; ++jj) {
      const int c = jj * 8 + c2;  // the two query columns of this thread
      const float l0 = lses[c], l1 = lses[c + 1], d0 = dis[c], d1 = dis[c + 1];
      const float mq0 = MODE == kSegment ? mqs[c] : 0.f, mq1 = MODE == kSegment ? mqs[c + 1] : 0.f;
      const float l2_0 = l0 * kLog2e, l2_1 = l1 * kLog2e;
      sc[4 * jj + 0] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 0], mq0, key0), l0, l2_0, inv_t);
      sc[4 * jj + 1] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 1], mq1, key0), l1, l2_1, inv_t);
      sc[4 * jj + 2] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 2], mq0, key1), l0, l2_0, inv_t);
      sc[4 * jj + 3] = recompute_p_ex2<MODE>(masked<MODE>(sc[4 * jj + 3], mq1, key1), l1, l2_1, inv_t);
      dp[4 * jj + 0] = sc[4 * jj + 0] * (dp[4 * jj + 0] - d0);
      dp[4 * jj + 1] = sc[4 * jj + 1] * (dp[4 * jj + 1] - d1);
      dp[4 * jj + 2] = sc[4 * jj + 2] * (dp[4 * jj + 2] - d0);
      dp[4 * jj + 3] = sc[4 * jj + 3] * (dp[4 * jj + 3] - d1);
    }
    uint32_t pa[QT / 16][4], sa[QT / 16][4];  // p^T and ds^T rounded to bf16
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      acc_to_a_frag(pa[kk], sc, kk);
      acc_to_a_frag(sa[kk], dp, kk);
    }

    sm90::wg_fence();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const int off = h * kQHalf + kk * 2 * sm90::kAtomBytes;
        sm90::wgmma_rs_n64_mn(dv_acc[h], pa[kk], sm90::desc_mnmajor(dos + off));
        sm90::wgmma_rs_n64_mn(dk_acc[h], sa[kk], sm90::desc_mnmajor(qs + off));
      }
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      sm90::fence_regs(dk_acc[h]);
      sm90::fence_regs(dv_acc[h]);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  const ll hoff = (ll)head * DH;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    store_half(dk + n * g_sn + hoff, g_st, r0, h * 64, c2, dk_acc[h]);
    store_half(dv + n * g_sn + hoff, g_st, r0, h * 64, c2, dv_acc[h]);
  }
}

// ----------------------------------------------------------------- fp32 path

constexpr int kFR = 8;   // a block's own rows (4 warps x 2)
constexpr int kFT = 32;  // streamed rows per tile: one per lane

template <int DH, int MODE>
__global__ void __launch_bounds__(128) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ di, float* __restrict__ dq, int t, ll q_sn, ll q_st, ll k_sn, ll k_st,
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
  float lse_r[kRows], di_r[kRows], mq[kRows], acc[kRows][kPer];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const ll row = q0 + warp * kRows + rr;
    lse_r[rr] = lse[stat + row];
    di_r[rr] = di[stat + row];
    mq[rr] = mb[row];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[rr][e] = 0.f;
  }

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
      const float ds = p * (dp - di_r[rr]);
      for (int j = 0; j < kFT; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[rr][e] = fmaf(dsj, ks[j][lane + 32 * e], acc[rr][e]);
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
__global__ void __launch_bounds__(128, 4) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int t, ll q_sn,
    ll q_st, ll k_sn, ll k_st, ll v_sn, ll v_st, ll do_sn, ll do_st, ll g_sn, ll g_st) {
  __shared__ float kks[kFR][DH], vvs[kFR][DH];  // the block's own keys
  __shared__ float qs[kFT][DH + 1], dos[kFT][DH + 1];
  __shared__ float lses[kFT], dis[kFT], mqs[kFT];  // mqs: the queries' mask values (segment ids)

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
      dis[tid] = di[stat + qq0 + tid];
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
      const float ds = p * (dp - dis[lane]);
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

// The strides of q, k, v, o, do (sn: chunk, st: row, in elements) and of the
// outputs dq, dk, dv (one contiguous layout).
struct BwdStrides {
  ll q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st, do_sn, do_st, g_sn, g_st;
};

template <int DH, int QT, int MODE>
int launch_products_bf16(const void* q, const void* k, const void* v, const float* mask, const float* lse,
                         const void* dout, bf16* dq, bf16* dk, bf16* dv, float* di, int n, int t, int heads,
                         const BwdStrides& st, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo, tq_s, tdo_s;
  int rc = 0;
  if ((rc = sm90::head_map(&tq, q, n, t, heads, DH, st.q_sn, st.q_st, kTile)) ||
      (rc = sm90::head_map(&tk, k, n, t, heads, DH, st.k_sn, st.k_st, kTile)) ||
      (rc = sm90::head_map(&tv, v, n, t, heads, DH, st.v_sn, st.v_st, kTile)) ||
      (rc = sm90::head_map(&tdo, dout, n, t, heads, DH, st.do_sn, st.do_st, kTile)) ||
      (rc = sm90::head_map(&tq_s, q, n, t, heads, DH, st.q_sn, st.q_st, QT)) ||
      (rc = sm90::head_map(&tdo_s, dout, n, t, heads, DH, st.do_sn, st.do_st, QT))) {
    return rc;
  }
  constexpr int kDqSmem = dq_smem_bytes<DH>();
  constexpr int kDkdvSmem = dkdv_smem_bytes<DH, QT>();
  // Set on every launch: a flag kept in a function-local static would be one
  // object across every library that instantiates this template.
  if ((rc = static_cast<int>(cudaFuncSetAttribute(bwd_dq_wgmma_kernel<DH, MODE>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem))) ||
      (rc = static_cast<int>(cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<DH, QT, MODE>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem)))) {
    return rc;
  }
  const dim3 grid(t / kTile, heads, n);
  bwd_dq_wgmma_kernel<DH, MODE><<<grid, kThreads, kDqSmem, s>>>(tq, tk, tv, tdo, mask, lse, di, dq, t, st.g_sn,
                                                                st.g_st);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  bwd_dkdv_wgmma_kernel<DH, QT, MODE><<<grid, kThreads, kDkdvSmem, s>>>(tk, tv, tq_s, tdo_s, mask, lse, di, dk, dv,
                                                                        t, st.g_sn, st.g_st);
  return static_cast<int>(cudaGetLastError());
}

// The callers' wrappers have checked: t % 128 == 0, dh in {64, 128}, q/k/v/o/
// do with a contiguous head row and 16-byte aligned rows and base pointers
// (what TMA takes), mask a contiguous fp32 [n, t], lse and the di scratch
// contiguous fp32 [n, heads, t], dq/dk/dv one contiguous layout. Launches
// di, then dq, then dk/dv; returns the first cudaError_t.
template <int MODE>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const float* mask, const float* lse,
                    const void* out, const void* dout, void* dq, void* dk, void* dv, float* di, int n, int t,
                    int heads, int dh, const BwdStrides& st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch_di<bf16>(out, dout, di, n, t, heads, dh, st.o_sn, st.o_st, st.do_sn, st.do_st, s);
  if (rc != 0) return rc;
  bf16* gq = static_cast<bf16*>(dq);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  if (dh == 64) return launch_products_bf16<64, 64, MODE>(q, k, v, mask, lse, dout, gq, gk, gv, di, n, t, heads, st, s);
  if (dh == 128) return launch_products_bf16<128, 32, MODE>(q, k, v, mask, lse, dout, gq, gk, gv, di, n, t, heads, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MODE>
int launch_bwd_f32(const void* q, const void* k, const void* v, const float* mask, const float* lse,
                   const void* out, const void* dout, void* dq, void* dk, void* dv, float* di, int n, int t,
                   int heads, int dh, const BwdStrides& st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch_di<float>(out, dout, di, n, t, heads, dh, st.o_sn, st.o_st, st.do_sn, st.do_st, s);
  if (rc != 0) return rc;
  const dim3 grid(t / kFR, heads, n);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (dh == 64) {
    bwd_dq_f32_kernel<64, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, di, dqf, t, st.q_sn, st.q_st,
                                                     st.k_sn, st.k_st, st.v_sn, st.v_st, st.do_sn, st.do_st,
                                                     st.g_sn, st.g_st);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    bwd_dkdv_f32_kernel<64, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, di, dkf, dvf, t, st.q_sn,
                                                       st.q_st, st.k_sn, st.k_st, st.v_sn, st.v_st, st.do_sn,
                                                       st.do_st, st.g_sn, st.g_st);
  } else if (dh == 128) {
    bwd_dq_f32_kernel<128, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, di, dqf, t, st.q_sn, st.q_st,
                                                      st.k_sn, st.k_st, st.v_sn, st.v_st, st.do_sn, st.do_st,
                                                      st.g_sn, st.g_st);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    bwd_dkdv_f32_kernel<128, MODE><<<grid, 128, 0, s>>>(qf, kf, vf, mask, lse, df, di, dkf, dvf, t, st.q_sn,
                                                        st.q_st, st.k_sn, st.k_st, st.v_sn, st.v_st, st.do_sn,
                                                        st.do_st, st.g_sn, st.g_st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
