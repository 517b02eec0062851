// Backward of K4 (segment-id self-attention, flash_attention.cu) for Hopper
// (sm_90a), the counterpart of both K4a's and K4b's backward kernels.
//
// Replaces the TPU kernels of the custom VJPs reached from
// multimodalrouting_tpu/ops/flash.py:
//   K4a flash_self_attention  -> upstream flash_attention.py, dk/dv
//       pallas_call (flash_attention.py:1121) and dq pallas_call (:1456);
//   K4b splash_self_attention -> upstream splash_attention_kernel.py, dq
//       pallas_call (:1635) and dk/dv pallas_call (:2196).
// Same function (flash_attention.py:254-275 and :895-920): given q
// (pre-scaled), k, v, the mask as segment ids, the forward's log-sum-exp, its
// output o and the output cotangent do, with di = rowsum(o * do),
//   p = exp(logit + where(m[q] == m[k], 0, -0.7 * FLT_MAX) - lse) in fp32,
//   dv = p^T do            (p rounded to the input type first),
//   ds = (do v^T - di) * p,
//   dk = ds^T q, dq = ds k (ds rounded to the input type first),
// fp32 accumulators, outputs in the input type. Upstream takes di from XLA
// before its kernels; here the di kernel takes it, on the same stream.
//
// Design: attention_bwd.cuh's kernels (K2's) with the segment test
// (kSegment): di, then one sweep of the dq kernel (S, dP, dQ) and one of the
// dk/dv kernel (S^T, dP^T, dV, dK), 7 T x T x dh products, over the strided
// [N, T, H, dh] view in place (4-D TMA maps), any T % 128 == 0. bf16 on
// wgmma with TMA and mbarriers, fp32 on FMA.
//
// What bounds it on an H100: at [128, 512, 768] bf16 the function does 5
// products of T x T x dh per head (258 GFLOP, 0.261 ms at 989 TFLOP/s)
// against 0.24 ms of bytes at 3.35 TB/s (q, k, v, o, do in; dq, dk, dv out;
// lse and the mask): bound by operations, as K2. The design feeds wgmma from
// a 2-stage TMA ring, so loads of the next tiles overlap the products;
// PERF.md has its time.

#include "attention_bwd.cuh"

// The wrapper (ops/flash.py) has checked: t % 128 == 0 and t >= 256,
// dh in {64, 128}, q/k/v/o/do [n, t, heads, dh] views with a contiguous head
// row, 16-byte aligned row strides and base pointers, mask a contiguous fp32
// [n, t], lse (from flash_attention_*) and the di scratch contiguous fp32
// [n, heads, t], dq/dk/dv one contiguous layout (strides g_sn, g_st).
// Launches di, dq, dk/dv; returns the first cudaError_t.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                                        const float* lse, const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, float* di, int n, int t, int heads, int dh, long long q_sn,
                                        long long q_st, long long k_sn, long long k_st, long long v_sn,
                                        long long v_st, long long o_sn, long long o_st, long long do_sn,
                                        long long do_st, long long g_sn, long long g_st, void* stream) {
  const attn::BwdStrides st{q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st, do_sn, do_st, g_sn, g_st};
  return attn::launch_bwd_bf16<attn::kSegment>(q, k, v, mask, lse, out, dout, dq, dk, dv, di, n, t, heads, dh, st,
                                               stream);
}

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const float* mask,
                                       const float* lse, const void* out, const void* dout, void* dq, void* dk,
                                       void* dv, float* di, int n, int t, int heads, int dh, long long q_sn,
                                       long long q_st, long long k_sn, long long k_st, long long v_sn,
                                       long long v_st, long long o_sn, long long o_st, long long do_sn,
                                       long long do_st, long long g_sn, long long g_st, void* stream) {
  const attn::BwdStrides st{q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st, do_sn, do_st, g_sn, g_st};
  return attn::launch_bwd_f32<attn::kSegment>(q, k, v, mask, lse, out, dout, dq, dk, dv, di, n, t, heads, dh, st,
                                              stream);
}
