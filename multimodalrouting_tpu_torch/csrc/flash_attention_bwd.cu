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
// (pre-scaled), k, v, the mask as segment ids, the forward's log-sum-exp, the
// output cotangent do and di = rowsum(o * do) from the saved output,
//   p = exp(logit + where(m[q] == m[k], 0, -0.7 * FLT_MAX) - lse) in fp32,
//   dv = p^T do            (p rounded to the input type first),
//   ds = (do v^T - di) * p,
//   dk = ds^T q, dq = ds k (ds rounded to the input type first),
// fp32 accumulators, outputs in the input type. Upstream takes di from XLA
// outside its kernels; the wrapper (ops/flash.py) takes it from one torch
// reduction before the launch, the same split.
//
// Design. The kernels are attention_bwd.cuh's (K2's), instantiated with the
// segment test (kSegment): the dq kernel (one block per 64-query tile, head,
// chunk) reads di instead of sweeping the keys for it, so it makes one sweep
// (S, dP and dQ), and the dk/dv kernel (one block per 64-key tile) makes S^T,
// dP^T, dV and dK: 7 T x T x dh products where K2 makes 9. Over the strided
// [N, T, H, dh] view in place, any T % 64 == 0, bf16 on mma.sync m16n8k16,
// fp32 on FMA.
//
// What bounds it on an H100: at [128, 512, 768] bf16 the function reads q,
// k, v, do and writes dq, dk, dv (7 x 100.7 MB plus lse, di and the mask:
// 0.211 ms at 3.35 TB/s) and does 5 products of T x T x dh per head (258
// GFLOP, 0.261 ms at 989 TFLOP/s): bound by operations, as K2. This version
// keeps no loads in flight during the products; PERF.md has its time.

#include "attention_bwd.cuh"

// The wrapper (ops/flash.py) has checked: t % 128 == 0 and t >= 256,
// dh in {64, 128}, q/k/v/do [n, t, heads, dh] views with a contiguous head
// row, 16-byte aligned row strides and base pointers, mask a contiguous fp32
// [n, t], lse (from flash_attention_*) and di contiguous fp32 [n, heads, t],
// dq/dk/dv one contiguous layout (strides g_sn, g_st). Returns the first
// cudaError_t of the two launches.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const float* mask, const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv, float* di, int n, int t,
                                        int heads, int dh, long long q_sn, long long q_st, long long k_sn,
                                        long long k_st, long long v_sn, long long v_st, long long do_sn,
                                        long long do_st, long long g_sn, long long g_st, void* stream) {
  return attn::launch_bwd_bf16<attn::kSegment>(q, k, v, mask, lse, dout, dq, dk, dv, di, n, t, heads, dh,
                                               q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st,
                                               stream);
}

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const float* mask, const float* lse, const void* dout,
                                       void* dq, void* dk, void* dv, float* di, int n, int t,
                                       int heads, int dh, long long q_sn, long long q_st, long long k_sn,
                                       long long k_st, long long v_sn, long long v_st, long long do_sn,
                                       long long do_st, long long g_sn, long long g_st, void* stream) {
  return attn::launch_bwd_f32<attn::kSegment>(q, k, v, mask, lse, dout, dq, dk, dv, di, n, t, heads, dh,
                                              q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st,
                                              stream);
}
