// K2: backward of the packed-layout self-attention (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalrouting_tpu/ops/flash_packed.py:_bwd_kernel
// (called through _packed_bwd_call from the custom VJP of
// packed_flash_self_attention). Same function: given q (pre-scaled), k, v in
// the packed [N, T, H*dh] layout, the key mask and the output cotangent do,
// recompute the fp32 softmax p of logits + (1 - m) * -1e30 and return
//   dv = p^T do            (p rounded to the input type first),
//   dp = do v^T,
//   ds = p * (dp - rowsum(dp * p)),
//   dq = ds k, dk = ds^T q (ds rounded to the input type first),
// with fp32 accumulators and outputs in the input type and packed layout.
// The scale of q is applied outside (autograd owns its gradient).
//
// Design. The kernels are attention_bwd.cuh's, instantiated with the key
// mask (kKeyMask); the backward of K4 (flash_attention_bwd.cu) instantiates
// them with segment ids. The TPU kernel holds a whole [T, T] fp32 block per
// 128-lane chunk in VMEM and separates two 64-wide heads by zero-masking
// lanes; here a block holds O(64 * dh) state and one head, and p is
// recomputed from K1's per-row log-sum-exp (lse, fp32 [N, H, T]) as
// exp(logit - lse). Two kernels, launched in order on one stream:
//   1. dq: one block per (64-query tile, head, chunk). A first sweep over
//      the key tiles computes delta = rowsum(dp * p) exactly as the TPU
//      kernel does (from p and dp, not from do . o, so the bf16-stored output
//      is not needed); it is written to a scratch [N, H, T] for kernel 2. A
//      second sweep accumulates dq = ds k.
//   2. dk/dv: one block per (64-key tile, head, chunk), with its keys as the
//      rows of S^T and dP^T.
// bf16 multiplies with mma.sync m16n8k16 (fp32 accumulators); the fp32 path
// is plain FMA, one key (or query) per lane.
//
// A row whose keys are all padding has every logit at exactly -1e30 in fp32,
// so its softmax is uniform, 1/T (the plain version and the TPU kernel give
// the same); its lse rounds to -1e30 and loses log T, so such rows (lse below
// -1e29) take p = 1/T explicitly and stay finite.
//
// What bounds it on an H100: at the flagship shape [128, 512, 768] bf16 the
// function reads q, k, v, do and writes dq, dk, dv (7 x 100.7 MB, plus lse and
// the mask) and does 5 products of T x T x dh per head: 4 x 128 x 12 x 512^2
// x 64 x 2.5 = 258 GFLOP, 0.26 ms at 989 TFLOP/s against 0.21 ms of bytes at
// 3.35 TB/s. This design recomputes S and dP in each of its three sweeps
// (9 products instead of 5) and keeps no loads in flight during the
// products (no cp.async/TMA, mma.sync not wgmma); PERF.md has its time.

#include "attention_bwd.cuh"

// The wrapper (ops/flash_packed.py) has checked: t % 64 == 0, t <= 512,
// dh in {64, 128}, q/k/v/do with a contiguous inner dimension and 16-byte
// aligned rows and base pointers, mask a contiguous fp32 [n, t], lse and the
// delta scratch contiguous fp32 [n, heads, t], dq/dk/dv one contiguous layout
// (strides g_sn, g_st). Returns the first cudaError_t of the two launches.
extern "C" int packed_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const float* mask, const float* lse, const void* dout,
                                         void* dq, void* dk, void* dv, float* delta, int n, int t,
                                         int heads, int dh, long long q_sn, long long q_st, long long k_sn, long long k_st,
                                         long long v_sn, long long v_st, long long do_sn, long long do_st, long long g_sn, long long g_st,
                                         void* stream) {
  return attn::launch_bwd_bf16<attn::kKeyMask>(q, k, v, mask, lse, dout, dq, dk, dv, delta, n, t, heads, dh,
                                               q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st,
                                               stream);
}

extern "C" int packed_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const float* mask, const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv, float* delta, int n, int t,
                                        int heads, int dh, long long q_sn, long long q_st, long long k_sn, long long k_st,
                                        long long v_sn, long long v_st, long long do_sn, long long do_st, long long g_sn, long long g_st,
                                        void* stream) {
  return attn::launch_bwd_f32<attn::kKeyMask>(q, k, v, mask, lse, dout, dq, dk, dv, delta, n, t, heads, dh,
                                              q_sn, q_st, k_sn, k_st, v_sn, v_st, do_sn, do_st, g_sn, g_st,
                                              stream);
}
