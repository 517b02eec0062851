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
// Design: attention_bwd.cuh's kernels with the key mask (kKeyMask); the
// backward of K4 (flash_attention_bwd.cu) runs the same ones with segment
// ids. The TPU kernel holds a whole [T, T] fp32 block per 128-lane chunk in
// VMEM and separates two 64-wide heads by zero-masking lanes; here a block
// holds one head's 64-row tile and p is recomputed from K1's per-row
// log-sum-exp (lse, fp32 [N, H, T]). The di kernel first takes
// di = rowsum(o * do) from K1's saved output (the tensor the out-projection
// keeps for its own backward), so the dq kernel makes one sweep, where the
// TPU order read the other way would need a first sweep for rowsum(dp * p).
// That sweep still sums the TPU order's rowsum(dp * p) from fp32 p and
// corrects dq to it with one more product (P K), and the dk/dv kernel reads
// that rowsum: the bf16 rounding of o, the same for every key of a row,
// would otherwise add up in dq and dk. 8 T x T x dh products, against 9 in
// the two-sweep design and 5 in the function.
//
// A row whose keys are all padding has every logit at exactly -1e30 in fp32,
// so its softmax is uniform, 1/T (the plain version and the TPU kernel give
// the same); its lse rounds to -1e30 and loses log T, so such rows (lse below
// -1e29) take p = 1/T explicitly and stay finite.
//
// What bounds it on an H100: at the flagship shape [128, 512, 768] bf16 the
// function does 5 products of T x T x dh per head: 4 x 128 x 12 x 512^2 x 64
// x 2.5 = 258 GFLOP, 0.261 ms at 989 TFLOP/s, against 0.21 ms of bytes at
// 3.35 TB/s (q, k, v, do in, dq, dk, dv out, 7 x 100.7 MB; o for di adds
// 0.03 ms). Bound by operations: the products run on wgmma from
// TMA-fed, 128-byte-swizzled shared memory, with the next tiles in flight
// during the current tile's products (attention_bwd.cuh); PERF.md has the
// time.

#include "attention_bwd.cuh"

// The wrapper (ops/flash_packed.py) has checked: t % 128 == 0, t <= 512,
// dh in {64, 128}, q/k/v/o/do with a contiguous inner dimension and 16-byte
// aligned rows and base pointers, mask a contiguous fp32 [n, t], lse and the
// di scratch contiguous fp32 [n, heads, t], dq/dk/dv one contiguous layout
// (strides g_sn, g_st). Launches di, dq, dk/dv; returns the first cudaError_t.
extern "C" int packed_attention_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                                         const float* lse, const void* out, const void* dout, void* dq, void* dk,
                                         void* dv, float* di, int n, int t, int heads, int dh, long long q_sn,
                                         long long q_st, long long k_sn, long long k_st, long long v_sn,
                                         long long v_st, long long o_sn, long long o_st, long long do_sn,
                                         long long do_st, long long g_sn, long long g_st, void* stream) {
  const attn::BwdStrides st{q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st, do_sn, do_st, g_sn, g_st};
  return attn::launch_bwd_bf16<attn::kKeyMask>(q, k, v, mask, lse, out, dout, dq, dk, dv, di, n, t, heads, dh, st,
                                               stream);
}

extern "C" int packed_attention_bwd_f32(const void* q, const void* k, const void* v, const float* mask,
                                        const float* lse, const void* out, const void* dout, void* dq, void* dk,
                                        void* dv, float* di, int n, int t, int heads, int dh, long long q_sn,
                                        long long q_st, long long k_sn, long long k_st, long long v_sn,
                                        long long v_st, long long o_sn, long long o_st, long long do_sn,
                                        long long do_st, long long g_sn, long long g_st, void* stream) {
  const attn::BwdStrides st{q_sn, q_st, k_sn, k_st, v_sn, v_st, o_sn, o_st, do_sn, do_st, g_sn, g_st};
  return attn::launch_bwd_f32<attn::kKeyMask>(q, k, v, mask, lse, out, dout, dq, dk, dv, di, n, t, heads, dh, st,
                                              stream);
}

// The di kernel alone (both backwards launch it first): di[n, h, t] =
// rowsum(o * do) over the [n, t, heads, dh] views, fp32. Same checks as
// above. Returns the cudaError_t of the launch.
extern "C" int attention_bwd_di_bf16(const void* out, const void* dout, float* di, int n, int t, int heads,
                                     int dh, long long o_sn, long long o_st, long long do_sn, long long do_st,
                                     void* stream) {
  return attn::launch_di<attn::bf16>(out, dout, di, n, t, heads, dh, o_sn, o_st, do_sn, do_st,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int attention_bwd_di_f32(const void* out, const void* dout, float* di, int n, int t, int heads,
                                    int dh, long long o_sn, long long o_st, long long do_sn, long long do_st,
                                    void* stream) {
  return attn::launch_di<float>(out, dout, di, n, t, heads, dh, o_sn, o_st, do_sn, do_st,
                                static_cast<cudaStream_t>(stream));
}
