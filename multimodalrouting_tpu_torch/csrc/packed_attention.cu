// K1: packed-layout self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalrouting_tpu/ops/flash_packed.py:_kernel
// (called through _packed_call / packed_flash_self_attention). Same function:
// non-causal self-attention over q, k, v in the projections' packed
// [N, T, H*dh] layout (q already scaled), an additive (1 - m) * -1e30 key
// mask on fp32 logits, an fp32 softmax, p rounded to the input type before
// p @ v, fp32 accumulation, output in the input type and packed layout.
// A query row whose keys are all padding gets uniform attention (finite).
//
// Design. The kernels are attention_fwd.cuh's, instantiated with the key
// mask (kKeyMask); K4 (flash_attention.cu) instantiates the same kernels with
// segment ids. They read the strided [N, T, H, dh] view of the packed tensors
// in place (row strides are arguments), so no transpose or copy is made
// around them. The bf16 kernel is persistent (one block per SM, each taking
// (128-query tile, head, chunk) items in turn): a producer warpgroup streams
// Q, K and V tiles by TMA into shared memory (a 3-stage K/V ring that runs on
// across items), and two consumer warpgroups run both products on wgmma
// (p stays in registers as the A operand of p @ v), taking turns so that one's
// softmax overlaps the other's products. The fp32 path (the tight check and
// fp32 serving) is plain FMA, one key per lane.
//
// What bounds it on an H100: at the flagship shape [128, 512, 768] bf16 one
// call reads q, k, v and writes out, 403 MB (0.120 ms at 3.35 TB/s), and does
// 4 * 128 * 12 * 512^2 * 64 = 103 GFLOP (0.104 ms at 989 TFLOP/s): it sits
// near the ridge, so both the loads (TMA, kept in flight by the producer) and
// the tensor cores (wgmma, fed while the other consumer does its softmax)
// have to run at once; PERF.md has its measured time.
//
// The online softmax rounds p to bf16 before it is normalised, where the TPU
// kernel rounds the normalised p; bf16 results therefore differ from the
// plain version by a few bf16 ulps of the output (tolerance in the tests).
//
// Under a gradient the wrapper also asks for each row's log-sum-exp
// (lse = m + log l of the online softmax, fp32 [N, H, T]), which the backward
// K2 (packed_attention_bwd.cu) uses to recompute p; serving passes a null
// pointer and writes nothing more.

#include "attention_fwd.cuh"

// The wrapper (ops/flash_packed.py) has checked: t % 128 == 0, dh in {64, 128},
// inner dimension contiguous, row strides and base pointers 16-byte aligned,
// mask a contiguous fp32 [n, t]; lse is null or a contiguous fp32 [n, heads, t].
// Returns the cudaError_t of the launch.
extern "C" int packed_attention_bf16(const void* q, const void* k, const void* v,
                                     const float* mask, void* out, float* lse, int n, int t,
                                     int heads, int dh, long long q_sn, long long q_st,
                                     long long k_sn, long long k_st, long long v_sn,
                                     long long v_st, long long o_sn, long long o_st,
                                     void* stream) {
  return attn::launch_fwd_bf16<attn::kKeyMask>(q, k, v, mask, out, lse, n, t, heads, dh, q_sn, q_st,
                                               k_sn, k_st, v_sn, v_st, o_sn, o_st, stream);
}

extern "C" int packed_attention_f32(const void* q, const void* k, const void* v,
                                    const float* mask, void* out, float* lse, int n, int t,
                                    int heads, int dh, long long q_sn, long long q_st,
                                    long long k_sn, long long k_st, long long v_sn,
                                    long long v_st, long long o_sn, long long o_st,
                                    void* stream) {
  return attn::launch_fwd_f32<attn::kKeyMask>(q, k, v, mask, out, lse, n, t, heads, dh, q_sn, q_st,
                                              k_sn, k_st, v_sn, v_st, o_sn, o_st, stream);
}
