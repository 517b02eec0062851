// K4: segment-id self-attention forward for Hopper (sm_90a), the counterpart
// of both K4a and K4b.
//
// Replaces the TPU kernels reached from multimodalrouting_tpu/ops/flash.py:
//   K4a flash_self_attention  -> upstream jax/experimental/pallas/ops/tpu/
//       flash_attention.py, forward pallas_call (flash_attention.py:758);
//   K4b splash_self_attention -> upstream .../splash_attention/
//       splash_attention_kernel.py, forward pallas_call (:1137), with an
//       all-FullMask MultiHeadMask, so its block-sparse skipping skips nothing.
// Both compute one function over [B, H, T, dh] with segment ids q = kv = the
// key mask, a full non-causal mask and q pre-scaled: fp32 logits plus
// where(m[query] == m[key], 0, -0.7 * FLT_MAX), an fp32 softmax, p rounded to
// the input type before p @ v, fp32 accumulation, output in the input type.
// A valid query attends the valid keys, a pad query the pad keys only, and an
// all-pad chunk gets an ordinary softmax over all of its keys: unlike K1,
// whose pad queries attend the valid keys and whose all-pad rows are uniform.
//
// Design. The kernels are attention_fwd.cuh's (K1's), instantiated with the
// segment test (kSegment): the persistent bf16 kernel takes (128-query
// tile, head, chunk) items in turn, reads the strided [N, T, H, dh] view of
// the packed [N, T, H*dh] projections in place through TMA tensor maps, so
// none of the TPU side's head transposes is made, and streams keys in tiles
// of 128 (64 at dh 128) through a shared-memory ring with an online softmax,
// so T has no upper limit; both products on wgmma, fp32 on FMA. Under a gradient the
// wrapper (ops/flash.py) asks for each row's log-sum-exp, which the backward
// (flash_attention_bwd.cu) uses to recompute p.
//
// What bounds it on an H100: the same work as K1 at the same shape; at
// [128, 512, 768] bf16 the bytes (q, k, v, out: 403 MB, 0.120 ms at
// 3.35 TB/s) against 103 GFLOP (0.104 ms at 989 TFLOP/s). The segment test
// is a compare-select per key for a thread's two rows where K1 adds a key
// term; PERF.md has its time.
//
// The upstream flash kernel at T <= 512 (one key block) normalises p before
// rounding it to bf16, at T = 1024 (two blocks of 512) it rounds p relative
// to each block's running maximum; this kernel rounds p relative to the
// running maximum of 128-key tiles (64 at dh 128). The results differ by
// rounding only (the bf16 limits in chip_smoke.py).

#include "attention_fwd.cuh"

// The wrapper (ops/flash.py) has checked: t % 128 == 0 and t >= 256,
// dh in {64, 128}, q/k/v [n, t, heads, dh] views with a contiguous head row,
// 16-byte aligned row strides and base pointers, mask a contiguous fp32
// [n, t]; lse is null or a contiguous fp32 [n, heads, t].
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const float* mask, void* out, float* lse, int n, int t,
                                    int heads, int dh, long long q_sn, long long q_st,
                                    long long k_sn, long long k_st, long long v_sn,
                                    long long v_st, long long o_sn, long long o_st,
                                    void* stream) {
  return attn::launch_fwd_bf16<attn::kSegment>(q, k, v, mask, out, lse, n, t, heads, dh, q_sn, q_st,
                                               k_sn, k_st, v_sn, v_st, o_sn, o_st, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const float* mask, void* out, float* lse, int n, int t,
                                   int heads, int dh, long long q_sn, long long q_st,
                                   long long k_sn, long long k_st, long long v_sn,
                                   long long v_st, long long o_sn, long long o_st,
                                   void* stream) {
  return attn::launch_fwd_f32<attn::kSegment>(q, k, v, mask, out, lse, n, t, heads, dh, q_sn, q_st,
                                              k_sn, k_st, v_sn, v_st, o_sn, o_st, stream);
}
