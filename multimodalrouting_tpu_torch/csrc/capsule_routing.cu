// K3: fused capsule routing-by-agreement for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalrouting_tpu/ops/pallas_capsule.py:
// _capsule_kernel (called through capsule_routing_pallas). Same function as
// multimodalrouting_tpu/ops/capsule.py:capsule_routing in its softmax_out /
// ONES mode, all iterations in one launch, fp32 throughout:
//   votes[n,m,d] = sum_a pose[n,a] * w[n,a,m,d]
//   seed: pose[m,d] = sum_n votes[n,m,d] / M, act[m] = mean_n(act_in), coef = 1/M
//   per iteration:
//     agree[n,m] = sum_d votes[n,m,d] * pose[m,d] / sqrt(D)
//     qk = softmax_m(agree) * act[m];  coef = qk / (sum_m qk + 1e-10)
//     pose[m,d] = sum_n coef[n,m] * votes[n,m,d] * act_in[n];  act = 1
//
// Design. One block per batch row: the votes of one row (N*M*D floats, 5 KB
// on the flagship's 10 x 2 x 64) live in shared memory for every iteration,
// so the iterations make no trip to device memory. The agreement is one warp
// per (n, m) pair with a shuffle reduction; the vote product and the pose
// update are one thread per output element.
//
// What bounds it on an H100: almost nothing is moved (w is 164 KB, pose 20 KB
// on the flagship) — 0.05 us at 3.35 TB/s — so one launch costs what a
// launch costs, a few microseconds. Fusing every iteration into that one
// launch is the whole point of the kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) capsule_routing_kernel(
    const float* __restrict__ pose, const float* __restrict__ act,
    const float* __restrict__ w, float* __restrict__ pose_out,
    float* __restrict__ act_out, float* __restrict__ coef_out, int n, int a,
    int m, int d, int iters, float scale) {
  extern __shared__ float smem[];
  const int md = m * d;
  float* votes = smem;            // [n][m][d]
  float* npose = votes + n * md;  // [m][d] decision pose
  float* agree = npose + md;      // [n][m]
  float* coef = agree + n * m;    // [n][m]
  float* acts = coef + n * m;     // [n] primary activations
  float* nact = acts + n;         // [m] decision activations
  float* poses = nact + m;        // [n][a] primary poses

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < n * a; i += kThreads) poses[i] = pose[(long long)row * n * a + i];
  for (int i = tid; i < n; i += kThreads) acts[i] = act[(long long)row * n + i];
  __syncthreads();

  for (int i = tid; i < n * md; i += kThreads) {
    const int nn = i / md;
    const int j = i - nn * md;
    const float* wp = w + (long long)nn * a * md + j;
    float s = 0.f;
    for (int aa = 0; aa < a; ++aa) s = fmaf(poses[nn * a + aa], wp[(long long)aa * md], s);
    votes[i] = s;
  }
  __syncthreads();

  const float inv_m = 1.f / m;
  for (int j = tid; j < md; j += kThreads) {
    float s = 0.f;
    for (int nn = 0; nn < n; ++nn) s += votes[nn * md + j];
    npose[j] = s * inv_m;
  }
  float mean_act = 0.f;
  for (int nn = 0; nn < n; ++nn) mean_act += acts[nn];
  mean_act /= n;
  for (int i = tid; i < m; i += kThreads) nact[i] = mean_act;
  for (int i = tid; i < n * m; i += kThreads) coef[i] = inv_m;

  for (int it = 0; it < iters; ++it) {
    __syncthreads();  // npose / nact of the previous step are complete
    for (int p = warp; p < n * m; p += kThreads / 32) {
      const int nn = p / m;
      const int mm = p - nn * m;
      const float* vp = votes + (nn * m + mm) * d;
      const float* pp = npose + mm * d;
      float s = 0.f;
      for (int dd = lane; dd < d; dd += 32) s = fmaf(vp[dd], pp[dd], s);
      for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) agree[p] = s * scale;
    }
    __syncthreads();
    for (int nn = tid; nn < n; nn += kThreads) {
      const float* ag = agree + nn * m;
      float mx = -INFINITY;
      for (int mm = 0; mm < m; ++mm) mx = fmaxf(mx, ag[mm]);
      float sum = 0.f;
      for (int mm = 0; mm < m; ++mm) sum += expf(ag[mm] - mx);
      float tot = 0.f;
      for (int mm = 0; mm < m; ++mm) {
        const float qk = expf(ag[mm] - mx) / sum * nact[mm];
        coef[nn * m + mm] = qk;
        tot += qk;
      }
      for (int mm = 0; mm < m; ++mm) coef[nn * m + mm] = coef[nn * m + mm] / (tot + 1e-10f);
    }
    __syncthreads();
    for (int j = tid; j < md; j += kThreads) {
      const int mm = j / d;
      float s = 0.f;
      for (int nn = 0; nn < n; ++nn) s += coef[nn * m + mm] * (votes[nn * md + j] * acts[nn]);
      npose[j] = s;
    }
    for (int i = tid; i < m; i += kThreads) nact[i] = 1.f;
  }
  __syncthreads();

  for (int j = tid; j < md; j += kThreads) pose_out[(long long)row * md + j] = npose[j];
  for (int i = tid; i < m; i += kThreads) act_out[(long long)row * m + i] = nact[i];
  for (int i = tid; i < n * m; i += kThreads) coef_out[(long long)row * n * m + i] = coef[i];
}

// Shared memory one block needs, in bytes.
long long smem_bytes(int n, int a, int m, int d) {
  return (long long)sizeof(float) * ((long long)n * m * d + m * d + 2LL * n * m + n + m + n * a);
}

}  // namespace

// All inputs contiguous fp32 on the device: pose [b,n,a], act [b,n],
// w [n,a,m,d]; outputs pose [b,m,d], act [b,m], coef [b,n,m].
// Returns the cudaError_t of the launch: cudaErrorInvalidValue when one
// row's state exceeds a block's 48 KB of shared memory.
extern "C" int capsule_routing_f32(const float* pose, const float* act, const float* w,
                                   float* pose_out, float* act_out, float* coef_out,
                                   int b, int n, int a, int m, int d, int iters,
                                   void* stream) {
  const long long smem = smem_bytes(n, a, m, d);
  if (smem > 48 * 1024 || b <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  capsule_routing_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pose, act, w, pose_out, act_out, coef_out, n, a, m, d, iters, scale);
  return static_cast<int>(cudaGetLastError());
}
