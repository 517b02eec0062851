// K3: fused capsule routing-by-agreement for Hopper (sm_90a), as a
// thread-block cluster kernel.
//
// Replaces the TPU kernel multimodalrouting_tpu/ops/pallas_capsule.py:
// _capsule_kernel (called through capsule_routing_pallas). Same function as
// multimodalrouting_tpu/ops/capsule.py:capsule_routing in its softmax_out /
// ONES mode, all iterations in one launch:
//   votes[n,m,d] = sum_a pose[n,a] * w[n,a,m,d]
//   seed: pose[m,d] = sum_n votes[n,m,d] / M, act[m] = mean_n(act_in), coef = 1/M
//   per iteration:
//     agree[n,m] = sum_d votes[n,m,d] * pose[m,d] / sqrt(D)
//     qk = softmax_m(agree) * act[m];  coef = qk / (sum_m qk + 1e-10)
//     pose[m,d] = sum_n coef[n,m] * votes[n,m,d] * act_in[n];  act = 1
// Inputs are fp32 or bf16 (all three of one type), read in their own type and
// converted to fp32 on load, as the TPU body casts them; everything after the
// load, and the outputs, are fp32.
//
// What bounds it on an H100. Almost nothing is moved: w is the only large
// operand (164 KB on the 2-label mortality head, 2.05 MB on the 25-label
// phenotype head, fp32), 0.06 / 0.65 us at 3.35 TB/s. The vote product is
// the only real arithmetic (B*N*M*D*A FMAs: 8.2 M on the phenotype head at
// B = 16), so one launch is bound by launch latency, the latency of its
// dependent phases, and how many SMs share the vote product.
//
// Design. One cluster of C = G x H CTAs (C <= 16, non-portable above 8)
// takes a tile of up to 16 batch rows. CTA (g, h) owns the routes of group g
// and the labels of group h (H = min(M, 16), G = min(N, 16 / H): the
// phenotype head splits the 25 labels over 16 CTAs, the mortality head its
// 10 routes over 8 x 2 labels), so
//   - no thread waits on a chain of dependent loads from device memory:
//     each CTA's pose rows arrive as one TMA box [rows][routes][A] (a 4-D
//     tensor map over pose), the act rows as one load per thread;
//   - w is read from device memory once per cluster: each CTA streams its
//     slice w[n in g, :, m in h, :] through a ring of 2-4 stages in shared
//     memory, one TMA box [A][labels][D] per route (a 4-D tensor map over the
//     strided slice; completion on an mbarrier). One instruction per route:
//     a bulk copy per contiguous [labels][D] run costs ~60-80 cycles to
//     start, 320 of them on a phenotype CTA. At B <= 16 one cluster takes
//     every row, so w is read once per launch; each further tile of 16 rows
//     reads it again from L2;
//   - the vote product runs from shared memory: each thread keeps 8 rows x
//     4 columns of votes in registers over the A terms (each w value read
//     from shared memory serves 8 rows), then stores them through
//     distributed shared memory into the CTA that routes the row (row r of
//     the tile goes to rank r mod C);
//   - after one cluster barrier every CTA routes its own rows alone: seed,
//     then per iteration the agreement (a thread per (row, n, m)), the
//     softmax over M (a group of up to 32 lanes per (row, n), sized so
//     that one pass takes every (row, n)) and the decision pose (a thread
//     per 4 values of (row, m, d)), with block barriers only. A design that
//     kept the votes split over the cluster for the iterations, exchanging
//     softmax statistics and partial poses through distributed shared
//     memory, paid two cluster barriers (~1-3k cycles each on the card) and
//     ~5 us per iteration;
//   - every reduction runs in a fixed order, without atomics: a repeat
//     launch gives the same bits.
// A = 32 and D = 64 (both heads) are compile-time extents; other shapes take
// a generic instantiation of the same kernel.
//
// Limits (the launch returns cudaErrorInvalidValue beyond them, and the
// wrapper raises with the shape): A and D at most 256 and times the
// input's element size multiples of 16 bytes, pose and w 16-byte aligned
// (the tensor maps' boxes and strides); a CTA's own rows (their votes,
// 4 N M D bytes a row), its pose rows and a ring of two stages of one route
// (one, where one route is all of the CTA's) within the 227 KB of shared
// memory a block can have; a cluster of the planned size that the card can
// schedule (else smaller ones are tried, down to 1 CTA).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 8;   // rows of one vote-product item
constexpr int kMaxRows = 16;   // rows of one cluster's tile
constexpr int kMaxCluster = 16;
constexpr int kMaxBuf = 4;      // ring stages
constexpr long long kSmemLimit = 232448;  // 227 KB, a block's opt-in maximum on sm_90

// How one launch splits its work, and where each buffer sits in a CTA's
// shared memory (byte offsets).
struct Plan {
  int g, h;               // cluster = g route groups x h label groups
  int rows, rows_pad;     // batch rows of a tile; rounded up to kRowChunk
  int rows_own;           // the most rows one CTA routes: ceil(rows / (g h))
  int nb, mb;             // the largest route group and label group
  int rs;                 // routes per ring stage
  int nbuf;               // ring stages in flight (2 to kMaxBuf; 1 when one stage holds the slice)
  long long route_bytes;  // one route's box [A][MB][D] in the ring, 128-byte aligned
  long long smem;         // bytes; -1 when nothing fits
  long long off_rv, off_npose, off_coef, off_acts, off_mact, off_bars, off_praw, off_pose_t, off_ring;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Max and sum over aligned groups of `width` lanes (a power of two up to
// 32), every lane of a warp taking part: the same butterfly on every launch,
// a fixed order.
__device__ __forceinline__ float group_max(float x, int width) {
  for (int off = width >> 1; off >= 1; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int width) {
  for (int off = width >> 1; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int KA, int KD>
__global__ void __launch_bounds__(kThreads) capsule_routing_kernel(
    const __grid_constant__ CUtensorMap tpose, const T* __restrict__ act, const __grid_constant__ CUtensorMap tw,
    float* __restrict__ pose_out, float* __restrict__ act_out, float* __restrict__ coef_out, int b, int n,
    int a_rt, int m, int d_rt, int iters, float scale, Plan p) {
  const int A = KA ? KA : a_rt;
  const int D = KD ? KD : d_rt;
  const int D4 = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int csize = p.g * p.h;
  const int rank = blockIdx.x % csize;  // the CTA's rank in its (1-D) cluster
  const int tile = blockIdx.x / csize;
  const int gi = rank / p.h, hi = rank % p.h;
  const int n0 = gi * n / p.g, nb = (gi + 1) * n / p.g - n0;
  const int m0 = hi * m / p.h, mb = (hi + 1) * m / p.h - m0;
  const int row0 = tile * p.rows;
  const int R = min(p.rows, b - row0);
  const int RP = p.rows_pad;
  const int own = rank < R ? (R - rank + csize - 1) / csize : 0;  // rows rank, rank + C, ... of the tile

  // routing phase: the CTA's own rows, whole (written by the cluster)
  float* rv = reinterpret_cast<float*>(smem + p.off_rv);           // [own][n][m][D] votes
  float* npose = reinterpret_cast<float*>(smem + p.off_npose);     // [own][m][D] decision pose
  float* cbuf = reinterpret_cast<float*>(smem + p.off_coef);       // [own][n][m] agreement, then coef
  float* acts = reinterpret_cast<float*>(smem + p.off_acts);       // [own][n] input acts
  float* mact = reinterpret_cast<float*>(smem + p.off_mact);       // [own] mean input act
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.off_bars);  // [kMaxBuf + 1] ring stages; pose rows
  // vote phase: this CTA's routes and labels of every row of the tile
  T* praw = reinterpret_cast<T*>(smem + p.off_praw);               // [rows][NB][A] pose rows, as copied
  float* pose_t = reinterpret_cast<float*>(smem + p.off_pose_t);   // [nb][A][RP]
  T* ring = reinterpret_cast<T*>(smem + p.off_ring);               // [nbuf][rs][A][MB][D]

  // every CTA arrives now and waits before its first write to another's
  // shared memory: all of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // w streams through a ring of `nbuf` stages of `rs` routes, one box
  // [A][MB][D] per route (a CTA with mb < MB reads a label it does not use,
  // or zeros past M)
  const int nstages = (nb + p.rs - 1) / p.rs;
  const long long route_elems = p.route_bytes / sizeof(T);
  auto load_stage = [&](int s) {  // one thread
    const int first = s * p.rs, cnt = min(p.rs, nb - first);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int buf = s % p.nbuf;
    sm90::mbar_expect_tx(&full[buf], cnt * p.route_bytes);
    for (int j = 0; j < cnt; ++j)
      sm90::tma_load_4d(ring + (buf * p.rs + j) * route_elems, &tw, &full[buf], 0, m0, 0, n0 + first + j);
  };
  if (tid == 0) {
    for (int i = 0; i <= kMaxBuf; ++i) sm90::mbar_init(&full[i], 1);
    sm90::fence_barrier_init();
    // this CTA's pose rows, one box [rows][NB][A] (zeros past the batch)
    sm90::mbar_expect_tx(&full[kMaxBuf], p.rows * p.nb * A * sizeof(T));
    sm90::tma_load_4d(praw, &tpose, &full[kMaxBuf], 0, n0, row0, 0);
    for (int st = 0; st < min(p.nbuf, nstages); ++st) load_stage(st);
  }
  for (int i = tid; i < own * n; i += kThreads) {  // one load per thread, all in flight
    const int rl = i / n;
    acts[i] = to_f(act[(long long)(row0 + rank + rl * csize) * n + i % n]);
  }
  __syncthreads();
  for (int rl = tid; rl < own; rl += kThreads) {
    float s = 0.f;
    for (int nn = 0; nn < n; ++nn) s += acts[rl * n + nn];
    mact[rl] = s / n;
  }
  sm90::mbar_wait(&full[kMaxBuf], 0);
  for (int i = tid; i < nb * A; i += kThreads) {  // a thread per (n, a) = (i / A, i % A), 4 rows a store
    const T* src = praw + i;                       // praw[(r * NB + n) * A + a] = src[r * NB * A]
    for (int r = 0; r < RP; r += 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = r + k < R ? to_f(src[(long long)(r + k) * p.nb * A]) : 0.f;
      *reinterpret_cast<float4*>(pose_t + (long long)i * RP + r) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // ---- votes of (row, route n in g, label m in h), each pushed from
  // registers into the shared memory of the CTA that routes the row
  const int cols4 = mb * D4;
  const int chunks = RP / kRowChunk;
  for (int s = 0; s < nstages; ++s) {
    const int first = s * p.rs, cnt = min(p.rs, nb - first);
    sm90::mbar_wait(&full[s % p.nbuf], (s / p.nbuf) & 1);
    const T* st = ring + (s % p.nbuf) * p.rs * route_elems;
    for (int it = tid; it < cnt * chunks * cols4; it += kThreads) {
      const int cq = it % cols4, rest = it / cols4, q = rest % chunks, j = rest / chunks;
      const int nl = first + j;
      const T* wp = st + j * route_elems + cq * 4;
      const float* pp = pose_t + (long long)nl * A * RP + q * kRowChunk;
      float4 acc[kRowChunk];
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int aa = 0; aa < A; ++aa) {
        const float4 wv = load4(wp + aa * p.mb * D);
        const float4 p0 = *reinterpret_cast<const float4*>(pp + aa * RP);
        const float4 p1 = *reinterpret_cast<const float4*>(pp + aa * RP + 4);
        fma4(acc[0], p0.x, wv);
        fma4(acc[1], p0.y, wv);
        fma4(acc[2], p0.z, wv);
        fma4(acc[3], p0.w, wv);
        fma4(acc[4], p1.x, wv);
        fma4(acc[5], p1.y, wv);
        fma4(acc[6], p1.z, wv);
        fma4(acc[7], p1.w, wv);
      }
      const int ml = cq * 4 / D, dd = cq * 4 - ml * D;
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        const int r = q * kRowChunk + i;
        if (r < R) {
          float* dst = cluster.map_shared_rank(rv, r % csize);
          *reinterpret_cast<float4*>(dst + (((long long)(r / csize) * n + n0 + nl) * m + m0 + ml) * D + dd) = acc[i];
        }
      }
    }
    __syncthreads();  // every thread is done with this stage's buffer
    if (tid == 0 && s + p.nbuf < nstages) load_stage(s + p.nbuf);
  }
  cluster.sync();  // every vote is in its row's CTA; nothing is written across CTAs after this

  // ---- routing of this CTA's own rows, all iterations
  const long long vrow = (long long)n * m * D;  // one row's votes
  const int md4 = m * D4;
  const float inv_m = 1.f / m;
  for (int e = tid; e < own * md4; e += kThreads) {  // seed: sum_n votes / M
    const int rl = e / md4, c4 = e % md4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int nn = 0; nn < n; ++nn)
      fma4(s, inv_m, *reinterpret_cast<const float4*>(rv + rl * vrow + (long long)nn * m * D + c4 * 4));
    reinterpret_cast<float4*>(npose)[e] = s;
  }
  __syncthreads();
  const int lane_off = lane % D4;
  // lanes per (row, n) in the softmax: the labels rounded up to a power of
  // two, at most a warp, and fewer where that lets one pass take every
  // (row, n) (the phenotype head: 16 lanes of 2 labels for 10 routes)
  int L = 1;
  while (L < m && L < 32) L <<= 1;
  while (L > 1 && (kThreads / L) < own * n && (kThreads / (L / 2)) >= own * n) L >>= 1;
  for (int it = 0; it < iters; ++it) {
    for (int q = tid; q < own * n * m; q += kThreads) {  // agreement of (row, n, m)
      const int mm = q % m, rl = q / (n * m);
      const float4* vp = reinterpret_cast<const float4*>(rv + (long long)q * D);
      const float4* np = reinterpret_cast<const float4*>(npose + ((long long)rl * m + mm) * D);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      int k4 = lane_off;  // a rotated start: the warp's lanes read distinct banks
      for (int k = 0; k < D4; ++k) {
        const float4 v = vp[k4], u = np[k4];
        acc.x = fmaf(v.x, u.x, acc.x);
        acc.y = fmaf(v.y, u.y, acc.y);
        acc.z = fmaf(v.z, u.z, acc.z);
        acc.w = fmaf(v.w, u.w, acc.w);
        if (++k4 == D4) k4 = 0;
      }
      cbuf[q] = ((acc.x + acc.y) + (acc.z + acc.w)) * scale;
    }
    __syncthreads();
    // softmax over M: a group of L lanes per (row, n), one label per lane
    // (M <= 32), or a warp looping over the labels; every lane of a warp
    // takes the same trips, for the shuffles
    for (int base = warp * (32 / L); base < own * n; base += kThreads / L) {
      const int pr = base + lane / L, gl = lane % L;
      const bool live = pr < own * n;
      float* cq = cbuf + (long long)(live ? pr : 0) * m;
      const float nact = it == 0 ? mact[live ? pr / n : 0] : 1.f;  // the decision act: the seed's mean, then ONES
      float mx = -INFINITY;
      if (live)
        for (int mm = gl; mm < m; mm += L) mx = fmaxf(mx, cq[mm]);
      mx = group_max(mx, L);
      float sm = 0.f;
      if (live)
        for (int mm = gl; mm < m; mm += L) {
          const float e = expf(cq[mm] - mx);
          cq[mm] = e;
          sm += e;
        }
      sm = group_sum(sm, L);
      float tot = 0.f;
      if (live)
        for (int mm = gl; mm < m; mm += L) {
          const float qk = cq[mm] / sm * nact;
          cq[mm] = qk;
          tot += qk;
        }
      tot = group_sum(tot, L);
      if (live)
        for (int mm = gl; mm < m; mm += L) cq[mm] = cq[mm] / (tot + 1e-10f);
    }
    __syncthreads();
    for (int e = tid; e < own * md4; e += kThreads) {  // decision pose: sum_n coef * votes * act
      const int rl = e / md4, c4 = e % md4, mm = c4 / D4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int nn = 0; nn < n; ++nn) {
        float4 v = *reinterpret_cast<const float4*>(rv + rl * vrow + (long long)nn * m * D + c4 * 4);
        const float av = acts[rl * n + nn];
        v.x *= av;
        v.y *= av;
        v.z *= av;
        v.w *= av;
        fma4(s, cbuf[((long long)rl * n + nn) * m + mm], v);
      }
      reinterpret_cast<float4*>(npose)[e] = s;
    }
    __syncthreads();
  }

  // ---- outputs of the own rows
  for (int e = tid; e < own * m * D; e += kThreads) {
    const int rl = e / (m * D);
    pose_out[(long long)(row0 + rank + rl * csize) * m * D + e % (m * D)] = npose[e];
  }
  for (int e = tid; e < own * m; e += kThreads) {
    const int rl = e / m;
    act_out[(long long)(row0 + rank + rl * csize) * m + e % m] = iters > 0 ? 1.f : mact[rl];
  }
  for (int q = tid; q < own * n * m; q += kThreads) {
    const int rl = q / (n * m);
    coef_out[(long long)(row0 + rank + rl * csize) * n * m + q % (n * m)] = iters > 0 ? cbuf[q] : inv_m;
  }
}

__global__ void capsule_routing_empty_kernel() {}

// Buffers of a plan at `rows` rows and `rs` routes per stage; sets p.smem.
void layout(Plan& p, int rows, int rs, int nbuf, int n, int a, int m, int d, int es) {
  p.rows = rows;
  p.rows_pad = (rows + kRowChunk - 1) / kRowChunk * kRowChunk;
  p.rows_own = (rows + p.g * p.h - 1) / (p.g * p.h);
  p.rs = rs;
  p.nbuf = nbuf;
  p.route_bytes = (1LL * a * p.mb * d * es + 127) / 128 * 128;
  const long long own = p.rows_own;
  long long off = 0;
  auto take = [&](long long bytes) {
    const long long at = off;
    off += (bytes + 127) / 128 * 128;
    return at;
  };
  p.off_rv = take(4LL * own * n * m * d);
  p.off_npose = take(4LL * own * m * d);
  p.off_coef = take(4LL * own * n * m);
  p.off_acts = take(4LL * own * n);
  p.off_mact = take(4LL * own);
  p.off_bars = take(8 * (kMaxBuf + 1));
  p.off_praw = take(1LL * es * rows * p.nb * a);
  p.off_pose_t = take(4LL * p.nb * a * p.rows_pad);
  p.off_ring = take(1LL * nbuf * rs * p.route_bytes);
  p.smem = off;
}

// The plan for clusters of at most `cap` CTAs: the most rows per tile (up
// to 16), then the most routes per ring stage (up to what fills the
// block's threads), then the most stages in flight, that fit in shared
// memory.
Plan make_plan(int b, int n, int a, int m, int d, int es, int cap) {
  Plan p{};
  p.h = m < cap ? m : cap;
  p.g = n < cap / p.h ? n : cap / p.h;
  if (p.g < 1) p.g = 1;
  p.nb = (n + p.g - 1) / p.g;
  p.mb = (m + p.h - 1) / p.h;
  for (int rows = b < kMaxRows ? b : kMaxRows; rows >= 1; --rows) {
    const int items = (rows + kRowChunk - 1) / kRowChunk * (p.mb * d / 4);
    int rs = (kThreads + items - 1) / items;
    if (rs > p.nb) rs = p.nb;
    for (; rs >= 1; --rs) {
      const int stages = (p.nb + rs - 1) / rs;
      for (int nbuf = stages < kMaxBuf ? stages : kMaxBuf; nbuf >= (stages > 1 ? 2 : 1); --nbuf) {
        layout(p, rows, rs, nbuf, n, a, m, d, es);
        if (p.smem <= kSmemLimit) return p;
      }
    }
  }
  p.smem = -1;
  return p;
}

// A [d0, d1, d2, d3] view (d0 contiguous; strides in elements) as a 4-D
// tensor map with boxes `box`, no swizzle. Returns a cudaError_t.
int tensor_map(CUtensorMap* map, const void* base, int es, const long long (&dims)[4], const long long (&strides)[3],
               const int (&box)[4]) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], el[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) gd[i] = dims[i], bx[i] = box[i];
  for (int i = 0; i < 3; ++i) gs[i] = strides[i] * es;
  const CUresult r = fn(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), gd, gs, bx, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int KA, int KD>
int launch(const T* pose, const T* act, const T* w, float* pose_out, float* act_out, float* coef_out, int b,
           int n, int a, int m, int d, int iters, cudaStream_t stream) {
  const int es = sizeof(T);
  if (b <= 0 || n <= 0 || a <= 0 || m <= 0 || d <= 0 || iters < 0 || (d * es) % 16 != 0 || (a * es) % 16 != 0 ||
      a > 256 || d > 256 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(pose) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = capsule_routing_kernel<T, KA, KD>;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  // the cluster size the card schedules at this shape, found once per
  // (device, type, shape)
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int, int>, int> caps;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, es, b, n, a, m, d);
  int known = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = caps.find(key);
    if (hit != caps.end()) known = hit->second;
  }
  for (int cap = known ? known : kMaxCluster; cap >= 1; cap /= 2) {
    const Plan p = make_plan(b, n, a, m, d, es, cap);
    if (p.smem < 0 || p.nb > 256 || p.mb > 256) return static_cast<int>(cudaErrorInvalidValue);
    // w [n][a][m][d] in boxes [A][MB][D]; pose [b][n][a] in boxes [rows][NB][A]
    CUtensorMap tw, tpose;
    int rc = tensor_map(&tw, w, es, {d, m, a, n}, {(long long)d, (long long)m * d, (long long)a * m * d},
                        {d, p.mb, a, 1});
    if (rc == 0)
      rc = tensor_map(&tpose, pose, es, {a, n, b, 1}, {(long long)a, (long long)n * a, (long long)b * n * a},
                      {a, p.nb, p.rows, 1});
    if (rc != 0) return rc;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    const int csize = p.g * p.h;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(csize * ((b + p.rows - 1) / p.rows));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (!known) {
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) != cudaSuccess || clusters < 1) {
        cudaGetLastError();  // clear, and try smaller clusters
        continue;
      }
      std::lock_guard<std::mutex> lock(mu);
      caps[key] = cap;
    }
    cudaLaunchKernelEx(&cfg, kern, tpose, act, tw, pose_out, act_out, coef_out, b, n, a, m, d, iters, scale, p);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* pose, const void* act, const void* w, float* pose_out, float* act_out, float* coef_out,
             int b, int n, int a, int m, int d, int iters, void* stream) {
  const T* ps = static_cast<const T*>(pose);
  const T* as = static_cast<const T*>(act);
  const T* ws = static_cast<const T*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a == 32 && d == 64)  // both heads of the repository
    return launch<T, 32, 64>(ps, as, ws, pose_out, act_out, coef_out, b, n, a, m, d, iters, st);
  return launch<T, 0, 0>(ps, as, ws, pose_out, act_out, coef_out, b, n, a, m, d, iters, st);
}

}  // namespace

// Inputs contiguous on the device, all fp32 or all bf16: pose [b,n,a],
// act [b,n], w [n,a,m,d] (16-byte aligned); outputs fp32: pose [b,m,d],
// act [b,m], coef [b,n,m]. Returns the cudaError_t of the launch:
// cudaErrorInvalidValue beyond the limits in the note above.
extern "C" int capsule_routing_f32(const float* pose, const float* act, const float* w, float* pose_out,
                                   float* act_out, float* coef_out, int b, int n, int a, int m, int d, int iters,
                                   void* stream) {
  return dispatch<float>(pose, act, w, pose_out, act_out, coef_out, b, n, a, m, d, iters, stream);
}

extern "C" int capsule_routing_bf16(const void* pose, const void* act, const void* w, float* pose_out,
                                    float* act_out, float* coef_out, int b, int n, int a, int m, int d, int iters,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(pose, act, w, pose_out, act_out, coef_out, b, n, a, m, d, iters, stream);
}

// One launch of an empty kernel: the floor any single launch pays.
extern "C" int capsule_routing_empty(void* stream) {
  capsule_routing_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
