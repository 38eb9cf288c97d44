// Fixed-batch 8-point RANSAC for the fundamental matrix: one launch for a
// whole `ransac_fundamental` call, every eye and lane.
//
// Replaces, on CUDA tensors, the port's plain path
// (rso_torch/solver/ransac.py `ransac_fundamental_torch`, which the CPU
// keeps): on the card that path was ~850 small PyTorch kernels a call, most
// of them the int64 threefry hashes of its keys and draws
// (rso_torch/random.py), then the Hartley sums, the [E,H,8,9] design rows
// and A^T A, kernel 4 on the [E*H,9,9] batch, the [E,H,N] Sampson scores,
// the argmax and the refit.  This kernel is all of it:
//
//   * the keys and draws: threefry-2x32 on uint32 in registers, jax's
//     PRNGKey / fold_in / split / uniform as rso_torch.random computes them
//     (the call's key split(fold_in(fold_in(PRNGKey(7), frame), data))
//     from the frame index, or an explicit key a eye, or injected draws);
//   * the stratified sample indices (rank strata over the mask's prefix
//     sum, searchsorted(right=True) and the clamps), integers;
//   * the Hartley normalisation, summed in `ransac._pairwise_sum`'s tree
//     order (zero-padded to a power of two, x[:half] + x[half:]) with
//     correctly rounded intrinsics, so T1 and T2 are the plain path's on the
//     card bit for bit;
//   * per hypothesis its normal matrix, its null vector by kernel 4's own
//     routine (csrc/nullvec9.cuh: the bits nullvec9_kernel gives on the same
//     matrix), de-normalisation and the squared Sampson distance against
//     threshold^2 over the valid points;
//   * the winner, the first maximum over hypotheses (torch.argmax's rule);
//   * the refit on the winner's inliers (the normal matrix summed in a fixed
//     order), its null vector, its count, `use_r = score_r >= best`, the
//     final mask, n_inliers and ok (>= 8 inliers and >= 25% of the valid
//     tracks), the input mask passed through where ok is false.
//
// What bounds it on the H100: latency.  At N = 896 points (537 valid), H =
// 256 hypotheses and two eyes a call is ~10 M operations (the scoring, ~32
// a valid point and hypothesis) and reads ~16 KB: 0.16 us of the card's
// f32 rate.  Every step is a chain: the hash (20 rounds), the 9x9 LDL^T,
// the block's reductions.  Design: a cluster of G blocks of 256 threads a
// (lane, eye), the grid (E G, lanes), G the most up to 8 with which every
// cluster is resident at once (`cluster_size`: 8 for a lone call, 5-6 for
// 11 lanes').  Each block compacts the valid points (the mask's prefix
// sum, a segment a thread) into shared memory, 20 bytes a point (global
// scratch where N exceeds what a block may opt in to), and sums the
// normalisation as the plain path's tree (each thread streams its residue
// class's leaves through a stack, then a shared-memory tree).  Thread h
// owns hypothesis h (and h + 256, ... where H > 256): draws, indices,
// normal matrix and null vector in registers; each block of the cluster
// makes every hypothesis and counts its inliers on its own slice of the
// compacted points (a broadcast float4 a point), and each hypothesis's
// count is its blocks' counts, read across the cluster's shared memory
// (integers: any order).  The first block then picks the winner and does
// the refit: each thread sums the winner's inliers of its residue class
// into the 45 normal-matrix entries, which go through a tree over the
// threads, 9 at a time; one thread solves it.  Every Sampson test is the
// same correctly rounded sequence (`sampson_in`), so the winner's count,
// its inlier set and the final mask agree wherever they are recomputed.
// A lane is blocks running the same code, and a hypothesis's count is an
// integer sum: a lane gives a lone call's bits, whatever G.
//   Measured (NVIDIA H100 80GB HBM3 at 700 W, torch.profiler, one call of
// tests/_torch_ransac_cases.py's inputs): 27.7-28.0 us a launch at N = 896
// (537 valid), 29.2 with all 896 valid, 28.5 at N = 1024, 21.9 at N = 128;
// 29.9 us for 11 lanes at N = 896; the plain path ~1.35 ms in a graph.
// By phase (N = 896, read once from per-block timestamps, since taken
// out): compaction 1.7 us, normalisation 4.1, hypotheses and a slice's
// counts 7.0, the refit's sums and solve ~10.
// Measured and dropped: one block a (lane, eye), 70 us at N = 896 (the
// scoring on one SM) and 104 us all valid; the refit's 45 entries summed by
// 45 x 5 threads over point segments, a switch on each thread's entry
// (divergent: ~40 us at N = 896).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nullvec9.cuh"

namespace {

using ldl9::kN;
using ldl9::kNN;

constexpr int kThreads = 256;
constexpr int kSample = 8;            // points a hypothesis
constexpr int kEntries = 45;          // a 9x9 symmetric matrix's lower triangle
constexpr int kRound = 9;             // the refit's entries a reduction round
constexpr int kStack = 24;            // in-thread tree depth: 2^24 leaves a thread
constexpr int kMaxCluster = 8;        // blocks a (lane, eye): the portable cluster
constexpr uint32_t kEngineSeed = 7;   // rso_torch.random.ENGINE_SEED
constexpr int kSmemDefault = 48 * 1024;

static_assert(kEntries % kRound == 0, "the refit's rounds cover its entries");

// A block's shared memory, all of it dynamic (the cluster's blocks read one
// another's `hcnt`): this, then each hypothesis's count on the block's slice
// (H ints) and model (H x 9 floats), then the compacted points (N float4 and
// N int) unless they are in global scratch.
struct Shared {
  float red[kRound][kThreads];          // the normalisation's and refit's trees
  unsigned long long arg[kThreads];     // the winner's reduction
  int scan[kThreads];                   // the compaction's scan
  float F[2][kN];                       // the winner's and the refit's model
  float M[kEntries];                    // the refit's normal matrix
  int count_r;                          // the refit's count
};

struct Layout {
  size_t hcnt, hF, pts, idx, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline Layout layout(int N, int H, bool points) {
  Layout l;
  l.hcnt = align16(sizeof(Shared));
  l.hF = l.hcnt + (size_t)H * sizeof(int);
  l.pts = align16(l.hF + (size_t)H * kN * sizeof(float));
  l.idx = l.pts + (points ? (size_t)N * sizeof(float4) : 0);
  l.bytes = l.idx + (points ? (size_t)N * sizeof(int) : 0);
  return l;
}

struct Args {
  const float* p1;               // [lanes][E][N][2]
  const float* p2;               // [lanes][E][N][2]
  const unsigned char* mask;     // [lanes][N] bool
  const long long* key;          // [lanes][E][2] or NULL
  const void* frame;             // [lanes] int32 / int64 or NULL
  const float* draws;            // [lanes][E][H][8] or NULL
  long long s_p1, s_p2, s_mask, s_key, s_frame, s_draws;  // lanes' strides (0: shared)
  int frame64, E, N, H;
  int G;                         // blocks (a cluster) a (lane, eye)
  uint32_t data;
  float thr2;
  unsigned char* inliers;        // [lanes][E][N] bool
  float* F;                      // [lanes][E][9]
  int* n_inliers;                // [lanes][E]
  unsigned char* ok;             // [lanes][E] bool
  float4* g_pts;                 // [lanes][E][8][N] where shared memory cannot hold them
  int* g_idx;                    // [lanes][E][8][N]
  // what the tests read, NULL on the main path
  float* p_draws;                // [lanes][E][H][8]
  int* p_idx;                    // [lanes][E][H][8]
  float* p_T;                    // [lanes][E][2][9]: T1, T2
  float* p_M;                    // [lanes][E][H + 1][81]: the refit's last
  float* p_x;                    // [lanes][E][H + 1][9]
  int* p_scores;                 // [lanes][E][H + 1]: the refit's count last
  int* p_best;                   // [lanes][E]
};

// ---- threefry-2x32 (rso_torch.random.threefry2x32) --------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                         uint32_t x1, uint32_t& y0,
                                         uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = x0 ^ rotl(x1, kRot[i % 2][r]);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// jax's uniform float in [0, 1) from the hash of counter i: the top 23 bits
// as the mantissa, times 2^-23 (exact)
__device__ __forceinline__ float uniform_draw(uint32_t k0, uint32_t k1,
                                              uint32_t i) {
  uint32_t b0, b1;
  threefry(k0, k1, 0u, i, b0, b1);
  return __fmul_rn((float)((b0 ^ b1) >> 9), 1.0f / 8388608.0f);
}

// ---- the Sampson test -------------------------------------------------------

// Whether the squared Sampson distance of the pair p = (x1, y1, x2, y2) to F
// (row-major) is within thr2: num^2 <= thr2 max(den, 1e-12), every operation
// correctly rounded, so that it gives the same answer wherever it runs.
__device__ __forceinline__ bool sampson_in(const float (&F)[kN], float4 p,
                                           float thr2) {
  const float a0 = __fmaf_rn(F[0], p.x, __fmaf_rn(F[1], p.y, F[2]));
  const float a1 = __fmaf_rn(F[3], p.x, __fmaf_rn(F[4], p.y, F[5]));
  const float a2 = __fmaf_rn(F[6], p.x, __fmaf_rn(F[7], p.y, F[8]));
  const float b0 = __fmaf_rn(F[0], p.z, __fmaf_rn(F[3], p.w, F[6]));
  const float b1 = __fmaf_rn(F[1], p.z, __fmaf_rn(F[4], p.w, F[7]));
  const float num = __fmaf_rn(p.z, a0, __fmaf_rn(p.w, a1, a2));
  const float den = __fmaf_rn(
      a0, a0, __fmaf_rn(a1, a1, __fmaf_rn(b0, b0, __fmul_rn(b1, b1))));
  return __fmul_rn(num, num) <= __fmul_rn(thr2, fmaxf(den, 1e-12f));
}

// The design row of a normalised pair (x1, y1, x2, y2): x2^T F x1 = a . f
__device__ __forceinline__ void design_row(float x1, float y1, float x2,
                                           float y2, float (&a)[kN]) {
  a[0] = __fmul_rn(x2, x1);
  a[1] = __fmul_rn(x2, y1);
  a[2] = x2;
  a[3] = __fmul_rn(y2, x1);
  a[4] = __fmul_rn(y2, y1);
  a[5] = y2;
  a[6] = x1;
  a[7] = y1;
  a[8] = 1.0f;
}

// F (pixels) = T2^T Fn T1, Ti = [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]
__device__ __forceinline__ void denormalise(const float (&f)[kN],
                                            const float (&t1)[kN],
                                            const float (&t2)[kN],
                                            float (&out)[kN]) {
  float g[kN];   // Fn T1
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g[3 * r + c] = f[3 * r] * t1[c] + f[3 * r + 1] * t1[3 + c]
                     + f[3 * r + 2] * t1[6 + c];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[3 * r + c] = t2[r] * g[c] + t2[3 + r] * g[3 + c]
                       + t2[6 + r] * g[6 + c];
    }
  }
}

__device__ __forceinline__ float4 load_pair(const float* p1, const float* p2,
                                            int i) {
  const float2 a = reinterpret_cast<const float2*>(p1)[i];
  const float2 b = reinterpret_cast<const float2*>(p2)[i];
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---- the normalisation's tree sums ------------------------------------------

// The sums over i < N of C channels of leaf(i), zero-padded to P = the next
// power of two, in `_pairwise_sum`'s order: P/2 adds x[i] + x[i + P/2], then
// P/4, ... down to one.  Thread t owns the leaves t + k kThreads: the levels
// whose half is kThreads or more pair its own leaves (k with k + K/2, ...),
// an adjacent-pair tree over k bit-reversed, streamed through a stack;
// the rest is a tree over the threads in shared memory.  Every thread gets
// the sums.
template <int C, class Leaf>
__device__ __forceinline__ void tree_sums(int N, Leaf leaf,
                                          float (*red)[kThreads],
                                          float (&sum)[C]) {
  const int t = threadIdx.x;
  int P = 1;
  while (P < N) P <<= 1;
  const int width = min(P, kThreads);   // leaves after the in-thread levels
  if (t < width) {
    const int K = P / width;
    int lg = 0;
    while ((1 << lg) < K) ++lg;
    float st[kStack][C];
    int sp = 0;
    for (int j = 0; j < K; ++j) {
      const int k = lg ? (int)(__brev((unsigned)j) >> (32 - lg)) : 0;
      const int i = t + k * kThreads;
      float v[C];
      if (i < N) {
        leaf(i, v);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = 0.0f;
      }
      for (int m = j; m & 1; m >>= 1) {
        --sp;
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __fadd_rn(st[sp][c], v[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) st[sp][c] = v[c];
      ++sp;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) red[c][t] = st[0][c];
  }
  __syncthreads();
  for (int half = width / 2; half >= 1; half >>= 1) {
    if (t < half) {
#pragma unroll
      for (int c = 0; c < C; ++c) red[c][t] = __fadd_rn(red[c][t], red[c][t + half]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < C; ++c) sum[c] = red[c][0];
  __syncthreads();
}

// what the tests read: a symmetric matrix from its lower triangle, a vector
__device__ __forceinline__ void probe_matrix(float* out,
                                             const float (&m)[kN][kN]) {
#pragma unroll
  for (int r = 0; r < kN; ++r) {
#pragma unroll
    for (int c = 0; c < kN; ++c) out[r * kN + c] = c <= r ? m[r][c] : m[c][r];
  }
}

__device__ __forceinline__ void probe_vector(float* out, const float (&x)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) out[k] = x[k];
}

__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

// `p` in shared memory: the same address in block `rank` of the cluster
__device__ __forceinline__ const int* cluster_map(const int* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

__global__ void __launch_bounds__(kThreads, 1) ransac_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float (*s_red)[kThreads] = sh.red;
  unsigned long long* s_arg = sh.arg;
  int* s_scan = sh.scan;
  float (*s_F)[kN] = sh.F;
  int& s_count = sh.count_r;

  const int t = threadIdx.x;
  const int G = a.G;
  const int rank = blockIdx.x % G;      // the block's rank in its cluster
  const int e = blockIdx.x / G;
  const int lane = blockIdx.y;
  const int E = a.E, N = a.N, H = a.H;
  const int le = lane * E + e;          // the output's (lane, eye)
  const float* p1 = a.p1 + lane * a.s_p1 + (size_t)e * N * 2;
  const float* p2 = a.p2 + lane * a.s_p2 + (size_t)e * N * 2;
  const unsigned char* mask = a.mask + lane * a.s_mask;

  const Layout L = layout(N, H, a.g_pts == nullptr);
  int* hcnt = reinterpret_cast<int*>(smem + L.hcnt);
  float* hF = reinterpret_cast<float*>(smem + L.hF);
  float4* pts;                          // the valid pairs, compacted
  int* idx;                             // their indices
  if (a.g_pts != nullptr) {
    pts = a.g_pts + ((size_t)le * kMaxCluster + rank) * N;
    idx = a.g_idx + ((size_t)le * kMaxCluster + rank) * N;
  } else {
    pts = reinterpret_cast<float4*>(smem + L.pts);
    idx = reinterpret_cast<int*>(smem + L.idx);
  }
  const bool lead = rank == 0;          // writes the results (and the probe)

  // ---- compaction: a contiguous segment a thread, an exclusive scan -------
  const int seg = (N + kThreads - 1) / kThreads;
  const int i0 = min(N, t * seg), i1 = min(N, i0 + seg);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += mask[i] != 0;
  s_scan[t] = mine;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = t >= off ? s_scan[t - off] : 0;
    __syncthreads();
    s_scan[t] += v;
    __syncthreads();
  }
  const int count = s_scan[kThreads - 1];
  for (int i = i0, o = s_scan[t] - mine; i < i1; ++i) {
    if (mask[i]) {
      pts[o] = load_pair(p1, p2, i);
      idx[o] = i;
      ++o;
    }
  }
  __syncthreads();

  // ---- Hartley normalisation of both views (ransac._normalize_pts) --------
  const float n = fmaxf((float)count, 1.0f);
  float mean[4];
  tree_sums<4>(N, [&](int i, float (&v)[4]) {
    const float w = mask[i] ? 1.0f : 0.0f;
    const float4 p = load_pair(p1, p2, i);
    v[0] = __fmul_rn(p.x, w);
    v[1] = __fmul_rn(p.y, w);
    v[2] = __fmul_rn(p.z, w);
    v[3] = __fmul_rn(p.w, w);
  }, s_red, mean);
#pragma unroll
  for (int c = 0; c < 4; ++c) mean[c] = __fdiv_rn(mean[c], n);
  float dist[2];
  tree_sums<2>(N, [&](int i, float (&v)[2]) {
    const float w = mask[i] ? 1.0f : 0.0f;
    const float4 p = load_pair(p1, p2, i);
    const float dx1 = __fsub_rn(p.x, mean[0]), dy1 = __fsub_rn(p.y, mean[1]);
    const float dx2 = __fsub_rn(p.z, mean[2]), dy2 = __fsub_rn(p.w, mean[3]);
    v[0] = __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(dx1, dx1), __fmul_rn(dy1, dy1))), w);
    v[1] = __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(dx2, dx2), __fmul_rn(dy2, dy2))), w);
  }, s_red, dist);
  // sqrt(2) / clamp(mean distance, 1e-9), as PyTorch evaluates it:
  // reciprocal, then times sqrt(2) rounded to float32
  const float s1 = __fmul_rn(__frcp_rn(fmaxf(__fdiv_rn(dist[0], n), 1e-9f)),
                             1.41421354f);
  const float s2 = __fmul_rn(__frcp_rn(fmaxf(__fdiv_rn(dist[1], n), 1e-9f)),
                             1.41421354f);
  const float T1[kN] = {s1, 0.f, __fmul_rn(-s1, mean[0]),
                        0.f, s1, __fmul_rn(-s1, mean[1]), 0.f, 0.f, 1.f};
  const float T2[kN] = {s2, 0.f, __fmul_rn(-s2, mean[2]),
                        0.f, s2, __fmul_rn(-s2, mean[3]), 0.f, 0.f, 1.f};
  if (a.p_T != nullptr && lead && t == 0) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      a.p_T[(size_t)le * 2 * kN + k] = T1[k];
      a.p_T[(size_t)le * 2 * kN + kN + k] = T2[k];
    }
  }

  // ---- the eye's key -------------------------------------------------------
  uint32_t k0 = 0, k1 = 0;
  if (a.draws == nullptr) {
    if (a.key != nullptr) {
      const long long* kp = a.key + lane * a.s_key + 2 * e;
      k0 = (uint32_t)kp[0];
      k1 = (uint32_t)kp[1];
    } else {
      const uint32_t f = a.frame64
          ? (uint32_t)static_cast<const long long*>(a.frame)[lane * a.s_frame]
          : (uint32_t)static_cast<const int*>(a.frame)[lane * a.s_frame];
      uint32_t f0, f1, c0, c1;
      threefry(0u, kEngineSeed, 0u, f, f0, f1);    // fold_in(PRNGKey(7), frame)
      threefry(f0, f1, 0u, a.data, c0, c1);        // fold_in(., data)
      threefry(c0, c1, 0u, (uint32_t)e, k0, k1);   // split(.)[e]
    }
  }

  // ---- the hypotheses: thread t owns t, t + 256, ...; each block of the
  // cluster makes every hypothesis and counts its inliers among its slice
  // of the compacted points -----------------------------------------------
  const int nv = max(count, 1);
  const bool probe = a.p_draws != nullptr && lead;
  const int slice = (count + G - 1) / G;
  const int j0 = min(count, rank * slice), j1 = min(count, j0 + slice);
  for (int h = t; h < H; h += kThreads) {
    float m[kN][kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) {
#pragma unroll
      for (int c = 0; c < kN; ++c) m[r][c] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSample; ++j) {
      const uint32_t di = (uint32_t)h * kSample + j;
      const float u = a.draws != nullptr
          ? a.draws[lane * a.s_draws + ((size_t)e * H + h) * kSample + j]
          : uniform_draw(k0, k1, di);
      const int lo = (j * nv) / kSample;
      const int hi = ((j + 1) * nv) / kSample;
      const float width = (float)max(hi - lo, 1);
      const int rank = min(lo + (int)floorf(__fmul_rn(u, width)), nv - 1);
      const int i = count > 0 ? idx[rank] : N - 1;
      const float4 p = count > 0 ? pts[rank] : load_pair(p1, p2, N - 1);
      if (probe) {
        a.p_draws[((size_t)le * H + h) * kSample + j] = u;
        a.p_idx[((size_t)le * H + h) * kSample + j] = i;
      }
      float row[kN];
      design_row(__fmul_rn(__fsub_rn(p.x, mean[0]), s1),
                 __fmul_rn(__fsub_rn(p.y, mean[1]), s1),
                 __fmul_rn(__fsub_rn(p.z, mean[2]), s2),
                 __fmul_rn(__fsub_rn(p.w, mean[3]), s2), row);
#pragma unroll
      for (int r = 0; r < kN; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c) {
          m[r][c] = j == 0 ? __fmul_rn(row[r], row[c])
                           : __fmaf_rn(row[r], row[c], m[r][c]);
        }
      }
    }
    if (probe) probe_matrix(a.p_M + ((size_t)le * (H + 1) + h) * kNN, m);
    float f[kN];
    ldl9::nullvec9_regs(m, f);
    if (probe) probe_vector(a.p_x + ((size_t)le * (H + 1) + h) * kN, f);
    float Fs[kN];
    denormalise(f, T1, T2, Fs);
    int score = 0;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) score += sampson_in(Fs, pts[j], a.thr2);
    hcnt[h] = score;
#pragma unroll
    for (int k = 0; k < kN; ++k) hF[(size_t)h * kN + k] = Fs[k];
  }

  // ---- each hypothesis's count: its blocks' counts, read across the
  // cluster; the first maximum (h ascends) ----------------------------------
  cluster_sync();
  int best_score = -1, best_h = -1;
  for (int h = t; h < H; h += kThreads) {
    int score = 0;
    for (int r = 0; r < G; ++r) score += cluster_map(hcnt, r)[h];
    if (probe) a.p_scores[(size_t)le * (H + 1) + h] = score;
    if (score > best_score) {
      best_score = score;
      best_h = h;
    }
  }
  cluster_sync();                       // no block leaves while it is read
  if (!lead) return;

  // ---- the winner: the largest score, the smallest index on ties ----------
  s_arg[t] = best_h < 0 ? 0ull
                        : ((unsigned long long)best_score << 32)
                              | (0xFFFFFFFFu - (uint32_t)best_h);
  __syncthreads();
  for (int half = kThreads / 2; half >= 1; half >>= 1) {
    if (t < half && s_arg[t + half] > s_arg[t]) s_arg[t] = s_arg[t + half];
    __syncthreads();
  }
  const int win_h = (int)(0xFFFFFFFFu - (uint32_t)(s_arg[0] & 0xFFFFFFFFull));
  const int win_score = (int)(s_arg[0] >> 32);
  if (t < kN) s_F[0][t] = hF[(size_t)win_h * kN + t];
  if (t == 0) s_count = 0;
  __syncthreads();

  // ---- the refit on the winner's inliers -----------------------------------
  float Fw[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) Fw[k] = s_F[0][k];
  // each thread sums the winner's inliers j = t mod 256 into the 45
  // entries, then the entries go through a tree over the threads, 9 at a
  // time: a fixed order
  float acc[kEntries];
#pragma unroll
  for (int q = 0; q < kEntries; ++q) acc[q] = 0.0f;
  for (int j = t; j < count; j += kThreads) {
    const float4 p = pts[j];
    if (!sampson_in(Fw, p, a.thr2)) continue;
    float row[kN];
    design_row(__fmul_rn(__fsub_rn(p.x, mean[0]), s1),
               __fmul_rn(__fsub_rn(p.y, mean[1]), s1),
               __fmul_rn(__fsub_rn(p.z, mean[2]), s2),
               __fmul_rn(__fsub_rn(p.w, mean[3]), s2), row);
#pragma unroll
    for (int r = 0, q = 0; r < kN; ++r) {
#pragma unroll
      for (int c = 0; c <= r; ++c, ++q) acc[q] = __fmaf_rn(row[r], row[c], acc[q]);
    }
  }
#pragma unroll
  for (int q0 = 0; q0 < kEntries; q0 += kRound) {
#pragma unroll
    for (int c = 0; c < kRound; ++c) s_red[c][t] = acc[q0 + c];
    __syncthreads();
    for (int half = kThreads / 2; half >= 1; half >>= 1) {
      if (t < half) {
#pragma unroll
        for (int c = 0; c < kRound; ++c)
          s_red[c][t] = __fadd_rn(s_red[c][t], s_red[c][t + half]);
      }
      __syncthreads();
    }
    if (t < kRound) sh.M[q0 + t] = s_red[t][0];
    __syncthreads();
  }
  if (t == 0) {
    float m[kN][kN];
#pragma unroll
    for (int r = 0, q = 0; r < kN; ++r) {
#pragma unroll
      for (int c = 0; c < kN; ++c) m[r][c] = c <= r ? sh.M[q++] : 0.0f;
    }
    if (probe) probe_matrix(a.p_M + ((size_t)le * (H + 1) + H) * kNN, m);
    float f[kN];
    ldl9::nullvec9_regs(m, f);
    if (probe) probe_vector(a.p_x + ((size_t)le * (H + 1) + H) * kN, f);
    float Fr[kN];
    denormalise(f, T1, T2, Fr);
#pragma unroll
    for (int k = 0; k < kN; ++k) s_F[1][k] = Fr[k];
  }
  __syncthreads();
  float Fr[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) Fr[k] = s_F[1][k];
  int mine_r = 0;
  for (int j = t; j < count; j += kThreads) mine_r += sampson_in(Fr, pts[j], a.thr2);
  atomicAdd(&s_count, mine_r);
  __syncthreads();

  // ---- the final mask ------------------------------------------------------
  const int score_r = s_count;
  const bool use_r = score_r >= win_score;
  const int n_inl = use_r ? score_r : win_score;
  const bool ok = n_inl >= 8 && (float)n_inl >= 0.25f * (float)count;
  float Ff[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) Ff[k] = use_r ? Fr[k] : Fw[k];
  unsigned char* out = a.inliers + (size_t)le * N;
  for (int i = t; i < N; i += kThreads) {
    const bool m = mask[i] != 0;
    out[i] = ok ? (m && sampson_in(Ff, load_pair(p1, p2, i), a.thr2)) : m;
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < kN; ++k) a.F[(size_t)le * kN + k] = Ff[k];
    a.n_inliers[le] = n_inl;
    a.ok[le] = ok;
    if (probe) {
      a.p_scores[(size_t)le * (H + 1) + H] = score_r;
      a.p_best[le] = win_h;
    }
  }
}

cudaError_t device_attr(cudaDeviceAttr what, int* value) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(value, what, dev);
  return e;
}

// The blocks a (lane, eye): the most, up to 8, with which all `units`
// clusters are resident at once (the device's SMs split by its GPCs: 8 for
// a lone call's two eyes on the H100, fewer for 11 lanes').  The answer
// for the last (units, shared memory) is kept: the occupancy query is the
// host's, once a shape.
cudaError_t cluster_size(cudaLaunchConfig_t cfg, int units, int* G) {
  static int last_units = -1, last_G = 1;
  static size_t last_smem = 0;
  if (units == last_units && cfg.dynamicSmemBytes == last_smem) {
    *G = last_G;
    return cudaSuccess;
  }
  int g = kMaxCluster;
  for (; g > 1; --g) {
    cfg.gridDim = dim3(units * g);
    cfg.attrs[0].val.clusterDim.x = g;
    int resident = 0;
    if (cudaOccupancyMaxActiveClusters(&resident, ransac_kernel, &cfg)
        != cudaSuccess) {
      cudaGetLastError();               // not this size: try a smaller one
      continue;
    }
    if (resident >= units) break;
  }
  last_units = units;
  last_smem = cfg.dynamicSmemBytes;
  last_G = g;
  *G = g;
  return cudaSuccess;
}

}  // namespace

// Where a call's N points and H hypotheses go on this device: 1 all in a
// block's shared memory (up to what a block may opt in to: N ~ 9,000 at
// H = 256 on the H100), 0 the points in global scratch (the caller's
// lanes * E * 8 * N float4 and int), -1 not even the hypotheses fit
// (H > ~5,500); below -1: a CUDA error, negated, less 1.
extern "C" int rso_ransac_fits(int N, int H) {
  int optin = 0;
  const cudaError_t e = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    &optin);
  if (e != cudaSuccess) return -(int)e - 1;
  if (layout(N, H, true).bytes <= (size_t)optin) return 1;
  return layout(N, H, false).bytes <= (size_t)optin ? 0 : -1;
}

// One launch: `lanes` calls of E eyes each, a cluster of G blocks a (lane,
// eye) (`cluster_size`), the grid (E G, lanes).
// Each operand's lanes' stride is in elements (0: one for every lane).  The
// eyes' draws: `draws` where given, else from `key` (one a eye), else from
// the frame index (`frame`, int64 where frame64) as
// split(fold_in(fold_in(PRNGKey(7), frame), data)).  `g_pts`/`g_idx`:
// scratch where rso_ransac_fits is 0, else NULL.  `probe`: NULL, or 7
// pointers (Args' p_draws ... p_best).
extern "C" int rso_ransac(const float* p1, long long s_p1, const float* p2,
                          long long s_p2, const unsigned char* mask,
                          long long s_mask, const long long* key,
                          long long s_key, const void* frame, long long s_frame,
                          int frame64, const float* draws, long long s_draws,
                          int lanes, int E, int N, int H, int data,
                          float thr2, unsigned char* inliers, float* F,
                          int* n_inliers, unsigned char* ok, void* g_pts,
                          void* g_idx, void** probe, void* stream) {
  if (lanes < 1 || E < 1 || N < 1 || H < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (draws == nullptr && key == nullptr && frame == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.p1 = p1; a.p2 = p2; a.mask = mask; a.key = key; a.frame = frame;
  a.draws = draws;
  a.s_p1 = s_p1; a.s_p2 = s_p2; a.s_mask = s_mask; a.s_key = s_key;
  a.s_frame = s_frame; a.s_draws = s_draws;
  a.frame64 = frame64; a.E = E; a.N = N; a.H = H;
  a.data = (uint32_t)data; a.thr2 = thr2;
  a.inliers = inliers; a.F = F; a.n_inliers = n_inliers; a.ok = ok;
  a.g_pts = static_cast<float4*>(g_pts);
  a.g_idx = static_cast<int*>(g_idx);
  float** pf = reinterpret_cast<float**>(probe);
  int** pi = reinterpret_cast<int**>(probe);
  a.p_draws = probe ? pf[0] : nullptr;
  a.p_idx = probe ? pi[1] : nullptr;
  a.p_T = probe ? pf[2] : nullptr;
  a.p_M = probe ? pf[3] : nullptr;
  a.p_x = probe ? pf[4] : nullptr;
  a.p_scores = probe ? pi[5] : nullptr;
  a.p_best = probe ? pi[6] : nullptr;
  const size_t smem = layout(N, H, g_pts == nullptr).bytes;
  cudaError_t err;
  if (smem > (size_t)kSmemDefault) {
    err = cudaFuncSetAttribute(ransac_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_size(cfg, E * lanes, &a.G);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(E * a.G, lanes);
  attr[0].val.clusterDim.x = a.G;
  err = cudaLaunchKernelEx(&cfg, ransac_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
