// One masked iteration of the pose solver's robust Gauss-Newton loop: one
// launch for every lane.
//
// No TPU kernel of the reference corresponds: rso's GN iteration
// (rso/solver/robust_gn.py `_eval_rgn` and the body of `_gn_phase`'s
// lax.while_loop) is plain XLA, fused by its compiler.  The port ran it as
// ~470 small PyTorch kernels an iteration (rso_torch/solver/robust_gn.py
// `gn_iteration_torch`, the plain version beside this kernel, which the
// CPU keeps), each a node of the step's CUDA graph inside the GN loop's
// conditional WHILE node.  This kernel is the whole iteration: the Rodrigues
// rotation of the increment and its derivatives, every slot's stereo
// projection, 4x6 Jacobian, residual, finite-Jacobian mask, robust weight
// and cost, the normal equations (H, g), LM damping, the 6x6 solve (the
// Cholesky inverse and its 1-norm condition number, or the eigh backend's
// cyclic Jacobi, csrc/eigh6.cuh, the routine the eigh6 kernel runs), and
// the carry update (lambda, error code, pose increment, the stop, the
// cost-increase count, the abort, the iteration count, the residuals), all
// written in place over the carry, which is the loop's own.
//
// What bounds it on the H100: latency.  One iteration at T = 896 slots
// (kitti: 512 + 256 + 128) is ~0.3 MFLOP and ~40 KB, under 0.01 us of the
// card's rate or bandwidth; its time is a chain of dependent steps.
// Design: one block of 256 threads a lane (B = 1 for Engine, 11 lanes in
// the fleet), each thread computing R and dR from the increment in
// registers and striding over the slots; every slot's terms are formed as
// the plain version forms them (a masked slot contributes 0 * its terms, so
// a non-finite one poisons the sums there too); the 21 lower entries of H,
// the 6 of g and the cost are summed per thread, over each warp by a
// butterfly of shuffles and over the 8 warps through shared memory, in a
// fixed order (no atomics: the same bits for a lane alone and in a batch,
// launch after launch).  One thread then solves and writes the carry.  A
// lane whose loop has stopped (`active` false) returns at once and leaves
// its carry as it was: the masked iteration's own meaning.  Variants
// (robust kernel, IRLS weighting of H, per-slot weights, LM damping, the
// Cholesky or the eigh backend) are template parameters, one kernel each;
// the eigh variants call one non-inlined copy of eigh6's routine.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 14.7 us a
// launch at [1, 896], 15.0 us at 11 lanes, against a bound of 0.010 us
// (bytes) and ~400 us an iteration of the plain version's ~250 graph nodes;
// in the step's graph an iteration (the WHILE body: the kernel and the
// flag's copy) takes 22-24 us.  127-128 registers, no spill; 31 s of nvcc.
// The next design: 512 threads with each thread's slots loaded up front,
// reciprocals in place of the Jacobian's divisions, a warp for the solve.
#include <cuda_runtime.h>

#include <array>
#include <utility>

#include "eigh6.cuh"

namespace {

constexpr int kN = rso_jacobi6::kN;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kH = kN * (kN + 1) / 2;    // H's lower entries
constexpr int kSums = kH + kN + 1;       // H, g, the cost
constexpr float kF32Max = 3.402823466e38f;
constexpr float kCondMax = 1e7f;
constexpr float kSmallAngle = 1e-5f;

enum Variant {
  kRobust = 1, kIrls = 2, kWeighted = 4, kLm = 8, kEigh = 16, kVariants = 32
};

struct GnArgs {
  // inputs: each with its lanes' stride in elements (0: shared by every lane)
  const float* cam;            // [9]: fx_l fy_l cx_l cy_l fx_r fy_r cx_r cy_r baseline
  const float* lmks;           // [T, 3]
  const float* obs;            // [T, 4]
  const unsigned char* mask;   // [T] bool
  const float* weight;         // [T], or null
  long long cam_stride, lmks_stride, obs_stride, mask_stride, weight_stride;
  // the carry, read and written in place, lane-major
  int* it;
  unsigned char* active;
  float* dp;                   // [6]
  float* cost;
  int* times_inc;
  unsigned char* abort;
  float* res;                  // [T]
  int* ec;
  float* lam;                  // null without LM
  int T;
  float b2, min_mod;
  int max_incr_cost, max_iters, incr_cost_code, bad_cond_code;
};

__device__ __forceinline__ int tri(int j, int k) { return j * (j + 1) / 2 + k; }

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// max that keeps a NaN, as torch's amax does
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// R(w) and dR/dw_k (rso_torch/geometry/rotations.py `rodrigues_with_grad`,
// the small-angle branch at |w| < 1e-5 included)
__device__ __forceinline__ void rodrigues_with_grad(const float (&w)[3],
                                                    float (&R)[3][3],
                                                    float (&dR)[3][3][3]) {
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float t = sqrtf(t2);
  const bool small = t < kSmallAngle;
  const float st = small ? 1.0f : t;
  const float st2 = small ? 1.0f : t2;
  const float st3 = st2 * st;
  const float st4 = st2 * st2;
  const float sn = sinf(t);
  const float cs = cosf(t);
  const float u = (1.0f - cs) / st2;
  const float v = sn / st;
  const float duc = ((sn / st) * st2 - (1.0f - cs) * 2.0f) / st4;
  const float dvc = (st * cs - sn) / st3;
  const float K[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]},
                         {-w[1], w[0], 0.0f}};
  // E_k = hat(e_k) = dK/dw_k
  const float E[3][3][3] = {
      {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, -1.0f}, {0.0f, 1.0f, 0.0f}},
      {{0.0f, 0.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, {-1.0f, 0.0f, 0.0f}},
      {{0.0f, -1.0f, 0.0f}, {1.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = small ? eye + K[i][j] : eye + v * K[i][j] + u * K2[i][j];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float du = duc * w[k];
    const float dv = dvc * w[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float dK2 = 0.0f;
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          dK2 += E[k][i][l] * K[l][j] + K[i][l] * E[k][l][j];
        }
        const float full = dv * K[i][j] + v * E[k][i][j] + du * K2[i][j]
                           + u * dK2;
        dR[k][i][j] = small ? E[k][i][j] : full;
      }
    }
  }
}

// (L L^T)^-1 from a Cholesky factor of the lower triangle of H; false where
// H is not positive definite (a pivot not > 0, or NaN), as cholesky_ex's
// info reports it
__device__ __forceinline__ bool cho_inverse(const float (&H)[kN][kN],
                                            float (&Hinv)[kN][kN]) {
  float L[kN][kN];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float d = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    ok = ok && d > 0.0f;
    L[j][j] = sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < kN; ++i) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s / L[j][j];
    }
  }
  // Linv = L^-1, lower triangular: forward substitution on the identity
  float Li[kN][kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    Li[c][c] = 1.0f / L[c][c];
#pragma unroll
    for (int i = c + 1; i < kN; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = c; k < i; ++k) s -= L[i][k] * Li[k][c];
      Li[i][c] = s / L[i][i];
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int k = 0; k <= j; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int i = j; i < kN; ++i) s += Li[i][j] * Li[i][k];
      Hinv[j][k] = s;
      Hinv[k][j] = s;
    }
  }
  return ok;
}

// eigh6's routine, compiled once and called by the eigh variants' solving
// thread (inlined in each of the 16, it would make most of the file's build)
__device__ __noinline__ void jacobi6(const float (&h)[kN * kN], float (&w)[kN],
                                     float (&V)[kN][kN]) {
  rso_jacobi6::eigh6(h, w, V);
}

// The 6x6 solve of `_eval_rgn`: dx and bad_cond from H (damped) and g.
template <bool kUseEigh, bool kUseLm>
__device__ __forceinline__ bool solve6(const float (&H)[kN][kN],
                                       const float (&g)[kN], float (&dx)[kN]) {
  bool bad;
  if constexpr (!kUseEigh) {
    float Hinv[kN][kN];
    const bool pd = cho_inverse(H, Hinv);
    float nh = 0.0f, ni = 0.0f;
    bool dx_finite = true;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s += (pd ? Hinv[j][k] : quiet_nan()) * g[k];
      dx[j] = s;
      dx_finite = dx_finite && finite(s);
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      float ch = 0.0f, ci = 0.0f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        ch += fabsf(H[j][k]);
        ci += fabsf(pd ? Hinv[j][k] : quiet_nan());
      }
      nh = nan_max(nh, ch);
      ni = nan_max(ni, ci);
    }
    const float cond = nh * ni;
    bad = !finite(cond) || !dx_finite;
    if (!kUseLm) bad = bad || cond > kCondMax;
#pragma unroll
    for (int j = 0; j < kN; ++j) dx[j] = finite(dx[j]) ? dx[j] : 0.0f;
  } else {
    // a non-finite H is swapped for the identity and its cond set to NaN
    bool h_finite = true;
    float h[kN * kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        h_finite = h_finite && finite(H[i][j]);
        h[i * kN + j] = H[i][j];
      }
    }
    if (!h_finite) {
#pragma unroll
      for (int i = 0; i < kN * kN; ++i) h[i] = i % (kN + 1) == 0 ? 1.0f : 0.0f;
    }
    float w[kN];
    float V[kN][kN];
    jacobi6(h, w, V);
    float cond = w[5] / (w[0] <= 0.0f ? quiet_nan() : w[0]);
    if (!h_finite) cond = quiet_nan();
    bad = !finite(cond);
    if (!kUseLm) bad = bad || cond > kCondMax;
    float y[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kN; ++r) s += V[r][k] * g[r];
      const float inv = w[k] > w[5] * 1e-9f
                            ? 1.0f / (w[k] > 0.0f ? w[k] : 1.0f) : 0.0f;
      y[k] = inv * s;
    }
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) s += V[r][k] * y[k];
      dx[r] = s;
    }
  }
  return bad;
}

template <bool kRobustKernel, bool kIrlsWeighting, bool kSlotWeights,
          bool kUseLm, bool kUseEigh>
__global__ void __launch_bounds__(kThreads) gn_iter_kernel(const GnArgs a) {
  const int b = blockIdx.x;
  if (!a.active[b]) return;      // stopped: the carry stays as it is
  const float* cam = a.cam + b * a.cam_stride;
  const float fxl = cam[0], fyl = cam[1], cxl = cam[2], cyl = cam[3];
  const float fxr = cam[4], fyr = cam[5], cxr = cam[6], cyr = cam[7];
  const float base = cam[8];
  float* dpb = a.dp + static_cast<size_t>(b) * kN;
  float dp[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) dp[k] = dpb[k];
  float R[3][3], dR[3][3][3];
  rodrigues_with_grad({dp[0], dp[1], dp[2]}, R, dR);

  const float* lmks = a.lmks + b * a.lmks_stride;
  const float* obs = a.obs + b * a.obs_stride;
  const unsigned char* mask = a.mask + b * a.mask_stride;
  const float* weight = kSlotWeights ? a.weight + b * a.weight_stride : nullptr;
  float* res = a.res + static_cast<size_t>(b) * a.T;

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  for (int n = threadIdx.x; n < a.T; n += kThreads) {
    const float l[3] = {lmks[3 * n], lmks[3 * n + 1], lmks[3 * n + 2]};
    float P[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      P[i] = l[0] * R[i][0] + l[1] * R[i][1] + l[2] * R[i][2] + dp[3 + i];
    }
    const float X = P[0], Y = P[1];
    const float Zs = fabsf(P[2]) < 1e-9f ? 1e-9f : P[2];
    const float X2 = X - base;
    const float pix[4] = {fxl * X / Zs + cxl, fyl * Y / Zs + cyl,
                          fxr * X2 / Zs + cxr, fyr * Y / Zs + cyr};
    const float Z2 = Zs * Zs;
    float J[4][kN];
    bool ok = finite(pix[0]) && finite(pix[1]) && finite(pix[2])
              && finite(pix[3]);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      float d[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i] = k < 3 ? dR[k][i][0] * l[0] + dR[k][i][1] * l[1]
                           + dR[k][i][2] * l[2]
                     : (i == k - 3 ? 1.0f : 0.0f);
      }
      J[0][k] = fxl * (d[0] * Zs - X * d[2]) / Z2;
      J[1][k] = fyl * (d[1] * Zs - Y * d[2]) / Z2;
      J[2][k] = fxr * (d[0] * Zs - X2 * d[2]) / Z2;
      J[3][k] = fyr * (d[1] * Zs - Y * d[2]) / Z2;
#pragma unroll
      for (int i = 0; i < 4; ++i) ok = ok && finite(J[i][k]);
    }
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = obs[4 * n + i] - pix[i];
    const float s = r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3];
    const bool m = mask[n] != 0 && ok;
    float mf = m ? 1.0f : 0.0f;
    float rho, fi;
    if constexpr (kRobustKernel) {
      const float nn = sqrtf(1.0f + s / a.b2);
      rho = 1.0f / nn;
      fi = a.b2 * (nn - 1.0f);
    } else {
      rho = 1.0f;
      fi = 0.5f * s;
    }
    if constexpr (kSlotWeights) mf = mf * weight[n];
    acc[kSums - 1] += mf * fi;
    const float mr = mf * rho;
    const float hw = kIrlsWeighting ? mr : mf;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      float gj = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) gj += (mr * J[i][j]) * r[i];
      acc[kH + j] += gj;
#pragma unroll
      for (int k = 0; k <= j; ++k) {
        float hjk = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) hjk += (hw * J[i][j]) * J[i][k];
        acc[tri(j, k)] += hjk;
      }
    }
    res[n] = m ? s : kF32Max;
  }

  // the sums: a butterfly over each warp, then the warps in order
  __shared__ float part[kWarps][kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    float x = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, off);
    }
    acc[i] = x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) part[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  float tot[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    float x = part[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += part[w][i];
    tot[i] = x;
  }
  float H[kN][kN], g[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    g[j] = tot[kH + j];
#pragma unroll
    for (int k = 0; k <= j; ++k) {
      H[j][k] = tot[tri(j, k)];
      H[k][j] = H[j][k];
    }
  }
  const float c_cost = tot[kSums - 1];
  float lam = 0.0f;
  if constexpr (kUseLm) {
    lam = a.lam[b];
    // Marquardt damping: lambda * diag(H) keeps the step scale-relative
#pragma unroll
    for (int j = 0; j < kN; ++j) H[j][j] = H[j][j] + lam * H[j][j];
  }
  float dx[kN];
  const bool bad = solve6<kUseEigh, kUseLm>(H, g, dx);

  // the carry update (rso_torch/solver/robust_gn.py `gn_iteration_torch`)
  const int it = a.it[b];
  const float p_cost = a.cost[b];
  if constexpr (kUseLm) {
    const bool improved = it == 0 || c_cost <= p_cost;
    const float up = lam * 0.5f;
    const float down = lam * 4.0f;
    // torch.clamp keeps a NaN
    a.lam[b] = improved ? (up < 1e-7f ? 1e-7f : up)
                        : (down > 1e3f ? 1e3f : down);
  }
  int ec = bad ? a.bad_cond_code : a.ec[b];
  const bool later = it > 0;
  float n2 = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) n2 += dx[k] * dx[k];
  const bool done = later && sqrtf(n2) < a.min_mod;
  const int times_inc = a.times_inc[b] + ((later && p_cost < c_cost) ? 1 : 0);
  const bool too_many = times_inc > a.max_incr_cost;
  if (too_many && !bad) ec = a.incr_cost_code;
  const bool abort = bad || too_many;
  const int it1 = it + 1;
  if (!bad) {
#pragma unroll
    for (int k = 0; k < kN; ++k) dpb[k] = dp[k] + dx[k];
  }
  a.it[b] = it1;
  a.active[b] = !done && !abort && it1 < a.max_iters;
  a.cost[b] = c_cost;
  a.times_inc[b] = times_inc;
  a.abort[b] = abort;
  a.ec[b] = ec;
}

using Launcher = int (*)(const GnArgs&, int, cudaStream_t);

template <int V>
int launch_variant(const GnArgs& a, int B, cudaStream_t stream) {
  gn_iter_kernel<(V & kRobust) != 0, (V & kIrls) != 0, (V & kWeighted) != 0,
                 (V & kLm) != 0, (V & kEigh) != 0>
      <<<B, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int... V>
constexpr std::array<Launcher, sizeof...(V)> launchers(
    std::integer_sequence<int, V...>) {
  return {{&launch_variant<V>...}};
}

constexpr std::array<Launcher, kVariants> kLaunchers =
    launchers(std::make_integer_sequence<int, kVariants>{});

}  // namespace

// One GN iteration for B lanes, in place over the carry (it, active, dp,
// cost, times_inc, abort, res, ec, lam: lane-major, contiguous); `variant`
// the Variant bits, which must agree with weight and lam being given.
// Returns cudaErrorInvalidValue for a variant out of range.
extern "C" int rso_gn_iter(
    const float* cam, long long cam_stride, const float* lmks,
    long long lmks_stride, const float* obs, long long obs_stride,
    const unsigned char* mask, long long mask_stride, const float* weight,
    long long weight_stride, int* it, unsigned char* active, float* dp,
    float* cost, int* times_inc, unsigned char* abort, float* res, int* ec,
    float* lam, int B, int T, int variant, float b2, float min_mod,
    int max_incr_cost, int max_iters, int incr_cost_code, int bad_cond_code,
    void* stream) {
  if (variant < 0 || variant >= kVariants || B <= 0 || T < 0
      || ((variant & kWeighted) != 0) != (weight != nullptr)
      || ((variant & kLm) != 0) != (lam != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const GnArgs a{cam, lmks, obs, mask, weight,
                 cam_stride, lmks_stride, obs_stride, mask_stride, weight_stride,
                 it, active, dp, cost, times_inc, abort, res, ec, lam,
                 T, b2, min_mod, max_incr_cost, max_iters, incr_cost_code,
                 bad_cond_code};
  return kLaunchers[variant](a, B, (cudaStream_t)stream);
}
