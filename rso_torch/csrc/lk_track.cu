// Pyramidal Lucas-Kanade tracking of a set of keypoints: one launch for
// every keypoint, eye and lane of a `lk_track` call.
//
// No TPU kernel of the reference corresponds: rso's LK
// (rso/frontend/optical_flow.py `lk_track`, `_lk_level`, `_coarse_sad_seed`)
// is plain XLA, fused by its compiler.  The port ran it as plain PyTorch
// (rso_torch/frontend/optical_flow.py `lk_track_torch`, the plain version
// beside this kernel, which the CPU keeps): ~30 small kernels an iteration,
// 10 iterations a level, a level a pyramid octave, each eye on its own, and
// an `unfold` SAD seed a call, thousands of nodes of the step's CUDA graph.
// This kernel is the whole of `lk_track`: the coarse SAD seed at the
// coarsest level (the exhaustive 8x8 SAD over +-seed_range px, first index
// on ties), then level by level, coarse to fine, the template and its
// gradients, the 2x2 structure tensor and its det > 1e-6 gate, `iters`
// Gauss-Newton updates of the bilinear window (its integer base held within
// _LK_SLACK px of the initial guess), the final mean absolute residual, the
// flow doubled between levels, and the status gates (valid, every level's
// gate, in bounds, err <= max_err).  The images are read with the edge
// clamped, as the plain version's edge-replicated padding reads them.
//
// What bounds it on the H100: latency.  A frame of the KITTI cell (K = 512
// / 256 / 128 slots, 3 / 2 / 1 levels, both eyes) is ~0.55 GFLOP and reads
// ~10 MB of pyramids, ~8 us of the card's f32 rate; every keypoint-level is
// a chain of 12 dependent block-wide sums.  Design: one block of 128 threads
// a keypoint and eye (and lane) runs the keypoint's whole coarse-to-fine
// chain, with the level's template patch and search patch in shared memory;
// each thread keeps its pixels' template value and gradients in registers,
// the 441-pixel sums are warp shuffles and one pass over the 4 warps'
// partials in shared memory (double-buffered: one barrier a sum), in a fixed
// order, so a lane gives the same bits alone and in a batch; every thread
// then forms the same 2x2 update from the same sums (no broadcast needed).
// The seed is exact in f32 (each SAD a sum of 64 multiples of 1/4^level
// below 256), so any order gives the plain version's seed.
// Measured (vobench's kitti_flow.live traced, NVIDIA H100 80GB HBM3 at
// 700 W): 0.109 ms a frame for its 3 launches, 7.6% of the operations
// bound, against ~17 ms of the plain version in the step's graph; 80
// registers, no spill.  One build: 4 pixels a thread cover any window up to
// win 10 (21x21, the port's only window), so a wider one is refused.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxEyes = 2;
constexpr int kSlots = 4;      // window pixels a thread
constexpr int kMaxWin = 10;
static_assert((2 * kMaxWin + 1) * (2 * kMaxWin + 1) <= kSlots * kThreads,
              "the widest window fits the block's pixels");
constexpr int kSlack = 5;      // optical_flow._LK_SLACK
constexpr int kSeed = 8;       // the seed's SAD window
constexpr int kSeedHalf = 3;   // its offset (extract_patches_wide)

struct LkArgs {
  const float* prev[kMaxEyes][kMaxLevels];   // each [B, h, w]
  const float* cur[kMaxEyes][kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  int levels, K, win, iters, seed_range;
  float max_err;
  const float* pts;               // [B, E, K, 2], octave-0 coords of the pyramids
  const unsigned char* valid;     // [B, E, K] bool
  float* pos;                     // [B, E, K, 2]
  unsigned char* status;          // [B, E, K] bool
  float* err;                     // [B, E, K]
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// an image's pixel with the edge replicated (F.pad(..., "replicate"))
__device__ __forceinline__ float pixel(const float* img, int h, int w, int y,
                                       int x) {
  return __ldg(img + (size_t)clampi(y, 0, h - 1) * w + clampi(x, 0, w - 1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// N block-wide sums, every thread getting them: one barrier; `red` has two
// buffers used in turn, so the next call writes where no thread reads
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (*red)[kWarps][3],
                                          int& phase) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[phase][warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = red[phase][0][i];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += red[phase][k][i];
    v[i] = s;
  }
  phase ^= 1;
}

// (sad, index) with the smaller sad, the smaller index on ties
__device__ __forceinline__ void arg_min(float& s, int& i, float s2, int i2) {
  if (s2 < s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

// The coarse SAD seed (optical_flow._coarse_sad_seed) of the keypoint at
// (x, y) of this level: the integer flow of the least 8x8 SAD over
// +-seed_range px; `tpl` holds 64 floats, `srch` (8 + 2 range)^2.
__device__ void coarse_seed(const float* prev, const float* cur, int h,
                            int w, float x, float y, int range, float* tpl,
                            float* srch, float* red_s, int* red_i,
                            float& gx, float& gy) {
  const int S = kSeed + 2 * range;
  const int D = 2 * range + 1;
  const int pad = range + kSeedHalf + 1;
  // the windows of extract_patches_wide on the padded images, each clamped
  // into the padded image as one unit
  const int cx = (int)rintf(x + (float)pad);
  const int cy = (int)rintf(y + (float)pad);
  const int tx0 = clampi(cx - kSeedHalf, 0, w + 2 * pad - kSeed) - pad;
  const int ty0 = clampi(cy - kSeedHalf, 0, h + 2 * pad - kSeed) - pad;
  const int sx0 = clampi(cx - kSeedHalf - range, 0, w + 2 * pad - S) - pad;
  const int sy0 = clampi(cy - kSeedHalf - range, 0, h + 2 * pad - S) - pad;
  for (int p = threadIdx.x; p < kSeed * kSeed; p += kThreads) {
    tpl[p] = pixel(prev, h, w, ty0 + p / kSeed, tx0 + p % kSeed);
  }
  for (int p = threadIdx.x; p < S * S; p += kThreads) {
    srch[p] = pixel(cur, h, w, sy0 + p / S, sx0 + p % S);
  }
  __syncthreads();
  float best = 3.402823466e38f;
  int best_i = D * D;
  for (int c = threadIdx.x; c < D * D; c += kThreads) {
    const int dy = c / D, dx = c % D;
    float s = 0.0f;
    for (int a = 0; a < kSeed; ++a) {
#pragma unroll
      for (int b = 0; b < kSeed; ++b) {
        s += fabsf(srch[(dy + a) * S + dx + b] - tpl[a * kSeed + b]);
      }
    }
    arg_min(best, best_i, s, c);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float s2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    arg_min(best, best_i, s2, i2);
  }
  if ((threadIdx.x & 31) == 0) {
    red_s[threadIdx.x >> 5] = best;
    red_i[threadIdx.x >> 5] = best_i;
  }
  __syncthreads();
  best = red_s[0];
  best_i = red_i[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) arg_min(best, best_i, red_s[k], red_i[k]);
  gx = (float)(best_i % D - range);
  gy = (float)(best_i / D - range);
}

// the bilinear mix of a 2x2 support (the plain version's order)
__device__ __forceinline__ float bilerp(const float* p, int stride, float fx,
                                        float fy) {
  return (1.0f - fy) * (1.0f - fx) * p[0] + (1.0f - fy) * fx * p[1]
         + fy * (1.0f - fx) * p[stride] + fy * fx * p[stride + 1];
}

// kSlots pixels a thread cover the (2 win + 1)^2 window
__global__ void __launch_bounds__(kThreads)
lk_track_kernel(const LkArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[2][kWarps][3];
  __shared__ float seed_s[kWarps];
  __shared__ int seed_i[kWarps];

  const int k = blockIdx.x, eye = blockIdx.y, lane = blockIdx.z;
  const int E = gridDim.y;
  const size_t slot = ((size_t)lane * E + eye) * a.K + k;
  const int r = a.win, P = 2 * r + 1, M = kSlack;
  const int St = 2 * r + 4, Sc = 2 * r + 2 + 2 * M;
  float* Tp = smem;              // St x St: image rows by-r-1.., cols bx-r-1..
  float* Cp = smem + St * St;    // Sc x Sc: image rows cby0-r-M.., cols cbx0-r-M..
  const float px0 = a.pts[2 * slot], py0 = a.pts[2 * slot + 1];

  // this thread's pixels of the window: (row, col) of pixel p, and whether
  // it is one
  int pr[kSlots], pc[kSlots];
  bool own[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int p = threadIdx.x + s * kThreads;
    own[s] = p < P * P;
    pr[s] = own[s] ? p / P : 0;
    pc[s] = own[s] ? p % P : 0;
  }

  int phase = 0;
  float gx = 0.0f, gy = 0.0f, err = 0.0f;
  bool ok_all = true;
  for (int lvl = a.levels - 1; lvl >= 0; --lvl) {
    const int h = a.h[lvl], w = a.w[lvl];
    const size_t lane_off = (size_t)lane * h * w;
    const float* prev = a.prev[eye][lvl] + lane_off;
    const float* cur = a.cur[eye][lvl] + lane_off;
    const float scale = 1.0f / (float)(1 << lvl);
    const float xl = px0 * scale, yl = py0 * scale;
    if (lvl == a.levels - 1 && a.seed_range > 0) {
      // its barrier before the last step orders every read of its patches
      // before the level's loads over them
      coarse_seed(prev, cur, h, w, xl, yl, a.seed_range, smem, smem + 64,
                  seed_s, seed_i, gx, gy);
    }
    const float xmax = (float)((double)w - 1.001);
    const float ymax = (float)((double)h - 1.001);
    const float x = clampf(xl, 0.0f, xmax), y = clampf(yl, 0.0f, ymax);
    const float bx = floorf(x), by = floorf(y);
    const float fx = x - bx, fy = y - by;
    const float cbx0 = floorf(clampf(x + gx, 0.0f, xmax));
    const float cby0 = floorf(clampf(y + gy, 0.0f, ymax));
    const int tx = (int)bx - r - 1, ty = (int)by - r - 1;
    const int cx = (int)cbx0 - r - M, cy = (int)cby0 - r - M;
    for (int p = threadIdx.x; p < St * St; p += kThreads) {
      Tp[p] = pixel(prev, h, w, ty + p / St, tx + p % St);
    }
    for (int p = threadIdx.x; p < Sc * Sc; p += kThreads) {
      Cp[p] = pixel(cur, h, w, cy + p / Sc, cx + p % Sc);
    }
    __syncthreads();

    // the template and its central-difference gradients
    float T[kSlots], Ix[kSlots], Iy[kSlots];
    float G[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float* q = Tp + (pr[s] + 1) * St + pc[s] + 1;
      T[s] = bilerp(q, St, fx, fy);
      Ix[s] = (bilerp(q + 1, St, fx, fy) - bilerp(q - 1, St, fx, fy)) * 0.5f;
      Iy[s] = (bilerp(q + St, St, fx, fy) - bilerp(q - St, St, fx, fy)) * 0.5f;
      if (!own[s]) T[s] = Ix[s] = Iy[s] = 0.0f;
      G[0] += Ix[s] * Ix[s];
      G[1] += Ix[s] * Iy[s];
      G[2] += Iy[s] * Iy[s];
    }
    block_sum<3>(G, red, phase);
    const float Gxx = G[0], Gxy = G[1], Gyy = G[2];
    const float det = Gxx * Gyy - Gxy * Gxy;
    const bool ok = det > 1e-6f;
    const float inv_det = ok ? 1.0f / det : 0.0f;

    // the bilinear window at flow (gx, gy): its 2x2 support's top-left in
    // Cp and its fractions
    auto window = [&](const float*& base, float& wx, float& wy) {
      const float qx = clampf(x + gx, 0.0f, xmax);
      const float qy = clampf(y + gy, 0.0f, ymax);
      const float cbx = floorf(qx), cby = floorf(qy);
      const int dbx = (int)clampf(cbx - cbx0, (float)-M, (float)M);
      const int dby = (int)clampf(cby - cby0, (float)-M, (float)M);
      base = Cp + (M + dby) * Sc + M + dbx;
      wx = qx - cbx;
      wy = qy - cby;
    };
    for (int it = 0; it < a.iters; ++it) {
      const float* base;
      float wx, wy;
      window(base, wx, wy);
      float b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float e = bilerp(base + pr[s] * Sc + pc[s], Sc, wx, wy) - T[s];
        b[0] += Ix[s] * e;   // 0 where the slot is no pixel (Ix = 0)
        b[1] += Iy[s] * e;
      }
      block_sum<2>(b, red, phase);
      const float dgx = -(Gyy * b[0] - Gxy * b[1]) * inv_det;
      const float dgy = -(-Gxy * b[0] + Gxx * b[1]) * inv_det;
      gx += dgx;
      gy += dgy;
    }
    {
      const float* base;
      float wx, wy;
      window(base, wx, wy);
      float e[1] = {0.0f};
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (own[s]) {
          e[0] += fabsf(bilerp(base + pr[s] * Sc + pc[s], Sc, wx, wy) - T[s]);
        }
      }
      // the barrier inside also orders every read of Tp and Cp before the
      // next level's loads
      block_sum<1>(e, red, phase);
      err = e[0] / (float)(P * P);
    }
    ok_all = ok_all && ok;
    if (lvl > 0) {
      gx *= 2.0f;
      gy *= 2.0f;
    }
  }
  if (threadIdx.x == 0) {
    const float nx = px0 + gx, ny = py0 + gy;
    const bool inb = nx >= 1.0f && nx < (float)(a.w[0] - 1) && ny >= 1.0f
                     && ny < (float)(a.h[0] - 1);
    a.pos[2 * slot] = nx;
    a.pos[2 * slot + 1] = ny;
    a.err[slot] = err;
    a.status[slot] = a.valid[slot] && ok_all && inb && err <= a.max_err;
  }
}

}  // namespace

// prev, cur: E x L image pointers, eye-major (eye e's level l at e * L + l),
// each [B, hw[2 l], hw[2 l + 1]] float32, lanes contiguous
extern "C" int rso_lk_track(void* const* prev, void* const* cur,
                            const int* hw, int B, int E, int K, int L,
                            const void* pts, const void* valid, int win,
                            int iters, int seed_range, float max_err,
                            void* pos, void* status, void* err,
                            void* stream) {
  if (B <= 0 || B > 65535 || E <= 0 || E > kMaxEyes || K <= 0 || L <= 0
      || L > kMaxLevels || win <= 0 || win > kMaxWin || iters < 0
      || seed_range < 0) {
    return (int)cudaErrorInvalidValue;
  }
  LkArgs a{};
  for (int e = 0; e < E; ++e) {
    for (int l = 0; l < L; ++l) {
      a.prev[e][l] = static_cast<const float*>(prev[e * L + l]);
      a.cur[e][l] = static_cast<const float*>(cur[e * L + l]);
    }
  }
  for (int l = 0; l < L; ++l) {
    a.h[l] = hw[2 * l];
    a.w[l] = hw[2 * l + 1];
    if (a.h[l] <= 0 || a.w[l] <= 0) return (int)cudaErrorInvalidValue;
  }
  a.levels = L;
  a.K = K;
  a.win = win;
  a.iters = iters;
  a.seed_range = seed_range;
  a.max_err = max_err;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const unsigned char*>(valid);
  a.pos = static_cast<float*>(pos);
  a.status = static_cast<unsigned char*>(status);
  a.err = static_cast<float*>(err);
  const int St = 2 * win + 4, Sc = 2 * win + 2 + 2 * kSlack;
  const int Ss = kSeed + 2 * seed_range;
  const size_t level_floats = (size_t)St * St + (size_t)Sc * Sc;
  const size_t seed_floats = seed_range > 0 ? 64 + (size_t)Ss * Ss : 0;
  const size_t smem = sizeof(float) * (level_floats > seed_floats
                                           ? level_floats : seed_floats);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lk_track_kernel<<<dim3(K, E, B), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
