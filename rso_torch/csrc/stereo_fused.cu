// Fused exact-SAD cores of stereo matching (stage 3) and tracking (stage 4).
//
// rso_stereo_sad_fused replaces the TPU kernel rso/kernels/stereo_fused.py
// `stereo_sad_fused` (`_kernel`): for each left slot, the exact SAD over P
// patch values against every right slot, masked by validity,
// |round(yl) - round(yr)| <= max_y_diff, 1 <= xl - xr <= max_disp and
// SAD <= max_distance; per row the best distance, its index (first on ties)
// and the second-best distance (the minimum over every other position, so a
// tie gives second == best), with 1e9 for "no admissible pair".
//
// rso_track_sad_fused replaces `track_sad_fused` (`_track_kernel`): the sum of
// both eyes' exact SADs (prev-left vs cur-left, prev-right vs cur-right,
// match-aligned), masked by validity, |dy| <= win_row, |dx_left| and
// |dx_right| <= win_col and each eye's SAD <= sad_max; per prev row the
// argmin (first on ties) and its distance.
//
// What bounds them on the H100: launch latency.  At K = 512, P = 64 a call
// is ~16.8 M abs-adds and ~0.3 MB of operands, microseconds of work for the
// card.  Design: one block per left (prev) row, the row's patch staged in
// shared memory, threads striding over the other side's slots, then a
// shared-memory tree merge of (best, index, second).  No padding is needed
// for odd K: every row is its own block.
//
// Exactness: patch values are multiples of 1/16 below 256, so every partial
// SAD is exact in f32 whatever the summation order.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e9f;

struct Top2 {
  float best;
  int idx;
  float second;
};

// Lexicographic (value, index) minimum; `second` is the minimum over every
// position except the winner's.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  if (b.best < a.best || (b.best == a.best && b.idx < a.idx)) {
    return Top2{b.best, b.idx, fminf(a.best, b.second)};
  }
  return Top2{a.best, a.idx, fminf(a.second, b.best)};
}

__device__ Top2 block_merge(Top2 t) {
  __shared__ float s_best[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ float s_second[kThreads];
  const int tid = threadIdx.x;
  s_best[tid] = t.best;
  s_idx[tid] = t.idx;
  s_second[tid] = t.second;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const Top2 m = merge(Top2{s_best[tid], s_idx[tid], s_second[tid]},
                           Top2{s_best[tid + s], s_idx[tid + s],
                                s_second[tid + s]});
      s_best[tid] = m.best;
      s_idx[tid] = m.idx;
      s_second[tid] = m.second;
    }
    __syncthreads();
  }
  return Top2{s_best[0], s_idx[0], s_second[0]};
}

__global__ void stereo_sad_kernel(
    const float* __restrict__ pl, const float* __restrict__ pr,
    const float* __restrict__ xyl, const float* __restrict__ xyr,
    const unsigned char* __restrict__ okl, const unsigned char* __restrict__ okr,
    int Kr, int P, float max_y_diff, float max_disp, float max_distance,
    int* __restrict__ best_r, float* __restrict__ best_d,
    float* __restrict__ second_d) {
  extern __shared__ float s_patch[];
  const int row = blockIdx.x;
  for (int d = threadIdx.x; d < P; d += blockDim.x) {
    s_patch[d] = pl[(size_t)row * P + d];
  }
  __syncthreads();
  const float xl = xyl[2 * row];
  const float ryl = rintf(xyl[2 * row + 1]);   // round half to even
  const bool ok_l = okl[row] != 0;

  Top2 t{INFINITY, INT_MAX, INFINITY};
  for (int j = threadIdx.x; j < Kr; j += blockDim.x) {
    const float* q = pr + (size_t)j * P;
    float acc = 0.f;
    for (int d = 0; d < P; ++d) acc += fabsf(s_patch[d] - q[d]);
    const float dy = fabsf(ryl - rintf(xyr[2 * j + 1]));
    const float disp = xl - xyr[2 * j];
    const bool ok = ok_l && okr[j] != 0 && dy <= max_y_diff && disp >= 1.f &&
                    disp <= max_disp && acc <= max_distance;
    t = merge(t, Top2{ok ? acc : kBig, j, INFINITY});
  }
  const Top2 r = block_merge(t);
  if (threadIdx.x == 0) {
    best_r[row] = r.idx;
    best_d[row] = r.best;
    second_d[row] = fminf(r.second, kBig);   // K == 1: nothing else -> 1e9
  }
}

__global__ void track_sad_kernel(
    const float* __restrict__ p_left, const float* __restrict__ c_left,
    const float* __restrict__ p_right, const float* __restrict__ c_right,
    const float* __restrict__ p_xy, const float* __restrict__ c_xy,
    const float* __restrict__ p_rx, const float* __restrict__ c_rx,
    const unsigned char* __restrict__ ok_p,
    const unsigned char* __restrict__ ok_c, int Kc, int P, float win_row,
    float win_col, float sad_max, int* __restrict__ best_c,
    float* __restrict__ best_d) {
  extern __shared__ float s_patch[];   // [2P]: prev-left, prev-right
  const int row = blockIdx.x;
  for (int d = threadIdx.x; d < P; d += blockDim.x) {
    s_patch[d] = p_left[(size_t)row * P + d];
    s_patch[P + d] = p_right[(size_t)row * P + d];
  }
  __syncthreads();
  const float px = p_xy[2 * row];
  const float py = p_xy[2 * row + 1];
  const float prx = p_rx[row];
  const bool okp = ok_p[row] != 0;

  Top2 t{INFINITY, INT_MAX, INFINITY};
  for (int j = threadIdx.x; j < Kc; j += blockDim.x) {
    const float* ql = c_left + (size_t)j * P;
    const float* qr = c_right + (size_t)j * P;
    float acc_l = 0.f, acc_r = 0.f;
    for (int d = 0; d < P; ++d) {
      acc_l += fabsf(s_patch[d] - ql[d]);
      acc_r += fabsf(s_patch[P + d] - qr[d]);
    }
    const bool ok = okp && ok_c[j] != 0 &&
                    fabsf(py - c_xy[2 * j + 1]) <= win_row &&
                    fabsf(px - c_xy[2 * j]) <= win_col &&
                    fabsf(prx - c_rx[j]) <= win_col && acc_l <= sad_max &&
                    acc_r <= sad_max;
    t = merge(t, Top2{ok ? acc_l + acc_r : kBig, j, INFINITY});
  }
  const Top2 r = block_merge(t);
  if (threadIdx.x == 0) {
    best_c[row] = r.idx;
    best_d[row] = r.best;
  }
}

}  // namespace

extern "C" int rso_stereo_sad_fused(
    const float* pl, const float* pr, const float* xyl, const float* xyr,
    const unsigned char* okl, const unsigned char* okr, int Kl, int Kr, int P,
    float max_y_diff, float max_disp, float max_distance, int* best_r,
    float* best_d, float* second_d, void* stream) {
  stereo_sad_kernel<<<Kl, kThreads, P * sizeof(float), (cudaStream_t)stream>>>(
      pl, pr, xyl, xyr, okl, okr, Kr, P, max_y_diff, max_disp, max_distance,
      best_r, best_d, second_d);
  return (int)cudaGetLastError();
}

extern "C" int rso_track_sad_fused(
    const float* p_left, const float* c_left, const float* p_right,
    const float* c_right, const float* p_xy, const float* c_xy,
    const float* p_rx, const float* c_rx, const unsigned char* ok_p,
    const unsigned char* ok_c, int Kp, int Kc, int P, float win_row,
    float win_col, float sad_max, int* best_c, float* best_d, void* stream) {
  track_sad_kernel<<<Kp, kThreads, 2 * P * sizeof(float),
                     (cudaStream_t)stream>>>(
      p_left, c_left, p_right, c_right, p_xy, c_xy, p_rx, c_rx, ok_p, ok_c, Kc,
      P, win_row, win_col, sad_max, best_c, best_d);
  return (int)cudaGetLastError();
}
