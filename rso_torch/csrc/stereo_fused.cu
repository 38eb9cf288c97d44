// Fused exact-SAD cores of stereo matching (stage 3) and tracking (stage 4).
//
// rso_stereo_sad_fused replaces the TPU kernel rso/kernels/stereo_fused.py
// `stereo_sad_fused` (`_kernel`): for each left slot, the exact SAD over P
// patch values against every right slot, masked by validity,
// |round(yl) - round(yr)| <= max_y_diff, 1 <= xl - xr <= max_disp and
// SAD <= max_distance; per row the best distance, its index (first on ties)
// and the second-best distance (the minimum over every other position, so a
// tie gives second == best), with 1e9 for "no admissible pair".
// What bounds it on the H100: its full scan.  Design: one block per left
// row, the row's patch staged in shared memory, threads striding over the
// right slots (lane j walks row j: uncoalesced), then a shared-memory tree
// merge of (best, index, second).  It forms every pair's SAD before the
// mask, as the tracking kernel's first design did: 69.6 us on the device at
// K = 512 against a bound of 0.78 us (chip_smoke.py, NVIDIA H100 80GB HBM3
// at 700 W), the next kernel to redesign (ROADMAP, rule 2).
//
// rso_track_sad_fused replaces `track_sad_fused` (`_track_kernel`): the sum of
// both eyes' exact SADs (prev-left vs cur-left, prev-right vs cur-right,
// match-aligned), masked by validity, |dy| <= win_row, |dx_left| and
// |dx_right| <= win_col and each eye's SAD <= sad_max; per prev row the
// argmin (first on ties) and its distance, (index 0, 1e9) where no pair is
// admissible.
//   The first design (one block per prev row, one thread per candidate, the
// full 64-value SAD of both eyes for every pair, then the mask) spent more
// than 97% of its work on pairs the mask throws away: on bench frames 0 -> 1
// the window admits 0.56% of the 512 x 512 pairs at octave 0, 0.86% of the
// 256 x 256 at octave 1 and 2.2% of the 128 x 128 at octave 2.
// Its loads were uncoalesced too: lane j walked candidate row j, so each
// load instruction touched 32 rows 256 B apart, and every block re-read all
// candidate patches.
//   This design does no SAD work for a rejected pair.  One block of 8 warps
// per prev row, the row's two patches in shared memory; warp w takes the
// 32-candidate chunks w, w + 8, ...  Pass 1: each lane tests one candidate's
// validity and window (the twin's predicate, ~10 operations) and
// __ballot_sync gives the chunk's admitted set.  Pass 2: for the admitted
// candidates in ascending order, 4 at a time, the whole warp reads each
// candidate's two patch rows coalesced (lane l takes values l, l + 32), and
// a transposed butterfly (10 shuffles) reduces the 8 sums; each eye is gated
// by sad_max and (value, index) merged lexicographically, then across lanes
// and the block's warps.  A row whose ok_p is false writes (0, 1e9) and
// stops.  With the window open (win 1e4) every warp walks all its chunks.
//   Measured (tests/_torch_kernel_ab.py on the bench features, NVIDIA H100
// 80GB HBM3 at 700 W; the A/B of record in PERF.md, section 6): K = 512 with
// the engine's window (0.56% of pairs admitted) 4.163 us on the device,
// against 137.143 us for the first design; K = 256 and 128 3.878 and 3.782
// us (36.725, 12.014); the open window 18.498 us at K = 512 (32% of the
// pairs valid; 137.318).  8 warps of groups of 4 measured faster than 4
// warps, or groups of 8 (PERF.md).
//   What bounds it now: at ~4 us a call it is near the card's floor for a
// small launch (2.2-3.8 us for the Hamming and null-vector kernels in
// chip_smoke.py); its bound is the operands read once (bytes, 0.16 us at
// K = 512), the mask over all pairs and the SAD of the admitted ones being
// ~3.2 M operations.
// Tensor cores do not apply: an absolute difference is not a product, and
// after the mask the work is too small for wgmma (ROADMAP lists the TPU's
// MXU shortlist as not to port); nor does TMA: each admitted row is 256 B
// that a warp's one coalesced load brings in.
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

// ---- tracking: mask first, then SAD only where the mask admits a pair ----

constexpr int kTrackWarps = 8;   // warps per block, one prev row
constexpr int kGroup = 4;   // candidates whose SADs are formed together
constexpr int kQuant = 2 * kGroup;   // their left and right SADs
constexpr unsigned kFull = 0xffffffffu;
// after warp_sum, lane l holds quantity (l >> kQShift) & 7
constexpr int kQShift = 2;

// v[0..8) are this lane's partial sums of 8 quantities; afterwards every
// lane holds the warp-wide total of quantity (lane >> kQShift) & 7.  A
// transposed butterfly: each step keeps half of the quantities and sends
// the other half to the partner lane, 4 + 2 + 1 shuffles, then 2 plain
// steps: 9 shuffles where 8 separate reductions take 40.
__device__ __forceinline__ float warp_sum(float (&v)[kQuant], int lane) {
  int off = 16;
#pragma unroll
  for (int n = kQuant; n > 1; n >>= 1, off >>= 1) {
    const bool hi = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = hi ? v[i] : v[i + n / 2];
      v[i] = (hi ? v[i + n / 2] : v[i]) + __shfl_xor_sync(kFull, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Lexicographic (value, index) minimum.
__device__ __forceinline__ void take_min(float& best, int& idx, float v, int j) {
  if (v < best || (v == best && j < idx)) {
    best = v;
    idx = j;
  }
}

__global__ void __launch_bounds__(kTrackWarps * 32) track_sad_kernel(
    const float* __restrict__ p_left, const float* __restrict__ c_left,
    const float* __restrict__ p_right, const float* __restrict__ c_right,
    const float* __restrict__ p_xy, const float* __restrict__ c_xy,
    const float* __restrict__ p_rx, const float* __restrict__ c_rx,
    const unsigned char* __restrict__ ok_p,
    const unsigned char* __restrict__ ok_c, int Kc, int P, float win_row,
    float win_col, float sad_max, int* __restrict__ best_c,
    float* __restrict__ best_d) {
  extern __shared__ float s_patch[];   // [2P]: prev-left, prev-right
  __shared__ float s_best[kTrackWarps];
  __shared__ int s_idx[kTrackWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (ok_p[row] == 0) {
    // the twin's argmin over a row of 1e9: index 0
    if (threadIdx.x == 0) {
      best_c[row] = 0;
      best_d[row] = kBig;
    }
    return;
  }
  for (int d = threadIdx.x; d < P; d += blockDim.x) {
    s_patch[d] = p_left[(size_t)row * P + d];
    s_patch[P + d] = p_right[(size_t)row * P + d];
  }
  __syncthreads();
  const float px = p_xy[2 * row];
  const float py = p_xy[2 * row + 1];
  const float prx = p_rx[row];

  // Warp w takes the 32-candidate chunks w, w + kTrackWarps, ...  A round is
  // up to 32 of them: pass 1 keeps chunk i's admitted set in lane i's
  // `mask`, pass 2 forms the SADs of the admitted candidates in ascending
  // order.
  float best = kBig;   // no admissible pair: (1e9, 0), as the twin
  int idx = 0;
  const int n_chunks = (Kc + 31) >> 5;
  for (int r0 = warp; r0 < n_chunks; r0 += kTrackWarps * 32) {
    const int n_round = min(32, (n_chunks - r0 + kTrackWarps - 1) / kTrackWarps);
    unsigned mask = 0u;
#pragma unroll 4
    for (int i = 0; i < n_round; ++i) {
      const int j = ((r0 + i * kTrackWarps) << 5) + lane;
      bool ok = false;
      if (j < Kc) {
        ok = (ok_c[j] != 0) & (fabsf(py - c_xy[2 * j + 1]) <= win_row) &
             (fabsf(px - c_xy[2 * j]) <= win_col) &
             (fabsf(prx - c_rx[j]) <= win_col);
      }
      const unsigned admitted = __ballot_sync(kFull, ok);
      if (lane == i) mask = admitted;
    }

    int ci = 0;
    unsigned m = __shfl_sync(kFull, mask, 0);
    while (true) {
      int js[kGroup];   // the next admitted candidates, -1 past the last
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        while (m == 0u && ++ci < n_round) m = __shfl_sync(kFull, mask, ci);
        if (m != 0u) {
          js[k] = ((r0 + ci * kTrackWarps) << 5) + __ffs(m) - 1;
          m &= m - 1u;
        } else {
          js[k] = -1;
        }
      }
      if (js[0] < 0) break;
      // lane l sums patch values l, l + 32, ...: coalesced row reads
      float v[kQuant];
#pragma unroll
      for (int k = 0; k < kQuant; ++k) v[k] = 0.f;
#pragma unroll 2
      for (int d = lane; d < P; d += 32) {
        const float a = s_patch[d], b = s_patch[P + d];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (js[k] >= 0) {
            v[2 * k] += fabsf(a - c_left[(size_t)js[k] * P + d]);
            v[2 * k + 1] += fabsf(b - c_right[(size_t)js[k] * P + d]);
          }
        }
      }
      // quantity 2k + e is candidate k's SAD in eye e (0 left, 1 right)
      const float own = warp_sum(v, lane);
      const float other = __shfl_xor_sync(kFull, own, 1 << kQShift);
      const bool right_eye = (lane >> kQShift) & 1;
      const float acc_l = right_eye ? other : own;
      const float acc_r = right_eye ? own : other;
      const int k = (lane >> (kQShift + 1)) & (kGroup - 1);
      int j = -1;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) j = k == q ? js[q] : j;
      if (j >= 0 && acc_l <= sad_max && acc_r <= sad_max) {
        take_min(best, idx, acc_l + acc_r, j);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_min(best, idx, __shfl_xor_sync(kFull, best, off),
             __shfl_xor_sync(kFull, idx, off));
  }
  if (lane == 0) {
    s_best[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kTrackWarps; ++w) take_min(best, idx, s_best[w], s_idx[w]);
    best_c[row] = idx;
    best_d[row] = best;
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
  track_sad_kernel<<<Kp, kTrackWarps * 32, 2 * P * sizeof(float),
                     (cudaStream_t)stream>>>(
      p_left, c_left, p_right, c_right, p_xy, c_xy, p_rx, c_rx, ok_p, ok_c, Kc,
      P, win_row, win_col, sad_max, best_c, best_d);
  return (int)cudaGetLastError();
}
