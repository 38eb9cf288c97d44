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
// argmin (first on ties) and its distance, (index 0, 1e9) where no pair is
// admissible.
//
// What bounds them on the H100: their masks admit few pairs.  On the bench
// features (chip_smoke.py) the stereo mask admits 0.66%, 1.21% and 2.37% of
// the 512^2, 256^2 and 128^2 pairs at octaves 0-2, the tracking window
// 0.56%, 0.86% and 2.2%.  A design that forms every pair's SAD and then
// masks (both kernels' first design: lane j walked right row j, so each
// load touched 32 rows 256 B apart, and every block re-read all right
// patches) spends more than 97% of its work on pairs it throws away.
// Counted on the admitted pairs, the work is the mask over all pairs plus
// ~0.1 M abs-adds at K = 512: the bound is the operands read once (bytes),
// ~0.08 us (stereo) and ~0.16 us (tracking) at K = 512.
//
// Design (`for_admitted`, shared by both kernels): a block of 8 warps per
// left (prev) row; warp w takes the chunks w, w + 8, ... of kChunk slots.
// Pass 1: each lane tests one slot with the twin's geometric predicate (~10
// operations) and __ballot_sync gives the chunk's admitted set.  Pass 2:
// the admitted slots in ascending order, kGroup at a time (8 candidates of
// one eye, or 4 of two: 8 sums), the whole warp reading each candidate's
// patch row coalesced (lane l takes values l, l + 32) and a transposed
// butterfly (9 shuffles) reducing the 8 sums.  The SAD gate and the (value,
// index) merge follow on one lane per candidate, then across lanes and the
// block's warps.  No SAD is formed for a pair the geometric mask rejects.  A
// row with ok false writes (index 0, 1e9[, 1e9]) itself: the twin's argmin
// over a row of 1e9.  Stereo takes 16-slot chunks, so that at K = 128 all 8
// warps hold a chunk, and reads its left patch from global memory (L1
// after the first group); tracking takes 32-slot chunks and stages its two
// patches in shared memory, as measured best for each.  With the mask open
// (1e4) every warp walks all its chunks: the design is then a coalesced
// all-pairs SAD over the valid pairs.
//   Measured (tests/_torch_kernel_ab.py on the bench features, NVIDIA H100
// 80GB HBM3 at 700 W, against the all-pairs-then-mask design in the same
// call; PERF.md section 6): stereo with the engine's mask 5.111, 3.993 and
// 3.642 us on the device at K = 512/256/128 (all pairs: 69.511, 19.502,
// 6.932); with the mask open 18.112, 8.721 and 5.367 (69.511, 19.486,
// 6.948).  Tracking 4.185, 3.913 and 3.833 us (window open: 18.687 at
// K = 512).  Measured and dropped, stereo at K = 512 unless named: 32-slot
// chunks 4.944 us, but 8.064 with the mask open at K = 128 (4 chunks for 8
// warps); 4 warps a row 4.910, open 24.903; groups of 16 10.704; the patch
// in shared memory 5.216; predicated rather than branched candidate loads:
// tracking 5-13% slower.
//   What bounds them now: at ~3.6-5.1 us a call they are near the card's
// floor for a small launch (2.2-3.8 us for the Hamming and null-vector
// kernels in chip_smoke.py), far above their byte bounds.
// Tensor cores do not apply: an absolute difference is not a product, and
// after the mask the work (~0.1 M abs-adds at K = 512) is too small for
// wgmma (ROADMAP lists the TPU's MXU shortlist as not to port); nor does
// TMA: each admitted row is 256 B that a warp's one coalesced load brings
// in.
//
// Exactness: patch values are multiples of 1/16 below 256, so every partial
// SAD is exact in f32 whatever the summation order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStereoWarps = 8;   // warps per left row
constexpr int kTrackWarps = 8;    // warps per prev row
// candidates whose SADs are formed together: kGroup x eyes quantities
constexpr int kStereoGroup = 8;
constexpr int kTrackGroup = 4;
// slots a warp's ballot covers (its lanes 0 .. kChunk - 1)
constexpr int kStereoChunk = 16;
constexpr int kTrackChunk = 32;

__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n / 2) : 0;
}

// v[0..N) are this lane's partial sums of N quantities (N a power of two up
// to 32); afterwards every lane holds the warp-wide total of quantity
// lane >> (5 - log2 N).  A transposed butterfly: each step keeps half of
// the quantities and sends the other half to the partner lane (N/2 + ... + 1
// shuffles), then 5 - log2 N plain steps: for N = 8, 9 shuffles where 8
// separate reductions take 40.
template <int N>
__device__ __forceinline__ float warp_sum(float (&v)[N], int lane) {
  int off = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, off >>= 1) {
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

// The warp's share of one row: admit(j) on each slot j < K of its
// kChunk-slot chunks (warp w of kRowWarps takes chunks w, w + kRowWarps,
// ...), then, for the admitted slots in ascending order, kGroup at a time,
// the SADs of the row's patch patch[e][0 .. P) in each eye e against
// cand[e][j * P ..].  visit(j, acc) runs on every lane after each group:
// acc[e] is eye e's SAD of candidate j on the first lane that holds it, and
// j is -1 on every other lane.
template <int kEyes, int kGroup, int kChunk, int kRowWarps, class Admit,
          class Visit>
__device__ __forceinline__ void for_admitted(
    int K, int P, int warp, int lane, const float* const (&patch)[kEyes],
    const float* const (&cand)[kEyes], Admit admit, Visit visit) {
  constexpr int kQuant = kGroup * kEyes;
  // after warp_sum, lane l holds quantity l >> kQShift
  constexpr int kQShift = 5 - log2i(kQuant);
  const int n_chunks = (K + kChunk - 1) / kChunk;
  // a round is up to 32 of the warp's chunks: pass 1 keeps chunk i's
  // admitted set in lane i's `mask`
  for (int r0 = warp; r0 < n_chunks; r0 += kRowWarps * 32) {
    const int n_round = min(32, (n_chunks - r0 + kRowWarps - 1) / kRowWarps);
    unsigned mask = 0u;
#pragma unroll 4
    for (int i = 0; i < n_round; ++i) {
      const int j = (r0 + i * kRowWarps) * kChunk + lane;
      const unsigned admitted =
          __ballot_sync(kFull, lane < kChunk && j < K && admit(j));
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
          js[k] = (r0 + ci * kRowWarps) * kChunk + __ffs(m) - 1;
          m &= m - 1u;
        } else {
          js[k] = -1;
        }
      }
      if (js[0] < 0) break;
      // lane l sums patch values l, l + 32, ...: coalesced row reads;
      // quantity kEyes * k + e is candidate k's SAD in eye e
      float v[kQuant];
#pragma unroll
      for (int q = 0; q < kQuant; ++q) v[q] = 0.f;
#pragma unroll 2
      for (int d = lane; d < P; d += 32) {
        float a[kEyes];
#pragma unroll
        for (int e = 0; e < kEyes; ++e) a[e] = patch[e][d];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (js[k] >= 0) {
#pragma unroll
            for (int e = 0; e < kEyes; ++e) {
              v[kEyes * k + e] += fabsf(a[e] - cand[e][(size_t)js[k] * P + d]);
            }
          }
        }
      }
      const float own = warp_sum(v, lane);
      float acc[kEyes];
      if constexpr (kEyes == 1) {
        acc[0] = own;
      } else {
        const float other = __shfl_xor_sync(kFull, own, 1 << kQShift);
        const bool right_eye = (lane >> kQShift) & 1;
        acc[0] = right_eye ? other : own;
        acc[1] = right_eye ? own : other;
      }
      // candidate k's quantities sit on the kEyes << kQShift lanes from
      // (k kEyes) << kQShift
      const int k = (lane >> kQShift) / kEyes;
      int j = -1;
      if ((lane & ((kEyes << kQShift) - 1)) == 0) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) j = k == q ? js[q] : j;
      }
      visit(j, acc);
    }
  }
}

// ---- stereo: (best, index, second) ---------------------------------------

struct Top2 {
  float best;
  int idx;
  float second;
};

// Lexicographic (value, index) minimum of two disjoint sets of positions;
// `second` is the minimum over every position except the winner's.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  if (b.best < a.best || (b.best == a.best && b.idx < a.idx)) {
    return Top2{b.best, b.idx, fminf(a.best, b.second)};
  }
  return Top2{a.best, a.idx, fminf(a.second, b.best)};
}

__global__ void __launch_bounds__(kStereoWarps * 32) stereo_sad_kernel(
    const float* __restrict__ pl, const float* __restrict__ pr,
    const float* __restrict__ xyl, const float* __restrict__ xyr,
    const unsigned char* __restrict__ okl, const unsigned char* __restrict__ okr,
    int Kl, int Kr, int P, float max_y_diff, float max_disp,
    float max_distance, int* __restrict__ best_r, float* __restrict__ best_d,
    float* __restrict__ second_d) {
  __shared__ Top2 s_top[kStereoWarps];
  const int row = blockIdx.x;
  // the sequence (lane) of a batched launch: its operands and outputs
  const size_t seq = blockIdx.y;
  pl += seq * Kl * P;
  pr += seq * Kr * P;
  xyl += seq * Kl * 2;
  xyr += seq * Kr * 2;
  okl += seq * Kl;
  okr += seq * Kr;
  best_r += seq * Kl;
  best_d += seq * Kl;
  second_d += seq * Kl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float xl = xyl[2 * row];
  const float ryl = rintf(xyl[2 * row + 1]);   // round half to even
  if (okl[row] == 0) {
    // the twin's row of 1e9: argmin 0, second 1e9
    if (threadIdx.x == 0) {
      best_r[row] = 0;
      best_d[row] = kBig;
      second_d[row] = kBig;
    }
    return;
  }

  // every position the mask rejects is a 1e9 at index >= 0 in the twin's
  // row: starting from (1e9, 0, 1e9) gives its argmin where nothing is
  // admitted, and second = 1e9 where one pair is (also for Kr = 1)
  Top2 t{kBig, 0, kBig};
  const float* const patch[1] = {pl + (size_t)row * P};
  const float* const cand[1] = {pr};
  for_admitted<1, kStereoGroup, kStereoChunk, kStereoWarps>(
      Kr, P, warp, lane, patch, cand,
      [&](int j) {
        const float disp = xl - xyr[2 * j];
        return (okr[j] != 0) &
               (fabsf(ryl - rintf(xyr[2 * j + 1])) <= max_y_diff) &
               (disp >= 1.f) & (disp <= max_disp);
      },
      [&](int j, const float (&acc)[1]) {
        if (j >= 0 && acc[0] <= max_distance) {
          t = merge(t, Top2{acc[0], j, kBig});
        }
      });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t = merge(t, Top2{__shfl_xor_sync(kFull, t.best, off),
                      __shfl_xor_sync(kFull, t.idx, off),
                      __shfl_xor_sync(kFull, t.second, off)});
  }
  if (lane == 0) s_top[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kStereoWarps; ++w) t = merge(t, s_top[w]);
    best_r[row] = t.idx;
    best_d[row] = t.best;
    second_d[row] = t.second;
  }
}

// ---- tracking: argmin of the two eyes' summed SADs -----------------------

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
    const unsigned char* __restrict__ ok_c, int Kp, int Kc, int P,
    float win_row, float win_col, float sad_max, int* __restrict__ best_c,
    float* __restrict__ best_d) {
  extern __shared__ float s_patch[];   // [2P]: prev-left, prev-right
  __shared__ float s_best[kTrackWarps];
  __shared__ int s_idx[kTrackWarps];
  const int row = blockIdx.x;
  // the sequence (lane) of a batched launch: its operands and outputs
  const size_t seq = blockIdx.y;
  p_left += seq * Kp * P;
  p_right += seq * Kp * P;
  c_left += seq * Kc * P;
  c_right += seq * Kc * P;
  p_xy += seq * Kp * 2;
  c_xy += seq * Kc * 2;
  p_rx += seq * Kp;
  c_rx += seq * Kc;
  ok_p += seq * Kp;
  ok_c += seq * Kc;
  best_c += seq * Kp;
  best_d += seq * Kp;
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

  float best = kBig;   // no admissible pair: (1e9, 0), as the twin
  int idx = 0;
  const float* const patch[2] = {s_patch, s_patch + P};
  const float* const cand[2] = {c_left, c_right};
  for_admitted<2, kTrackGroup, kTrackChunk, kTrackWarps>(
      Kc, P, warp, lane, patch, cand,
      [&](int j) {
        return (ok_c[j] != 0) & (fabsf(py - c_xy[2 * j + 1]) <= win_row) &
               (fabsf(px - c_xy[2 * j]) <= win_col) &
               (fabsf(prx - c_rx[j]) <= win_col);
      },
      [&](int j, const float (&acc)[2]) {
        if (j >= 0 && acc[0] <= sad_max && acc[1] <= sad_max) {
          take_min(best, idx, acc[0] + acc[1], j);
        }
      });
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

// Both entries take B lanes (sequences) in one launch, the grid's y axis:
// every operand and output with a leading [B] axis, lanes contiguous.
extern "C" int rso_stereo_sad_fused(
    const float* pl, const float* pr, const float* xyl, const float* xyr,
    const unsigned char* okl, const unsigned char* okr, int B, int Kl, int Kr,
    int P, float max_y_diff, float max_disp, float max_distance, int* best_r,
    float* best_d, float* second_d, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  stereo_sad_kernel<<<dim3(Kl, B), kStereoWarps * 32, 0,
                      (cudaStream_t)stream>>>(
      pl, pr, xyl, xyr, okl, okr, Kl, Kr, P, max_y_diff, max_disp,
      max_distance, best_r, best_d, second_d);
  return (int)cudaGetLastError();
}

extern "C" int rso_track_sad_fused(
    const float* p_left, const float* c_left, const float* p_right,
    const float* c_right, const float* p_xy, const float* c_xy,
    const float* p_rx, const float* c_rx, const unsigned char* ok_p,
    const unsigned char* ok_c, int B, int Kp, int Kc, int P, float win_row,
    float win_col, float sad_max, int* best_c, float* best_d, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  track_sad_kernel<<<dim3(Kp, B), kTrackWarps * 32, 2 * P * sizeof(float),
                     (cudaStream_t)stream>>>(
      p_left, c_left, p_right, c_right, p_xy, c_xy, p_rx, c_rx, ok_p, ok_c, Kp,
      Kc, P, win_row, win_col, sad_max, best_c, best_d);
  return (int)cudaGetLastError();
}
