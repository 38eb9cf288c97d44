// All-pairs distance matrices of the descriptor and dense-SAD paths.
//
// rso_hamming_matrix replaces the TPU kernel rso/kernels/distance.py
// `hamming_matrix_pallas` (`_hamming_kernel`): the [Ka,Kb] Hamming distance
// between 256-bit descriptors packed as W = 8 32-bit words (XOR, population
// count, summed over the words), written as f32.  The words arrive as int32
// with the reference's uint32 bits and are read as unsigned, so the sign bit
// counts like any other.
//
// rso_sad_matrix replaces `sad_matrix_pallas` (`_sad_kernel`): the [Ka,Kb]
// sum of absolute differences of P-float patches.  Patch values are
// multiples of 1/16 below 256, so every partial sum is exact in f32 and the
// result equals the PyTorch twin's bit for bit whatever order either sums
// in: this kernel splits each sum over four lanes and four accumulations.
//
// What bounds them on the H100.  At Ka = Kb = 512 the Hamming matrix reads
// 32 KB and writes 1 MB: ~0.3 us at 3.35 TB/s, against ~6.3 M integer
// operations (~0.1 us at 67 T/s), so its bound is the output's bytes.  On
// the CUDA cores its 2.1 M population counts issue at 16 a clock per SM,
// ~0.5 us over 128 SMs: more than the bytes take.  Every launch also pays
// ~1 us on the device (PyTorch's fill of one element takes 0.99 us, of the
// same 1 MB output 1.12 us; tests/_torch_kernel_ab.py).  The first design
// (32x32 tiles staged in shared memory, W and the popcount loop at run
// time) took 2.560, 2.240 and 2.209 us at K = 512/256/128 (chip run 7 of
// PERF.md section 6).
//   Hamming design for W = 8 (any other W, 1..64, or descriptors not 16-byte
// aligned, take the first design): the tensor cores count the bits.
// mma.m16n8k256 on 1-bit operands sums popc(a AND b) over a 16x8 tile, and
// popc(a XOR b) = popc(a AND NOT b) + popc(NOT a AND b): two products into
// one accumulator, no POPC at all.  A block is one warp of 16 rows x 8 tiles
// of 8 columns where that still gives 256 warps (K = 512), else x 2 tiles;
// each operand is one 8-byte load a row, and two shuffles a tile let each
// thread store a float4.  Measured (tests/_torch_kernel_ab.py on the bench
// descriptors, NVIDIA H100 80GB HBM3 at 700 W, against the first design in
// the same call, chip run 7 of PERF.md section 6): 1.696, 1.376 and 1.280 us at K =
// 512/256/128.  Measured and dropped: the CUDA cores (a warp's A rows in
// registers, __popc, float4 stores), 2.657 / 2.017 / 1.792 us; 4 tiles a
// warp at every K, 1.664 / 1.408 / 1.345; four warps a block, 1.920 /
// 1.888 / 1.840.
//   The SAD matrix is 512^2 x 64 = 16.8 M terms, every one needed (no mask):
// on the card a term is two f32 instructions, FADD a, -b and an FADD that
// takes |x| as an operand modifier (SASS: the abs folds into the FADD), so
// ~1.0 us of issue at 132 SMs x 128 lanes x ~1.98 GHz (chip_smoke.py counts
// 3 operations a term: 0.75 us at 67 TFLOP/s); 256 KB in and 1 MB out take
// ~0.4 us.  FP32 issue bounds it.  The first design (32x8 threads, 4
// outputs each, one float per d) spent 5 shared-memory loads per 4 terms,
// so shared-load issue set its pace: 5.495 us on the device at K = 512.
//   Design: a block computes a 32x32 output tile with 256 threads.  The
// tile's 32 A rows and 32 B rows are staged in shared memory with d
// contiguous, zero-padded to P4 = P rounded up to 4 (|0 - 0| adds nothing,
// so any P takes the same loop), each row S = P4 + ((16 - P4) mod 32) words
// apart; a lane issues all its staging loads of a step before its first
// store.  A thread owns a 4x4 micro-tile (rows ty + 8i, columns tx + 8j) and
// a quarter of d: lane bits 0-1 pick the float4s q, q + 4, ... of d.  Per
// float4 it loads 4 A and 4 B float4s (8 LDS.128) for 64 terms (128 FP32
// instructions), so the FP32 pipes, not shared-memory loads, set the pace.
// The 8 lanes of one LDS.128 phase read B rows tx = 0, 1 at the four
// quarters' offsets: with S = 16 (mod 32) words they fall in 8 distinct
// 16-byte bank groups, and their A reads are four broadcasts.  Two shuffles
// add the quarters (exact), and each quarter stores one column of the
// micro-tile: a warp's store is a 128-byte row segment.  At K = 512 the
// grid is 16 x 16 = 256 blocks of 8 warps, all resident at once (~2 a SM);
// ragged edges load zeros and skip stores.
//   Measured (tests/_torch_kernel_ab.py on the bench patches, NVIDIA H100
// 80GB HBM3 at 700 W, against the first design in the same call; PERF.md
// section 6): 3.801, 2.651 and 2.588 us on the device at K = 512/256/128
// (first design: 5.495, 3.769, 3.737).  Measured and dropped: d split over
// 2 lanes (128 threads) 4.256 us at K = 512; staging by cp.async, with or
// without a second stage overlapping the sums, 5.8-7.2 us.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;   // output rows and columns per block

// Hamming, any width W (1..64): a block computes a 32x32 output tile with
// 32x8 threads, four outputs a thread; A and B rows staged in shared memory.
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;

__global__ void hamming_kernel(const unsigned* __restrict__ a,
                               const unsigned* __restrict__ b, int Ka, int Kb,
                               int W, float* __restrict__ out) {
  extern __shared__ unsigned s_words[];
  const size_t seq = blockIdx.z;   // the sequence (lane) of a batched launch
  a += seq * Ka * W;
  b += seq * Kb * W;
  out += seq * Ka * Kb;
  unsigned* s_a = s_words;                 // [kTile][W]
  unsigned* s_b = s_words + kTile * W;     // [kTile][W + 1]
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kTile * W; i += kTile * kThreadsY) {
    const int r = i / W, w = i % W;
    s_a[r * W + w] = row0 + r < Ka ? a[(size_t)(row0 + r) * W + w] : 0u;
    s_b[r * (W + 1) + w] = col0 + r < Kb ? b[(size_t)(col0 + r) * W + w] : 0u;
  }
  __syncthreads();
  const int col = col0 + threadIdx.x;
  const unsigned* q = s_b + threadIdx.x * (W + 1);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + k * kThreadsY;
    const unsigned* p = s_a + r * W;
    int acc = 0;
    for (int w = 0; w < W; ++w) acc += __popc(p[w] ^ q[w]);
    if (row0 + r < Ka && col < Kb) out[(size_t)(row0 + r) * Kb + col] = (float)acc;
  }
}

// Hamming, W = 8 (256-bit rBRIEF, the engine's only width), on the tensor
// cores: mma.m16n8k256 on 1-bit operands sums popc(a AND b) over the 256
// bits of a 16x8 output tile, and popc(a XOR b) = popc(a AND NOT b) +
// popc(NOT a AND b), two such products into one accumulator.  A block is
// one warp; it takes 16 rows x kTiles tiles of 8 columns.
constexpr int kWords = 8;
constexpr int kMmaRows = 16;
constexpr int kMmaCols = 8;
// warps a launch should have to fill the card (two a SM): the most tiles a
// warp, 8 or 2, that still gives them
constexpr long kHamMinWarps = 256;

// d += the 16x8 tile of popc(a AND b) over k = 256 bits.  Fragments (thread
// lane = 4 g + t): a[0], a[2] row g, a[1], a[3] row g + 8, b[0], b[1] column
// g; a[0], a[1], b[0] hold bits 32t..32t+31 of k, a[2], a[3], b[1] bits
// 128 + 32t..; d[0], d[1] row g, columns 2t, 2t + 1, d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a, b: the descriptors as 8-byte pairs of words (4 a descriptor).  Which
// word fills which bits of k does not matter as long as A and B agree:
// thread t puts words 2t and 2t + 1 where the fragments take k-parts t and
// 4 + t, so each operand is one 8-byte load a row.
template <int kTiles>
__global__ void __launch_bounds__(32) hamming_kernel(
    const uint2* __restrict__ a, const uint2* __restrict__ b, int Ka, int Kb,
    bool vec_out, float* __restrict__ out) {
  const size_t seq = blockIdx.z;   // the sequence (lane) of a batched launch
  a += seq * Ka * 4;
  b += seq * Kb * 4;
  out += seq * Ka * Kb;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  const int r0 = blockIdx.y * kMmaRows;
  const int c0 = blockIdx.x * kMmaCols * kTiles;
  // every load first, rows and columns clamped at a ragged edge (those
  // outputs are not stored)
  const uint2 lo = a[(size_t)min(r0 + g, Ka - 1) * 4 + t];
  const uint2 hi = a[(size_t)min(r0 + g + 8, Ka - 1) * 4 + t];
  uint2 col[kTiles];
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    col[n] = b[(size_t)min(c0 + n * kMmaCols + g, Kb - 1) * 4 + t];
  }
  const unsigned fa[4] = {lo.x, hi.x, lo.y, hi.y};
  const unsigned fn[4] = {~lo.x, ~hi.x, ~lo.y, ~hi.y};
  // every product and exchange before the first store: mma.sync and the
  // shuffles need the whole warp, and the stores branch at ragged edges
  const bool even = (t & 1) == 0;
  float v[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    int d[4] = {0, 0, 0, 0};
    mma_and_popc(d, fa, ~col[n].x, ~col[n].y);
    mma_and_popc(d, fn, col[n].x, col[n].y);
    // thread pairs (t, t ^ 1) swap halves: the even one then holds row g,
    // columns 2t..2t + 3, the odd one row g + 8, columns 2t - 2..2t + 1
    const int s0 = __shfl_xor_sync(0xffffffffu, even ? d[2] : d[0], 1);
    const int s1 = __shfl_xor_sync(0xffffffffu, even ? d[3] : d[1], 1);
    v[n][0] = (float)(even ? d[0] : s0);
    v[n][1] = (float)(even ? d[1] : s1);
    v[n][2] = (float)(even ? s0 : d[2]);
    v[n][3] = (float)(even ? s1 : d[3]);
  }
  const int row = r0 + g + (even ? 0 : 8);
  if (row >= Ka) return;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int c = c0 + n * kMmaCols + 2 * (t & ~1);
    float* dst = out + (size_t)row * Kb + c;
    if (vec_out && c + 4 <= Kb) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[n][0], v[n][1], v[n][2], v[n][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < Kb) dst[j] = v[n][j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <int kTiles>
void launch_hamming_w8(const unsigned* a, const unsigned* b, int B, int Ka,
                       int Kb, float* out, cudaStream_t stream) {
  const dim3 grid((Kb + kMmaCols * kTiles - 1) / (kMmaCols * kTiles),
                  (Ka + kMmaRows - 1) / kMmaRows, B);
  hamming_kernel<kTiles><<<grid, 32, 0, stream>>>(
      reinterpret_cast<const uint2*>(a), reinterpret_cast<const uint2*>(b), Ka,
      Kb, Kb % 4 == 0 && aligned16(out), out);
}

constexpr int kMicro = 4;           // micro-tile rows and columns
constexpr int kSpan = kTile / kMicro;   // 8: row (column) step in a micro-tile
constexpr int kSplit = 4;           // lanes that share a micro-tile, by d
constexpr int kSadThreads = kSpan * kSpan * kSplit;
constexpr int kSadWarps = kSadThreads / 32;
constexpr int kStageRows = kTile / kSadWarps;   // A (and B) rows a warp stages

// words between staged rows: at least P4, and 4 kSplit (mod 32), so the 8
// lanes of an LDS.128 phase (8 / kSplit columns tx x kSplit parts of d)
// hit 8 distinct 16-byte bank groups
__host__ __device__ __forceinline__ int sad_stride(int P4) {
  return P4 + ((4 * kSplit - P4) & 31);
}

__global__ void __launch_bounds__(kSadThreads) sad_kernel(
    const float* __restrict__ a, const float* __restrict__ b, int Ka, int Kb,
    int P, float* __restrict__ out) {
  extern __shared__ float4 s_vec[];        // 16-byte aligned
  const size_t seq = blockIdx.z;   // the sequence (lane) of a batched launch
  a += seq * Ka * P;
  b += seq * Kb * P;
  out += seq * Ka * Kb;
  const int P4 = (P + 3) & ~3;
  const int S = sad_stride(P4);
  float* s_a = reinterpret_cast<float*>(s_vec);   // [kTile][S]
  float* s_b = s_a + kTile * S;                   // [kTile][S]
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w stages tile rows w, w + kSadWarps, ... of A and of B, coalesced
  // along d; a lane issues all its loads of a step before its first store.
  // Zeros past the edges and in d = P..P4.
#pragma unroll 2
  for (int d = lane; d < P4; d += 32) {
    float v[2 * kStageRows];
#pragma unroll
    for (int k = 0; k < 2 * kStageRows; ++k) {
      const bool is_b = k >= kStageRows;
      const int g = (is_b ? col0 : row0) + warp + kSadWarps * (k % kStageRows);
      v[k] = g < (is_b ? Kb : Ka) && d < P ? (is_b ? b : a)[(size_t)g * P + d]
                                           : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 2 * kStageRows; ++k) {
      const int rr = warp + kSadWarps * (k % kStageRows);
      (k >= kStageRows ? s_b : s_a)[rr * S + d] = v[k];
    }
  }
  __syncthreads();

  const int h = lane & (kSplit - 1);      // d's float4s h, h + kSplit, ...
  const int tx = (lane / kSplit) & (kSpan - 1);   // columns tx + 8j
  const int ty = (threadIdx.x / kSplit) / kSpan;  // rows ty + 8i
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
  }
  for (int d = 4 * h; d < P4; d += 4 * kSplit) {
    float4 va[kMicro], vb[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      va[i] = *reinterpret_cast<const float4*>(s_a + (ty + kSpan * i) * S + d);
      vb[i] = *reinterpret_cast<const float4*>(s_b + (tx + kSpan * i) * S + d);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        acc[i][j] += fabsf(va[i].x - vb[j].x);
        acc[i][j] += fabsf(va[i].y - vb[j].y);
        acc[i][j] += fabsf(va[i].z - vb[j].z);
        acc[i][j] += fabsf(va[i].w - vb[j].w);
      }
    }
  }
  // the kSplit parts of each sum (exact), then part h stores its share of
  // the columns: j = h kMicro / kSplit, ...
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      }
    }
  }
  constexpr int kCols = kMicro / kSplit;   // columns each part stores
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty + kSpan * i;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int j = h * kCols + jj;
      float v = acc[i][jj];
#pragma unroll
      for (int q = kCols + jj; q < kMicro; q += kCols) {
        v = j == q ? acc[i][q] : v;
      }
      const int c = col0 + tx + kSpan * j;
      if (r < Ka && c < Kb) out[(size_t)r * Kb + c] = v;
    }
  }
}

dim3 tiles(int B, int Ka, int Kb) {
  return dim3((Kb + kTile - 1) / kTile, (Ka + kTile - 1) / kTile, B);
}

}  // namespace

// Both entries take B lanes (sequences) in one launch, the grid's z axis:
// a [B][Ka][.], b [B][Kb][.] and out [B][Ka][Kb], lanes contiguous.
extern "C" int rso_hamming_matrix(const unsigned* a, const unsigned* b, int B,
                                  int Ka, int Kb, int W, float* out,
                                  void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (W == kWords && aligned16(a) && aligned16(b)) {
    const long rows = (Ka + kMmaRows - 1) / kMmaRows;
    if (B * rows * ((Kb + 8 * kMmaCols - 1) / (8 * kMmaCols)) >=
        kHamMinWarps) {
      launch_hamming_w8<8>(a, b, B, Ka, Kb, out, s);
    } else {
      launch_hamming_w8<2>(a, b, B, Ka, Kb, out, s);
    }
  } else {
    const size_t smem = (size_t)kTile * (2 * W + 1) * sizeof(unsigned);
    hamming_kernel<<<tiles(B, Ka, Kb), dim3(kTile, kThreadsY), smem, s>>>(
        a, b, Ka, Kb, W, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rso_sad_matrix(const float* a, const float* b, int B, int Ka,
                              int Kb, int P, float* out, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)2 * kTile * sad_stride((P + 3) & ~3) * sizeof(float);
  sad_kernel<<<tiles(B, Ka, Kb), kSadThreads, smem, (cudaStream_t)stream>>>(
      a, b, Ka, Kb, P, out);
  return (int)cudaGetLastError();
}
