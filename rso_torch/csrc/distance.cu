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
// sum of absolute differences of P-float patches, accumulated over d in
// ascending order as the TPU kernel does.  Patch values are multiples of
// 1/16 below 256, so every partial sum is exact in f32 and the result equals
// the PyTorch twin's bit for bit whatever order that one sums in.
//
// What bounds them on the H100.  At Ka = Kb = 512 the Hamming matrix reads
// 32 KB and writes 1 MB: ~0.3 us at 3.35 TB/s, against ~6.3 M integer
// operations (~0.1 us at 67 T/s), so its bound is the output's bytes.  The
// SAD matrix does ~50 M f32 operations (sub, abs, add per term: ~0.75 us at
// 67 TFLOP/s) on 256 KB in and 1 MB out (~0.4 us), so operations bound it.
// Either way the bound is a microsecond, below a launch's own latency.
// Design: a block computes a 32x32 output tile with 32x8 threads, four
// outputs a thread (rows ty, ty+8, ty+16, ty+24; column tx).  The tile's
// 32 A rows and 32 B rows are staged in shared memory once; a warp reads
// one A row (a broadcast) and 32 different B rows, which are padded by one
// word (W+1, P+1) so those 32 reads hit 32 banks.  Stores are coalesced
// along Kb.  Ragged edges load zeros and skip their stores.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;   // output rows and columns per block
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kTile / kRowsPerThread;

__global__ void hamming_kernel(const unsigned* __restrict__ a,
                               const unsigned* __restrict__ b, int Ka, int Kb,
                               int W, float* __restrict__ out) {
  extern __shared__ unsigned s_words[];
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

__global__ void sad_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, int Ka, int Kb, int P,
                           float* __restrict__ out) {
  extern __shared__ float s_vals[];
  float* s_a = s_vals;                     // [kTile][P]
  float* s_b = s_vals + kTile * P;         // [kTile][P + 1]
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kTile * P; i += kTile * kThreadsY) {
    const int r = i / P, d = i % P;
    s_a[r * P + d] = row0 + r < Ka ? a[(size_t)(row0 + r) * P + d] : 0.f;
    s_b[r * (P + 1) + d] = col0 + r < Kb ? b[(size_t)(col0 + r) * P + d] : 0.f;
  }
  __syncthreads();
  const int col = col0 + threadIdx.x;
  const float* q = s_b + threadIdx.x * (P + 1);
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;
  for (int d = 0; d < P; ++d) {            // d ascending, as _sad_kernel
    const float qd = q[d];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      acc[k] += fabsf(s_a[(threadIdx.y + k * kThreadsY) * P + d] - qd);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + threadIdx.y + k * kThreadsY;
    if (r < Ka && col < Kb) out[(size_t)r * Kb + col] = acc[k];
  }
}

dim3 tiles(int Ka, int Kb) {
  return dim3((Kb + kTile - 1) / kTile, (Ka + kTile - 1) / kTile);
}

}  // namespace

extern "C" int rso_hamming_matrix(const unsigned* a, const unsigned* b, int Ka,
                                  int Kb, int W, float* out, void* stream) {
  const size_t smem = (size_t)kTile * (2 * W + 1) * sizeof(unsigned);
  hamming_kernel<<<tiles(Ka, Kb), dim3(kTile, kThreadsY), smem,
                   (cudaStream_t)stream>>>(a, b, Ka, Kb, W, out);
  return (int)cudaGetLastError();
}

extern "C" int rso_sad_matrix(const float* a, const float* b, int Ka, int Kb,
                              int P, float* out, void* stream) {
  const size_t smem = (size_t)kTile * (2 * P + 1) * sizeof(float);
  sad_kernel<<<tiles(Ka, Kb), dim3(kTile, kThreadsY), smem,
               (cudaStream_t)stream>>>(a, b, Ka, Kb, P, out);
  return (int)cudaGetLastError();
}
