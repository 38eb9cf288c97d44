// Batched symmetric eigendecomposition of 6x6 f32 matrices: cyclic Jacobi.
//
// No TPU kernel of the reference corresponds: rso's eigh solve backend calls
// XLA's `jnp.linalg.eigh` on the GN's 6x6 normal matrix
// (rso/solver/robust_gn.py:133), and rso jits it into the step like any
// other op.  The port's GN calls this kernel on the GPU instead of
// cuSOLVER's syevd, whose status check reads the host and so keeps the step
// out of a CUDA graph (rso_torch/solver/robust_gn.py `_eval_rgn`).
//
// Algorithm: the lower triangle of H (what eigh reads) mirrored into a full
// symmetric A, V = I, then kSweeps cyclic sweeps over the 15 pairs
// (p, q), p < q, row by row; each rotation zeroes A[p][q] (Golub and Van
// Loan's sym.schur2: theta = (aqq - app) / (2 apq), t = sign(theta) /
// (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c) and is
// skipped where A[p][q] is exactly 0.  A fixed sweep count, no convergence
// test: 6 sweeps reach the f32 fixed point on matrices of condition number
// up to 1e9 (the twin's check in tests/test_torch_eigh6.py), 8 leave two in
// hand, and every thread runs the same code.  Then a 12-comparator sorting
// network orders the eigenvalues ascending, moving V's columns with them.
// Every operation is a correctly rounded f32 intrinsic (__fmul_rn, ...):
// no fused multiply-add, so the PyTorch twin `eigh6_torch`
// (rso_torch/kernels/eigh6.py), which runs the same operations in the same
// order, gives the same bits.
//
// What bounds it on the H100: latency.  The GN calls it once an iteration
// with B = 1 (Engine) or B = lanes (BatchEngine: 11 in the fleet sweep).  A
// matrix is one thread's chain of 8 x 15 rotations, each a division, two
// square roots and ~80 dependent multiply-adds; 144 bytes in, 168 out, so
// bytes and the card's operation rate bound it below a microsecond: the
// time is the chain's latency plus the launch.  Design: one thread a
// matrix, A and V in registers (every index is a compile-time constant
// once the pairs are unrolled; 80 registers, no spill), 64-thread blocks,
// so a batch of lanes is one block and 4096 matrices are 64 blocks.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 24.7 us a
// launch at B = 1, 31.1 us at 11 lanes, against a bound of 0.14 ns and
// torch.linalg.eigh's 0.10 ms a call; bit for bit with the twin.  A warp a
// matrix, or a convergence test, is the next design.
#include <cuda_runtime.h>

namespace {

constexpr int kN = 6;
constexpr int kSweeps = 8;
constexpr int kThreads = 64;

template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[kN][kN], float (&v)[kN][kN]) {
  const float apq = a[P][Q];
  if (apq == 0.0f) return;
  const float app = a[P][P];
  const float aqq = a[Q][Q];
  const float theta = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(apq, 2.0f));
  const float at = fabsf(theta);
  const float root = __fsqrt_rn(__fadd_rn(__fmul_rn(at, at), 1.0f));
  float t = __fdiv_rn(1.0f, __fadd_rn(at, root));
  if (theta < 0.0f) t = -t;
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.0f)));
  const float s = __fmul_rn(t, c);
  a[P][P] = __fsub_rn(app, __fmul_rn(t, apq));
  a[Q][Q] = __fadd_rn(aqq, __fmul_rn(t, apq));
  a[P][Q] = 0.0f;
  a[Q][P] = 0.0f;
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    if (r == P || r == Q) continue;
    const float arp = a[r][P];
    const float arq = a[r][Q];
    const float np = __fsub_rn(__fmul_rn(c, arp), __fmul_rn(s, arq));
    const float nq = __fadd_rn(__fmul_rn(s, arp), __fmul_rn(c, arq));
    a[r][P] = np;
    a[P][r] = np;
    a[r][Q] = nq;
    a[Q][r] = nq;
  }
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    const float vrp = v[r][P];
    const float vrq = v[r][Q];
    v[r][P] = __fsub_rn(__fmul_rn(c, vrp), __fmul_rn(s, vrq));
    v[r][Q] = __fadd_rn(__fmul_rn(s, vrp), __fmul_rn(c, vrq));
  }
}

template <int I, int J>
__device__ __forceinline__ void order(float (&w)[kN], float (&v)[kN][kN]) {
  if (w[J] < w[I]) {
    const float x = w[I];
    w[I] = w[J];
    w[J] = x;
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      const float y = v[r][I];
      v[r][I] = v[r][J];
      v[r][J] = y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
eigh6_kernel(const float* __restrict__ H, float* __restrict__ w_out,
             float* __restrict__ V_out, int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* h = H + static_cast<size_t>(b) * kN * kN;
  float a[kN][kN];
  float v[kN][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float x = h[i * kN + j];
      a[i][j] = x;
      a[j][i] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate<0, 1>(a, v); rotate<0, 2>(a, v); rotate<0, 3>(a, v);
    rotate<0, 4>(a, v); rotate<0, 5>(a, v);
    rotate<1, 2>(a, v); rotate<1, 3>(a, v); rotate<1, 4>(a, v);
    rotate<1, 5>(a, v);
    rotate<2, 3>(a, v); rotate<2, 4>(a, v); rotate<2, 5>(a, v);
    rotate<3, 4>(a, v); rotate<3, 5>(a, v);
    rotate<4, 5>(a, v);
  }
  float w[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) w[i] = a[i][i];
  order<0, 5>(w, v); order<1, 3>(w, v); order<2, 4>(w, v);
  order<1, 2>(w, v); order<3, 4>(w, v);
  order<0, 3>(w, v); order<2, 5>(w, v);
  order<0, 1>(w, v); order<2, 3>(w, v); order<4, 5>(w, v);
  order<1, 2>(w, v); order<3, 4>(w, v);
  float* wo = w_out + static_cast<size_t>(b) * kN;
  float* vo = V_out + static_cast<size_t>(b) * kN * kN;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    wo[i] = w[i];
#pragma unroll
    for (int j = 0; j < kN; ++j) vo[i * kN + j] = v[i][j];
  }
}

}  // namespace

// H [B,6,6] -> w [B,6] ascending, V [B,6,6] (eigenvectors as columns).
extern "C" int rso_eigh6(const float* H, float* w, float* V, int B,
                         void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  eigh6_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(H, w, V, B);
  return (int)cudaGetLastError();
}
