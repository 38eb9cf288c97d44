// The 6x6 symmetric eigensolver of one thread: cyclic Jacobi, then a
// sorting network.  Shared by the eigh6 kernel (csrc/eigh6.cu: one thread a
// matrix) and the pose solver's GN iteration kernel (csrc/gn_iter.cu: the
// solving thread of a lane on the eigh backend), so that the PyTorch twin
// `eigh6_torch` (rso_torch/kernels/eigh6.py) describes both bit for bit.
//
// The lower triangle of H (what eigh reads) is mirrored into a full
// symmetric A, V = I, then kEighSweeps cyclic sweeps over the 15 pairs
// (p, q), p < q, row by row; each rotation zeroes A[p][q] (Golub and Van
// Loan's sym.schur2: theta = (aqq - app) / (2 apq), t = sign(theta) /
// (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c) and is
// skipped where A[p][q] is exactly 0.  A fixed sweep count, no convergence
// test: 6 sweeps reach the f32 fixed point on matrices of condition number
// up to 1e9 (the twin's check in tests/test_torch_eigh6.py), 8 leave two in
// hand.  Then a 12-comparator sorting network orders the eigenvalues
// ascending, moving V's columns with them.  Every operation is a correctly
// rounded f32 intrinsic (__fmul_rn, ...): no fused multiply-add, so the
// twin, which runs the same operations in the same order, gives the same
// bits.
#pragma once

#include <cuda_runtime.h>

namespace rso_jacobi6 {

constexpr int kN = 6;
constexpr int kEighSweeps = 8;

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

// h: a row-major 6x6 matrix whose lower triangle is read (h[i * 6 + j],
// j <= i) -> w ascending, v with the eigenvectors as columns.
__device__ __forceinline__ void eigh6(const float (&h)[kN * kN], float (&w)[kN],
                                      float (&v)[kN][kN]) {
  float a[kN][kN];
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
  for (int sweep = 0; sweep < kEighSweeps; ++sweep) {
    rotate<0, 1>(a, v); rotate<0, 2>(a, v); rotate<0, 3>(a, v);
    rotate<0, 4>(a, v); rotate<0, 5>(a, v);
    rotate<1, 2>(a, v); rotate<1, 3>(a, v); rotate<1, 4>(a, v);
    rotate<1, 5>(a, v);
    rotate<2, 3>(a, v); rotate<2, 4>(a, v); rotate<2, 5>(a, v);
    rotate<3, 4>(a, v); rotate<3, 5>(a, v);
    rotate<4, 5>(a, v);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) w[i] = a[i][i];
  order<0, 5>(w, v); order<1, 3>(w, v); order<2, 4>(w, v);
  order<1, 2>(w, v); order<3, 4>(w, v);
  order<0, 3>(w, v); order<2, 5>(w, v);
  order<0, 1>(w, v); order<2, 3>(w, v); order<4, 5>(w, v);
  order<1, 2>(w, v); order<3, 4>(w, v);
}

}  // namespace rso_jacobi6
