// Batched symmetric eigendecomposition of 6x6 f32 matrices: cyclic Jacobi.
//
// No TPU kernel of the reference corresponds: rso's eigh solve backend calls
// XLA's `jnp.linalg.eigh` on the GN's 6x6 normal matrix
// (rso/solver/robust_gn.py:133), and rso jits it into the step like any
// other op.  The port's GN calls this kernel on the GPU instead of
// cuSOLVER's syevd, whose status check reads the host and so keeps the step
// out of a CUDA graph (rso_torch/solver/robust_gn.py `_eval_rgn`).
//
// Algorithm (csrc/eigh6.cuh, the routine this kernel shares with the GN
// iteration kernel csrc/gn_iter.cu): cyclic Jacobi, 8 sweeps over the 15
// pairs, then a 12-comparator sorting network, every operation a correctly
// rounded f32 intrinsic (__fmul_rn, ...) with no fused multiply-add, so the
// PyTorch twin `eigh6_torch` (rso_torch/kernels/eigh6.py), which runs the
// same operations in the same order, gives the same bits.
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

#include "eigh6.cuh"

namespace {

using rso_jacobi6::kN;
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
eigh6_kernel(const float* __restrict__ H, float* __restrict__ w_out,
             float* __restrict__ V_out, int B) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const float* hp = H + static_cast<size_t>(b) * kN * kN;
  float h[kN * kN];
#pragma unroll
  for (int i = 0; i < kN * kN; ++i) h[i] = hp[i];
  float w[kN];
  float v[kN][kN];
  rso_jacobi6::eigh6(h, w, v);
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
