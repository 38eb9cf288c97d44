// FAST-12 segment test + Shi-Tomasi response, one octave image per launch.
//
// Replaces the TPU kernel rso/kernels/fast_detect.py `corner_response_pallas`
// (`_kernel`), and computes what its XLA composition `corner_response_jnp`
// computes, border included: central-difference gradients that WRAP at the
// image edge (`_shift2d` is a roll), structure-tensor box sums that are
// zero-padded (`_box_sum`), and a 3-px ring of -inf.  The Pallas kernel's
// zero halo gives other values within 5 px of the edge, which NMS then
// carries inward, so it is not the semantics followed here.
//
// Output: response where the pixel is a FAST corner, -inf elsewhere.
//
// What bounds it on the H100: memory.  At 1241x376 it reads the image and
// writes the response once (~1.9 MB per octave-0 image) and the arithmetic
// is a few hundred flops per corner pixel, far below the card's compute.
// Design: one thread per output pixel, 32x8 blocks so a warp reads one row
// segment; the 16 circle reads and the 9x9 gradient window are re-read
// through L1/L2 instead of staged, which is the simple form.  Non-corner
// pixels (most of them) skip the structure tensor entirely.
//
// Rounding: the box sums run in the reference's order (rows dy = 0..8, then
// columns dx = 0..8) with explicit round-to-nearest intrinsics, so no
// multiply-add is contracted into an FMA and the response is bit-equal to
// the PyTorch twin `corner_response_torch`.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Any circular run of >= arc set bits in a 16-bit word (arc in 1..16): the
// same predicate as the reference's run-length doubling.
__device__ __forceinline__ bool has_arc(unsigned b, int arc) {
  const unsigned w = b | (b << 16);
  const unsigned need = (1u << arc) - 1u;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    if (((w >> s) & need) == need) return true;
  }
  return false;
}

__device__ __forceinline__ float grad_x(const float* __restrict__ img, int W,
                                        int y, int x) {
  const int xp = (x + 1 == W) ? 0 : x + 1;
  const int xm = (x == 0) ? W - 1 : x - 1;
  return __fmul_rn(__fsub_rn(img[y * W + xp], img[y * W + xm]), 0.5f);
}

__device__ __forceinline__ float grad_y(const float* __restrict__ img, int H,
                                        int W, int y, int x) {
  const int yp = (y + 1 == H) ? 0 : y + 1;
  const int ym = (y == 0) ? H - 1 : y - 1;
  return __fmul_rn(__fsub_rn(img[yp * W + x], img[ym * W + x]), 0.5f);
}

__device__ float shi_tomasi(const float* __restrict__ img, int H, int W,
                            int y, int x, int win) {
  const int n = 2 * win + 1;
  float sxx = 0.f, syy = 0.f, sxy = 0.f;
  for (int dx = 0; dx < n; ++dx) {
    const int xx = x + dx - win;
    if (xx < 0 || xx >= W) continue;          // zero-padded column
    float rxx = 0.f, ryy = 0.f, rxy = 0.f;
    for (int dy = 0; dy < n; ++dy) {
      const int yy = y + dy - win;
      if (yy < 0 || yy >= H) continue;        // zero-padded row
      const float gx = grad_x(img, W, yy, xx);
      const float gy = grad_y(img, H, W, yy, xx);
      rxx = __fadd_rn(rxx, __fmul_rn(gx, gx));
      ryy = __fadd_rn(ryy, __fmul_rn(gy, gy));
      rxy = __fadd_rn(rxy, __fmul_rn(gx, gy));
    }
    sxx = __fadd_rn(sxx, rxx);
    syy = __fadd_rn(syy, ryy);
    sxy = __fadd_rn(sxy, rxy);
  }
  // the window mean as a multiply by the rounded reciprocal, like the twin
  const float inv_area = __fdiv_rn(1.0f, (float)(n * n));
  const float gxx = __fmul_rn(sxx, inv_area);
  const float gyy = __fmul_rn(syy, inv_area);
  const float gxy = __fmul_rn(sxy, inv_area);
  const float tr_half = __fmul_rn(0.5f, __fadd_rn(gxx, gyy));
  const float d = __fsub_rn(gxx, gyy);
  const float inner = __fadd_rn(__fmul_rn(0.25f, __fmul_rn(d, d)),
                                __fmul_rn(gxy, gxy));
  return __fsub_rn(tr_half, __fsqrt_rn(fmaxf(inner, 0.f)));
}

__global__ void corner_response_kernel(const float* __restrict__ img,
                                       const int* __restrict__ threshold,
                                       float* __restrict__ out, int H, int W,
                                       int arc, int win) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  float result = -INFINITY;
  if (x >= 3 && x < W - 3 && y >= 3 && y < H - 3) {
    const float c = img[y * W + x];
    const float t = (float)threshold[0];
    const float hi = __fadd_rn(c, t);
    const float lo = __fsub_rn(c, t);
    unsigned bright = 0u, dark = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = img[(y + kDY[k]) * W + (x + kDX[k])];
      if (v > hi) bright |= 1u << k;
      if (v < lo) dark |= 1u << k;
    }
    if (has_arc(bright, arc) || has_arc(dark, arc)) {
      result = shi_tomasi(img, H, W, y, x, win);
    }
  }
  out[y * W + x] = result;
}

}  // namespace

extern "C" int rso_corner_response(const float* img, const int* threshold,
                                   float* out, int H, int W, int arc, int win,
                                   void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  corner_response_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, threshold, out, H, W, arc, win);
  return (int)cudaGetLastError();
}
