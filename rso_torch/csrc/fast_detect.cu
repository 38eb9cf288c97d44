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
// The first design (one thread per pixel, everything read through L1/L2)
// ran the structure tensor only at corner pixels: a serial 9x9 loop that
// recomputed both gradients at each of the 81 taps (324 image reads), with
// a branch per tap at the border.  Only 2.8% of the octave-0 pixels of the
// bench frame are corners, but 31% of its 32-pixel warps hold one (68% at
// octave 2; chip_smoke.py prints both), and each such warp paid the whole
// loop while its other lanes idled.
//
// This design: one block of 256 threads per 32x16 output tile.  The block
// loads the image tile and its halo (win + 1 px, at least FAST's 3) once
// into shared memory with row-coalesced reads, taking coordinates modulo H
// and W, as the roll does; computes the gradients and the three products
// once for each position of the tile and a win-px ring (0 outside the
// image: the box sums' zero padding); sums them in two separable passes,
// the 2*win + 1 rows of each column in order dy = 0..2*win, then the
// 2*win + 1 column sums in order dx = 0..2*win, which is the twin's order;
// and gives every pixel its response, with no divergence, before the FAST
// test (16 taps from shared memory) selects it.  The window is a template
// parameter for the configs' win 4, so the tile's sizes and the loops' trip
// counts are constants; any other win takes the same kernel with the window
// at run time.  The launch sizes the tile's shared memory from win (23.6 KB
// at win 4) and from win 13, past 48 KB, opts in to more, up to the H100's
// 227 KB a block, which holds the tile of win <= 45.
//
// A wider window takes the wide path (`launch_wide`, below): pass 1 writes
// each pixel's three column sums over its 2*win + 1 rows to global memory,
// pass 2 sums 2*win + 1 of them along the row, in the same order as the
// tile path and the twin (a sliding or prefix sum would round otherwise:
// the sums pass 2^24), and takes the response and the FAST test through
// the same device functions.  It is simple, not fast.  Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 111.554 us at win 46
// and 145.665 us at win 64 on 376x1241, against 330.915 us for the tile
// path at win 45 (whose 32x16 tile carries a 124x108 halo); the bound is
// ~4.8 / 6.3 us of operations.  Each pixel reads 4 (2*win + 1) image
// values in pass 1 and 3 (2*win + 1) column sums in pass 2, through L1/L2.
//
// Measured (tests/_torch_kernel_ab.py on the bench frame, NVIDIA H100 80GB
// HBM3 at 700 W; the A/B of record in PERF.md, section 6): 14.779 us on the
// device at 376x1241, against 40.158 us for the first design; 5.752 and
// 4.450 us at the two smaller octaves (21.327, 10.838).  In one call, win 4
// through the run-time path took 22.508, 7.709 and 6.021 us against 15.037,
// 5.830 and 4.476 compiled as a constant.  64-wide tiles were 3% faster at
// octave 0 and 18% and 51% slower at the smaller octaves (PERF.md).
//
// What bounds it: the bound is ~190 operations a pixel (1.3 us at the f32
// rate; the image read once and the response written once, ~1.9 MB, take
// 0.6 us).  By count the kernel issues several times that: the index
// arithmetic of four shared-memory phases, and the FAST test's 32 compares
// a pixel.  Holding a column in registers to cut the box passes'
// shared-memory reads gained 1.6% (PERF.md) and was not kept.  Tensor
// cores and TMA do not apply: the arithmetic is elementwise and sums in a
// fixed order, and a tile with its halo is ~4 KB that the block's own
// coalesced loads bring in.
//
// Rounding: explicit round-to-nearest intrinsics, so no multiply-add is
// contracted into an FMA, and the window mean as a multiply by the rounded
// reciprocal of its area: the response is bit-equal to the PyTorch twin
// `corner_response_torch`.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kBatch = 8;   // image loads in flight per thread
constexpr int kSmemDefault = 48 * 1024;   // dynamic shared memory without opt-in

// The 16 circle taps' offsets, +3, in 3 bits each: compile-time constants
// once the tap loop is unrolled.
constexpr unsigned long long kCircleDX = 0x440053976D63ull;  // 3,4,5,6,6,6,5,4,3,2,1,0,0,0,1,2
constexpr unsigned long long kCircleDY = 0x53976D63440ull;   // 0,0,1,2,3,4,5,6,6,6,5,4,3,2,1,0

__device__ __forceinline__ constexpr int circle_dx(int k) {
  return (int)((kCircleDX >> (3 * k)) & 7u) - 3;
}

__device__ __forceinline__ constexpr int circle_dy(int k) {
  return (int)((kCircleDY >> (3 * k)) & 7u) - 3;
}

// Any circular run of >= arc set bits in a 16-bit word (arc in 1..16): the
// reference's run-length doubling.  Bit s of `run` marks len set bits from
// bit s of the word doubled to 32 bits; `acc` chains the runs the binary
// digits of arc name.
__device__ __forceinline__ bool has_arc(unsigned b, int arc) {
  unsigned run = b | (b << 16);
  unsigned acc = 0xffffffffu;
  int done = 0;
#pragma unroll
  for (int len = 1; len <= 16; len <<= 1) {
    if (arc & len) {
      acc &= run >> done;
      done += len;
    }
    run &= run >> len;
  }
  return (acc & 0xffffu) != 0u;
}

// The Shi-Tomasi response (the smaller eigenvalue) of the window sums of
// the three products: both paths take it from here, so they round alike.
__device__ __forceinline__ float shi_tomasi(float sxx, float syy, float sxy,
                                            float inv_area) {
  const float gxx = __fmul_rn(sxx, inv_area);
  const float gyy = __fmul_rn(syy, inv_area);
  const float gxy = __fmul_rn(sxy, inv_area);
  const float tr_half = __fmul_rn(0.5f, __fadd_rn(gxx, gyy));
  const float dd = __fsub_rn(gxx, gyy);
  const float inner = __fadd_rn(__fmul_rn(0.25f, __fmul_rn(dd, dd)),
                                __fmul_rn(gxy, gxy));
  return __fsub_rn(tr_half, __fsqrt_rn(fmaxf(inner, 0.f)));
}

// The FAST segment test of the pixel at `cen` in rows `stride` floats apart
// (shared or global memory): an arc of `arc` circle taps all brighter than
// cen + t or all darker than cen - t.
__device__ __forceinline__ bool fast_corner(const float* cen, int stride,
                                            float t, int arc) {
  const float hi = __fadd_rn(cen[0], t);
  const float lo = __fsub_rn(cen[0], t);
  unsigned bright = 0u, dark = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float v = cen[circle_dy(k) * stride + circle_dx(k)];
    if (v > hi) bright |= 1u << k;
    if (v < lo) dark |= 1u << k;
  }
  return has_arc(bright, arc) || has_arc(dark, arc);
}

// v modulo n for the halo's coordinates, which lie within about a tile of
// the image (a loop: the tile may be larger than the image).
__device__ __forceinline__ int wrap(int v, int n) {
  while (v < 0) v += n;
  while (v >= n) v -= n;
  return v;
}

// (row, column) of index i = tid, tid + kThreads, ... in a row-major array
// `cols` wide, stepped without a division.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int tid, int cols_)
      : r(tid / cols_), c(tid % cols_), dr(kThreads / cols_),
        dc(kThreads % cols_), cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// The tile's shared-memory layout for window half-width win: the image and
// its halo, the three products over the tile and a win-px ring, and their
// column sums over the tile's rows.
struct Tile {
  int halo, iw, ih, pw, ph;
  __host__ __device__ constexpr explicit Tile(int win)
      : halo(win + 1 > 3 ? win + 1 : 3), iw(kTileW + 2 * halo),
        ih(kTileH + 2 * halo), pw(kTileW + 2 * win), ph(kTileH + 2 * win) {}
  __host__ __device__ constexpr size_t floats() const {
    return (size_t)ih * iw + 3 * (size_t)ph * pw + 3 * (size_t)kTileH * pw;
  }
};

// WIN > 0: the window fixed at compile time (the configs' 4), so the tile's
// sizes and the loops' trip counts are constants; WIN == 0: `win` at run
// time, for any other window.
template <int WIN>
__global__ void __launch_bounds__(kThreads) corner_response_kernel(
    const float* __restrict__ img, const int* __restrict__ threshold,
    float* __restrict__ out, int H, int W, int arc, int win_arg) {
  extern __shared__ float smem[];
  // the sequence (lane) of a batched launch: its image, threshold and output
  const size_t seq = blockIdx.z;
  img += seq * H * W;
  out += seq * H * W;
  const int win = WIN > 0 ? WIN : win_arg;
  const Tile T(win);
  const int N = 2 * win + 1;
  float* s_img = smem;                          // [ih][iw]
  float* s_prod = s_img + T.ih * T.iw;          // [3][ph][pw]: gx*gx, gy*gy, gx*gy
  float* s_col = s_prod + 3 * T.ph * T.pw;      // [3][kTileH][pw]: their column sums
  const int plane = T.ph * T.pw, col_plane = kTileH * T.pw;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const float t = (float)threshold[seq];

  // kBatch loads of the tile go out before their stores to shared memory:
  // one memory latency a batch.  An index past the end re-reads the last
  // element and is not stored.
  const int n_img = T.ih * T.iw;
  // loads a thread makes in a batch: all it has, up to kBatch
  const int n_loads = min(kBatch, (n_img + kThreads - 1) / kThreads);
  Walk w(tid, T.iw);
  for (int base = 0; base < n_img; base += n_loads * kThreads) {
    float vals[kBatch];
    Walk v = w;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < n_loads) {
        const int r = min(v.r, T.ih - 1), c = v.r < T.ih ? v.c : T.iw - 1;
        vals[k] = img[wrap(y0 - T.halo + r, H) * W + wrap(x0 - T.halo + c, W)];
        v.next();
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < n_loads) {
        if (base + tid + k * kThreads < n_img) s_img[w.r * T.iw + w.c] = vals[k];
        w.next();
      }
    }
  }
  __syncthreads();

  for (Walk p(tid, T.pw); p.r < T.ph; p.next()) {
    const int y = y0 - win + p.r, x = x0 - win + p.c;
    float gxx = 0.f, gyy = 0.f, gxy = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float* q = s_img + (p.r + T.halo - win) * T.iw + p.c + T.halo - win;
      const float gx = __fmul_rn(__fsub_rn(q[1], q[-1]), 0.5f);
      const float gy = __fmul_rn(__fsub_rn(q[T.iw], q[-T.iw]), 0.5f);
      gxx = __fmul_rn(gx, gx);
      gyy = __fmul_rn(gy, gy);
      gxy = __fmul_rn(gx, gy);
    }
    const int i = p.r * T.pw + p.c;
    s_prod[i] = gxx;
    s_prod[plane + i] = gyy;
    s_prod[2 * plane + i] = gxy;
  }
  __syncthreads();

  for (Walk p(tid, T.pw); p.r < kTileH; p.next()) {
    const float* q = s_prod + p.r * T.pw + p.c;
    float a = 0.f, b = 0.f, d = 0.f;
#pragma unroll
    for (int dy = 0; dy < N; ++dy, q += T.pw) {
      a = __fadd_rn(a, q[0]);
      b = __fadd_rn(b, q[plane]);
      d = __fadd_rn(d, q[2 * plane]);
    }
    const int i = p.r * T.pw + p.c;
    s_col[i] = a;
    s_col[col_plane + i] = b;
    s_col[2 * col_plane + i] = d;
  }
  __syncthreads();

  const float inv_area = __fdiv_rn(1.0f, (float)(N * N));
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float* q = s_col + r * T.pw + c;
    float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
    for (int dx = 0; dx < N; ++dx) {
      sxx = __fadd_rn(sxx, q[dx]);
      syy = __fadd_rn(syy, q[col_plane + dx]);
      sxy = __fadd_rn(sxy, q[2 * col_plane + dx]);
    }
    const float resp = shi_tomasi(sxx, syy, sxy, inv_area);
    const bool corner =
        x >= 3 && x < W - 3 && y >= 3 && y < H - 3 &&
        fast_corner(s_img + (r + T.halo) * T.iw + c + T.halo, T.iw, t, arc);
    out[y * W + x] = corner ? resp : -INFINITY;
  }
}

// The wide path, for a window whose tile does not fit a block's shared
// memory: two launches over the whole image, in the twin's order.  Pass 1
// gives each pixel the sums of the three products over its column's
// 2*win + 1 rows (dy = 0..2*win, 0 outside the image) in `colsum`
// ([3][H][W] in global memory, scratch the caller allocates); pass 2 sums 2*win + 1 of those along the
// row (dx = 0..2*win, 0 outside), then takes the response and the FAST
// test as the tile path does.  One thread a pixel; the gradients are
// recomputed at each row of the column from global memory (L1/L2 serve
// the neighbours' reads).
constexpr int kWideW = 32;
constexpr int kWideH = 8;

__global__ void __launch_bounds__(kWideW * kWideH) corner_colsum_kernel(
    const float* __restrict__ img, float* __restrict__ colsum, int H, int W,
    int win) {
  const int x = blockIdx.x * kWideW + threadIdx.x;
  const int y = blockIdx.y * kWideH + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t seq = blockIdx.z;
  img += seq * H * W;
  colsum += seq * 3 * H * W;
  const int xl = x == 0 ? W - 1 : x - 1, xr = x == W - 1 ? 0 : x + 1;
  float a = 0.f, b = 0.f, d = 0.f;
  for (int dy = 0; dy <= 2 * win; ++dy) {
    const int yy = y - win + dy;
    float gxx = 0.f, gyy = 0.f, gxy = 0.f;
    if (yy >= 0 && yy < H) {
      const int yu = yy == 0 ? H - 1 : yy - 1, yd = yy == H - 1 ? 0 : yy + 1;
      const float gx = __fmul_rn(__fsub_rn(img[yy * W + xr], img[yy * W + xl]), 0.5f);
      const float gy = __fmul_rn(__fsub_rn(img[yd * W + x], img[yu * W + x]), 0.5f);
      gxx = __fmul_rn(gx, gx);
      gyy = __fmul_rn(gy, gy);
      gxy = __fmul_rn(gx, gy);
    }
    a = __fadd_rn(a, gxx);
    b = __fadd_rn(b, gyy);
    d = __fadd_rn(d, gxy);
  }
  const size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  colsum[i] = a;
  colsum[plane + i] = b;
  colsum[2 * plane + i] = d;
}

__global__ void __launch_bounds__(kWideW * kWideH) corner_wide_kernel(
    const float* __restrict__ img, const int* __restrict__ threshold,
    const float* __restrict__ colsum, float* __restrict__ out, int H, int W,
    int arc, int win) {
  const int x = blockIdx.x * kWideW + threadIdx.x;
  const int y = blockIdx.y * kWideH + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t seq = blockIdx.z;
  img += seq * H * W;
  colsum += seq * 3 * H * W;
  out += seq * H * W;
  const size_t plane = (size_t)H * W;
  const float* row = colsum + (size_t)y * W;
  float sxx = 0.f, syy = 0.f, sxy = 0.f;
  for (int dx = 0; dx <= 2 * win; ++dx) {
    const int xx = x - win + dx;
    float a = 0.f, b = 0.f, d = 0.f;
    if (xx >= 0 && xx < W) {
      a = row[xx];
      b = row[plane + xx];
      d = row[2 * plane + xx];
    }
    sxx = __fadd_rn(sxx, a);
    syy = __fadd_rn(syy, b);
    sxy = __fadd_rn(sxy, d);
  }
  const int n = 2 * win + 1;
  const float resp = shi_tomasi(sxx, syy, sxy, __fdiv_rn(1.0f, (float)(n * n)));
  const bool corner = x >= 3 && x < W - 3 && y >= 3 && y < H - 3 &&
                      fast_corner(img + (size_t)y * W + x, W,
                                  (float)threshold[seq], arc);
  out[(size_t)y * W + x] = corner ? resp : -INFINITY;
}

// The largest dynamic shared memory a block may opt in to on this device.
cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  *bytes = (size_t)optin;
  return e;
}

int launch_wide(const float* img, const int* threshold, float* colsum,
                float* out, int B, int H, int W, int arc, int win,
                cudaStream_t stream) {
  if (colsum == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 block(kWideW, kWideH);
  const dim3 grid((W + kWideW - 1) / kWideW, (H + kWideH - 1) / kWideH, B);
  corner_colsum_kernel<<<grid, block, 0, stream>>>(img, colsum, H, W, win);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  corner_wide_kernel<<<grid, block, 0, stream>>>(img, threshold, colsum, out,
                                                 H, W, arc, win);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 where window half-width `win` takes the one-tile path on this device
// (its tile fits the shared memory a block may opt in to: win <= 45 on the
// H100), 0 where it takes the wide path; negative: a CUDA error.
extern "C" int rso_corner_tile_fits(int win) {
  size_t optin = 0;
  const cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return -(int)e;
  return Tile(win).floats() * sizeof(float) <= optin ? 1 : 0;
}

// B lanes (sequences) in one launch, the grid's z axis: img and out
// [B][H][W], one threshold a lane.  `colsum`: B*3*H*W floats of scratch
// for the wide path, which this entry takes where the window's tile does
// not fit (NULL where it does).
extern "C" int rso_corner_response(const float* img, const int* threshold,
                                   float* out, float* colsum, int B, int H,
                                   int W, int arc, int win, void* stream) {
  if (win < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = Tile(win).floats() * sizeof(float);
  if (smem > (size_t)kSmemDefault) {
    size_t optin = 0;
    const cudaError_t e = smem_optin(&optin);
    if (e != cudaSuccess) return (int)e;
    if (smem > optin)   // the tile does not fit: the wide path
      return launch_wide(img, threshold, colsum, out, B, H, W, arc, win,
                         (cudaStream_t)stream);
  }
  const auto kernel = win == 4 ? corner_response_kernel<4>
                               : corner_response_kernel<0>;
  if (smem > (size_t)kSmemDefault) {
    // win >= 13: opt in to the larger shared memory (227 KB a block on the
    // H100, so win <= 45)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(img, threshold, out,
                                                         H, W, arc, win);
  return (int)cudaGetLastError();
}
