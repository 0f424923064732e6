// K3: separable blur of many images for Hopper (sm_90a).
//
// Replaces the TPU kernel gslivm_tpu/ops/blur_pallas.py:_kernel (launched
// by _blur_impl through pl.pallas_call, public as blur_many).
//
// What it computes. For each [H, W] slice of x [N, H, W] (float32,
// contiguous), the zero-padded SAME separable CORRELATION with k taps,
// r = k / 2:  y[h, w] = sum_i sum_j t[i] t[j] x[h + i - r, w + j - r],
// with x = 0 outside the image. SSIM uses k = 11 asymmetric taps, so the
// orientation matters; the VJP is this kernel with the taps reversed.
//
// What bounds it. 2k flops per pass per element against 8 bytes of device
// traffic per element (one read, one write): ~5 flops per byte, far below
// the card's ~20 fp32 flops per byte, so it is bound by bytes.
//
// What the design does about it. One block per (slice, 32-row x 32-column
// output tile). The block stages its input tile plus an r-pixel halo on
// every side into shared memory (zero outside the image), runs the
// horizontal pass into a second shared buffer and the vertical pass from
// there straight to the output. Every input element is read from device
// memory once plus the halo share ((32 + 2r)^2 / 32^2 = 1.8x at r = 5, most
// of it served by L2), every output written once; consecutive threads read
// and write consecutive addresses. The TPU kernel's 128-row bands and lane
// padding of the width are TPU layout rules and do not carry over.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kMaxTaps = 15;
constexpr int kMaxR = kMaxTaps / 2;
constexpr int kThreads = 256;

struct Taps {
  float t[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
            int k, Taps taps) {
  __shared__ float in[kTile + 2 * kMaxR][kTile + 2 * kMaxR + 1];
  __shared__ float mid[kTile + 2 * kMaxR][kTile];
  const int r = k / 2;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t plane = (size_t)H * W;
  const float* src = x + blockIdx.z * plane;
  float* dst = y + blockIdx.z * plane;
  const int rows = kTile + 2 * r;
  const int cols = kTile + 2 * r;

  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int rr = e / cols, cc = e % cols;
    const int gy = y0 - r + rr, gx = x0 - r + cc;
    in[rr][cc] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? src[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // horizontal pass over every staged row, halo rows included
  for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
    const int rr = e / kTile, cc = e % kTile;
    float acc = 0.f;
    for (int i = 0; i < k; ++i) acc += taps.t[i] * in[rr][cc + i];
    mid[rr][cc] = acc;
  }
  __syncthreads();

  // vertical pass to the output
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int rr = e / kTile, cc = e % kTile;
    const int gy = y0 + rr, gx = x0 + cc;
    if (gy >= H || gx >= W) continue;
    float acc = 0.f;
    for (int i = 0; i < k; ++i) acc += taps.t[i] * mid[rr + i][cc];
    dst[(size_t)gy * W + gx] = acc;
  }
}

}  // namespace

// x, y: device pointers to [n, h, w] float32; taps: HOST pointer to k
// floats (1 <= k <= 15). Returns cudaGetLastError() after the launch.
extern "C" int blur_many(const float* x, float* y, int n, int h, int w,
                         const float* taps, int k, void* stream) {
  if (k < 1 || k > kMaxTaps) return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Taps tp = {};
  for (int i = 0; i < k; ++i) tp.t[i] = taps[i];
  dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  blur_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, y, h, w, k, tp);
  return (int)cudaGetLastError();
}
