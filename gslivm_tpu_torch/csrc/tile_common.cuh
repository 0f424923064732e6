// Per-(instance, pixel) compositing math shared by the forward tile kernel
// K1 (tile_forward.cu) and the backward tile kernel K2 (tile_backward.cu).
//
// K2 replays K1's front-to-back compositing from K1's chunk-start
// checkpoints, so both kernels must take the same accepted / contributing /
// done decisions and compute the same transmittance, bit for bit. The
// arithmetic that decides them lives here once, written with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn): nvcc may
// contract a product and a sum into an FMA differently in two kernels, and
// these intrinsics are never contracted. The result is also the rounding of
// the plain PyTorch versions, which evaluate the same expressions without
// FMA.
#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kChunk = 128;   // instances per chunk (the TPU kernel's CHUNK)
constexpr int kFeat = 16;     // feature columns of an instance row
constexpr int kThreads = 256;  // threads per block; each owns npix/256 pixels
// feature columns (rasterize_tiles.py): mean2d, conic, opacity, rgb, depth,
// the splat's 16x16 tile-rect bounds in pixels, the rank id
enum { FX = 0, FY, FA, FB, FC, FO, FR, FG, FB2, FD, FX0, FX1, FY0, FY1, FID };

// the same f32 constants as the JAX kernel's python literals
#define TILE_MIN_ALPHA ((float)(1.0 / 255.0))
#define TILE_MIN_T ((float)1e-4)

// the columns of one instance that the per-pixel test reads
struct Splat {
  float x, y, a, b, c, o, x0, x1, y0, y1;
};

__device__ __forceinline__ Splat load_splat(const float* g) {
  return Splat{g[FX], g[FY], g[FA], g[FB], g[FC], g[FO],
               g[FX0], g[FX1], g[FY0], g[FY1]};
}

// One instance at one pixel:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  G = e^power,
//   alpha = min(0.99, o G),
//   accepted if power <= 0, alpha >= 1/255 and (supertile mode) the pixel
//   lies inside the splat's 16x16 tile rect.
struct Pair {
  float dx, dy, G, raw_alpha, alpha;
  bool accepted;
};

__device__ __forceinline__ Pair eval_pair(const Splat& s, float px, float py,
                                          int rect_test) {
  Pair r;
  r.dx = __fsub_rn(s.x, px);
  r.dy = __fsub_rn(s.y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.a, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(s.c, r.dy), r.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(s.b, r.dx), r.dy));
  r.G = expf(power);
  r.raw_alpha = __fmul_rn(s.o, r.G);
  r.alpha = fminf(0.99f, r.raw_alpha);
  bool ok = power <= 0.f && r.alpha >= TILE_MIN_ALPHA;
  if (rect_test) ok = ok && px >= s.x0 && px < s.x1 && py >= s.y0 && py < s.y1;
  r.accepted = ok;
  return r;
}

// The transmittance after an accepted pair, T (1 - alpha). A pixel is done
// once this falls below 1e-4; that pair does not contribute.
__device__ __forceinline__ float next_T(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

// The pair's compositing weight alpha T.
__device__ __forceinline__ float weight(float alpha, float T) {
  return __fmul_rn(alpha, T);
}

}  // namespace tile
