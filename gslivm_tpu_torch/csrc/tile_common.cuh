// Per-(instance, pixel) compositing math and the pixel layout shared by the
// forward tile kernel K1 (tile_forward.cu) and the backward tile kernel K2
// (tile_backward.cu); the K1 ablation T2 (microbench_fwdablate.cu) uses
// both.
//
// K2 replays K1's front-to-back compositing from K1's chunk-start
// checkpoints, so both kernels must take the same accepted / contributing /
// done decisions and compute the same transmittance, bit for bit. The
// arithmetic that decides them lives here once, written with
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn): nvcc may
// contract a product and a sum into an FMA differently in two kernels, and
// these intrinsics are never contracted. The exp is CUDA's expf, the
// function torch.exp calls for f32 on the card, so every pair's alpha and
// its 1/255 acceptance test are bit-equal to the plain PyTorch versions'.
// (The hardware __expf differs from it in the last bits, and a splat whose
// alpha lies that close to 1/255 was then accepted by one and rejected by
// the other: alpha x depth, 1e-3 of scale and more, at a pixel of low
// coverage.) The kernels and the plain versions still differ in the order
// of their sums and of the transmittance products.
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
//   accepted if power <= 0 and alpha >= 1/255. The pixel must also lie
//   inside the splat's 16x16 tile rect: K1, K2 and T2 test that once per
//   warp before this (rect_holds). T2's noexp variant takes EXP = false,
//   G = power.
struct Pair {
  float dx, dy, G, raw_alpha, alpha;
  bool accepted;
};

template <bool EXP = true>
__device__ __forceinline__ Pair eval_pair(const Splat& s, float px, float py) {
  Pair r;
  r.dx = __fsub_rn(s.x, px);
  r.dy = __fsub_rn(s.y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.a, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(s.c, r.dy), r.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(s.b, r.dx), r.dy));
  r.G = EXP ? expf(power) : power;
  r.raw_alpha = __fmul_rn(s.o, r.G);
  r.alpha = fminf(0.99f, r.raw_alpha);
  r.accepted = power <= 0.f && r.alpha >= TILE_MIN_ALPHA;
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

// Supertile mode: whether the 16x16 tile with origin (tx, ty) lies inside
// the splat's tile rect. The rect bounds are multiples of 16 (the tile rect
// in pixels), so this is the per-pixel rect test of every pixel of that
// tile at once.
__device__ __forceinline__ bool rect_holds(const Splat& s, float tx, float ty) {
  return tx >= s.x0 && tx < s.x1 && ty >= s.y0 && ty < s.y1;
}

// Whether the kernels take a pw x ph pixel block: 256..2048 pixels in
// whole 16x16 tiles (patch_pixel below tiles the block with them).
inline bool block_ok(int pw, int ph) {
  const int npix = pw * ph;
  return pw > 0 && ph > 0 && pw % 16 == 0 && ph % 16 == 0 && npix % kThreads == 0 &&
         npix / kThreads <= 8;
}

// Warp-uniform pixel patches. A block of pw x ph pixels (npix = 256 PPT,
// pw and ph multiples of 16) is cut into npix / 32 groups of 32 pixels,
// each a 16x2 strip of one 16x16 tile: group g is strip g % 8 (rows
// 2 (g % 8) and 2 (g % 8) + 1) of the block's tile g / 8, tiles numbered
// row-major. Warp w owns groups
// w PPT .. w PPT + PPT - 1, lane l pixel (l % 16, l / 16) of each strip, so
// a warp's pixels of one group share one tile and the rect test is the
// same for every lane: at PPT 4 a warp owns a 16x8 patch of one tile, at
// PPT 8 a whole tile. For thread pixel k this gives its block-relative
// position (x, y), whose index in the block's row-major pixel order (the
// order of K1's output rows and checkpoints) is y pw + x, and the
// block-relative origin (ox, oy) of its tile.
template <int PPT>
__device__ __forceinline__ void patch_pixel(int k, int pw, int& x, int& y, int& ox,
                                            int& oy) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp * PPT + k;
  // when PPT divides 8 the warp's groups share its first group's tile;
  // written so, the tile origin is the same expression for every k
  const int tb = (8 % PPT == 0 ? warp * PPT : g) >> 3;
  const int tiles_per_row = pw >> 4;
  ox = (tb % tiles_per_row) << 4;
  oy = (tb / tiles_per_row) << 4;
  x = ox + (lane & 15);
  y = oy + 2 * (g & 7) + (lane >> 4);
}

}  // namespace tile
