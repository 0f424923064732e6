// K1: forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gslivm_tpu/ops/rasterize_pallas.py:_fwd_kernel
// (launched by _fwd_call through pl.pallas_call), including its optional
// chunk-start transmittance checkpoints, which the backward kernel K2
// (tile_backward.cu) reads.
//
// What it computes. One CUDA block per pixel block of pw x ph pixels (a
// 16x16 tile, or a (16*block_x) x (16*block_y) supertile). The block walks
// its tile's depth-sorted instance run, instances sorted_start[t] ..
// sorted_start[t] + cnt_allowed[t] of the [L, 16] feature table, front to
// back, with the per-pair math of tile_common.cuh. Output per pixel, as
// [T, 8, npix]: C_r, C_g, C_b, D, A, T_final, n_contrib (1-based position
// in the tile run of the last contributor), neff (the first chunk of 128 at
// whose start every pixel of the block was done; tile_nchunks[t] if that
// never happens). Out-of-image pixels of the last supertile row are
// composited and vote like the TPU kernel's. With ckpt non-null, the
// transmittance at the start of every walked chunk i < neff goes to
// ckpt[t, i, p] as T with the done flag in the sign bit (-T once the pixel
// is done; T >= 1e-4 > 0 always), the JAX contract. Chunks from neff on are
// not written.
//
// What bounds it. Per (instance, pixel) pair inside the instance's tile
// rect it does ~15 flops and one exp on data that sits in shared memory;
// it reads each instance once (64 B) and writes 32 B per pixel (and 4 B
// per pixel per walked chunk with checkpoints). At 1080p the pair work dominates: it is bound by
// operations (fp32 and the SFU exp), not by bytes.
//
// What the design does about it. The TPU kernel vectorised a chunk across
// a (128 instances x npix) array with a multiplicative prefix scan; here
// each thread composites its pixels sequentially over a batch of 128
// instances staged in shared memory (8 KB, loaded with float4, coalesced),
// which is the reference CUDA forward's order and needs no scan. Every
// thread reads the same instance from shared memory (a broadcast), and the
// per-pixel state stays in registers. npix can reach 2048 (block 2x4), so
// each of the 256 threads owns npix/256 pixels (a template parameter), laid
// out in warp-uniform patches (tile_common.cuh: at 4 pixels a thread a warp
// owns a 16x8 patch of one 16x16 tile). In supertile mode a splat's tile
// rect covers whole 16x16 tiles, so the rect test is one uniform branch per
// warp and instance, taken before any per-pixel work: a warp skips a splat
// that misses its tile. A warp whose pixels are all done skips the rest of
// the chunk. The walk is bound by the latency of each
// pixel's dependent chain (shared load, quadratic form, exp, tests), so
// residency pays: up to 4 pixels a thread the kernel is held to 64
// registers, 4 blocks (32 warps) per SM. The all-done vote before each
// batch is one __syncthreads_and, which is also the barrier that protects
// the shared batch before it is overwritten. CUDA blocks run in no order,
// so the TPU kernel's cross-program DMA baton has no counterpart: each
// block reads its own run.

#include "kernel_usage.cuh"
#include "tile_common.cuh"

namespace {

using namespace tile;

template <int PPT>
__global__ void __launch_bounds__(kThreads, PPT <= 4 ? 4 : 1)
tile_forward_kernel(const float* __restrict__ inst,
                    const int* __restrict__ sorted_start,
                    const int* __restrict__ tile_nchunks,
                    const int* __restrict__ cnt_allowed,
                    float* __restrict__ out, float* __restrict__ ckpt,
                    int grid_x, int pw, int ph, int max_chunks, int rect_test,
                    int contrib_stats) {
  __shared__ float4 batch[kChunk * kFeat / 4];
  const int t = blockIdx.x;
  const int npix = pw * ph;
  const int bx = (t % grid_x) * pw;  // the block's origin in the image
  const int by = (t / grid_x) * ph;

  // pixel k of this thread, and the origin of the 16x16 tile holding it
  float px[PPT], py[PPT], rx[PPT], ry[PPT];
  float T[PPT], C0[PPT], C1[PPT], C2[PPT], D[PPT], A[PPT];
  int N[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int x, y, ox, oy;
    patch_pixel<PPT>(k, pw, x, y, ox, oy);
    const int p = y * pw + x;
    px[k] = (float)(bx + x);
    py[k] = (float)(by + y);
    rx[k] = (float)(bx + ox);
    ry[k] = (float)(by + oy);
    T[k] = 1.f;
    C0[k] = C1[k] = C2[k] = D[k] = A[k] = 0.f;
    N[k] = 0;
    done[k] = false;
  }

  const int start = sorted_start[t];
  const int nchunks = tile_nchunks[t];
  const int count = cnt_allowed[t];
  int neff = nchunks;
  const float* feats = reinterpret_cast<const float*>(batch);

  for (int i = 0; i < nchunks; ++i) {
    bool mine = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) mine = mine && done[k];
    if (__syncthreads_and(mine)) {
      neff = i;
      break;
    }
    if (ckpt != nullptr && i < max_chunks) {
      float* c = ckpt + ((size_t)t * max_chunks + i) * npix;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        int x, y, ox, oy;
        patch_pixel<PPT>(k, pw, x, y, ox, oy);
        c[y * pw + x] = done[k] ? -T[k] : T[k];
      }
    }
    const int m = min(kChunk, count - i * kChunk);
    const float4* src = reinterpret_cast<const float4*>(
        inst + (size_t)(start + i * kChunk) * kFeat);
    for (int e = threadIdx.x; e < m * (kFeat / 4); e += kThreads) batch[e] = src[e];
    __syncthreads();
    if (__all_sync(0xffffffffu, mine)) continue;  // this warp is done

    for (int j = 0; j < m; ++j) {
      const float* g = feats + j * kFeat;
      const Splat s = load_splat(g);
      bool in[PPT];
      bool any_in = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        in[k] = !rect_test || rect_holds(s, rx[k], ry[k]);  // warp-uniform
        any_in = any_in || in[k];
      }
      if (!any_in) continue;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!in[k] || done[k]) continue;
        const Pair pr = eval_pair(s, px[k], py[k]);
        if (!pr.accepted) continue;
        const float T_next = next_T(T[k], pr.alpha);
        if (T_next < TILE_MIN_T) {
          done[k] = true;
          continue;
        }
        const float w = weight(pr.alpha, T[k]);
        C0[k] += w * g[FR];
        C1[k] += w * g[FG];
        C2[k] += w * g[FB2];
        D[k] += w * g[FD];
        A[k] += w;
        T[k] = T_next;
        N[k] = i * kChunk + j + 1;
      }
    }
  }

  float* o = out + (size_t)t * 8 * npix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int x, y, ox, oy;
    patch_pixel<PPT>(k, pw, x, y, ox, oy);
    const int p = y * pw + x;
    o[0 * npix + p] = C0[k];
    o[1 * npix + p] = C1[k];
    o[2 * npix + p] = C2[k];
    o[3 * npix + p] = D[k];
    o[4 * npix + p] = A[k];
    o[5 * npix + p] = T[k];
    o[6 * npix + p] = contrib_stats ? (float)N[k] : 0.f;
    o[7 * npix + p] = (float)neff;
  }
}
template <int PPT>
void launch(const float* inst, const int* start, const int* nch, const int* cnt,
            float* out, float* ckpt, int num_tiles, int grid_x, int pw, int ph,
            int max_chunks, int rect_test, int contrib_stats,
            cudaStream_t stream) {
  tile_forward_kernel<PPT><<<num_tiles, kThreads, 0, stream>>>(
      inst, start, nch, cnt, out, ckpt, grid_x, pw, ph, max_chunks, rect_test,
      contrib_stats);
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for a pixel block that is not 256..2048 pixels in whole 16x16 tiles.
// ckpt may be null (no checkpoints); else it holds [num_tiles, max_chunks,
// npix] floats and every tile_nchunks[t] <= max_chunks. With rect_test the
// tile-rect columns of inst are multiples of 16, as binning makes them.
extern "C" int tile_forward(const float* inst, const int* sorted_start,
                            const int* tile_nchunks, const int* cnt_allowed,
                            float* out, float* ckpt, int num_tiles, int grid_x,
                            int pw, int ph, int max_chunks, int rect_test,
                            int contrib_stats, void* stream) {
  if (!block_ok(pw, ph)) return (int)cudaErrorInvalidValue;
  const int npix = pw * ph;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
#define CASE(P)                                                                \
  case P:                                                                      \
    launch<P>(inst, sorted_start, tile_nchunks, cnt_allowed, out, ckpt,        \
              num_tiles, grid_x, pw, ph, max_chunks, rect_test, contrib_stats, \
              s);                                                              \
    break;
    switch (npix / kThreads) {
      CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef CASE
  }
  return (int)cudaGetLastError();
}

// Resource use of the kernel that a block of 256 ppt pixels launches, as the
// runtime reports it on the current device (kernel_usage.cuh);
// 1 (cudaErrorInvalidValue) for a ppt outside 1..8.
extern "C" int tile_forward_usage(int ppt, int* out) {
  switch (ppt) {
#define CASE(P) \
  case P:       \
    return kernel_usage(tile_forward_kernel<P>, kThreads, 0, out);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
