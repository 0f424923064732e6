// T2: ablation of the forward tile kernel's chunk walk, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/microbench_fwdablate.py:kernel (launched by
// its run() through pl.pallas_call), a copy of the TPU forward kernel's
// chunk walk with one piece removed at a time. Here the walk is the port's
// own K1 (tile_forward.cu), so that the time each piece saves says what it
// costs K1 on this card.
//
// What it computes. One CUDA block per 32x32-pixel tile (a 2x2 supertile
// of 16x16 tiles); each of its 256 threads owns 4 pixels. The block walks
// its tile's instances start[t] .. start[t] + cnt[t] of the row-major
// [L, 16] table in chunks of 128, with tile_common.cuh's pair math, and with
// no 1e-4 stop and no done flags (so K1's skip of a chunk for a warp whose
// pixels are all done has nothing to skip here). Output [T, 8, 1024] in
// row-major pixel order: C0, C1, C2, D, A, T, T, T per pixel. The rect test
// is K1's: once per warp and instance, on the origin of the warp's 16x16
// tile, which equals the per-pixel test of the JAX tool when the rect
// bounds are multiples of 16 (binning makes them so) or, as in the tool's
// inputs, +-1e9 (the test then always passes: it is timed, it saves
// nothing). The variants (the outputs of the same-named JAX variants):
//   kFull      each pixel composites the instances in order, as K1 does;
//   kNoExp     G = power in place of exp(power) (nothing is then accepted);
//   kNoTrans   FULL's values, each instance read straight from global
//              memory: no shared staging and no __syncthreads;
//   kNoAccept  contrib = alpha > accept_thr, never true for the 1e30 the
//              wrapper passes (an argument, so nvcc cannot fold it): w = 0
//              and T is unchanged; the per-pixel accept test (power <= 0,
//              alpha >= 1/255) is gone, the warp's rect test stays;
//   kNoScan    no transmittance carried inside a chunk: each pair's T_prev
//              = T_chunk_start (1 - alpha), and the chunk ends at the min of
//              the contributors' T_next;
//   kNoAccum   C0 += w only; C1, C2, D and A stay 0.
// The ablated variants are wrong renders on purpose: they exist to time
// what is left.
//
// What bounds it. Operations: ~15 flops and one exp per (instance, pixel)
// pair on data in shared memory; at the tool's size (2,040 tiles x 512
// instances x 1,024 pixels = 1.07e9 pairs) 1.6e10 flops take 0.239 ms at
// 67 TFLOP/s f32, while its 134 MB (instances read, rows written) take
// 0.040 ms at 3.35 TB/s.
//
// What the design does about it. It walks a chunk as K1 (tile_forward.cu)
// does since its redesign, so that the time each piece saves says what it
// costs K1 on this card: pixels in K1's warp-uniform 16x8 patches
// (tile_common.cuh:patch_pixel<4>), the rect test once per warp before any
// pair math, K1's launch bound of 4 blocks (32 warps) per SM, per-pixel
// state in registers, the chunk staged in shared memory with float4 loads
// and read back as a broadcast, and one template instantiation per variant
// so that each loses only its piece at compile time.

#include "kernel_usage.cuh"
#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kPPT = 4;      // pixels per thread
constexpr int kSide = 32;    // tile side in pixels
enum Variant { kFull = 0, kNoExp, kNoTrans, kNoAccept, kNoScan, kNoAccum };

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
ablate_kernel(const float* __restrict__ inst, const int* __restrict__ start,
              const int* __restrict__ nchunks, const int* __restrict__ count,
              float* __restrict__ out, int grid_x, float accept_thr) {
  __shared__ float4 batch[kChunk * kFeat / 4];
  const int t = blockIdx.x;
  const int npix = kSide * kSide;
  const int bx = (t % grid_x) * kSide;  // the tile's origin in the image
  const int by = (t / grid_x) * kSide;
  // pixel k of this thread, and the origin of the 16x16 tile holding it
  float px[kPPT], py[kPPT], rx[kPPT], ry[kPPT];
  float T[kPPT], C0[kPPT], C1[kPPT], C2[kPPT], D[kPPT], A[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    int x, y, ox, oy;
    patch_pixel<kPPT>(k, kSide, x, y, ox, oy);
    px[k] = (float)(bx + x);
    py[k] = (float)(by + y);
    rx[k] = (float)(bx + ox);
    ry[k] = (float)(by + oy);
    T[k] = 1.f;
    C0[k] = C1[k] = C2[k] = D[k] = A[k] = 0.f;
  }
  const int s0 = start[t];
  const int n = nchunks[t];
  const int cnt = count[t];
  const float* feats = reinterpret_cast<const float*>(batch);

  for (int i = 0; i < n; ++i) {
    const int m = min(kChunk, cnt - i * kChunk);
    const float* rows = inst + (size_t)(s0 + i * kChunk) * kFeat;
    if (V != kNoTrans) {
      const float4* src = reinterpret_cast<const float4*>(rows);
      for (int e = threadIdx.x; e < m * (kFeat / 4); e += kThreads) batch[e] = src[e];
      __syncthreads();
    }
    float Tc[kPPT], Tout[kPPT];  // kNoScan: T at the chunk's start, its min
#pragma unroll
    for (int k = 0; k < kPPT; ++k) Tc[k] = Tout[k] = T[k];

    for (int j = 0; j < m; ++j) {
      const float* g = (V == kNoTrans ? rows : feats) + j * kFeat;
      const Splat s = load_splat(g);
      bool in[kPPT];
      bool any_in = false;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        in[k] = rect_holds(s, rx[k], ry[k]);  // warp-uniform
        any_in = any_in || in[k];
      }
      if (!any_in) continue;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        if (!in[k]) continue;
        const Pair pr = eval_pair<V != kNoExp>(s, px[k], py[k]);
        const bool contrib = V == kNoAccept ? pr.alpha > accept_thr : pr.accepted;
        if (!contrib) continue;
        const float T_prev = V == kNoScan ? next_T(Tc[k], pr.alpha) : T[k];
        const float T_next = next_T(T_prev, pr.alpha);
        const float w = weight(pr.alpha, T_prev);
        if (V == kNoAccum) {
          C0[k] += w;
        } else {
          C0[k] += w * g[FR];
          C1[k] += w * g[FG];
          C2[k] += w * g[FB2];
          D[k] += w * g[FD];
          A[k] += w;
        }
        if (V == kNoScan) {
          Tout[k] = fminf(Tout[k], T_next);
        } else {
          T[k] = T_next;
        }
      }
    }
    if (V == kNoScan) {
#pragma unroll
      for (int k = 0; k < kPPT; ++k) T[k] = Tout[k];
    }
    if (V != kNoTrans) __syncthreads();  // the batch is refilled next chunk
  }

  float* o = out + (size_t)t * 8 * npix;
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    int x, y, ox, oy;
    patch_pixel<kPPT>(k, kSide, x, y, ox, oy);
    const int p = y * kSide + x;
    o[0 * npix + p] = C0[k];
    o[1 * npix + p] = C1[k];
    o[2 * npix + p] = C2[k];
    o[3 * npix + p] = D[k];
    o[4 * npix + p] = A[k];
    o[5 * npix + p] = T[k];
    o[6 * npix + p] = T[k];
    o[7 * npix + p] = T[k];
  }
}

template <int V>
void launch(const float* inst, const int* start, const int* nch, const int* cnt,
            float* out, int num_tiles, int grid_x, float accept_thr,
            cudaStream_t stream) {
  ablate_kernel<V><<<num_tiles, kThreads, 0, stream>>>(inst, start, nch, cnt, out,
                                                       grid_x, accept_thr);
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for an unknown variant. Tiles are 32x32 pixels, grid_x of them a row.
extern "C" int microbench_fwdablate(const float* inst, const int* start,
                                    const int* nchunks, const int* count, float* out,
                                    int num_tiles, int grid_x, int variant,
                                    float accept_thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    switch (variant) {
      case kFull: launch<kFull>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      case kNoExp: launch<kNoExp>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      case kNoTrans: launch<kNoTrans>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      case kNoAccept: launch<kNoAccept>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      case kNoScan: launch<kNoScan>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      case kNoAccum: launch<kNoAccum>(inst, start, nchunks, count, out, num_tiles, grid_x, accept_thr, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// Resource use of one variant's kernel, as the runtime reports it on the
// current device (kernel_usage.cuh); 1 (cudaErrorInvalidValue) for an
// unknown variant.
extern "C" int microbench_fwdablate_usage(int variant, int* out) {
  switch (variant) {
    case kFull: return kernel_usage(ablate_kernel<kFull>, kThreads, 0, out);
    case kNoExp: return kernel_usage(ablate_kernel<kNoExp>, kThreads, 0, out);
    case kNoTrans: return kernel_usage(ablate_kernel<kNoTrans>, kThreads, 0, out);
    case kNoAccept: return kernel_usage(ablate_kernel<kNoAccept>, kThreads, 0, out);
    case kNoScan: return kernel_usage(ablate_kernel<kNoScan>, kThreads, 0, out);
    case kNoAccum: return kernel_usage(ablate_kernel<kNoAccum>, kThreads, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
