// T2: ablation of the forward tile kernel's chunk walk, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/microbench_fwdablate.py:kernel (launched by
// its run() through pl.pallas_call), a copy of the TPU forward kernel's
// chunk walk with one piece removed at a time. Here the walk is the port's
// own K1 (tile_forward.cu), so that the time each piece saves says what it
// costs K1 on this card.
//
// What it computes. One CUDA block per 32x32-pixel tile; each of its 256
// threads owns 4 pixels. The block walks its tile's instances
// start[t] .. start[t] + cnt[t] of the row-major [L, 16] table in chunks of
// 128, with tile_common.cuh's pair math and the rect test, and with no
// 1e-4 stop and no done flags. Output [T, 8, 1024]: C0, C1, C2, D, A, T, T,
// T per pixel. The variants (the outputs of the same-named JAX variants):
//   kFull      each pixel composites the instances in order, as K1 does;
//   kNoExp     G = power in place of exp(power) (nothing is then accepted);
//   kNoTrans   FULL's values, each instance read straight from global
//              memory: no shared staging and no __syncthreads;
//   kNoAccept  contrib = alpha > accept_thr, never true for the 1e30 the
//              wrapper passes (an argument, so nvcc cannot fold it): w = 0
//              and T is unchanged; the accept test is gone;
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
// What the design does about it. It keeps K1's shape, so that it measures
// K1: per-pixel state in registers, the chunk staged in shared memory with
// float4 loads and read back as a broadcast, one template instantiation per
// variant so that each loses only its piece at compile time.

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kPPT = 4;      // pixels per thread
constexpr int kSide = 32;    // tile side in pixels
enum Variant { kFull = 0, kNoExp, kNoTrans, kNoAccept, kNoScan, kNoAccum };

// eval_pair with G = power: the exp removed, the rest as in tile_common.cuh
__device__ __forceinline__ Pair eval_pair_noexp(const Splat& s, float px, float py) {
  Pair r;
  r.dx = __fsub_rn(s.x, px);
  r.dy = __fsub_rn(s.y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.a, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(s.c, r.dy), r.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(s.b, r.dx), r.dy));
  r.G = power;
  r.raw_alpha = __fmul_rn(s.o, r.G);
  r.alpha = fminf(0.99f, r.raw_alpha);
  r.accepted = power <= 0.f && r.alpha >= TILE_MIN_ALPHA && px >= s.x0 &&
               px < s.x1 && py >= s.y0 && py < s.y1;
  return r;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const float* __restrict__ inst, const int* __restrict__ start,
              const int* __restrict__ nchunks, const int* __restrict__ count,
              float* __restrict__ out, int grid_x, float accept_thr) {
  __shared__ float4 batch[kChunk * kFeat / 4];
  const int t = blockIdx.x;
  const int npix = kSide * kSide;
  float px[kPPT], py[kPPT], T[kPPT], C0[kPPT], C1[kPPT], C2[kPPT], D[kPPT], A[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = (float)((t % grid_x) * kSide + p % kSide);
    py[k] = (float)((t / grid_x) * kSide + p / kSide);
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
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const Pair pr = V == kNoExp ? eval_pair_noexp(s, px[k], py[k])
                                    : eval_pair(s, px[k], py[k], 1);
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
    const int p = threadIdx.x + k * kThreads;
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
