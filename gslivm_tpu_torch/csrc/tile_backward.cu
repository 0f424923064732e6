// K2: backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gslivm_tpu/ops/rasterize_pallas.py:_bwd_kernel
// (launched by _bwd_call through pl.pallas_call, reduced to per-gaussian
// gradients in _render_from_table_bwd).
//
// What it computes. One CUDA block per pixel block, as in K1. Given the
// cotangents of K1's rows C_r, C_g, C_b, D, A, T (g_tiles [T, 8, npix]),
// K1's own output (fwd_tiles: T_final in row 5, neff in row 7) and K1's
// chunk-start checkpoints (ckpt [T, max_chunks, npix], T with the done flag
// in the sign bit), the block walks its chunks i = neff-1 .. 0 and writes,
// for every instance of a walked chunk, one row of out [L, 16]:
//   d mean2d (2), d conic (3), d opacity, d rgb (3), d depth (0 when
//   depth_grad is 0), zeros, the instance's rank id in column 14.
// Per pixel, with psi_j = gC . rgb_j + gA (+ gD d_j unless depth_grad is 0):
//   dL/dalpha_j = T_j psi_j - (S_j + gT T_final) / (1 - alpha_j)
// where S_j is the sum of w_k psi_k over the later contributors k of the
// pixel: within a chunk the chunk total minus the inclusive prefix, across
// chunks an exactly carried sum W_psi. dL/dalpha is gated by `contrib`, and
// d opacity and d power by the raw alpha < 0.99 subgradient (the JAX
// package's documented deviation from the reference CUDA backward). T is
// never divided by (1 - alpha): it is replayed forward from the checkpoint.
// Chunks from neff on are never walked and their rows stay as the caller
// allocated them (zeros, id 0), which the per-gaussian scatter relies on.
//
// What bounds it. Per walked (instance, pixel) pair: two replays of K1's
// pair math (~15 flops and one exp each) and, for contributing pairs, ~30
// flops of gradient terms; then per instance a reduction of 10 terms over
// the block's pixels. Bytes are small beside that: the cotangents and
// T_final (28 B per pixel), one checkpoint row per walked chunk (4 B per
// pixel), each walked instance read once and its row written once (64 B
// each). It is bound by operations.
//
// What the design does about it. Each of the 256 threads owns npix/256
// pixels (a template parameter) with its cotangents and W_psi in registers,
// and walks a chunk of 128 instances staged in shared memory. Pass A
// replays the chunk with K1's exact per-pair arithmetic (tile_common.cuh)
// to get the chunk total of w psi; pass B replays it again, keeping the
// running prefix, and forms dL/dalpha and the per-pair gradient terms. Two
// replays need no per-instance storage and no division of T. The 10 terms
// of an instance are summed over a warp with shuffles, only in warps where
// some lane contributed (__any_sync: most pairs fail the alpha or rect
// test), into a per-warp slot in shared memory; after the chunk, thread j
// sums instance j's 8 warp slots in a fixed order and writes its row with
// float4 stores. Runs of different tiles are disjoint, so no atomics are
// needed and the kernel is deterministic. Shared memory: 8 KB of instances
// + 40 KB of warp slots (8 warps x 128 instances x 10 terms).

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kTerms = 10;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes =
    (kChunk * kFeat + kWarps * kChunk * kTerms) * (int)sizeof(float);

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tile_backward_kernel(const float* __restrict__ inst,
                     const int* __restrict__ sorted_start,
                     const int* __restrict__ cnt_allowed,
                     const float* __restrict__ g_tiles,
                     const float* __restrict__ fwd_tiles,
                     const float* __restrict__ ckpt, float* __restrict__ out,
                     int grid_x, int pw, int ph, int max_chunks, int rect_test,
                     int depth_grad) {
  extern __shared__ float4 smem[];
  float4* batch = smem;
  float* red = reinterpret_cast<float*>(smem + kChunk * kFeat / 4);
  const float* feats = reinterpret_cast<const float*>(batch);

  const int t = blockIdx.x;
  const int npix = pw * ph;
  const float* fwd = fwd_tiles + (size_t)t * 8 * npix;
  const int neff = (int)fwd[7 * npix];
  if (neff <= 0) return;  // uniform over the block: nothing walked
  const float* gt = g_tiles + (size_t)t * 8 * npix;
  const int tile_x = t % grid_x;
  const int tile_y = t / grid_x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float px[PPT], py[PPT], gC0[PPT], gC1[PPT], gC2[PPT], gD[PPT], gA[PPT];
  float gTT[PPT], Wpsi[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = (float)(tile_x * pw + p % pw);
    py[k] = (float)(tile_y * ph + p / pw);
    gC0[k] = gt[0 * npix + p];
    gC1[k] = gt[1 * npix + p];
    gC2[k] = gt[2 * npix + p];
    gD[k] = gt[3 * npix + p];
    gA[k] = gt[4 * npix + p];
    gTT[k] = gt[5 * npix + p] * fwd[5 * npix + p];
    Wpsi[k] = 0.f;
  }

  const int start = sorted_start[t];
  const int count = cnt_allowed[t];
  for (int i = neff - 1; i >= 0; --i) {
    const int m = min(kChunk, count - i * kChunk);
    __syncthreads();  // the previous chunk's readers of batch and red are done
    const float4* src = reinterpret_cast<const float4*>(
        inst + (size_t)(start + i * kChunk) * kFeat);
    for (int e = threadIdx.x; e < m * (kFeat / 4); e += kThreads) batch[e] = src[e];
    __syncthreads();
    const float* ck = ckpt + ((size_t)t * max_chunks + i) * npix;

    // pass A: the chunk total of w psi per pixel
    float total[PPT];
    {
      float T[PPT];
      bool done[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float c = ck[threadIdx.x + k * kThreads];
        T[k] = fabsf(c);
        done[k] = c < 0.f;
        total[k] = 0.f;
      }
      for (int j = 0; j < m; ++j) {
        const float* g = feats + j * kFeat;
        const Splat s = load_splat(g);
        const float r = g[FR], gg = g[FG], b = g[FB2], d = g[FD];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (done[k]) continue;
          const Pair pr = eval_pair(s, px[k], py[k], rect_test);
          if (!pr.accepted) continue;
          const float T_next = next_T(T[k], pr.alpha);
          if (T_next < TILE_MIN_T) {
            done[k] = true;
            continue;
          }
          float psi = gC0[k] * r + gC1[k] * gg + gC2[k] * b + gA[k];
          if (depth_grad) psi += gD[k] * d;
          total[k] += weight(pr.alpha, T[k]) * psi;
          T[k] = T_next;
        }
      }
    }

    // pass B: dL/dalpha and the per-instance gradient terms
    {
      float T[PPT], prefix[PPT];
      bool done[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float c = ck[threadIdx.x + k * kThreads];
        T[k] = fabsf(c);
        done[k] = c < 0.f;
        prefix[k] = 0.f;
      }
      for (int j = 0; j < m; ++j) {
        const float* g = feats + j * kFeat;
        const Splat s = load_splat(g);
        const float r = g[FR], gg = g[FG], b = g[FB2], d = g[FD];
        float acc[kTerms];
#pragma unroll
        for (int c = 0; c < kTerms; ++c) acc[c] = 0.f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (done[k]) continue;
          const Pair pr = eval_pair(s, px[k], py[k], rect_test);
          if (!pr.accepted) continue;
          const float T_next = next_T(T[k], pr.alpha);
          if (T_next < TILE_MIN_T) {
            done[k] = true;
            continue;
          }
          const float w = weight(pr.alpha, T[k]);
          float psi = gC0[k] * r + gC1[k] * gg + gC2[k] * b + gA[k];
          if (depth_grad) psi += gD[k] * d;
          prefix[k] += w * psi;
          const float S = (total[k] - prefix[k]) + Wpsi[k];
          const float inv = 1.f / fmaxf(1.f - pr.alpha, 1e-6f);
          const float dLda = T[k] * psi - (S + gTT[k]) * inv;
          const bool not_clamped = pr.raw_alpha < 0.99f;
          const float d_op = not_clamped ? pr.G * dLda : 0.f;
          const float d_power = not_clamped ? s.o * dLda * pr.G : 0.f;
          const float u = d_power * pr.dx;
          const float v = d_power * pr.dy;
          acc[0] += u;
          acc[1] += v;
          acc[2] += u * pr.dx;
          acc[3] += u * pr.dy;
          acc[4] += v * pr.dy;
          acc[5] += d_op;
          acc[6] += gC0[k] * w;
          acc[7] += gC1[k] * w;
          acc[8] += gC2[k] * w;
          if (depth_grad) acc[9] += gD[k] * w;
          any = true;
          T[k] = T_next;
        }
        float* slot = red + (warp * kChunk + j) * kTerms;
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int c = 0; c < kTerms; ++c) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
          }
          if (lane == 0) {
#pragma unroll
            for (int c = 0; c < kTerms; ++c) slot[c] = acc[c];
          }
        } else if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kTerms; ++c) slot[c] = 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) Wpsi[k] = Wpsi[k] + total[k];

    __syncthreads();  // every warp slot of this chunk is written
    if (threadIdx.x < m) {
      const int j = threadIdx.x;
      float sum[kTerms];
#pragma unroll
      for (int c = 0; c < kTerms; ++c) sum[c] = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* slot = red + (w * kChunk + j) * kTerms;
#pragma unroll
        for (int c = 0; c < kTerms; ++c) sum[c] += slot[c];
      }
      const float* g = feats + j * kFeat;
      const float ca = g[FA], cb = g[FB], cc = g[FC];
      float4* o = reinterpret_cast<float4*>(
          out + (size_t)(start + i * kChunk + j) * kFeat);
      o[0] = make_float4(-(ca * sum[0] + cb * sum[1]),   // d mean2d.x
                         -(cc * sum[1] + cb * sum[0]),   // d mean2d.y
                         -0.5f * sum[2],                 // d conic a
                         -sum[3]);                       // d conic b
      o[1] = make_float4(-0.5f * sum[4],                 // d conic c
                         sum[5],                         // d opacity
                         sum[6], sum[7]);                // d rgb r, g
      o[2] = make_float4(sum[8],                         // d rgb b
                         depth_grad ? sum[9] : 0.f,      // d depth
                         0.f, 0.f);
      o[3] = make_float4(0.f, 0.f, g[FID], 0.f);         // rank id, col 14
    }
  }
}

template <int PPT>
int launch(const float* inst, const int* start, const int* cnt,
           const float* g_tiles, const float* fwd_tiles, const float* ckpt,
           float* out, int num_tiles, int grid_x, int pw, int ph,
           int max_chunks, int rect_test, int depth_grad, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_backward_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  tile_backward_kernel<PPT><<<num_tiles, kThreads, kSmemBytes, stream>>>(
      inst, start, cnt, g_tiles, fwd_tiles, ckpt, out, grid_x, pw, ph,
      max_chunks, rect_test, depth_grad);
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error of setting the
// kernel's shared-memory size); 1 (cudaErrorInvalidValue) for a pixel block
// that is not 256..2048 pixels in whole multiples of 256. out [L, 16] must
// be zeroed by the caller: rows of unwalked instances are not written.
extern "C" int tile_backward(const float* inst, const int* sorted_start,
                             const int* cnt_allowed, const float* g_tiles,
                             const float* fwd_tiles, const float* ckpt,
                             float* out, int num_tiles, int grid_x, int pw,
                             int ph, int max_chunks, int rect_test,
                             int depth_grad, void* stream) {
  const int npix = pw * ph;
  if (npix % kThreads != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    int err = 0;
#define CASE(P)                                                              \
  case P:                                                                    \
    err = launch<P>(inst, sorted_start, cnt_allowed, g_tiles, fwd_tiles,     \
                    ckpt, out, num_tiles, grid_x, pw, ph, max_chunks,        \
                    rect_test, depth_grad, s);                               \
    break;
    switch (npix / kThreads) {
      CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef CASE
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
