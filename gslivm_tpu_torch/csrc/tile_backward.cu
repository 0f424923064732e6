// K2: backward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gslivm_tpu/ops/rasterize_pallas.py:_bwd_kernel
// (launched by _bwd_call through pl.pallas_call) together with the
// per-gaussian reduction of its rows in _render_from_table_bwd.
//
// What it computes. One CUDA block per pixel block, as in K1. Given the
// cotangents of K1's rows C_r, C_g, C_b, D, A, T (g_tiles [T, 8, npix]),
// K1's own output (fwd_tiles: C, D, A in rows 0-4, T_final in row 5, neff
// in row 7) and K1's chunk-start checkpoints (ckpt [T, max_chunks, npix], T
// with the done flag in the sign bit), the block walks its chunks
// i = 0 .. neff-1 and adds, for every instance of a walked chunk, its
// gradient into the per-gaussian gradient out [16, P] at column id (the
// instance's rank id, column 14 of its row):
//   rows 0-9: d mean2d (2), d conic (3), d opacity, d rgb (3), d depth (not
//   added when depth_grad is 0); rows 10-15 are left as the caller zeroed
//   them.
// Per pixel, with psi_j = gC . rgb_j + gA (+ gD d_j with depth_grad):
//   dL/dalpha_j = T_j psi_j - (S_j + gT T_final) / (1 - alpha_j)
// where S_j is the sum of w_k psi_k over the later contributors k of the
// pixel. The sum over all contributors is Psi = gC . C + gA A (+ gD D),
// from K1's own rows, so S_j = Psi - P_j with P_j the running inclusive
// prefix of w psi along the pixel's walk: one forward replay per chunk. The
// subtraction costs about one ulp of |Psi| in S, at most ~100 ulp in
// dL/dalpha since 1 - alpha >= 0.01, far inside the 1e-3 gate against the
// plain version's suffix scan. dL/dalpha is gated by `contrib`, and
// d opacity and d power by the raw alpha < 0.99 subgradient (the JAX
// package's documented deviation from the reference CUDA backward). T is
// never divided by (1 - alpha): each chunk starts from its checkpoint and
// T is replayed forward with K1's exact per-pair arithmetic
// (tile_common.cuh).
//
// What bounds it. Per walked (instance, pixel) pair inside the instance's
// tile rect: one replay of K1's pair math (~15 flops and one exp) and, for
// contributing pairs, ~30 flops of gradient terms; per instance a reduction
// of 10 terms over the block's pixels and 10 atomic adds. Bytes are small
// beside that: the cotangents and K1's rows (48 B per pixel), one
// checkpoint row per walked chunk (4 B per pixel), each walked instance
// read once (64 B) and its 40 B added to the gradient. It is bound by
// operations.
//
// What the design does about it. Each of the 256 threads owns npix/256
// pixels (a template parameter) in K1's warp-uniform patches
// (tile_common.cuh), so both kernels map pixels alike and take the same
// decisions, and in supertile mode a warp skips an instance whose tile rect
// misses its patch with one uniform branch, before any pair math and
// before the reduction. A warp where some lane contributed reduces its 10
// terms with a halving reduce-scatter (12 shuffles; each lane pair ends
// with one term) into a per-warp slot in shared memory, else it writes a
// zero slot. After the chunk, thread j sums instance j's 8 warp slots in a
// fixed order and adds the gradient into out with one red.global.add per
// term: only walked instances are added, so no per-instance rows are
// written and no unwalked slot is summed. A gaussian instanced in several
// tiles receives its sums in run-to-run order, so out varies by f32
// rounding between runs. Per-pixel state is the cotangents, the
// running prefix and T (Psi and gT T_final folded into one register), and
// the depth term is a template parameter; up to 4 pixels a thread the
// kernel is held to 80 registers, 3 blocks per SM (a few spilled bytes
// cost less than the third block gains; at 64 registers the spills cost
// more than a fourth block gains).
// Shared memory: 8 KB of instances + 40 KB of warp slots (8 warps x 128
// instances x 10 terms).

#include "kernel_usage.cuh"
#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kTerms = 10;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes =
    (kChunk * kFeat + kWarps * kChunk * kTerms) * (int)sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

// Halving reduce-scatter of a lane's 10 terms over the warp: exchanges at
// lane distance 16, 8, 4, 2 each keep half of the remaining terms (10, 5,
// 3, 2, 1) and the last sums the pair, 5 + 3 + 2 + 1 + 1 shuffles. Returns
// the warp sum of term reduced_term(lane) (see below), which both lanes
// 2i and 2i + 1 hold; the order of every sum is fixed.
__device__ __forceinline__ float reduce_scatter10(const float (&a)[kTerms], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
  float b[5];  // terms 5 h4 + 0..4
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float keep = h4 ? a[5 + i] : a[i];
    const float send = h4 ? a[i] : a[5 + i];
    b[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float c[3];  // h3 ? b3, b4, - : b0, b1, b2
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float hi = i + 3 < 5 ? b[i + 3] : 0.f;
    const float keep = h3 ? hi : b[i];
    const float send = h3 ? b[i] : hi;
    c[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float d[2];  // h2 ? c2, - : c0, c1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float hi = i + 2 < 3 ? c[i + 2] : 0.f;
    const float keep = h2 ? hi : c[i];
    const float send = h2 ? c[i] : hi;
    d[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  float e = (h1 ? d[1] : d[0]) + __shfl_xor_sync(kFull, h1 ? d[0] : d[1], 2);
  return e + __shfl_xor_sync(kFull, e, 1);
}

// The term that reduce_scatter10 leaves in `lane`, or -1 for none.
__device__ __forceinline__ int reduced_term(int lane) {
  const int base = (lane & 16) ? 5 : 0;
  const bool h3 = lane & 8, h2 = lane & 4;
  const int h1 = (lane >> 1) & 1;
  if (!h3 && !h2) return base + h1;
  if (!h3) return h1 ? -1 : base + 2;
  if (!h2) return base + 3 + h1;
  return -1;
}

template <int PPT, bool DG>
__global__ void __launch_bounds__(kThreads, PPT <= 4 ? 3 : 1)
tile_backward_kernel(const float* __restrict__ inst,
                     const int* __restrict__ sorted_start,
                     const int* __restrict__ cnt_allowed,
                     const float* __restrict__ g_tiles,
                     const float* __restrict__ fwd_tiles,
                     const float* __restrict__ ckpt, float* __restrict__ out,
                     int num_gaussians, int grid_x, int pw, int ph,
                     int max_chunks, int rect_test) {
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
  const int bx = (t % grid_x) * pw;
  const int by = (t / grid_x) * ph;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int term = reduced_term(lane);
  const bool writer = term >= 0 && !(lane & 1);

  float px[PPT], py[PPT], rx[PPT], ry[PPT];
  float gC0[PPT], gC1[PPT], gC2[PPT], gA[PPT], gD[DG ? PPT : 1];
  float Q[PPT], P[PPT];  // Psi + gT T_final; the running prefix of w psi
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int x, y, ox, oy;
    patch_pixel<PPT>(k, pw, x, y, ox, oy);
    const int p = y * pw + x;
    px[k] = (float)(bx + x);
    py[k] = (float)(by + y);
    rx[k] = (float)(bx + ox);
    ry[k] = (float)(by + oy);
    gC0[k] = gt[0 * npix + p];
    gC1[k] = gt[1 * npix + p];
    gC2[k] = gt[2 * npix + p];
    gA[k] = gt[4 * npix + p];
    float psi = gC0[k] * fwd[0 * npix + p] + gC1[k] * fwd[1 * npix + p] +
                gC2[k] * fwd[2 * npix + p] + gA[k] * fwd[4 * npix + p];
    if (DG) {
      gD[k] = gt[3 * npix + p];
      psi += gD[k] * fwd[3 * npix + p];
    }
    Q[k] = psi + gt[5 * npix + p] * fwd[5 * npix + p];
    P[k] = 0.f;
  }

  const int start = sorted_start[t];
  const int count = cnt_allowed[t];
  for (int i = 0; i < neff; ++i) {
    const int m = min(kChunk, count - i * kChunk);
    __syncthreads();  // the previous chunk's readers of batch and red are done
    const float4* src = reinterpret_cast<const float4*>(
        inst + (size_t)(start + i * kChunk) * kFeat);
    for (int e = threadIdx.x; e < m * (kFeat / 4); e += kThreads) batch[e] = src[e];
    const float* ck = ckpt + ((size_t)t * max_chunks + i) * npix;
    float T[PPT];
    bool done[PPT];
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      int x, y, ox, oy;
      patch_pixel<PPT>(k, pw, x, y, ox, oy);
      const float c = ck[y * pw + x];
      T[k] = fabsf(c);
      done[k] = c < 0.f;
      all_done = all_done && done[k];
    }
    __syncthreads();

    if (__all_sync(kFull, all_done)) {
      // nothing of this chunk contributes in this warp
      for (int e = lane; e < m * kTerms; e += 32) red[warp * kChunk * kTerms + e] = 0.f;
    } else {
      for (int j = 0; j < m; ++j) {
        const float* g = feats + j * kFeat;
        const Splat s = load_splat(g);
        float* slot = red + (warp * kChunk + j) * kTerms;
        bool in[PPT];
        bool any_in = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          in[k] = !rect_test || rect_holds(s, rx[k], ry[k]);  // warp-uniform
          any_in = any_in || in[k];
        }
        if (!any_in) {
          if (lane < kTerms) slot[lane] = 0.f;
          continue;
        }
        const float r = g[FR], gg = g[FG], b = g[FB2], dd = g[FD];
        float acc[kTerms];
#pragma unroll
        for (int c = 0; c < kTerms; ++c) acc[c] = 0.f;
        bool any = false;
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
          float psi = gC0[k] * r + gC1[k] * gg + gC2[k] * b + gA[k];
          if (DG) psi += gD[k] * dd;
          P[k] += w * psi;
          const float inv = 1.f / fmaxf(1.f - pr.alpha, 1e-6f);
          const float dLda = T[k] * psi - (Q[k] - P[k]) * inv;
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
          if (DG) acc[9] += gD[k] * w;
          any = true;
          T[k] = T_next;
        }
        if (__any_sync(kFull, any)) {
          const float v = reduce_scatter10(acc, lane);
          if (writer) slot[term] = v;
        } else if (lane < kTerms) {
          slot[lane] = 0.f;
        }
      }
    }

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
      const int id = (int)g[FID];
      if (id >= 0 && id < num_gaussians) {
        const float ca = g[FA], cb = g[FB], cc = g[FC];
        const float grad[kTerms] = {
            -(ca * sum[0] + cb * sum[1]),  // d mean2d.x
            -(cc * sum[1] + cb * sum[0]),  // d mean2d.y
            -0.5f * sum[2],                // d conic a
            -sum[3],                       // d conic b
            -0.5f * sum[4],                // d conic c
            sum[5],                        // d opacity
            sum[6], sum[7], sum[8],        // d rgb
            sum[9]};                       // d depth
#pragma unroll
        for (int c = 0; c < (DG ? kTerms : kTerms - 1); ++c)
          atomicAdd(out + (size_t)c * num_gaussians + id, grad[c]);
      }
    }
  }
}

// Lets the kernel take kSmemBytes of dynamic shared memory, once per
// process and instantiation.
template <int PPT, bool DG>
int allow_smem() {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_backward_kernel<PPT, DG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  return 0;
}

template <int PPT, bool DG>
int launch(const float* inst, const int* start, const int* cnt,
           const float* g_tiles, const float* fwd_tiles, const float* ckpt,
           float* out, int num_gaussians, int num_tiles, int grid_x, int pw,
           int ph, int max_chunks, int rect_test, cudaStream_t stream) {
  const int e = allow_smem<PPT, DG>();
  if (e) return e;
  tile_backward_kernel<PPT, DG><<<num_tiles, kThreads, kSmemBytes, stream>>>(
      inst, start, cnt, g_tiles, fwd_tiles, ckpt, out, num_gaussians, grid_x,
      pw, ph, max_chunks, rect_test);
  return 0;
}

template <int PPT, bool DG>
int usage(int* out) {
  const int e = allow_smem<PPT, DG>();
  return e ? e : kernel_usage(tile_backward_kernel<PPT, DG>, kThreads, kSmemBytes, out);
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error of setting the
// kernel's shared-memory size); 1 (cudaErrorInvalidValue) for a pixel block
// that is not 256..2048 pixels in whole 16x16 tiles. With rect_test the
// tile-rect columns of inst are multiples of 16, as binning makes them.
// out [16, num_gaussians] must be zeroed by the caller: the kernel adds
// into rows 0-9 (0-8 without depth_grad) at each walked instance's rank
// id; ids outside [0, num_gaussians) are skipped.
extern "C" int tile_backward(const float* inst, const int* sorted_start,
                             const int* cnt_allowed, const float* g_tiles,
                             const float* fwd_tiles, const float* ckpt,
                             float* out, int num_gaussians, int num_tiles,
                             int grid_x, int pw, int ph, int max_chunks,
                             int rect_test, int depth_grad, void* stream) {
  if (!block_ok(pw, ph)) return (int)cudaErrorInvalidValue;
  const int npix = pw * ph;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    int err = 0;
#define CASE(P)                                                                 \
  case P:                                                                       \
    err = depth_grad                                                            \
              ? launch<P, true>(inst, sorted_start, cnt_allowed, g_tiles,       \
                                fwd_tiles, ckpt, out, num_gaussians, num_tiles, \
                                grid_x, pw, ph, max_chunks, rect_test, s)       \
              : launch<P, false>(inst, sorted_start, cnt_allowed, g_tiles,      \
                                 fwd_tiles, ckpt, out, num_gaussians,           \
                                 num_tiles, grid_x, pw, ph, max_chunks,         \
                                 rect_test, s);                                 \
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

// Resource use of the kernel that a block of 256 ppt pixels launches with
// depth_grad, as the runtime reports it on the current device
// (kernel_usage.cuh); 1 (cudaErrorInvalidValue) for a ppt
// outside 1..8.
extern "C" int tile_backward_usage(int ppt, int depth_grad, int* out) {
  switch (ppt) {
#define CASE(P) \
  case P:       \
    return depth_grad ? usage<P, true>(out) : usage<P, false>(out);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
