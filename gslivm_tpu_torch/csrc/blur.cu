// K3: separable blur of many images for Hopper (sm_90a).
//
// Replaces the TPU kernel gslivm_tpu/ops/blur_pallas.py:_kernel (launched
// by _blur_impl through pl.pallas_call, public as blur_many).
//
// What it computes. For each [H, W] slice of x [N, H, W] (float32,
// contiguous), the zero-padded SAME separable CORRELATION with k taps
// (1 <= k <= 15), r = k / 2:
//   y[h, w] = sum_i t[i] sum_j t[j] x[h + i - r, w + j - r],
// x = 0 outside the image: the horizontal pass first, then the vertical
// one, each summed in tap order, as the plain version (blur.py:blur_plain)
// sums them. SSIM uses k = 11 asymmetric taps, so the orientation matters;
// the VJP is this kernel with the taps reversed. Even k pads (r, r) too.
//
// What bounds it. 2k flops per pass per element against 8 bytes of device
// traffic per element (one read, one write): at k = 11 ~5.5 flops per byte,
// far below the card's ~20 fp32 flops per byte, so it is bound by bytes.
//
// What the design does about it. One block of 128 threads per (slice, strip
// of `strip` output rows, 512 output columns); each thread owns 4 adjacent
// columns. The block walks its strip's input rows, the r rows above it and
// the k - 1 - r below included, top to bottom, so that each input row is
// read from device memory once per strip (the k - 1 halo rows cost
// (strip + k - 1) / strip, 1.08x at 128 rows and k = 11). Each row, with 8 zero-or-image
// columns on each side, is copied into a ring of 4 shared rows by cp.async,
// 3 rows ahead of the one being summed, so that every block keeps 3 rows of
// loads in flight; copies of pixels outside the image read nothing and write
// zeros (the cp.async source size 0). Per row a thread sums its 4 horizontal
// outputs from shared memory (float4 reads) into a ring of the last k
// horizontal rows in registers, and once k rows are in, the vertical sum of
// the ring is the output row, written as one float4. k is a template
// parameter, so both tap loops and the ring unroll and the ring's indices
// are static (the row loop is unrolled k times); the taps are kernel
// parameters, read by the FMAs from the constant bank. The float4
// instantiation needs W % 4 == 0 and 16-byte aligned x and y; any other
// shape takes the scalar one (4-byte copies and stores), chosen by the
// wrapper from the shape and pointers (blur.py:float4_rows). The strip
// height is the wrapper's too (blur.py:strip_rows): the shortest of 32, 64
// and 128 rows whose grid fits in one wave of resident blocks, so that as
// many rows of loads are in flight as the card holds and no block waits for
// a second wave. The TPU kernel's 128-row bands and lane padding of the
// width are TPU layout rules and do not carry over.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_usage.cuh"

namespace {

constexpr int kThreads = 128;           // threads a block
constexpr int kCols = 4 * kThreads;     // output columns a block: 4 a thread
constexpr int kPad = 8;                 // staged columns on each side (r <= 7)
constexpr int kRow = kCols + 2 * kPad;  // floats of one staged row
constexpr int kGran = kRow / 4;         // its 16-byte granules
constexpr int kStages = 4;              // staged rows: 3 in flight, 1 summed
constexpr int kMaxTaps = 15;

struct Taps {
  float t[kMaxTaps];
};

// 16 (or 4) bytes from global to shared memory; src_bytes 0 reads nothing
// and writes zeros
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W, int strip,
            Taps taps) {
  constexpr int R = K / 2;
  // a thread's horizontal window, columns 4 tx - R .. 4 tx + 3 + (K - 1 - R)
  // of the block, starts at float lo + off of the staged row (kPad is
  // column 0) and is read as nv float4s from lo
  constexpr int lo = (kPad - R) / 4 * 4;
  constexpr int off = kPad - R - lo;
  constexpr int nv = (off + K + 3 + 3) / 4;
  __shared__ __align__(16) float rows[kStages][kRow];

  const int tx = threadIdx.x;
  const int x0 = blockIdx.x * kCols;
  const int y0 = blockIdx.y * strip;
  const int n_out = min(strip, H - y0);
  const int n_in = n_out + K - 1;  // image rows y0 - R .. y0 + n_out - 1 + (K - 1 - R)
  const size_t plane = (size_t)H * W;
  const float* src = x + blockIdx.z * plane;
  float* dst = y + blockIdx.z * plane;
  const int col = x0 + 4 * tx;  // this thread's first output column

  // copy input row q of the strip (image row y0 - R + q) into its stage
  auto stage = [&](int q) {
    const int gy = y0 - R + q;
    const bool row_in = gy >= 0 && gy < H;
    const float* srow = src + (size_t)(row_in ? gy : 0) * W;
    float* drow = rows[q % kStages];
    for (int g = tx; g < kGran; g += kThreads) {
      const int gx = x0 - kPad + 4 * g;
      if (VEC) {  // W % 4 == 0: a granule lies wholly inside or outside
        const bool in = row_in && gx >= 0 && gx < W;
        cp_async16(drow + 4 * g, srow + (in ? gx : 0), in ? 16 : 0);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool in = row_in && gx + c >= 0 && gx + c < W;
          cp_async4(drow + 4 * g + c, srow + (in ? gx + c : 0), in ? 4 : 0);
        }
      }
    }
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n_in) stage(q);
    cp_async_commit();  // one group per row, empty or not, keeps the count
  }

  float ring[K][4];  // the horizontal sums of input rows q - K + 1 .. q
  for (int base = 0; base < n_in; base += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {  // q % K == s: the ring's indices are static
      const int q = base + s;
      if (q < n_in) {  // the same for the whole block
        cp_async_wait<kStages - 2>();  // row q has landed
        __syncthreads();               // ... for every thread; row q - 1 is read
        if (q + kStages - 1 < n_in) stage(q + kStages - 1);
        cp_async_commit();

        float v[4 * nv];
        const float4* row4 = reinterpret_cast<const float4*>(rows[q % kStages] + lo + 4 * tx);
#pragma unroll
        for (int j = 0; j < nv; ++j) {
          const float4 f = row4[j];
          v[4 * j] = f.x;
          v[4 * j + 1] = f.y;
          v[4 * j + 2] = f.z;
          v[4 * j + 3] = f.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float h = taps.t[0] * v[off + c];
#pragma unroll
          for (int i = 1; i < K; ++i) h = fmaf(taps.t[i], v[off + c + i], h);
          ring[s][c] = h;
        }

        if (q >= K - 1) {  // output row y0 + q - (K - 1) has all K rows
          float o[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o[c] = taps.t[0] * ring[(s + 1) % K][c];
#pragma unroll
            for (int i = 1; i < K; ++i) o[c] = fmaf(taps.t[i], ring[(s + 1 + i) % K][c], o[c]);
          }
          float* out = dst + (size_t)(y0 + q - (K - 1)) * W + col;
          if (VEC) {
            if (col < W) *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (col + c < W) out[c] = o[c];
          }
        }
      }
    }
  }
}

// the whole [n, h, w] stack: (w / 512) x (h / strip) x n blocks
template <int K>
int launch(const float* x, float* y, int n, int h, int w, const Taps& taps, int vec, int strip,
           cudaStream_t stream) {
  const dim3 grid((w + kCols - 1) / kCols, (h + strip - 1) / strip, n);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  if (vec) {
    blur_kernel<K, true><<<grid, kThreads, 0, stream>>>(x, y, h, w, strip, taps);
  } else {
    blur_kernel<K, false><<<grid, kThreads, 0, stream>>>(x, y, h, w, strip, taps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define BLUR_CASES(CASE)                                                              \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)   \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)

// x, y: device pointers to [n, h, w] float32; taps: HOST pointer to k
// floats (1 <= k <= 15); vec: the float4 instantiation, which needs w % 4
// == 0 and 16-byte aligned x and y; strip: output rows a block. Returns
// cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for
// arguments the kernel does not take.
extern "C" int blur_many(const float* x, float* y, int n, int h, int w, const float* taps,
                         int k, int vec, int strip, void* stream) {
  if (k < 1 || k > kMaxTaps || strip < 1) return (int)cudaErrorInvalidValue;
  if (vec && (w % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  Taps tp = {};
  for (int i = 0; i < k; ++i) tp.t[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define CASE(K) \
  case K:       \
    return launch<K>(x, y, n, h, w, tp, vec, strip, s);
    BLUR_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resource use of the instantiation that k taps and vec launch, as the
// runtime reports it on the current device (kernel_usage.cuh); 1
// (cudaErrorInvalidValue) for a k outside 1..15.
extern "C" int blur_usage(int k, int vec, int* out) {
  switch (k) {
#define CASE(K) \
  case K:       \
    return vec ? kernel_usage(blur_kernel<K, true>, kThreads, 0, out) \
               : kernel_usage(blur_kernel<K, false>, kThreads, 0, out);
    BLUR_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
