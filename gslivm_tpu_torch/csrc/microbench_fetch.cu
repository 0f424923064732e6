// T1: chunk-fetch microbenchmark for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/microbench_roll.py:kernel (launched by its
// run() through pl.pallas_call), which measured what reading a tile's run
// from an unaligned offset costs the TPU render kernels. Here it asks the
// same question of the port's own K1 fetch (tile_forward.cu: float4 loads of
// a chunk's 128 instance rows into one shared batch, then __syncthreads).
//
// What it computes. One CUDA block per tile t sums the squares of every
// feature of the tile's nch[t] chunks of 128 rows of the row-major [L, 16]
// instance table, starting at row off[t]:
//   out[t] = sum_{i < nch[t]} sum_{c < 128} sum_{f < 16} inst[off[t] + 128 i + c, f]^2
// The fetch variants give the same sums:
//   kDirect  K1's fetch: the chunk's rows straight into one shared batch
//            (variant A at aligned offsets, B at sorted unaligned ones);
//   kAsync   cp.async into two shared buffers, so that chunk i+1 copies
//            while chunk i is summed (variant C; the TPU tool's two-slot
//            DMA);
//   kWindow  the TPU design's aligned two-chunk window: rows
//            floor(off/128)*128 + 128 i ... +256 into shared memory, the
//            chunk's rows read back at the run's phase (variant D).
//
// What bounds it. Bytes: each of the 64-byte rows of a tile's run is read
// once, and the work per byte is one multiply-add; at the tool's size
// (2,040 tiles x 4 chunks) 66.8 MB take 0.020 ms at 3.35 TB/s. The input is
// larger than the 50 MB L2, but back-to-back launches still find part of
// it there.
//
// What the design does about it. Loads are 16 bytes a thread, neighbouring
// threads on neighbouring addresses (a row is 64 bytes, so any row offset
// keeps a float4 aligned); the sum stays in registers and the block's
// partial sums meet once per tile in a fixed order (warp shuffles, then one
// thread over the warps), so the result is deterministic. The variants
// differ only in how the bytes reach shared memory, which is the question.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kFeat = 16;
constexpr int kThreads = 256;
constexpr int kVec = kChunk * kFeat / 4;  // float4s in a chunk: 512

enum Fetch { kDirect = 0, kAsync = 1, kWindow = 2 };

__device__ __forceinline__ float sq4(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the block's sum of v, returned to thread 0 (a fixed order)
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
fetch_kernel(const float* __restrict__ inst, const int* __restrict__ off,
             const int* __restrict__ nch, float* __restrict__ out, int rows) {
  // kDirect: one batch; kAsync: two; kWindow: one window of two chunks
  __shared__ float4 buf[2 * kVec];
  const int t = blockIdx.x;
  const int o = off[t];
  const int n = nch[t];
  const float4* src = reinterpret_cast<const float4*>(inst);
  float acc = 0.f;

  // the float4s [lo, hi) of chunk i that lie inside the table's rows
  // [0, rows): rows outside it count as zero
  auto lo_of = [&](int i) { return max(0, -(o + i * kChunk)) * (kFeat / 4); };
  auto hi_of = [&](int i) {
    return max(lo_of(i), min(kChunk, rows - (o + i * kChunk)) * (kFeat / 4));
  };

  if (F == kDirect) {
    for (int i = 0; i < n; ++i) {
      const float4* c = src + (ptrdiff_t)(o + i * kChunk) * (kFeat / 4);
      const int lo = lo_of(i), hi = hi_of(i);
      for (int e = lo + threadIdx.x; e < hi; e += kThreads) buf[e] = c[e];
      __syncthreads();
      for (int e = lo + threadIdx.x; e < hi; e += kThreads) acc += sq4(buf[e]);
      __syncthreads();
    }
  } else if (F == kAsync) {
    if (n > 0) {
      const float4* c = src + (ptrdiff_t)o * (kFeat / 4);
      for (int e = lo_of(0) + threadIdx.x; e < hi_of(0); e += kThreads)
        cp_async16(&buf[e], &c[e]);
      cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
      if (i + 1 < n) {
        const float4* c = src + (ptrdiff_t)(o + (i + 1) * kChunk) * (kFeat / 4);
        float4* b = buf + ((i + 1) & 1) * kVec;
        for (int e = lo_of(i + 1) + threadIdx.x; e < hi_of(i + 1); e += kThreads)
          cp_async16(&b[e], &c[e]);
        cp_async_commit();
        cp_async_wait<1>();  // chunk i has landed; chunk i+1 is in flight
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* b = buf + (i & 1) * kVec;
      for (int e = lo_of(i) + threadIdx.x; e < hi_of(i); e += kThreads) acc += sq4(b[e]);
      __syncthreads();  // buffer i&1 is refilled by the copy issued at i+1
    }
  } else {  // kWindow
    const int phase = (o % kChunk + kChunk) % kChunk;  // in [0, 128) for any o
    const int base = o - phase;
    for (int i = 0; i < n; ++i) {
      const int w0 = base + i * kChunk;
      for (int e = threadIdx.x; e < 2 * kVec; e += kThreads) {
        const int r = w0 + e / (kFeat / 4);
        buf[e] = r >= 0 && r < rows ? src[(ptrdiff_t)w0 * (kFeat / 4) + e]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      const float4* b = buf + phase * (kFeat / 4);
      for (int e = threadIdx.x; e < kVec; e += kThreads) acc += sq4(b[e]);
      __syncthreads();
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[t] = s;
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for an unknown variant. Rows of a run outside the table's [0, rows) count
// as zero, so no offset reads outside it.
extern "C" int microbench_fetch(const float* inst, const int* off, const int* nch,
                                float* out, int num_tiles, int rows, int variant,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    switch (variant) {
      case kDirect:
        fetch_kernel<kDirect><<<num_tiles, kThreads, 0, s>>>(inst, off, nch, out, rows);
        break;
      case kAsync:
        fetch_kernel<kAsync><<<num_tiles, kThreads, 0, s>>>(inst, off, nch, out, rows);
        break;
      case kWindow:
        fetch_kernel<kWindow><<<num_tiles, kThreads, 0, s>>>(inst, off, nch, out, rows);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
