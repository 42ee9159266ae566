// Streaming scale-and-shift copy: out[i] = x[i] * 0.999f + 0.001f.
//
// Replaces the TPU kernel tools/pallas_rate_probe.py: copy_kernel (wrapper
// pallas_scale), which streams [n, 128] f32 through 1024-row blocks to ask
// whether a hand-written kernel runs at the memory's rate.
//
// Rounding: the Pallas source is a multiply and then an add. Run
// interpreted on XLA:CPU, which contracts the two into a fused
// multiply-add, it gives the exact x * 0.999f + 0.001f rounded once to f32
// (jitted XLA on the CPU gives the same bits). What the TPU's lowering
// rounds was not observed. This kernel matches the interpreted kernel: it
// calls __fmaf_rn, which --fmad=false leaves as it is; the plain version
// (ops/row_kernels.py) emulates the single rounding in f64.
//
// Design: one pass over the flat array, UNROLL 16-byte vectors a thread
// when both pointers are 16-byte aligned, UNROLL floats otherwise. A block
// covers THREADS x UNROLL consecutive items, one grid step covering them
// all, so a warp's loads stay contiguous; a thread issues all its loads
// before it stores, so several loads a thread are in flight. The floats
// past the last vector (n % 4 of them) go one a thread in the same way.
//
// Bound on an H100: memory. Each float is read once and written once
// (8 bytes an element, 2 flops); at 3.35 TB/s a [131072, 128] array takes
// about 40 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__device__ __forceinline__ float scale(float v) {
  return __fmaf_rn(v, 0.999f, 0.001f);
}

__global__ void __launch_bounds__(THREADS)
scale_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int64_t n, int64_t n_vec) {
  const int64_t base = (int64_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
  float4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) v[u] = x4[i];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = base + u * THREADS;
    if (i < n_vec) {
      v[u].x = scale(v[u].x);
      v[u].y = scale(v[u].y);
      v[u].z = scale(v[u].z);
      v[u].w = scale(v[u].w);
      o4[i] = v[u];
    }
  }
  // floats not covered by the vectors: all of them when unaligned
  float f[UNROLL];
  const int64_t first = n_vec * 4 + base;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i < n) f[u] = x[i];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i < n) out[i] = scale(f[u]);
  }
}

}  // namespace

// x, out: n contiguous f32 on the current device. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int pbt_scale_copy(const float* x, float* out, int64_t n,
                              void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t n_vec = aligned ? n / 4 : 0;
  const int64_t items = n_vec > n - n_vec * 4 ? n_vec : n - n_vec * 4;
  const int64_t per_block = (int64_t)THREADS * UNROLL;
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  scale_copy_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, out, n, n_vec);
  return (int)cudaGetLastError();
}
