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
// Bound on an H100: memory. Each float is read once and written once
// (8 bytes an element, 2 flops); at 3.35 TB/s a [131072, 128] array
// (64 MiB) takes about 40 us, a [524288, 128] one about 160 us.
//
// Design: one 16-byte vector a thread, one-shot blocks of THREADS threads
// (4 KiB a block), loads and stores with the streaming hint (ld/st
// .global.cs: evict first). Measured on an H100 80GB HBM3 at 700 W against
// earlier designs and torch.add (rate_probe.py --scale-balanced on each
// design's checkout, copy_probe.py --tree; PERF.md §6):
//
//  * The streaming store hint closes most of the gap to torch.add: the
//    earlier design (256 threads x 4 vectors, default cache policy) took
//    1.02x torch.add's time at 64 MiB, and 0.995x with both hints; loads
//    hinted but stores not took 1.02x. Written lines that stay in L2 at
//    normal priority evict lines the stream still needs.
//  * Less work a block wins at 256 MiB: with the hints, 8 vectors a thread
//    took 1.002-1.004x torch.add's time there, 2 a thread 0.997x and 1 a
//    thread 0.993-0.995x; at 64 MiB all took 0.987-0.996x.
//  * A persistent grid loses: as many blocks as fit, each walking its
//    share of the tiles (strided or contiguous), took 1.05-1.06x torch.add
//    whether it was fed by a ring of 1-D bulk async copies (cp.async.bulk
//    into shared memory on mbarriers, bulk stores out) or by registers.
//    One-shot blocks are handed to SMs as they free up; a fixed share per
//    block waits for the slowest SM.
//  * Bulk async copies bring nothing over registers here: one-shot blocks
//    of one 16 KiB tile, bulk load and evict-first bulk store, ran at
//    torch.add's time. The kernel is bound by the memory, not by issuing
//    loads.
//
// Alignment: the vector body needs x and out 16-byte aligned at the same
// element. When they share their alignment mod 16, block 0's threads take
// the 0-3 floats before the first aligned element and the last 0-3. When
// they do not (the wrapper's out is always aligned; x may be a view one
// float into its buffer), scale_copy_kernel_shifted writes aligned float4s
// of out, each from an aligned float4 load of x and the next lane's,
// shifted by the floats between the two alignments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SHIFT_UNROLL = 4;   // float4s a thread of the shifted path

__device__ __forceinline__ float scale(float v) {
  return __fmaf_rn(v, 0.999f, 0.001f);
}

__device__ __forceinline__ float4 scale4(float4 v) {
  return make_float4(scale(v.x), scale(v.y), scale(v.z), scale(v.w));
}

// x, out: n floats with the same alignment mod 16; x + head and out + head
// are 16-byte aligned, n_vec float4s follow, then n - head - 4 * n_vec
// floats (at most 3).
__global__ void __launch_bounds__(THREADS)
scale_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int64_t n, int head, int64_t n_vec) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + 4 * n_vec;
    if (t < head) out[t] = scale(x[t]);
    if (t < n - tail0) out[tail0 + t] = scale(x[tail0 + t]);
  }
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out + head);
  const int64_t i = (int64_t)blockIdx.x * THREADS + t;
  if (i < n_vec) __stcs(o4 + i, scale4(__ldcs(x4 + i)));
}

// concat(a, b)[S .. S + 3]
template <int S>
__device__ __forceinline__ float4 take(float4 a, float4 b) {
  if (S == 1) return make_float4(a.y, a.z, a.w, b.x);
  if (S == 2) return make_float4(a.z, a.w, b.x, b.y);
  return make_float4(a.w, b.x, b.y, b.z);
}

// x and out differ in alignment mod 16. out + head is 16-byte aligned and
// x + head sits S floats past a 16-byte boundary (S in 1..3). Float4 k of
// out's body takes floats S.. of aligned x chunks k and k + 1; chunk k is
// lane-local, chunk k + 1 comes from the next lane (lane 31 takes lane 0's
// next chunk, and lane 0 loads the chunk past the warp's last). Each
// loaded chunk holds at least one float of x (chunk 0 holds x[head], chunk
// n_vec holds x[head + 4 * n_vec - S]), so no load leaves x's 16-byte
// granules.
template <int S>
__global__ void __launch_bounds__(THREADS)
scale_copy_kernel_shifted(const float* __restrict__ x,
                          float* __restrict__ out, int64_t n, int head,
                          int64_t n_vec) {
  const int t = threadIdx.x;
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + 4 * n_vec;   // at most 3 floats each side
    if (t < head) out[t] = scale(x[t]);
    if (t < n - tail0) out[tail0 + t] = scale(x[tail0 + t]);
  }
  const float4* __restrict__ xa =
      reinterpret_cast<const float4*>(x + head - S);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out + head);
  const int lane = t & 31;
  // the warp's float4s: SHIFT_UNROLL runs of 32 (the test is warp-uniform)
  const int64_t k0 =
      ((int64_t)blockIdx.x * (THREADS / 32) + (t >> 5)) * 32 * SHIFT_UNROLL;
  if (k0 >= n_vec) return;
  float4 a[SHIFT_UNROLL + 1];
#pragma unroll
  for (int u = 0; u <= SHIFT_UNROLL; ++u) {
    const int64_t k = k0 + u * 32 + lane;
    a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((u < SHIFT_UNROLL || lane == 0) && k <= n_vec) a[u] = __ldcs(xa + k);
  }
#pragma unroll
  for (int u = 0; u < SHIFT_UNROLL; ++u) {
    const float4 next = lane == 0 ? a[u + 1] : a[u];
    const int src = (lane + 1) & 31;
    float4 b;
    b.x = __shfl_sync(0xffffffffu, next.x, src);
    b.y = __shfl_sync(0xffffffffu, next.y, src);
    b.z = __shfl_sync(0xffffffffu, next.z, src);
    b.w = __shfl_sync(0xffffffffu, next.w, src);
    const int64_t k = k0 + u * 32 + lane;
    if (k < n_vec) __stcs(o4 + k, scale4(take<S>(a[u], b)));
  }
}

template <int S>
int launch_shifted(const float* x, float* out, int64_t n, int head,
                   cudaStream_t st) {
  const int64_t n_vec = (n - head) / 4;
  const int64_t per_block = (int64_t)THREADS * SHIFT_UNROLL;
  int64_t grid = (n_vec + per_block - 1) / per_block;
  if (grid < 1) grid = 1;
  scale_copy_kernel_shifted<S><<<(unsigned)grid, THREADS, 0, st>>>(
      x, out, n, head, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n contiguous f32 on the current device, any 4-byte alignment.
// Launches one kernel on `stream`; returns cudaGetLastError().
extern "C" int pbt_scale_copy(const float* x, float* out, int64_t n,
                              void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t xu = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ou = reinterpret_cast<uintptr_t>(out);
  // floats before out's first 16-byte boundary
  int64_t head = (int64_t)(((16 - (ou & 15)) & 15) >> 2);
  if (head > n) head = n;
  if (((xu ^ ou) & 15) != 0) {
    switch (((xu + 4 * head) & 15) >> 2) {
      case 1: return launch_shifted<1>(x, out, n, (int)head, st);
      case 2: return launch_shifted<2>(x, out, n, (int)head, st);
      default: return launch_shifted<3>(x, out, n, (int)head, st);
    }
  }
  const int64_t n_vec = (n - head) / 4;
  int64_t grid = (n_vec + THREADS - 1) / THREADS;
  if (grid < 1) grid = 1;
  scale_copy_kernel<<<(unsigned)grid, THREADS, 0, st>>>(x, out, n, (int)head,
                                                         n_vec);
  return (int)cudaGetLastError();
}
