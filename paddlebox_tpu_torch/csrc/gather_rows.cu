// Row gather: out[k, :] = src[min(ids[k], C - 1), :].
//
// Replaces the TPU kernel tools/pallas_rate_probe.py: gather_kernel (called
// through pgather), which copied 8 slab rows a grid step to ask whether a
// hand-written kernel gathers rows "at the pull shape" faster than XLA.
// In the port it is also the train step's pull (ops/sparse.py:
// gather_slab_rows), the JAX main path's slab[ids]
// (paddlebox_tpu/ops/sparse.py:gather_slab_rows).
//
// Ids: an id of C or more reads row C - 1, as the JAX gather on the main
// path clamps (the trash row C - 1 and duplicate ids are ordinary inputs).
// Negative ids are not handled: the pass table never produces them. The
// probe's TPU kernel did no bounds handling at all.
//
// Design: a block takes ROWS consecutive output rows. Its first ROWS threads
// load those rows' ids once (one id a row, not one a float), clamp them and
// keep each row's source offset in shared memory. Then the block's threads
// walk the ROWS * W output floats in order, so consecutive threads write
// consecutive floats (coalesced stores) and each row's read is one
// contiguous run of W * 4 bytes. Where W % 4 == 0 and both pointers are
// 16-byte aligned (the probe's W = 128) the walk moves float4s; otherwise
// (the pull's W = 17) single floats. Offsets are 64-bit. (On an H100 at the
// pull's shape, a warp per 32 rows, each float's row offset shuffled from
// the lane that loaded the id, took 1.27x as long as this block layout.)
//
// Bound on an H100: memory. Each id is read once (4 B), each gathered row
// read once and written once (2 * W * 4 B a row); at 3.35 TB/s, 131,072 rows
// of 17 floats take about 5.5 us and of 128 floats about 40 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;

// T is float (Wt = W) or float4 (Wt = W / 4); src [C, Wt], out [K, Wt]
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ src, T* __restrict__ out,
                   const int* __restrict__ ids, int64_t K, int64_t C,
                   int Wt) {
  __shared__ int64_t s_off[ROWS];
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)(K - row0 < ROWS ? K - row0 : ROWS);
  if ((int)threadIdx.x < rows) {
    int64_t id = ids[row0 + threadIdx.x];
    if (id > C - 1) id = C - 1;
    s_off[threadIdx.x] = id * Wt;
  }
  __syncthreads();
  T* __restrict__ o = out + row0 * Wt;
  const int total = rows * Wt;
#pragma unroll 4
  for (int f = (int)threadIdx.x; f < total; f += THREADS) {
    const int r = f / Wt;
    o[f] = src[s_off[r] + (f - r * Wt)];
  }
}

}  // namespace

// src [C, W] f32, ids [K] i32 (0 <= id; ids >= C read row C - 1), out
// [K, W] f32; all contiguous on the current device, C >= 1. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int pbt_gather_rows(const float* src, const int* ids, float* out,
                               int64_t C, int64_t K, int W, void* stream) {
  const unsigned blocks = (unsigned)((K + ROWS - 1) / ROWS);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    gather_rows_kernel<float4><<<blocks, THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(out),
        ids, K, C, W / 4);
  else
    gather_rows_kernel<float><<<blocks, THREADS, 0, s>>>(src, out, ids, K, C,
                                                         W);
  return (int)cudaGetLastError();
}
