// Row gather: out[k, :] = src[clamp(ids[k], 0, C - 1), :].
//
// Replaces the TPU kernel tools/pallas_rate_probe.py: gather_kernel (called
// through pgather), which copied 8 slab rows a grid step to ask whether a
// hand-written kernel gathers rows "at the pull shape" faster than XLA.
// In the port it is also the train step's pull (ops/sparse.py:
// gather_slab_rows), the JAX main path's slab[ids]
// (paddlebox_tpu/ops/sparse.py:gather_slab_rows).
//
// Ids: an id of C or more reads row C - 1, as the JAX gather on the main
// path clamps (the trash row C - 1 and duplicate ids are ordinary inputs),
// and a negative id reads row 0, so no int32 id reads outside the source.
// The pass table never produces a negative id; the public pull
// (ops/sparse.py pull_sparse) wraps ids in [-C, 0) to id + C before the
// gather, as JAX's indexing does, and an id below -C then reads row 0, as
// JAX's gather clamps. The probe's TPU kernel did no bounds handling at
// all.
//
// Bound on an H100: memory. Each id is read once (4 B), each gathered row
// read once and written once (2 * W * 4 B a row); at 3.35 TB/s, the pull's
// 131,072 rows of 17 floats over 77,128 distinct rows (14.7 MB) take about
// 4.4 us, and the probe's 131,072 rows of 128 floats about 40 us. Counted by
// the 32-byte sectors the accesses touch (a 68-byte row always spans 3), the
// pull moves about 16.8 MB: 0.5 MB of ids, 7.4 MB for the distinct rows,
// 8.9 MB of output, about 5.0 us. At that size the card's floors dominate:
// in a chain of launches a launch with no work takes about 3 us, and a
// streaming copy of the same 14.7 MB about 8.6 us (copy_probe.py floors,
// PERF.md), so the pull is bound by that floor and by the random sectors of
// its reads, not by overfetch.
//
// Design (narrow rows, the pull): persistent blocks, as many as fit on the
// card, walk tiles of R consecutive output rows (R % 4 == 0); at the pull
// (2,048 tiles, 12 blocks an SM) a block takes one or two. A tile's ids are
// in shared memory when the tile starts: the next tile's ids load with
// cp.async while this tile's rows are in flight. The tile's rows are staged
// in shared memory with cp.async, thread l taking flattened elements l,
// l + THREADS, ... (a warp's loads cover about two contiguous 68-byte rows),
// so every load of the tile is in flight before the block waits. The
// output tile is one contiguous run of R * W floats: one thread writes it
// with a single bulk asynchronous copy (cp.async.bulk, shared to global),
// which overlaps the next tile's loads; the row buffers are double so the
// next tile may stage while the copy reads. A partial last tile, or an
// output that is not 16-byte aligned, is written by the threads. Where
// W % 4 == 0 and both pointers are 16-byte aligned the elements are float4
// (16-byte cp.async), else single floats (4-byte cp.async): any alignment
// is handled.
//
// Wide rows (WIDE_FLOATS floats or more, the rate probe's 512-byte rows)
// take the direct path, the port's first design: a block of DIRECT_ROWS
// rows loads its ids once into shared memory and its threads walk the
// output floats (float4 where W % 4 == 0 and aligned) with loads straight
// to registers. A row there is 16 whole sectors, and this path runs at 80%
// of the bound; staging such rows, 32 a tile, was slower.
//
// On an H100 80GB HBM3 at 700 W (copy_probe.py, the earlier design and this
// one in one call, PERF.md §6): the pull 0.0104 ms against 0.0107 for a
// block of 64 rows a launch, ids loaded before the rows and the rows copied
// through registers, and 0.0130 for index_select; the probe's shape 0.0503
// ms either way. Tiles of 32 or 128 rows, 256 threads a block, or a grid of
// two or four blocks an SM were slower at the pull; a warp per 32 rows with
// shuffled offsets had taken 1.27x as long as the block of 64 rows.
//
// The 2-byte forms (the bf16 slab diet, embedding/accessor.py: a slab of
// int16 columns holding bf16 weights and (hi, lo) halves of the other
// f32 columns). The TPU gather is dtype-free, and the reference moves
// resident rows through it as raw 2-byte bits (the promote and the
// write-back) and decodes them at every pull. Two entries:
//   pbt_gather_rows_2byte   out[k] = src[clamp(ids[k], 0, C - 1)], raw bits;
//   pbt_gather_rows_decode  the same rows decoded to f32 (the pull): out
//                           [K, WL] f32, column c = (hi << 16 | lo) of the
//                           row's device columns hi_pos[c] and lo_pos[c]
//                           (lo_pos -1: a bf16 column, low bits zero).
// Bound on an H100: memory, as for f32. At the flagship pull (device width
// 25, 131,072 ids over 77,128 distinct rows) the raw gather moves 0.52 MB
// of ids, 3.86 MB of distinct rows read and 6.55 MB written, 10.9 MB, 3.3
// us at 3.35 TB/s; the decoding gather writes 17 f32 columns instead of 25
// int16 (8.9 MB), 13.3 MB, 4.0 us, against the separate decode's extra
// read and write of the rows through PyTorch ops.
// Design: the staged tiles of the f32 path (R rows, the next tile's ids by
// cp.async while this tile's rows load, the tile written as one bulk copy
// in the raw form), but a row of an odd width starts 4-byte aligned only
// on every other row and cp.async moves 4, 8 or 16 bytes, never 2: the
// rows' 2-byte elements load through registers, UNROLL2 loads in flight a
// thread before their stores to shared memory. R x W x 2 bytes is a
// multiple of 16 for R = 64 and any W, so every full tile bulk-stores. The
// decoding form writes its f32 tile with the threads, coalesced. Every
// width takes this kernel, up to the shared memory a block may hold (2 * R
// rows of W elements); the bf16 slab's device widths (17 + D, D 2..64) are
// odd and at most 81.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int THREADS = 128;         // a block of the staged path
constexpr int R = 64;                // rows a staged tile; R % 4 == 0
constexpr int WIDE_FLOATS = 128;     // rows this wide take the direct path
constexpr int DIRECT_THREADS = 256;  // a block of the direct path
constexpr int DIRECT_ROWS = 64;      // rows a block of the direct path

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async(float4* s, const float4* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async(int* s, const int* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [k0, k0 + rows) of ids into s_ids
__device__ __forceinline__ void stage_ids(int* s_ids, const int* ids,
                                          int64_t k0, int rows) {
  for (int r = threadIdx.x; r < rows; r += THREADS)
    cp_async(s_ids + r, ids + k0 + r);
}

// T is float (Wt = W) or float4 (Wt = W / 4); src [C, Wt], out [K, Wt].
// Shared memory: ids [2][R] ints, then rows [2][R * Wt] T.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ src, T* __restrict__ out,
                   const int* __restrict__ ids, int64_t K, int64_t C, int Wt,
                   int64_t n_tiles, bool bulk_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);
  T* s_rows = reinterpret_cast<T*>(smem + 2 * R * sizeof(int));
  const int t = threadIdx.x;
  // a thread's elements step by THREADS = q rows and m columns
  const int q = THREADS / Wt, m = THREADS - q * Wt;
  const int r0 = t / Wt, c0 = t - r0 * Wt;

  int64_t tile = blockIdx.x;
  stage_ids(s_ids, ids, tile * R, (int)(K - tile * R < R ? K - tile * R : R));
  cp_async_wait_all();
  __syncthreads();
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    const int64_t k0 = tile * R;
    const int rows = (int)(K - k0 < R ? K - k0 : R);
    const int n = rows * Wt;
    const int* si = s_ids + b * R;
    T* s = s_rows + b * R * Wt;
    // (1) the tile's rows into shared memory, every load in flight
    int r = r0, c = c0;
    for (int f = t; f < n; f += THREADS) {
      int64_t id = si[r];
      id = id < 0 ? 0 : (id > C - 1 ? C - 1 : id);
      cp_async(s + f, src + id * Wt + c);
      r += q;
      c += m;
      if (c >= Wt) {
        c -= Wt;
        ++r;
      }
    }
    // (2) the next tile's ids, in flight with the rows
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      stage_ids(s_ids + (b ^ 1) * R, ids, next * R,
                (int)(K - next * R < R ? K - next * R : R));
    cp_async_wait_all();
    // (3) the tile out as one contiguous run
    T* o = out + k0 * Wt;
    if (bulk_out && rows == R) {
      // the staged rows (written by cp.async, the generic proxy) become
      // visible to the bulk copy (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            "cp.async.bulk.commit_group;\n"
            // this buffer is staged again two tiles on: its read is done
            // before thread 0 reaches the next tile's barrier
            "cp.async.bulk.wait_group.read 0;\n" ::"l"(o),
            "r"(smem_u32(s)), "r"((unsigned)(R * Wt * sizeof(T)))
            : "memory");
      }
    } else {
      __syncthreads();
      for (int f = t; f < n; f += THREADS) o[f] = s[f];
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The direct path for wide rows: a block of DIRECT_ROWS rows, ids first.
template <typename T>
__global__ void __launch_bounds__(DIRECT_THREADS)
gather_rows_kernel_direct(const T* __restrict__ src, T* __restrict__ out,
                          const int* __restrict__ ids, int64_t K, int64_t C,
                          int Wt) {
  __shared__ int64_t s_off[DIRECT_ROWS];
  const int64_t row0 = (int64_t)blockIdx.x * DIRECT_ROWS;
  const int rows =
      (int)(K - row0 < DIRECT_ROWS ? K - row0 : DIRECT_ROWS);
  if ((int)threadIdx.x < rows) {
    int64_t id = ids[row0 + threadIdx.x];
    id = id < 0 ? 0 : (id > C - 1 ? C - 1 : id);
    s_off[threadIdx.x] = id * Wt;
  }
  __syncthreads();
  T* __restrict__ o = out + row0 * Wt;
  const int total = rows * Wt;
#pragma unroll 4
  for (int f = (int)threadIdx.x; f < total; f += DIRECT_THREADS) {
    const int r = f / Wt;
    o[f] = src[s_off[r] + (f - r * Wt)];
  }
}

// The 2-byte staged path. Kept in a kernel parameter: each logical column's
// device columns (the codec plan); lo -1 marks a bf16 column.
constexpr int MAX_DECODE_COLS = 128;
constexpr int UNROLL2 = 8;
struct DecodePlan {
  short hi[MAX_DECODE_COLS];
  short lo[MAX_DECODE_COLS];
};

// src [C, W] 2-byte, out [K, W] 2-byte (DECODE false) or [K, WL] f32
// (DECODE true). Shared memory: ids [2][R] ints, then rows [2][R * W]
// 2-byte elements.
template <bool DECODE>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel_2byte(const uint16_t* __restrict__ src,
                         void* __restrict__ out_v,
                         const int* __restrict__ ids, int64_t K, int64_t C,
                         int W, int WL, int64_t n_tiles, bool bulk_out,
                         DecodePlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_ids = reinterpret_cast<int*>(smem);
  uint16_t* s_rows = reinterpret_cast<uint16_t*>(smem + 2 * R * sizeof(int));
  // the plan in shared memory: the threads of a warp read different
  // columns' entries, which a kernel parameter would serve one at a time
  __shared__ short s_hi[MAX_DECODE_COLS], s_lo[MAX_DECODE_COLS];
  const int t = threadIdx.x;
  const int q = THREADS / W, m = THREADS - q * W;
  const int r0 = t / W, c0 = t - r0 * W;
  if (DECODE)
    for (int c = t; c < WL; c += THREADS) {
      s_hi[c] = plan.hi[c];
      s_lo[c] = plan.lo[c];
    }

  int64_t tile = blockIdx.x;
  stage_ids(s_ids, ids, tile * R, (int)(K - tile * R < R ? K - tile * R : R));
  cp_async_wait_all();
  __syncthreads();
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    const int64_t k0 = tile * R;
    const int rows = (int)(K - k0 < R ? K - k0 : R);
    const int n = rows * W;
    const int* si = s_ids + b * R;
    uint16_t* s = s_rows + b * R * W;
    // (1) the next tile's ids in flight while this tile's rows load
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      stage_ids(s_ids + (b ^ 1) * R, ids, next * R,
                (int)(K - next * R < R ? K - next * R : R));
    // (2) the tile's rows into shared memory, UNROLL2 loads a thread in
    // flight before their stores
    int r = r0, c = c0;
    for (int f0 = t; f0 < n; f0 += UNROLL2 * THREADS) {
      uint16_t v[UNROLL2];
#pragma unroll
      for (int u = 0; u < UNROLL2; ++u) {
        if (f0 + u * THREADS < n) {
          int64_t id = si[r];
          id = id < 0 ? 0 : (id > C - 1 ? C - 1 : id);
          v[u] = __ldg(src + id * W + c);
        }
        r += q;
        c += m;
        if (c >= W) {
          c -= W;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL2; ++u)
        if (f0 + u * THREADS < n) s[f0 + u * THREADS] = v[u];
    }
    cp_async_wait_all();
    // (3) the tile out
    if (DECODE) {
      __syncthreads();
      uint32_t* o = reinterpret_cast<uint32_t*>(out_v) + k0 * WL;
      int rr = t / WL, cc = t - (t / WL) * WL;
      const int qd = THREADS / WL, md = THREADS - qd * WL;
      for (int f = t; f < rows * WL; f += THREADS) {
        const uint16_t* row = s + rr * W;
        const int lo = s_lo[cc];
        o[f] = ((uint32_t)row[s_hi[cc]] << 16) |
               (lo < 0 ? 0u : (uint32_t)row[lo]);
        rr += qd;
        cc += md;
        if (cc >= WL) {
          cc -= WL;
          ++rr;
        }
      }
      // this buffer is staged again two tiles on, after the next tile's
      // barrier
    } else {
      uint16_t* o = reinterpret_cast<uint16_t*>(out_v) + k0 * W;
      if (bulk_out && rows == R) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (t == 0) {
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              "cp.async.bulk.commit_group;\n"
              "cp.async.bulk.wait_group.read 0;\n" ::"l"(o),
              "r"(smem_u32(s)), "r"((unsigned)(R * W * sizeof(uint16_t)))
              : "memory");
        }
      } else {
        __syncthreads();
        for (int f = t; f < n; f += THREADS) o[f] = s[f];
      }
    }
  }
  if (!DECODE && t == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Blocks of gather_rows_kernel<T> with `smem` bytes of shared memory that
// fit on device `dev` at once (SM count times blocks an SM), into *fit.
// Worked out on a device's first launch at each width, with the shared
// memory attribute set there, and kept: a launch then costs no query.
template <typename T>
cudaError_t staged_fit(int dev, int Wt, size_t smem, int64_t* fit) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int64_t> known;  // (dev, Wt)
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, Wt);
  const auto it = known.find(key);
  if (it != known.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(gather_rows_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rows_kernel<T>, THREADS, smem);
  if (e != cudaSuccess) return e;
  *fit = known[key] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// W floats a row, Wt = W * 4 / sizeof(T) elements. The staged grid is as
// many blocks as fit on the current device at once, or one a tile.
template <typename T>
int launch(const T* src, const int* ids, T* out, int64_t C, int64_t K, int W,
           cudaStream_t s) {
  const int Wt = W * 4 / (int)sizeof(T);
  if (W >= WIDE_FLOATS) {
    const unsigned blocks = (unsigned)((K + DIRECT_ROWS - 1) / DIRECT_ROWS);
    gather_rows_kernel_direct<T><<<blocks, DIRECT_THREADS, 0, s>>>(
        src, out, ids, K, C, Wt);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * R * sizeof(int) + 2 * (size_t)R * Wt * sizeof(T);
  const int64_t n_tiles = (K + R - 1) / R;
  int dev = 0;
  int64_t fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = staged_fit<T>(dev, Wt, smem, &fit);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = n_tiles < fit ? n_tiles : fit;
  const bool bulk_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  gather_rows_kernel<T><<<(unsigned)grid, THREADS, smem, s>>>(
      src, out, ids, K, C, Wt, n_tiles, bulk_out);
  return (int)cudaGetLastError();
}

// Blocks of gather_rows_kernel_2byte<DECODE> at row width W that fit on
// device `dev` at once, worked out at a device's first launch at a width.
template <bool DECODE>
cudaError_t staged_fit_2byte(int dev, int W, size_t smem, int64_t* fit) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int64_t> known;  // (dev, W)
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, W);
  const auto it = known.find(key);
  if (it != known.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(gather_rows_kernel_2byte<DECODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rows_kernel_2byte<DECODE>, THREADS, smem);
  if (e != cudaSuccess) return e;
  *fit = known[key] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <bool DECODE>
int launch_2byte(const uint16_t* src, const int* ids, void* out, int64_t C,
                 int64_t K, int W, int WL, const DecodePlan& plan,
                 cudaStream_t s) {
  const size_t smem = 2 * R * sizeof(int) + 2 * (size_t)R * W * 2;
  const int64_t n_tiles = (K + R - 1) / R;
  int dev = 0;
  int64_t fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = staged_fit_2byte<DECODE>(dev, W, smem, &fit);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = n_tiles < fit ? n_tiles : fit;
  const bool bulk_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  gather_rows_kernel_2byte<DECODE><<<(unsigned)grid, THREADS, smem, s>>>(
      src, out, ids, K, C, W, WL, n_tiles, bulk_out, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// src [C, W] f32, ids [K] i32 (ids < 0 read row 0, ids >= C row C - 1), out
// [K, W] f32; all contiguous on the current device, C >= 1. Launches on
// `stream`; returns cudaGetLastError() (or the error of sizing the grid).
extern "C" int pbt_gather_rows(const float* src, const int* ids, float* out,
                               int64_t C, int64_t K, int W, void* stream) {
  if (K <= 0 || W <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    return launch<float4>(reinterpret_cast<const float4*>(src), ids,
                          reinterpret_cast<float4*>(out), C, K, W, s);
  return launch<float>(src, ids, out, C, K, W, s);
}

// src [C, W] 2-byte elements (the bf16 slab's int16 bits), ids [K] i32
// (ids < 0 read row 0, ids >= C row C - 1), out [K, W] 2-byte; all
// contiguous on the current device, C >= 1. A pure copy of the bits.
// Launches on `stream`; returns cudaGetLastError() (or the error of sizing
// the grid).
extern "C" int pbt_gather_rows_2byte(const uint16_t* src, const int* ids,
                                     uint16_t* out, int64_t C, int64_t K,
                                     int W, void* stream) {
  if (K <= 0 || W <= 0) return 0;
  return launch_2byte<false>(src, ids, out, C, K, W, 0, DecodePlan(),
                             (cudaStream_t)stream);
}

// The same gather decoded to f32 rows: out [K, WL] f32 with out[k, c] the
// bits (src[id, hi_pos[c]] << 16) | (lo_pos[c] < 0 ? 0 : src[id,
// lo_pos[c]]) for id = clamp(ids[k], 0, C - 1). `plan_host` points at 2 * WL
// host ints, hi_pos then lo_pos, each below W; WL <= 128 (else
// cudaErrorInvalidValue).
extern "C" int pbt_gather_rows_decode(const uint16_t* src, const int* ids,
                                      float* out, int64_t C, int64_t K,
                                      int W, int WL, const int* plan_host,
                                      void* stream) {
  if (K <= 0 || W <= 0 || WL <= 0) return 0;
  if (WL > MAX_DECODE_COLS) return (int)cudaErrorInvalidValue;
  DecodePlan plan;
  for (int c = 0; c < WL; ++c) {
    plan.hi[c] = (short)plan_host[c];
    plan.lo[c] = (short)plan_host[WL + c];
  }
  return launch_2byte<true>(src, ids, out, C, K, W, WL, plan,
                            (cudaStream_t)stream);
}
