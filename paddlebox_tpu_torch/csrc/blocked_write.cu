// Blocked slab placement of the updated push rows, in place.
//
// Replaces the TPU kernel paddlebox_tpu/embedding/pallas_push.py:
// _blocked_write_kernel (wrapper pallas_blocked_write). For each touched
// block slot i and lane r with row_map[i, r] >= 0:
//     slab[blk_idx[i] * B + r, :] = new_rows[row_map[i, r], :]
// Lanes with row_map < 0 keep the slab's bits.
//
// Bound on an H100: memory. row_map is read once (4 B a lane) and each
// placed row is read from new_rows and written to the slab once (2 * W * 4 B
// a placed row): 14.7 MB at NB = B = 1024 with 77,128 rows of 17 floats
// placed, 4.4 us at 3.35 TB/s. Counted by the 32-byte sectors the accesses
// touch it is about 16.8 MB (4.2 MB of row_map, 5.2 MB of contiguous
// new_rows, 3 sectors for each 68-byte slab row), 5.0 us. What costs more
// is that the first and last sector of each written row are written in
// part: the same rows written to whole sectors (each slot's placed lanes
// moved to its first lanes) take a sixth less time, and index_copy_ of
// the same rows to consecutive rows a third less (copy_probe.py floors,
// PERF.md).
//
// Design: the flat row map (NB * B entries) is cut into tiles of TILE
// entries; persistent blocks, as many as fit on the card, walk the tiles
// (at the flagship, 1,024 tiles and 4 blocks an SM: two tiles a block). (1) A tile's row
// map entries and the blk_idx of the slots it covers are staged in shared
// memory with cp.async (16 bytes a thread where the row map is 16-byte
// aligned). There are two stage buffers: the next tile's entries are in
// flight while this tile's rows are copied. (2) The block compacts the
// tile's placed lanes into (source row, slab row) pairs in shared memory,
// in lane order: each thread counts its PER_THREAD entries, a warp scan
// (shuffles) and the warps' totals in shared memory give each thread its
// rank. As it places a pair, the thread prefetches the slab row's first and
// last sectors into L2, so the partial writes find them there. (3) The
// block copies the p placed rows as one flattened run of p * W floats,
// thread l taking floats l, l + THREADS, ..., UNROLL loads in flight before
// their stores. With sorted uids a slot's sources are consecutive rows of
// new_rows and these reads coalesce; any row_map gives the same result. A
// tile with no placed lane (a sentinel slot) costs its row map read and
// writes nothing. B and W are run-time values; a tile may straddle slots.
//
// On an H100 80GB HBM3 at 700 W (copy_probe.py, the earlier design and this
// one in one call, PERF.md §6): 0.0144 ms against 0.0158 for the port's
// first design (a warp per 32 lanes, its placed rows copied through
// registers after a ballot, two dependent trips to memory a warp) and
// 0.0156 for index_copy_ of the same rows. The same design without the L2
// prefetch was slower, and so were prefetching every sector of the row,
// loading the old value before each store, 128 threads a block, 4 or 16
// loads in flight, or two blocks an SM.
//
// The 2-byte form (the bf16 slab diet's int16 slab; the TPU kernel takes a
// slab of any dtype, pallas_push.py:137) is the same kernel over 2-byte
// elements: it moves bits and reads nothing back, so the width of an
// element changes no step. At the flagship shape (device width 25) it
// moves 11.9 MB (4.2 MB of row_map, 3.86 MB of rows read and as many
// written), 3.6 us at 3.35 TB/s. A 50-byte row starts 4-byte aligned only
// on even rows: the copy is element-wise, 2-byte loads and stores, and the
// partly written sectors at a row's edges are 2-byte granular.
//
// The Pallas grid ran its blocks in sequence and re-read each aliased block
// before overlaying it, so a sentinel slot clamped onto the last block had
// to be ordered before that block's real write (optimizers.py:443-456,
// pallas_push.py:111-120). This kernel never reads the slab back: a lane
// with row_map < 0 writes nothing, so sentinel slots (all lanes -1) are
// no-ops whatever order the tiles run in, and real slots address distinct
// rows. The ordering invariant has nothing left to protect here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 4;                 // row map entries a thread
constexpr int TILE = THREADS * PER_THREAD;    // row map entries a tile
constexpr int UNROLL = 8;                     // loads before their stores
static_assert(PER_THREAD == 4, "a thread reads its entries as one int4");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(int* s, const int* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(int* s, const int* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* g) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(g));
}

struct Stage {
  int map[TILE];   // the tile's row map entries (-1 past the last lane)
  int blk[TILE];   // blk_idx of the slots the tile covers, from its first
};

// Tile `tile`'s row map entries and slot block ids into `st` (cp.async,
// committed by the caller).
__device__ __forceinline__ void stage_tile(Stage& st, const int* row_map,
                                           const int* blk_idx,
                                           int64_t n_lanes, int B,
                                           int64_t tile, bool vec_map) {
  const int64_t e0 = tile * TILE;
  const int n = (int)(n_lanes - e0 < TILE ? n_lanes - e0 : TILE);
  const int j = threadIdx.x * PER_THREAD;
  if (vec_map && j + PER_THREAD <= n) {
    cp_async16(st.map + j, row_map + e0 + j);
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (j + k < n)
        cp_async4(st.map + j + k, row_map + e0 + j + k);
      else
        st.map[j + k] = -1;
    }
  }
  const int64_t first = e0 / B;
  const int slots = (int)((e0 + n - 1) / B - first + 1);
  for (int s = threadIdx.x; s < slots; s += THREADS)
    cp_async4(st.blk + s, blk_idx + first + s);
}

// T: float (the f32 slab) or uint16_t (the 2-byte slab).
template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_write_kernel(T* __restrict__ slab,
                     const T* __restrict__ new_rows,
                     const int* __restrict__ row_map,
                     const int* __restrict__ blk_idx, int64_t n_lanes, int B,
                     int W, int64_t n_tiles, bool vec_map) {
  __shared__ __align__(16) Stage st[2];
  __shared__ int s_src[TILE];        // placed lanes' source rows, in order
  __shared__ int64_t s_dst[TILE];    // and their slab rows
  __shared__ int s_warp[WARPS];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // a thread's copy floats step by THREADS = q rows and m columns
  const int q = THREADS / W, m = THREADS - q * W;
  const int r0 = t / W, c0 = t - r0 * W;

  int64_t tile = blockIdx.x;
  stage_tile(st[0], row_map, blk_idx, n_lanes, B, tile, vec_map);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    // (1) the next tile's entries in flight; wait for this tile's
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles)
      stage_tile(st[b ^ 1], row_map, blk_idx, n_lanes, B, next, vec_map);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::
                     : "memory");
    __syncthreads();

    // (2) compact the placed lanes: thread t holds entries t * PER_THREAD..
    const int4 mv = *reinterpret_cast<const int4*>(st[b].map + t * PER_THREAD);
    const int mk[PER_THREAD] = {mv.x, mv.y, mv.z, mv.w};
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) cnt += mk[k] >= 0;
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[w] = incl;
    __syncthreads();
    int pos = incl - cnt, p = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int v = s_warp[k];
      pos += k < w ? v : 0;
      p += v;
    }
    if (cnt) {
      const int64_t e = tile * TILE + t * PER_THREAD;
      const int64_t first = tile * TILE / B;
      int64_t slot = e / B;
      int r = (int)(e - slot * B);
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        if (mk[k] >= 0) {
          const int64_t dst = (int64_t)st[b].blk[slot - first] * B + r;
          s_src[pos] = mk[k];
          s_dst[pos] = dst;
          ++pos;
          // the row's first and last sectors are written in part: bring
          // them into L2 now, while the block waits for its source rows
          prefetch_l2(slab + dst * W);
          prefetch_l2(slab + dst * W + W - 1);
        }
        if (++r == B) {
          r = 0;
          ++slot;
        }
      }
    }
    __syncthreads();

    // (3) the p placed rows as one run of p * W floats
    const int total = p * W;
    int r = r0, c = c0;
    for (int f0 = t; f0 < total; f0 += UNROLL * THREADS) {
      T v[UNROLL];
      int64_t at[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (f0 + u * THREADS < total) {
          v[u] = new_rows[(int64_t)s_src[r] * W + c];
          at[u] = s_dst[r] * W + c;
        }
        r += q;
        c += m;
        if (c >= W) {
          c -= W;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (f0 + u * THREADS < total) slab[at[u]] = v[u];
    }
    // this tile's pairs and stage buffer are rewritten by the next tiles
    __syncthreads();
  }
}

// Blocks of blocked_write_kernel<T> that fit on device `dev` at once (SM
// count times blocks an SM), into *fit: worked out on the device's first
// launch and kept, so a launch then costs no query.
template <typename T>
cudaError_t kernel_fit(int dev, int64_t* fit) {
  static std::mutex mu;
  static std::map<int, int64_t> known;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(dev);
  if (it != known.end()) {
    *fit = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blocked_write_kernel<T>, THREADS, 0);
  if (e != cudaSuccess) return e;
  *fit = known[dev] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename T>
int launch(T* slab, const T* new_rows, const int* row_map, const int* blk_idx,
           int NB, int B, int W, cudaStream_t stream) {
  const int64_t n_lanes = (int64_t)NB * B;
  if (n_lanes <= 0 || W <= 0) return 0;
  const int64_t n_tiles = (n_lanes + TILE - 1) / TILE;
  int dev = 0;
  int64_t fit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = kernel_fit<T>(dev, &fit);
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = n_tiles < fit ? n_tiles : fit;
  const bool vec_map = (reinterpret_cast<uintptr_t>(row_map) & 15) == 0;
  blocked_write_kernel<T><<<(unsigned)grid, THREADS, 0, stream>>>(
      slab, new_rows, row_map, blk_idx, n_lanes, B, W, n_tiles, vec_map);
  return (int)cudaGetLastError();
}

}  // namespace

// slab [C, W] f32 (written in place), new_rows [U, W] f32, row_map [NB, B]
// i32, blk_idx [NB] i32 with blk_idx[i] * B + B <= C; all contiguous on the
// current device. Launches on `stream`; returns cudaGetLastError() (or the
// error of sizing the grid).
extern "C" int pbt_blocked_write(float* slab, const float* new_rows,
                                 const int* row_map, const int* blk_idx,
                                 int NB, int B, int W, void* stream) {
  return launch<float>(slab, new_rows, row_map, blk_idx, NB, B, W,
                       (cudaStream_t)stream);
}

// The same placement on a slab of 2-byte elements (the bf16 slab's int16
// bits): slab [C, W], new_rows [U, W] 2-byte, the rest as above.
extern "C" int pbt_blocked_write_2byte(uint16_t* slab,
                                       const uint16_t* new_rows,
                                       const int* row_map,
                                       const int* blk_idx, int NB, int B,
                                       int W, void* stream) {
  return launch<uint16_t>(slab, new_rows, row_map, blk_idx, NB, B, W,
                          (cudaStream_t)stream);
}
