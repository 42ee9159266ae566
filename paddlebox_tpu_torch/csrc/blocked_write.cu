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
// slab of any dtype, pallas_push.py:137) has a kernel of its own,
// blocked_write_kernel_2byte. Bound on an H100: memory. At the flagship
// shape (device width 25, 77,128 rows placed) it moves 11,911,200 B (4.2
// MB of row_map, 3.86 MB of rows read and as many written), 3.56 us at
// 3.35 TB/s. A 50-byte row starts 4-byte aligned only on even rows, and
// the slab and new_rows need only be 2-byte aligned.
// Design: tiles of TILE2 = 512 lanes, one a block of 128 threads, the
// blocks (2,048 at the flagship) left to the hardware's scheduler; the 12
// KB run buffer holds the residents to 13 blocks an SM. (1) A thread loads
// its 4 row map entries (one int4 where aligned) and their slots' block
// ids straight to registers. (2) A warp scan and the warps' totals in
// shared memory rank the placed lanes, and the same pass tells whether
// their sources form one consecutive run: source - rank is then one value.
// blocked_layout writes row_map[tgt] = arange(U) with tgt ascending
// (optimizers.py), so every tile of the blocked path is one run. (3) The
// run is staged in shared memory by 16-byte cp.async from the 16-byte
// boundary at or before its first element (chunks of the buffer where it
// is longer), while the threads write the placed lanes' slab rows in rank
// order. (4) The threads copy the tile's rows as one flattened run of
// 2-byte elements, thread l taking elements l, l + 128, ...: a warp's
// stores cover 64 contiguous bytes of one or two rows. A tile whose
// sources are not one run, or rows too wide to stage, read each element
// from new_rows. The slab is never read and the L2 is not prefetched.
//
// On an H100 80GB HBM3 at 700 W (copy_probe.py --tree, each design beside
// the earlier 2-byte form or this one in one call, ms; PERF.md §6):
// 0.0122-0.0125, against 0.0148-0.0152 for the earlier 2-byte form (the
// f32 kernel over 2-byte elements) and 0.0138-0.0142 for index_copy_ of
// the same rows. Designs tried:
// - 4-byte word stores, a row as 12 or 13 aligned words and a 2-byte head
//   or tail by its parity, over 1,024-lane tiles of 256 threads: 0.0157-
//   0.0161; persistent blocks with the next tile's entries in registers
//   0.0165-0.0167; that without the L2 prefetch 0.0159, with 32
//   registers (all tiles resident) 0.0162-0.0164; sources read
//   straight from new_rows, two 2-byte loads a word, 0.01905-0.01915;
//   one store path for both half words 0.0157-0.0158. A warp's word
//   stores and its edge stores are separate instructions over the same
//   sectors.
// - 2-byte element stores from the staged run over 1,024-lane tiles of 256
//   threads: 0.0147-0.0148 with the L2 prefetch, 0.0135-0.0138 without
//   it (the earlier form without it: 0.0146-0.0147); 8 loads in flight a
//   thread (74 registers, 3 blocks an SM) 0.0142-0.0143; streaming stores
//   0.01435; 32 registers 0.0135-0.0136.
// - This design over 512-lane tiles of 128 threads at 9 (56 registers),
//   10, 12, 13, 14 and 16 blocks an SM: 0.0130-0.0131, 0.0130-0.0131,
//   0.0124, 0.0122-0.0125, 0.0124, 0.0140-0.0141; at 16 with the L2
//   prefetch 0.0148-0.0149; at 13 with evict-first row map loads
//   0.0126-0.0128, as a persistent grid walking the tiles in turn
//   0.0146-0.0147. 256-lane tiles of 64 threads at 32 and 26 blocks an
//   SM: 0.0149-0.0150, 0.0127-0.0129; 384-lane tiles of 96 threads at 17:
//   0.0121-0.0122.
//
// The Pallas grid ran its blocks in sequence and re-read each aliased block
// before overlaying it, so a sentinel slot clamped onto the last block had
// to be ordered before that block's real write (optimizers.py:443-456,
// pallas_push.py:111-120). This kernel never reads the slab back: a lane
// with row_map < 0 writes nothing, so sentinel slots (all lanes -1) are
// no-ops whatever order the tiles run in, and real slots address distinct
// rows. The ordering invariant has nothing left to protect here.

#include <cuda_runtime.h>
#include <limits.h>
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

// T: float, the f32 slab (the 2-byte slab has its own kernel below).
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

// ------------------------------------------------------- the 2-byte form

constexpr int THREADS2 = 128;                  // threads of the 2-byte kernel
constexpr int WARPS2 = THREADS2 / 32;
constexpr int TILE2 = THREADS2 * PER_THREAD;   // row map entries a tile
constexpr int RUN_BYTES = 12288;   // a staged chunk of a consecutive run
// 2-byte elements a staged chunk holds: its first element may sit up to 14
// bytes past the 16-byte boundary its load starts at
constexpr int RUN_ELEMS = (RUN_BYTES - 16) / 2;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// slab[blk_idx[i] * B + r, :] = new_rows[row_map[i, r], :] on 2-byte
// elements, a tile of TILE2 lanes a block (see the header).
__global__ void __launch_bounds__(THREADS2, 16)
blocked_write_kernel_2byte(uint16_t* __restrict__ slab,
                           const uint16_t* __restrict__ new_rows,
                           const int* __restrict__ row_map,
                           const int* __restrict__ blk_idx, int64_t n_lanes,
                           int NB, int B, int W, int64_t n_tiles,
                           bool vec_map) {
  __shared__ int64_t s_dst[TILE2];   // placed lanes' slab rows, in order
  __shared__ __align__(16) union {
    uint16_t run[RUN_BYTES / 2];     // a consecutive run's chunk, staged
    int src[TILE2];                  // or the placed lanes' source rows
  } s_u;
  __shared__ int s_cnt[WARPS2], s_dmin[WARPS2], s_dmax[WARPS2];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // a thread's copy elements step by THREADS2 = q rows and m columns
  const int q = THREADS2 / W, m = THREADS2 - q * W;
  const int r0 = t / W, c0 = t - r0 * W;
  const int chunk_rows = RUN_ELEMS / W;   // 0: rows too wide to stage

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // (1) the thread's row map entries and their slots' block ids, all
    // loads in flight at once
    const int64_t e = tile * TILE2 + t * PER_THREAD;
    int mk[PER_THREAD], bk[PER_THREAD];
    if (vec_map && e + PER_THREAD <= n_lanes) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row_map + e));
      mk[0] = v.x;
      mk[1] = v.y;
      mk[2] = v.z;
      mk[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        mk[k] = e + k < n_lanes ? __ldg(row_map + e + k) : -1;
    }
    const int64_t slot0 = e / B;
    const int rr0 = (int)(e - slot0 * B);
    {
      int64_t slot = slot0;
      int r = rr0;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        bk[k] = __ldg(blk_idx + (slot < NB ? slot : NB - 1));
        if (++r == B) {
          r = 0;
          ++slot;
        }
      }
    }

    // (2) rank the placed lanes (warp scan, the warps' totals in shared
    // memory), and find whether their sources are one consecutive run:
    // source - rank is then one value, the run's first row
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) cnt += mk[k] >= 0;
    const int incl = warp_incl_scan(cnt, lane);
    int dmin = INT_MAX, dmax = INT_MIN;
    {
      int rank = incl - cnt;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        if (mk[k] >= 0) {
          dmin = min(dmin, mk[k] - rank);
          dmax = max(dmax, mk[k] - rank);
          ++rank;
        }
    }
    dmin = __reduce_min_sync(0xffffffffu, dmin);
    dmax = __reduce_max_sync(0xffffffffu, dmax);
    if (lane == 31) s_cnt[w] = incl;
    if (lane == 0) {
      s_dmin[w] = dmin;
      s_dmax[w] = dmax;
    }
    __syncthreads();
    int pos = incl - cnt, p = 0, first = 0;
    bool run = true, seen = false;
#pragma unroll
    for (int k = 0; k < WARPS2; ++k) {
      const int v = s_cnt[k];
      if (v) {
        const int d = s_dmin[k] - p;
        run = run && s_dmin[k] == s_dmax[k] && (!seen || d == first);
        if (!seen) first = d;
        seen = true;
      }
      pos += k < w ? v : 0;
      p += v;
    }
    if (p == 0) {   // no lane of the tile placed (the block agrees)
      __syncthreads();   // the warps' totals are rewritten next
      continue;
    }
    run = run && chunk_rows > 0;

    // the staged chunk of rows [cb, cb + n) of the run, by 16-byte
    // cp.async from the 16-byte boundary at or before its first element;
    // returns that element's index in s_u.run
    auto stage = [&](int cb, int n) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          new_rows + ((int64_t)first + cb) * W);
      const uintptr_t a0 = a & ~(uintptr_t)15;
      const int chunks = (int)((a + (uintptr_t)n * W * 2 - a0 + 15) >> 4);
      for (int c = t; c < chunks; c += THREADS2)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(s_u.run + c * 8)),
                     "l"(a0 + (uintptr_t)c * 16)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      return (int)((a - a0) >> 1);
    };
    int head = 0;
    if (run) head = stage(0, min(p, chunk_rows));

    // (3) the placed lanes' slab rows (and, off a run, their source rows)
    // in rank order, while the run loads
    {
      int r = rr0;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        if (mk[k] >= 0) {
          s_dst[pos] = (int64_t)bk[k] * B + r;
          if (!run) s_u.src[pos] = mk[k];
          ++pos;
        }
        if (++r == B) r = 0;
      }
    }

    // (4) the rows as one run of n * W elements a chunk, thread l taking
    // elements l, l + THREADS2, ...: from the staged run, or straight from
    // new_rows (any other row map, or rows too wide to stage)
    for (int cb = 0; cb < p; cb += run ? chunk_rows : p) {
      const int n = run ? min(p - cb, chunk_rows) : p;
      if (run) {
        if (cb) head = stage(cb, n);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const int total = n * W;
      int i = r0, c = c0;
      for (int f = t; f < total; f += THREADS2) {
        slab[s_dst[cb + i] * W + c] =
            run ? s_u.run[head + f]
                : __ldg(new_rows + (int64_t)s_u.src[cb + i] * W + c);
        i += q;
        c += m;
        if (c >= W) {
          c -= W;
          ++i;
        }
      }
      // the chunk and the pairs are rewritten next
      __syncthreads();
    }
  }
}

int launch_2byte(uint16_t* slab, const uint16_t* new_rows, const int* row_map,
                 const int* blk_idx, int NB, int B, int W,
                 cudaStream_t stream) {
  const int64_t n_lanes = (int64_t)NB * B;
  if (n_lanes <= 0 || W <= 0) return 0;
  const int64_t n_tiles = (n_lanes + TILE2 - 1) / TILE2;
  const int64_t grid = n_tiles < INT_MAX ? n_tiles : INT_MAX;
  const bool vec_map = (reinterpret_cast<uintptr_t>(row_map) & 15) == 0;
  blocked_write_kernel_2byte<<<(unsigned)grid, THREADS2, 0, stream>>>(
      slab, new_rows, row_map, blk_idx, n_lanes, NB, B, W, n_tiles, vec_map);
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
  return launch_2byte(slab, new_rows, row_map, blk_idx, NB, B, W,
                      (cudaStream_t)stream);
}
