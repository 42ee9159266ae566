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
// placed, 4.4 us at 3.35 TB/s; 60.0 MB, 17.9 us, with the 410,407 rows of
// a step of 8 flagship batches. The first and last sector of each written
// row are written in part.
//
// Design (the 2-byte form's, blocked_write_kernel, carried to 4-byte
// elements): tiles of TILE = 512 lanes, one a block of 128 threads,
// the blocks left to the hardware's scheduler. (1) A thread loads its 4
// row map entries (one int4 where aligned) and their slots' block ids
// straight to registers. (2) A warp scan and the warps' totals in shared
// memory rank the placed lanes, and the same pass tells whether their
// sources form one consecutive run: source - rank is then one value.
// blocked_layout writes row_map[tgt] = arange(U) with tgt ascending
// (optimizers.py), so every tile of the blocked path is one run. (3) The
// run is staged in shared memory by 16-byte cp.async from the 16-byte
// boundary at or before its first element (chunks of the buffer where it
// is longer), while the threads write the placed lanes' slab rows in rank
// order. (4) The threads copy the tile's rows as one flattened run of
// elements, thread l taking elements l, l + 128, ...: a warp's stores
// cover 128 (f32) or 64 (2-byte) contiguous bytes of one to three rows. A
// tile whose sources are not one run, or rows too wide to stage, read each
// element from new_rows. The slab is never read and the L2 is not
// prefetched. The f32 form's run buffer is 16 KB (F32_RUN_BYTES: where
// 410,407 rows spread over all 1024 slots a tile places about 200 rows of
// 68 bytes, one chunk), 10 blocks an SM; the 2-byte form's 12 KB, 13
// blocks an SM.
//
// The f32 form on an H100 80GB HBM3 at 700 W (copy_probe.py --tree
// --balanced, the earlier design and this one in one call, medians of
// rounds of A, B, B, A against index_copy_ of the same rows; PERF.md
// §6): at the flagship (77,128 rows) 0.01303-0.01305 ms against
// 0.01547-0.01554 for index_copy_ (0.840-0.842 of it), where the earlier
// design took 0.01425-0.01428 (0.922); at 410,407 rows over all 1024
// slots (blocked_write_chunk) 0.02886-0.02898 against 0.03336-0.03343
// (0.866-0.869), where it took 0.03627-0.03634 (1.087, slower than
// index_copy_). Where the same rows fill 546 slots three quarters full, as
// the sharded pipeline step's do (blocked_write_step), it still loses:
// 0.04419-0.04428 against 0.04093-0.04094 (1.078-1.082), where the earlier
// design took 0.05561 (1.357). A tile there places about 376 rows (25.6
// KB, two chunks of the buffer) and the loaded tiles are half as many.
// Designs tried for the f32 form:
// - The earlier design: the flat row map cut into tiles of 1,024
//   entries, persistent blocks of 256 threads walking them with the next
//   tile's entries in flight in a second stage buffer, the placed lanes
//   compacted into (source, slab row) pairs, the first and last sector of
//   each slab row prefetched into L2, the rows copied with 8 loads in
//   flight a thread; tuned at the flagship's 1,024 tiles: 0.0144 there
//   (0.0158 for the first design, a warp per 32 lanes; without the
//   prefetch, with
//   every sector prefetched, loading the old value before each store, 128
//   threads a block, 4 or 16 loads in flight, two blocks an SM: slower).
// - This design with the earlier one's L2 prefetch of each placed row's
//   first and last sector: 0.01455-0.01464 at the flagship,
//   0.04238-0.04248 at 410,407 rows (this design without it in the same
//   call 0.01316-0.0132, 0.02904-0.02914).
// - Its block and buffer (flagship, 410,407 rows over 1024 slots and over
//   546, each beside this design in one call: 0.01303-0.01340,
//   0.02886-0.02930, 0.04419-0.04470): a 32 KB buffer, 6 blocks an SM,
//   0.01437-0.01475, 0.02730-0.02810, 0.04152-0.04214 (1.013-1.017 of
//   index_copy_ there); 256-lane tiles of 64 threads, 12 blocks an SM,
//   0.01463-0.01470, 0.02739-0.02745, 0.04186-0.04191; 1,024-lane tiles of
//   256 threads with 32 KB, 5 blocks an SM, 0.01296, 0.03182-0.03200,
//   0.04321-0.04344; the buffer's halves taking alternate chunks (the
//   next loading while one is written), 16 KB and 24 KB, 0.01368-0.01415,
//   0.02668-0.02776, 0.04438-0.04533; no staging, the run read straight
//   from new_rows with 8 loads in flight a thread before their stores,
//   12 blocks an SM: 0.02462, 0.05267, 0.06648-0.06652.
//
// The 2-byte form (the bf16 slab diet's int16 slab; the TPU kernel takes a
// slab of any dtype, pallas_push.py:137) is the same kernel on 2-byte
// elements. At the flagship shape (device width 25, 77,128 rows
// placed) it moves 11,911,200 B (4.2 MB of row_map, 3.86 MB of rows read
// and as many written), 3.56 us at 3.35 TB/s. A 50-byte row starts 4-byte
// aligned only on even rows, and the slab and new_rows need only be
// 2-byte aligned.
//
// The 2-byte form on an H100 80GB HBM3 at 700 W (copy_probe.py --tree,
// each design beside the earlier 2-byte form or this one in one call, ms;
// PERF.md §6): 0.0122-0.0125, against 0.0148-0.0152 for the earlier 2-byte
// form (the f32 kernel over 2-byte elements) and 0.0138-0.0142 for
// index_copy_ of the same rows. Designs tried:
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

namespace {

constexpr int PER_THREAD = 4;                // row map entries a thread
// the f32 form's staged run (a tile of 200 placed 68-byte rows, the sharded
// pipeline step's density, in one chunk) and its blocks an SM
constexpr int F32_THREADS = 128;
constexpr int F32_RUN_BYTES = 16384;
constexpr int F32_MIN_BLOCKS = 10;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// slab[blk_idx[i] * B + r, :] = new_rows[row_map[i, r], :] on elements of
// type T (uint16_t: the 2-byte slab; float: the f32 slab), a tile of
// THREADS * PER_THREAD lanes a block (see the header). RUN_BYTES: the
// staged run's buffer; MIN_BLOCKS: the blocks an SM the registers are
// held to.
template <typename T, int THREADS, int RUN_BYTES, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
blocked_write_kernel(T* __restrict__ slab, const T* __restrict__ new_rows,
                   const int* __restrict__ row_map,
                   const int* __restrict__ blk_idx, int64_t n_lanes, int NB,
                   int B, int W, int64_t n_tiles, bool vec_map) {
  constexpr int WARPS = THREADS / 32;
  constexpr int TILE = THREADS * PER_THREAD;   // row map entries a tile
  // elements a staged chunk holds: its first element may sit up to 16 -
  // sizeof(T) bytes past the 16-byte boundary its load starts at
  constexpr int RUN_ELEMS = (RUN_BYTES - 16) / (int)sizeof(T);
  __shared__ int64_t s_dst[TILE];   // placed lanes' slab rows, in order
  __shared__ __align__(16) union {
    T run[RUN_BYTES / sizeof(T)];   // a consecutive run's chunk, staged
    int src[TILE];                  // or the placed lanes' source rows
  } s_u;
  __shared__ int s_cnt[WARPS], s_dmin[WARPS], s_dmax[WARPS];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // a thread's copy elements step by THREADS = q rows and m columns
  const int q = THREADS / W, m = THREADS - q * W;
  const int r0 = t / W, c0 = t - r0 * W;
  const int chunk_rows = RUN_ELEMS / W;   // 0: rows too wide to stage

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // (1) the thread's row map entries and their slots' block ids, all
    // loads in flight at once
    const int64_t e = tile * TILE + t * PER_THREAD;
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
    for (int k = 0; k < WARPS; ++k) {
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
      const int chunks =
          (int)((a + (uintptr_t)n * W * sizeof(T) - a0 + 15) >> 4);
      for (int c = t; c < chunks; c += THREADS)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(reinterpret_cast<unsigned char*>(
                                      s_u.run) + c * 16)),
                     "l"(a0 + (uintptr_t)c * 16)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      return (int)((a - a0) / sizeof(T));
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
    // elements l, l + THREADS, ...: from the staged run, or straight from
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
      for (int f = t; f < total; f += THREADS) {
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

template <typename T, int THREADS, int RUN_BYTES, int MIN_BLOCKS>
int launch(T* slab, const T* new_rows, const int* row_map, const int* blk_idx,
           int NB, int B, int W, cudaStream_t stream) {
  constexpr int TILE = THREADS * PER_THREAD;
  const int64_t n_lanes = (int64_t)NB * B;
  if (n_lanes <= 0 || W <= 0) return 0;
  const int64_t n_tiles = (n_lanes + TILE - 1) / TILE;
  const int64_t grid = n_tiles < INT_MAX ? n_tiles : INT_MAX;
  const bool vec_map = (reinterpret_cast<uintptr_t>(row_map) & 15) == 0;
  blocked_write_kernel<T, THREADS, RUN_BYTES, MIN_BLOCKS>
      <<<(unsigned)grid, THREADS, 0, stream>>>(slab, new_rows, row_map,
                                               blk_idx, n_lanes, NB, B, W,
                                               n_tiles, vec_map);
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
  return launch<float, F32_THREADS, F32_RUN_BYTES, F32_MIN_BLOCKS>(
      slab, new_rows, row_map, blk_idx, NB, B, W, (cudaStream_t)stream);
}

// The same placement on a slab of 2-byte elements (the bf16 slab's int16
// bits): slab [C, W], new_rows [U, W] 2-byte, the rest as above.
extern "C" int pbt_blocked_write_2byte(uint16_t* slab,
                                       const uint16_t* new_rows,
                                       const int* row_map,
                                       const int* blk_idx, int NB, int B,
                                       int W, void* stream) {
  return launch<uint16_t, 128, 12288, 16>(slab, new_rows, row_map, blk_idx,
                                          NB, B, W, (cudaStream_t)stream);
}
