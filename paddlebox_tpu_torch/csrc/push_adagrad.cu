// The sparse push of one train step, fused: merge the per-occurrence push
// rows of each unique key, read its slab row, apply the in-table adagrad
// update (with lazy embedx creation) and write the row back.
//
// Replaces the TPU kernel paddlebox_tpu/embedding/pallas_push.py:_push_kernel
// (wrapper pallas_apply_push) together with the XLA work around it in
// paddlebox_tpu/embedding/optimizers.py:275-345 (push_sparse_hostdedup:
// the occurrence gather, the sorted segment_sum merge, the row gather and
// the row scatter). The update is the TPU kernel's: show/click/delta_score/
// unseen bookkeeping, per-feature-lr adagrad on embed_w (the lr is picked by
// the UPDATED slot), shared-g2sum adagrad on embedx, and lazy embedx creation
// from an integer hash of (slab row id, column, seed). Rows whose merged
// g_show is 0 pass through.
//
// Inputs: the slab [C, W] (W = 9 + D), the per-occurrence push rows grads
// [K, G] (G = 4 + D), perm [K] (occurrences grouped by unique, ascending in
// each group), offsets [K + 1] (unique j's occurrences are perm[offsets[j] ..
// offsets[j + 1]), padding occurrences left out) and the strictly ascending
// uids [K], of which the first n_uniq are slab rows. Only those n_uniq are
// launched; the padding uids (>= C) never are. Two write modes: in place,
// slab[uids[j]] = new row (the scatter path), or rows out, out[j] = new row
// for every j < n_uniq, pass-through rows included (the blocked path, whose
// blocked_write places them).
//
// Bound on an H100: memory. Each valid occurrence moves its perm entry and
// its push row (4 + G * 4 B), each unique its uid and offset, its slab row
// read and its new row written (8 + 2 * W * 4 B): at the flagship batch
// (82,167 occurrences, 77,128 uniques, D = 8) 15.4 MB, 4.6 us at 3.35 TB/s.
// The arithmetic is ~60 flops a unique, far below the card's rate.
//
// Design: a block of THREADS threads takes a tile of TILE consecutive
// uniques. (1) It loads the tile's uids and offsets, and the perm entries of
// the tile's occurrences (up to OCC of them), coalesced, into shared memory.
// (2) It copies the tile's slab rows and occurrence push rows into shared
// memory with 4-byte cp.async: thread l takes flattened elements l, l +
// THREADS, ..., so a warp's 32 loads cover about two contiguous 68-byte rows
// instead of 32 rows 68 bytes apart, and every load of the tile is in flight
// before the block waits for any. (3) One thread per unique merges its
// occurrences in registers and updates its row in shared memory; the embedx
// width D is a template argument (2, 4, 8, 16, 32 or 64), so the column
// loops unroll and their divisions overlap. (4) The tile writes its
// rows back, 68 contiguous bytes a row (in place) or the whole tile as one
// contiguous run (rows out). A unique's occurrences past the tile's OCC
// budget (a hot key) are read from global memory in the same loop, so a
// segment of any length is summed exactly. Each uid is distinct, so the
// rows one block reads and writes are its own.
//
// Numerics: build WITHOUT --use_fast_math and with --fmad=false, so sqrtf and
// the divisions are IEEE and no multiply-add is contracted. Each unique's
// push rows are summed from 0.0f in ascending occurrence order, as
// torch.segment_reduce and JAX's sorted segment_sum add them; the update
// then takes exactly the f32 operations of its plain PyTorch version
// (push_kernels.push_adagrad_plain): the mean of the D squared embedx grads
// is summed from column 0 up and divided by D. The creation hash is uint32
// arithmetic exactly as in the TPU kernel, including its >>8 -> int32 -> f32
// step, so created embedx is bit-identical to the JAX package's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = THREADS;  // one thread per unique in the update
constexpr int OCC = 2 * TILE;  // occurrences staged in shared memory a tile

// value row columns (accessor.py, adagrad layout)
constexpr int kSlot = 0, kShow = 1, kClick = 2, kDelta = 3, kUnseen = 4,
              kMfSize = 5, kEmbedW = 6, kEmbedG2 = 7, kEmbedx = 8;
// push row columns
constexpr int gSlot = 0, gShow = 1, gClick = 2, gEmbed = 3, gEmbedx = 4;

struct PushConf {
  float nonclk_coeff, clk_coeff, nodeid_slot, mf_learning_rate,
      feature_learning_rate, mf_initial_g2sum, mf_min_bound, mf_max_bound,
      mf_create_thresholds, mf_initial_range;
};
constexpr int kConfFloats = 10;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared memory of a tile, in order: uids [TILE], offsets [TILE + 1], perm
// [OCC] (ints), slab rows [TILE][W], push rows [OCC][GP] (floats). GP =
// G | 1: an odd stride, so the threads of the merge, each reading its own
// unique's rows, hit distinct banks.
constexpr int stage_bytes(int W, int G) {
  return (TILE + TILE + 1 + OCC) * 4 + (TILE * W + OCC * (G | 1)) * 4;
}

// D, the embedx width, is a template argument: the column loops unroll and
// each unique's merged push row and scaled embedx grads live in registers.
template <int D>
__global__ void __launch_bounds__(THREADS)
push_adagrad_kernel(float* __restrict__ slab, const float* __restrict__ grads,
                    const int* __restrict__ perm,
                    const int* __restrict__ offsets,
                    const int* __restrict__ uids, float* __restrict__ out,
                    int n_uniq, uint32_t seed, PushConf conf) {
  constexpr int W = 9 + D, G = 4 + D, GP = G | 1;
  extern __shared__ int smem[];
  int* s_uid = smem;
  int* s_off = s_uid + TILE;
  int* s_perm = s_off + TILE + 1;
  float* s_row = reinterpret_cast<float*>(s_perm + OCC);
  float* s_occ = s_row + TILE * W;

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * TILE;
  const int rows = min(TILE, n_uniq - j0);
  const int occ0 = offsets[j0];
  const int occ_end = offsets[j0 + rows];
  const int n_occ = min(occ_end - occ0, OCC);

  // (1) the tile's ids and its staged occurrences' perm entries
  if (t < rows) {
    s_uid[t] = uids[j0 + t];
    s_off[t] = offsets[j0 + t] - occ0;
  }
  if (t == 0) s_off[rows] = occ_end - occ0;
  for (int o = t; o < n_occ; o += THREADS) s_perm[o] = perm[occ0 + o];
  __syncthreads();

  // (2) slab rows and push rows into shared memory, all loads in flight
  for (int f = t; f < rows * W; f += THREADS) {
    const int r = f / W;
    cp_async4(s_row + f, slab + (int64_t)s_uid[r] * W + (f - r * W));
  }
  for (int f = t; f < n_occ * G; f += THREADS) {
    const int o = f / G;
    const int c = f - o * G;
    cp_async4(s_occ + o * GP + c, grads + (int64_t)s_perm[o] * G + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // (3) one thread per unique: merge, then update its row in shared memory
  if (t < rows) {
    float m[G];  // the merged push row
#pragma unroll
    for (int c = 0; c < G; ++c) m[c] = 0.0f;
    for (int k = s_off[t]; k < s_off[t + 1]; ++k) {
      const float* x = k < n_occ ? s_occ + k * GP
                                 : grads + (int64_t)perm[occ0 + k] * G;
#pragma unroll
      for (int c = 0; c < G; ++c) m[c] += x[c];
    }
    const float g_show = m[gShow];
    if (g_show > 0.0f) {  // else: an inactive row passes through unchanged
      float* v = s_row + t * W;
      const float g_click = m[gClick];
      const float slot = m[gSlot];
      const float show = v[kShow] + g_show;
      const float click = v[kClick] + g_click;
      const float delta =
          (v[kDelta] + conf.nonclk_coeff * (g_show - g_click)) +
          conf.clk_coeff * g_click;

      // embed_w: per-feature-lr adagrad
      const float lr = (slot == conf.nodeid_slot) ? conf.mf_learning_rate
                                                  : conf.feature_learning_rate;
      const float g2 = v[kEmbedG2];
      const float sw = m[gEmbed] / g_show;
      const float ratio =
          lr * sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + g2));
      const float neww =
          clip(v[kEmbedW] + ratio * sw, conf.mf_min_bound, conf.mf_max_bound);
      const float newg2 = g2 + sw * sw;

      // embedx: lazy creation, else shared-g2sum adagrad once it exists
      const float mf_size = v[kMfSize];
      const float xg2 = v[kEmbedx + D];
      const float score =
          conf.nonclk_coeff * (show - click) + conf.clk_coeff * click;
      const bool create =
          (mf_size == 0.0f) && (score >= conf.mf_create_thresholds);
      float out_xg2 = xg2;
      if (create) {
        const uint32_t r = (uint32_t)s_uid[t];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          uint32_t bits = (r * 2654435761u) ^ ((uint32_t)c * 40503u + seed);
          bits = bits * 747796405u + 2891336453u;
          bits ^= bits >> 16;
          const float u01 =
              (float)(int32_t)(bits >> 8) * (1.0f / 16777216.0f);
          v[kEmbedx + c] = u01 * conf.mf_initial_range;
        }
      } else if (mf_size > 0.0f) {
        float sx[D];  // the scaled embedx grads
        float sq = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          sx[c] = m[gEmbedx + c] / g_show;
          sq = sq + sx[c] * sx[c];
        }
        const float xratio = conf.mf_learning_rate *
                             sqrtf(conf.mf_initial_g2sum /
                                   (conf.mf_initial_g2sum + xg2));
#pragma unroll
        for (int c = 0; c < D; ++c)
          v[kEmbedx + c] = clip(v[kEmbedx + c] + xratio * sx[c],
                                conf.mf_min_bound, conf.mf_max_bound);
        out_xg2 = xg2 + sq / (float)D;
      }
      v[kSlot] = slot;
      v[kShow] = show;
      v[kClick] = click;
      v[kDelta] = delta;
      v[kUnseen] = 0.0f;
      v[kMfSize] = create ? (float)D : mf_size;
      v[kEmbedW] = neww;
      v[kEmbedG2] = newg2;
      v[kEmbedx + D] = out_xg2;
    }
  }
  __syncthreads();

  // (4) the tile's rows back: at their slab rows, or as one run of out
  if (out != nullptr) {
    float* o = out + (int64_t)j0 * W;
    for (int f = t; f < rows * W; f += THREADS) o[f] = s_row[f];
  } else {
    for (int f = t; f < rows * W; f += THREADS) {
      const int r = f / W;
      slab[(int64_t)s_uid[r] * W + (f - r * W)] = s_row[f];
    }
  }
}

template <int D>
int launch(float* slab, const float* grads, const int* perm,
           const int* offsets, const int* uids, float* out, int n_uniq,
           uint32_t seed, const PushConf& conf, cudaStream_t stream) {
  constexpr int smem = stage_bytes(9 + D, 4 + D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        push_adagrad_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_uniq + TILE - 1) / TILE;
  push_adagrad_kernel<D><<<blocks, THREADS, smem, stream>>>(
      slab, grads, perm, offsets, uids, out, n_uniq, seed, conf);
  return (int)cudaGetLastError();
}

}  // namespace

// slab [C, W] f32 (W = 9 + D; written in place when out is null), grads
// [K, 4 + D] f32, perm [K] i32, offsets [K + 1] i32, uids [K] i32 with
// uids[0 .. n_uniq) distinct rows of the slab, out null or [n_uniq, W] f32;
// all contiguous on the current device. D is one of 2, 4, 8, 16, 32, 64
// (push_kernels.KERNEL_EMBEDX_DIMS; any other gives cudaErrorInvalidValue).
// conf points at 10 host floats in PushConf order. Launches on `stream`;
// returns cudaGetLastError() (or the error of raising the shared-memory
// limit).
extern "C" int pbt_push_adagrad(float* slab, const float* grads,
                                const int* perm, const int* offsets,
                                const int* uids, float* out, int n_uniq,
                                int D, int seed, const float* conf_host,
                                void* stream) {
  if (n_uniq <= 0) return 0;
  PushConf conf;
  float* dst = &conf.nonclk_coeff;
  for (int k = 0; k < kConfFloats; ++k) dst[k] = conf_host[k];
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t sd = (uint32_t)seed;
#define PBT_PUSH_CASE(d) \
  case d:                 \
    return launch<d>(slab, grads, perm, offsets, uids, out, n_uniq, sd, conf, s)
  switch (D) {
    PBT_PUSH_CASE(2);
    PBT_PUSH_CASE(4);
    PBT_PUSH_CASE(8);
    PBT_PUSH_CASE(16);
    PBT_PUSH_CASE(32);
    PBT_PUSH_CASE(64);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PBT_PUSH_CASE
}
