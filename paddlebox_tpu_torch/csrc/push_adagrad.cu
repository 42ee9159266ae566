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

// The bf16 slab (embedding/accessor.py, slab_embed_dtype="bfloat16"): the
// slab rows are DW = 17 + D 2-byte columns, bf16 weights and (hi, lo)
// halves of every other column. The reference decodes the rows, runs the
// TPU kernel on f32 and encodes the result (optimizers.py:259-262,
// 306-316, 342-343); this form does the same inside the kernel: each
// unique's device row is staged in shared memory (2-byte loads through
// registers: cp.async takes no 2-byte copy and an odd-width row starts
// 4-byte aligned only on every other row), decoded exactly to f32, updated
// by the same code as the f32 form, and encoded with the integer round to
// nearest even and the NaN quieting of the reference's numpy encoder
// (never __float2bfloat16_rn, whose NaN is canonical). The column plan
// (which device columns hold each logical column) comes from the host,
// accessor.slab_codec_plan, as the decoding gather's does. Every unique's row
// is decoded and encoded, as in the reference; for a row written by the
// codec the round trip is the identity, so a pass-through row keeps its
// bits. At the flagship batch it moves 12.6 MB (occurrences 82,167 x 52 B;
// uniques 77,128 x (8 + 2 x 50) B), 3.8 us at 3.35 TB/s.

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
// [OCC] (ints), slab rows [TILE][W] and push rows [OCC][GP] (floats), then
// under the bf16 slab the raw device rows [TILE][DW] (2-byte). GP = G | 1:
// an odd stride, so the threads of the merge, each reading its own
// unique's rows, hit distinct banks.
constexpr int stage_bytes(int W, int G, int DW) {
  return (TILE + TILE + 1 + OCC) * 4 + (TILE * W + OCC * (G | 1)) * 4 +
         TILE * DW * 2;
}

// The bf16 slab's column plan (embedding/accessor.py slab_codec_plan),
// passed as a kernel parameter: logical column c is the f32 bits (hi[c] <<
// 16 | lo[c]) of device columns hi[c] and lo[c], or a bf16 at hi[c] when
// lo[c] is -1. The threads of a warp read the same entry at once.
constexpr int MAX_PLAN_COLS = 9 + 64;
struct RowPlan {
  short hi[MAX_PLAN_COLS];
  short lo[MAX_PLAN_COLS];
};

// f32 bits -> bf16 bits, the integer round to nearest even of the
// reference's numpy twin (accessor.py encode_slab_rows_np), uint32
// arithmetic with its wrap; a NaN keeps its sign and high payload and is
// quieted (hi | 0x40). Not __float2bfloat16_rn: its NaN is canonical.
__device__ __forceinline__ uint16_t bf16_rne(uint32_t u) {
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

// decode device row `raw` [DW] into f32 `v` [W]
template <int D>
__device__ __forceinline__ void decode_row(const uint16_t* raw, float* v,
                                           const RowPlan& plan) {
  constexpr int W = 9 + D;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const int lo = plan.lo[c];
    v[c] = __uint_as_float(((uint32_t)raw[plan.hi[c]] << 16) |
                           (lo < 0 ? 0u : (uint32_t)raw[lo]));
  }
}

// encode f32 `v` [W] into device row `raw` [DW]
template <int D>
__device__ __forceinline__ void encode_row(const float* v, uint16_t* raw,
                                           const RowPlan& plan) {
  constexpr int W = 9 + D;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const uint32_t u = __float_as_uint(v[c]);
    const int lo = plan.lo[c];
    if (lo < 0) {
      raw[plan.hi[c]] = bf16_rne(u);
    } else {
      raw[plan.hi[c]] = (uint16_t)(u >> 16);
      raw[lo] = (uint16_t)(u & 0xFFFFu);
    }
  }
}

// The in-table update of one unique's row v [W] (shared memory) from its
// merged push row m [G], as the TPU kernel computes it; the caller skips
// rows whose merged g_show is not positive (they pass through).
template <int D>
__device__ __forceinline__ void update_row(float* v, const float* m,
                                           uint32_t uid, uint32_t seed,
                                           const PushConf& conf) {
  const float g_show = m[gShow];
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
#pragma unroll
    for (int c = 0; c < D; ++c) {
      uint32_t bits = (uid * 2654435761u) ^ ((uint32_t)c * 40503u + seed);
      bits = bits * 747796405u + 2891336453u;
      bits ^= bits >> 16;
      const float u01 = (float)(int32_t)(bits >> 8) * (1.0f / 16777216.0f);
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
    const float xratio =
        conf.mf_learning_rate *
        sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + xg2));
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

// D, the embedx width, is a template argument: the column loops unroll and
// each unique's merged push row and scaled embedx grads live in registers.
// BF16: the slab (and out) hold the bf16 slab's 2-byte device rows of DW =
// 17 + D columns, decoded on read and encoded on write by `plan`; else
// f32 rows of W columns (plan unused).
template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
push_adagrad_kernel(void* __restrict__ slab_v,
                    const float* __restrict__ grads,
                    const int* __restrict__ perm,
                    const int* __restrict__ offsets,
                    const int* __restrict__ uids, void* __restrict__ out_v,
                    int n_uniq, uint32_t seed, PushConf conf,
                    const __grid_constant__ RowPlan plan) {
  constexpr int W = 9 + D, G = 4 + D, GP = G | 1, DW = 17 + D;
  extern __shared__ int smem[];
  int* s_uid = smem;
  int* s_off = s_uid + TILE;
  int* s_perm = s_off + TILE + 1;
  float* s_row = reinterpret_cast<float*>(s_perm + OCC);
  float* s_occ = s_row + TILE * W;
  uint16_t* s_raw = reinterpret_cast<uint16_t*>(s_occ + OCC * GP);

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

  // (2) push rows and slab rows into shared memory: the push rows and f32
  // slab rows by cp.async, all in flight before the block waits; the bf16
  // slab's 2-byte rows through registers (cp.async takes no 2-byte copy,
  // and a row of odd width starts 4-byte aligned only on every other row)
  for (int f = t; f < n_occ * G; f += THREADS) {
    const int o = f / G;
    const int c = f - o * G;
    cp_async4(s_occ + o * GP + c, grads + (int64_t)s_perm[o] * G + c);
  }
  if (BF16) {
    // a thread's DW elements t, t + THREADS, ... (TILE == THREADS rows of
    // DW), every load issued before the first store
    const uint16_t* slab = reinterpret_cast<const uint16_t*>(slab_v);
    uint16_t v[DW];
#pragma unroll
    for (int k = 0; k < DW; ++k) {
      const int f = t + k * THREADS;
      const int r = f / DW;
      if (r < rows)
        v[k] = __ldg(slab + (int64_t)s_uid[r] * DW + (f - r * DW));
    }
#pragma unroll
    for (int k = 0; k < DW; ++k)
      if (t + k * THREADS < rows * DW) s_raw[t + k * THREADS] = v[k];
  } else {
    const float* slab = reinterpret_cast<const float*>(slab_v);
    for (int f = t; f < rows * W; f += THREADS) {
      const int r = f / W;
      cp_async4(s_row + f, slab + (int64_t)s_uid[r] * W + (f - r * W));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // (3) one thread per unique: merge, then update its row in shared memory
  // (under bf16: decoded from its device row first, encoded back after,
  // pass-through rows too, as the reference decodes, updates and encodes
  // every unique's row)
  if (t < rows) {
    float* v = s_row + t * W;
    if (BF16) decode_row<D>(s_raw + t * DW, v, plan);
    float m[G];  // the merged push row
#pragma unroll
    for (int c = 0; c < G; ++c) m[c] = 0.0f;
    for (int k = s_off[t]; k < s_off[t + 1]; ++k) {
      const float* x = k < n_occ ? s_occ + k * GP
                                 : grads + (int64_t)perm[occ0 + k] * G;
#pragma unroll
      for (int c = 0; c < G; ++c) m[c] += x[c];
    }
    // else: an inactive row passes through unchanged
    if (m[gShow] > 0.0f) update_row<D>(v, m, (uint32_t)s_uid[t], seed, conf);
    if (BF16) encode_row<D>(v, s_raw + t * DW, plan);
  }
  __syncthreads();

  // (4) the tile's rows back: at their slab rows, or as one run of out
  if (BF16) {
    if (out_v != nullptr) {
      uint16_t* o = reinterpret_cast<uint16_t*>(out_v) + (int64_t)j0 * DW;
      for (int f = t; f < rows * DW; f += THREADS) o[f] = s_raw[f];
    } else {
      uint16_t* slab = reinterpret_cast<uint16_t*>(slab_v);
      for (int f = t; f < rows * DW; f += THREADS) {
        const int r = f / DW;
        slab[(int64_t)s_uid[r] * DW + (f - r * DW)] = s_raw[f];
      }
    }
  } else {
    if (out_v != nullptr) {
      float* o = reinterpret_cast<float*>(out_v) + (int64_t)j0 * W;
      for (int f = t; f < rows * W; f += THREADS) o[f] = s_row[f];
    } else {
      float* slab = reinterpret_cast<float*>(slab_v);
      for (int f = t; f < rows * W; f += THREADS) {
        const int r = f / W;
        slab[(int64_t)s_uid[r] * W + (f - r * W)] = s_row[f];
      }
    }
  }
}

template <int D, bool BF16>
int launch(void* slab, const float* grads, const int* perm,
           const int* offsets, const int* uids, void* out, int n_uniq,
           uint32_t seed, const PushConf& conf, const RowPlan& plan,
           cudaStream_t stream) {
  constexpr int smem = stage_bytes(9 + D, 4 + D, BF16 ? 17 + D : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        push_adagrad_kernel<D, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_uniq + TILE - 1) / TILE;
  push_adagrad_kernel<D, BF16><<<blocks, THREADS, smem, stream>>>(
      slab, grads, perm, offsets, uids, out, n_uniq, seed, conf, plan);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(void* slab, const float* grads, const int* perm,
             const int* offsets, const int* uids, void* out, int n_uniq,
             int D, int seed, const float* conf_host, const int* plan_host,
             void* stream) {
  if (n_uniq <= 0) return 0;
  PushConf conf;
  float* dst = &conf.nonclk_coeff;
  for (int k = 0; k < kConfFloats; ++k) dst[k] = conf_host[k];
  RowPlan plan = {};
  if (BF16) {
    if (9 + D > MAX_PLAN_COLS) return (int)cudaErrorInvalidValue;
    for (int c = 0; c < 9 + D; ++c) {
      plan.hi[c] = (short)plan_host[c];
      plan.lo[c] = (short)plan_host[9 + D + c];
    }
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t sd = (uint32_t)seed;
#define PBT_PUSH_CASE(d)                                                    \
  case d:                                                                   \
    return launch<d, BF16>(slab, grads, perm, offsets, uids, out, n_uniq, \
                           sd, conf, plan, s)
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
  return dispatch<false>(slab, grads, perm, offsets, uids, out, n_uniq, D,
                         seed, conf_host, nullptr, stream);
}

// The same push on the bf16 slab: slab [C, 17 + D] and out null or
// [n_uniq, 17 + D] hold 2-byte device rows; each unique's row is decoded
// to f32, updated as above and encoded back. plan_host points at 2 * (9 +
// D) host ints, the layout's column plan: hi positions, then lo positions
// (-1 for a bf16 column), each below 17 + D.
extern "C" int pbt_push_adagrad_bf16(uint16_t* slab, const float* grads,
                                     const int* perm, const int* offsets,
                                     const int* uids, uint16_t* out,
                                     int n_uniq, int D, int seed,
                                     const float* conf_host,
                                     const int* plan_host, void* stream) {
  return dispatch<true>(slab, grads, perm, offsets, uids, out, n_uniq, D,
                        seed, conf_host, plan_host, stream);
}
