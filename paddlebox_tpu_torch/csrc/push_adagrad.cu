// The sparse push of one train step, fused: merge the per-occurrence push
// rows of each unique key, read its slab row, apply the table's in-table
// update (with lazy embedx creation) and write the row back.
//
// Replaces the TPU kernel paddlebox_tpu/embedding/pallas_push.py:_push_kernel
// (wrapper pallas_apply_push) together with the XLA work around it in
// paddlebox_tpu/embedding/optimizers.py:275-345 (push_sparse_hostdedup:
// the occurrence gather, the sorted segment_sum merge, the row gather and
// the row scatter), and for the rules the TPU kernel does not carry, the
// XLA apply_push (optimizers.py:73-225). The rule is a template argument:
//   adagrad      the TPU kernel's: per-feature-lr adagrad on embed_w (the lr
//                picked by the UPDATED slot), shared-g2sum adagrad on embedx;
//   adam         per-column adam on embed_w (learning_rate, beta*_decay_rate,
//                ada_epsilon) and on embedx (learning_rate too, with
//                mf_beta*_decay_rate and mf_ada_epsilon), both clipped to
//                the mf bounds, with their beta power columns;
//   adam_shared  embed_w as adam; embedx with scalar moments of the mean over
//                D of the scaled grads and of their squares;
//   naive        SGD: embed_w at learning_rate within min/max_bound, embedx at
//                mf_learning_rate within the mf bounds; no state.
// Every rule keeps show/click/delta_score/unseen bookkeeping and lazy embedx
// creation from an integer hash of (slab row id, column, seed); the embed_w
// state changes on every active row, the embedx state only where embedx
// exists. The expand block (E > 0, with adagrad or naive) shares the embedx
// gate: created with embedx (expand column e hashes column D + e, so its
// draws differ from embedx's), else stepped at mf_learning_rate (adagrad
// with one shared g2sum column, or naive). Rows whose merged g_show is 0
// pass through.
//
// Inputs: the slab [C, W] (W by the rule, accessor.py: 9 + D for adagrad,
// 11 + 3D + 2 adam, 15 + D adam_shared, 7 + D naive, and E + 1 (adagrad) or
// E (naive) more with the expand block), the per-occurrence push rows grads
// [K, G] (G = 4 + D + E), perm [K] (occurrences grouped by unique,
// ascending in each group), offsets [K + 1] (unique j's occurrences are
// perm[offsets[j] .. offsets[j + 1]), padding occurrences left out) and the
// strictly ascending uids [K], of which the first n_uniq are slab rows. Only
// those n_uniq are launched; the padding uids (>= C) never are. Two write
// modes: in place, slab[uids[j]] = new row (the scatter path), or rows out,
// out[j] = new row for every j < n_uniq, pass-through rows included (the
// blocked path, whose blocked_write places them).
//
// Bound on an H100: memory. Each valid occurrence moves its perm entry and
// its push row (4 + G * 4 B), each unique its uid and offset, its slab row
// read and its new row written (8 + 2 * W * 4 B): at the flagship batch
// (82,167 occurrences, 77,128 uniques, D = 8) 15.4 MB for adagrad, 4.6 us at
// 3.35 TB/s; adam (W = 37) 27.7 MB, adagrad with a 64-wide expand block
// (W = 82, G = 76) 76.5 MB. The arithmetic is tens of flops a column, far
// below the card's rate.
//
// Design: a block of TILE threads takes a tile of TILE consecutive uniques.
// (1) It loads the tile's uids and offsets, and the perm entries of the
// tile's occurrences (up to OCC = 2 TILE of them), coalesced, into shared
// memory. (2) It copies the tile's slab rows and occurrence push rows into
// shared memory with 4-byte cp.async: thread l takes flattened elements l,
// l + TILE, ..., so a warp's 32 loads cover a few contiguous rows instead
// of 32 rows a row apart, and every load of the tile is in flight before
// the block waits for any. (3) One thread per unique merges its occurrences
// in registers and updates its row in shared memory; D and E are template
// arguments, so the column loops unroll. (4) The tile writes its rows back,
// contiguous a row (in place) or the whole tile as one contiguous run (rows
// out). A unique's occurrences past the tile's OCC budget (a hot key) are
// read from global memory in the same loop, so a segment of any length is
// summed exactly. Each uid is distinct, so the rows one block reads and
// writes are its own. TILE is 128 uniques where the tile's shared memory
// fits in 64 KiB, else 64 or 32 (a wide row: adagrad with D = 64, the
// expand block), so that several blocks stay resident an SM; the first
// launch of each instantiation on a device checks that one fits at all.
//
// Numerics: build WITHOUT --use_fast_math and with --fmad=false, so sqrtf and
// the divisions are IEEE and no multiply-add is contracted. Each unique's
// push rows are summed from 0.0f in ascending occurrence order, as
// torch.segment_reduce and JAX's sorted segment_sum add them; the update
// then takes exactly the f32 operations of its plain PyTorch version
// (push_kernels.push_adagrad_plain): each mean over columns is summed from
// column 0 up and divided by the width; adam's ratio is a true division; each
// 1 - beta comes from the host as the double rounded to f32. The creation
// hash is uint32 arithmetic exactly as in the TPU kernel, including its >>8
// -> int32 -> f32 step, so created columns are bit-identical to the JAX
// package's.

// The bf16 slab (embedding/accessor.py, slab_embed_dtype="bfloat16"): the
// slab rows are DW = 2 W - (1 + D + E) 2-byte columns, bf16 weights
// (embed_w, embedx, expand) and (hi, lo) halves of every other column. The
// reference decodes the rows, runs the update on f32 and encodes the result
// (optimizers.py:259-262, 306-316, 342-343); this form does the same inside
// the kernel: each unique's device row is staged in shared memory (2-byte
// loads through registers, 32 a thread in flight: cp.async takes no 2-byte
// copy and an odd-width row starts 4-byte aligned only on every other row),
// decoded exactly to f32, updated by the same code as the f32 form, and
// encoded with the integer round to nearest even and the NaN quieting of
// the reference's numpy encoder (never __float2bfloat16_rn, whose NaN is
// canonical). The column plan (which device columns hold each logical
// column) comes from the host, accessor.slab_codec_plan, as the decoding
// gather's does. Every unique's row is decoded and encoded, as in the
// reference; for a row written by the codec the round trip is the identity,
// so a pass-through row keeps its bits. At the flagship batch the adagrad
// form moves 12.6 MB (occurrences 82,167 x 52 B; uniques 77,128 x (8 + 2 x
// 50) B), 3.8 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

enum Rule { kAdagrad = 0, kAdam = 1, kAdamShared = 2, kNaive = 3 };

// header columns of a value row and of a push row (accessor.py)
constexpr int kSlot = 0, kShow = 1, kClick = 2, kDelta = 3, kUnseen = 4,
              kMfSize = 5, kEmbedW = 6, kEmbedState = 7;
constexpr int gSlot = 0, gShow = 1, gClick = 2, gEmbed = 3, gEmbedx = 4;

// The column map of a layout (accessor.ValueLayout): state widths by rule.
template <int RULE, int D, int E>
struct Layout {
  static constexpr int ES = RULE == kAdagrad ? 1 : RULE == kNaive ? 0 : 4;
  static constexpr int XS =
      RULE == kAdagrad ? 1 : RULE == kAdam ? 2 * D + 2
                                           : RULE == kAdamShared ? 4 : 0;
  static constexpr int EMBEDX = kEmbedState + ES;
  static constexpr int XSTATE = EMBEDX + D;
  static constexpr int EXPAND = XSTATE + XS;
  static constexpr int ESTATE = EXPAND + E;
  static constexpr int W = ESTATE + ((E > 0 && RULE == kAdagrad) ? 1 : 0);
  static constexpr int G = 4 + D + E;
  static constexpr int DW = 2 * W - (1 + D + E);  // the bf16 slab's row
};

struct PushConf {
  float nonclk_coeff, clk_coeff, nodeid_slot, mf_learning_rate,
      feature_learning_rate, mf_initial_g2sum, mf_min_bound, mf_max_bound,
      mf_create_thresholds, mf_initial_range, learning_rate, min_bound,
      max_bound, beta1, beta2, one_minus_beta1, one_minus_beta2, ada_epsilon,
      mf_beta1, mf_beta2, one_minus_mf_beta1, one_minus_mf_beta2,
      mf_ada_epsilon;
};
constexpr int kConfFloats = 23;

// a NaN stays NaN, as jnp.clip and torch.clamp keep it (fmaxf alone would
// return the bound)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
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
__host__ __device__ constexpr int stage_bytes(int tile, int W, int G, int DW) {
  return (tile + tile + 1 + 2 * tile) * 4 +
         (tile * W + 2 * tile * (G | 1)) * 4 + tile * DW * 2;
}

// uniques a tile: 128 where the tile's shared memory fits in 64 KiB, else
// 64, else 32
__host__ __device__ constexpr int tile_for(int W, int G, int DW) {
  return stage_bytes(128, W, G, DW) <= 64 * 1024   ? 128
         : stage_bytes(64, W, G, DW) <= 64 * 1024 ? 64
                                                   : 32;
}

// The bf16 slab's column plan (embedding/accessor.py slab_codec_plan),
// passed as a kernel parameter: logical column c is the f32 bits (hi[c] <<
// 16 | lo[c]) of device columns hi[c] and lo[c], or a bf16 at hi[c] when
// lo[c] is -1. The threads of a warp read the same entry at once.
constexpr int MAX_PLAN_COLS = 96;
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
template <int W>
__device__ __forceinline__ void decode_row(const uint16_t* raw, float* v,
                                           const RowPlan& plan) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const int lo = plan.lo[c];
    v[c] = __uint_as_float(((uint32_t)raw[plan.hi[c]] << 16) |
                           (lo < 0 ? 0u : (uint32_t)raw[lo]));
  }
}

// encode f32 `v` [W] into device row `raw` [DW]
template <int W>
__device__ __forceinline__ void encode_row(const float* v, uint16_t* raw,
                                           const RowPlan& plan) {
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

// uniform [0, mf_initial_range) of column `col` of slab row `uid`: the TPU
// kernel's hash (pallas_push.py:86-98)
__device__ __forceinline__ float fresh(uint32_t uid, uint32_t col,
                                       uint32_t seed, float range) {
  uint32_t bits = (uid * 2654435761u) ^ (col * 40503u + seed);
  bits = bits * 747796405u + 2891336453u;
  bits ^= bits >> 16;
  const float u01 = (float)(int32_t)(bits >> 8) * (1.0f / 16777216.0f);
  return u01 * range;
}

// adam on one column (optimizers.py _adam_step): w, m, v in place, with the
// row's ratio lr * sqrt(1 - b2p) / (1 - b1p)
__device__ __forceinline__ void adam_col(float* w, float* m, float* v,
                                         float s, float ratio, float b1,
                                         float b2, float omb1, float omb2,
                                         float eps, float lo, float hi) {
  const float nm = b1 * *m + omb1 * s;
  const float nv = b2 * *v + omb2 * s * s;
  *w = clip(*w + ratio * (nm / (sqrtf(nv) + eps)), lo, hi);
  *m = nm;
  *v = nv;
}

// The in-table update of one unique's row v [W] (shared memory) from its
// merged push row m [G]; the caller skips rows whose merged g_show is not
// positive (they pass through).
template <int RULE, int D, int E>
__device__ __forceinline__ void update_row(float* v, const float* m,
                                           uint32_t uid, uint32_t seed,
                                           const PushConf& conf) {
  using L = Layout<RULE, D, E>;
  const float g_show = m[gShow];
  const float g_click = m[gClick];
  const float slot = m[gSlot];
  const float show = v[kShow] + g_show;
  const float click = v[kClick] + g_click;
  const float delta =
      (v[kDelta] + conf.nonclk_coeff * (g_show - g_click)) +
      conf.clk_coeff * g_click;
  const float mf_size = v[kMfSize];
  const float score =
      conf.nonclk_coeff * (show - click) + conf.clk_coeff * click;
  const bool create =
      (mf_size == 0.0f) && (score >= conf.mf_create_thresholds);
  const bool has_mf = mf_size > 0.0f;
  const float lo = conf.mf_min_bound, hi = conf.mf_max_bound;

  // embed_w and its state, on every active row
  const float sw = m[gEmbed] / g_show;
  if (RULE == kAdagrad) {
    const float lr = (slot == conf.nodeid_slot) ? conf.mf_learning_rate
                                                : conf.feature_learning_rate;
    const float g2 = v[kEmbedState];
    const float ratio =
        lr * sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + g2));
    v[kEmbedW] = clip(v[kEmbedW] + ratio * sw, lo, hi);
    v[kEmbedState] = g2 + sw * sw;
  } else if (RULE == kAdam || RULE == kAdamShared) {
    float* st = v + kEmbedState;  // m, v, b1p, b2p
    const float ratio =
        conf.learning_rate * sqrtf(1.0f - st[3]) / (1.0f - st[2]);
    adam_col(v + kEmbedW, st, st + 1, sw, ratio, conf.beta1, conf.beta2,
             conf.one_minus_beta1, conf.one_minus_beta2, conf.ada_epsilon,
             lo, hi);
    st[2] = st[2] * conf.beta1;
    st[3] = st[3] * conf.beta2;
  } else {
    v[kEmbedW] = clip(v[kEmbedW] + conf.learning_rate * sw, conf.min_bound,
                      conf.max_bound);
  }

  // embedx and the expand block: created, else updated once they exist
  float* x = v + L::EMBEDX;
  float* xs = v + L::XSTATE;
  float* e = v + L::EXPAND;
  if (create) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      x[c] = fresh(uid, (uint32_t)c, seed, conf.mf_initial_range);
#pragma unroll
    for (int c = 0; c < E; ++c)
      e[c] = fresh(uid, (uint32_t)(D + c), seed, conf.mf_initial_range);
  } else if (has_mf) {
    if (RULE == kAdagrad) {
      float sx[D];  // the scaled embedx grads
      float sq = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        sx[c] = m[gEmbedx + c] / g_show;
        sq = sq + sx[c] * sx[c];
      }
      const float xg2 = xs[0];
      const float xratio =
          conf.mf_learning_rate *
          sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + xg2));
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] = clip(x[c] + xratio * sx[c], lo, hi);
      xs[0] = xg2 + sq / (float)D;
    } else if (RULE == kAdam) {
      // xs: m [D], v [D], b1p, b2p
      const float ratio = conf.learning_rate * sqrtf(1.0f - xs[2 * D + 1]) /
                          (1.0f - xs[2 * D]);
#pragma unroll
      for (int c = 0; c < D; ++c)
        adam_col(x + c, xs + c, xs + D + c, m[gEmbedx + c] / g_show, ratio,
                 conf.mf_beta1, conf.mf_beta2, conf.one_minus_mf_beta1,
                 conf.one_minus_mf_beta2, conf.mf_ada_epsilon, lo, hi);
      xs[2 * D] = xs[2 * D] * conf.mf_beta1;
      xs[2 * D + 1] = xs[2 * D + 1] * conf.mf_beta2;
    } else if (RULE == kAdamShared) {
      // xs: m, v, b1p, b2p, scalars over the row
      float sx[D];
      float sum = 0.0f, sq = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        sx[c] = m[gEmbedx + c] / g_show;
        sum = sum + sx[c];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) sq = sq + sx[c] * sx[c];
      const float gm = sum / (float)D;
      const float gsq = sq / (float)D;
      const float ratio =
          conf.learning_rate * sqrtf(1.0f - xs[3]) / (1.0f - xs[2]);
      const float nm = conf.mf_beta1 * xs[0] + conf.one_minus_mf_beta1 * gm;
      const float nv = conf.mf_beta2 * xs[1] + conf.one_minus_mf_beta2 * gsq;
      const float step = ratio * (nm / (sqrtf(nv) + conf.mf_ada_epsilon));
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] = clip(x[c] + step, lo, hi);
      xs[0] = nm;
      xs[1] = nv;
      xs[2] = xs[2] * conf.mf_beta1;
      xs[3] = xs[3] * conf.mf_beta2;
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c)
        x[c] = clip(x[c] + conf.mf_learning_rate * (m[gEmbedx + c] / g_show),
                    lo, hi);
    }
    if constexpr (E > 0) {
      const float* eg = m + gEmbedx + D;
      if (RULE == kAdagrad) {
        float* eg2 = v + L::ESTATE;
        const float old = eg2[0];
        const float eratio =
            conf.mf_learning_rate *
            sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + old));
        float sq = 0.0f;
#pragma unroll
        for (int c = 0; c < E; ++c) {
          const float s = eg[c] / g_show;
          sq = sq + s * s;
          e[c] = clip(e[c] + eratio * s, lo, hi);
        }
        eg2[0] = old + sq / (float)E;
      } else {
#pragma unroll
        for (int c = 0; c < E; ++c)
          e[c] = clip(e[c] + conf.mf_learning_rate * (eg[c] / g_show), lo, hi);
      }
    }
  }
  v[kSlot] = slot;
  v[kShow] = show;
  v[kClick] = click;
  v[kDelta] = delta;
  v[kUnseen] = 0.0f;
  v[kMfSize] = create ? (float)D : mf_size;
}

// BF16: the slab (and out) hold the bf16 slab's 2-byte device rows of DW
// columns, decoded on read and encoded on write by `plan`; else f32 rows of
// W columns (plan unused).
template <int RULE, int D, int E, bool BF16>
__global__ void __launch_bounds__(tile_for(Layout<RULE, D, E>::W,
                                           Layout<RULE, D, E>::G,
                                           BF16 ? Layout<RULE, D, E>::DW : 0))
push_adagrad_kernel(void* __restrict__ slab_v,
                    const float* __restrict__ grads,
                    const int* __restrict__ perm,
                    const int* __restrict__ offsets,
                    const int* __restrict__ uids, void* __restrict__ out_v,
                    int n_uniq, uint32_t seed, PushConf conf,
                    const __grid_constant__ RowPlan plan) {
  using L = Layout<RULE, D, E>;
  constexpr int W = L::W, G = L::G, GP = G | 1, DW = L::DW;
  constexpr int TILE = tile_for(W, G, BF16 ? DW : 0);
  constexpr int OCC = 2 * TILE;
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
  for (int o = t; o < n_occ; o += TILE) s_perm[o] = perm[occ0 + o];
  __syncthreads();

  // (2) push rows and slab rows into shared memory: the push rows and f32
  // slab rows by cp.async, all in flight before the block waits; the bf16
  // slab's 2-byte rows through registers (cp.async takes no 2-byte copy,
  // and a row of odd width starts 4-byte aligned only on every other row)
  for (int f = t; f < n_occ * G; f += TILE) {
    const int o = f / G;
    const int c = f - o * G;
    cp_async4(s_occ + o * GP + c, grads + (int64_t)s_perm[o] * G + c);
  }
  if (BF16) {
    // a thread's elements t, t + TILE, ... of the tile's rows * DW, 32 at
    // a time, each chunk's loads issued before its first store
    const uint16_t* slab = reinterpret_cast<const uint16_t*>(slab_v);
    constexpr int CH = 32;
#pragma unroll
    for (int k0 = 0; k0 < DW; k0 += CH) {
      uint16_t r16[CH];
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int f = t + (k0 + k) * TILE;
        const int r = f / DW;
        if (k0 + k < DW && r < rows)
          r16[k] = __ldg(slab + (int64_t)s_uid[r] * DW + (f - r * DW));
      }
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int f = t + (k0 + k) * TILE;
        if (k0 + k < DW && f < rows * DW) s_raw[f] = r16[k];
      }
    }
  } else {
    const float* slab = reinterpret_cast<const float*>(slab_v);
    for (int f = t; f < rows * W; f += TILE) {
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
    if (BF16) decode_row<W>(s_raw + t * DW, v, plan);
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
    if (m[gShow] > 0.0f)
      update_row<RULE, D, E>(v, m, (uint32_t)s_uid[t], seed, conf);
    if (BF16) encode_row<W>(v, s_raw + t * DW, plan);
  }
  __syncthreads();

  // (4) the tile's rows back: at their slab rows, or as one run of out
  if (BF16) {
    if (out_v != nullptr) {
      uint16_t* o = reinterpret_cast<uint16_t*>(out_v) + (int64_t)j0 * DW;
      for (int f = t; f < rows * DW; f += TILE) o[f] = s_raw[f];
    } else {
      uint16_t* slab = reinterpret_cast<uint16_t*>(slab_v);
      for (int f = t; f < rows * DW; f += TILE) {
        const int r = f / DW;
        slab[(int64_t)s_uid[r] * DW + (f - r * DW)] = s_raw[f];
      }
    }
  } else {
    if (out_v != nullptr) {
      float* o = reinterpret_cast<float*>(out_v) + (int64_t)j0 * W;
      for (int f = t; f < rows * W; f += TILE) o[f] = s_row[f];
    } else {
      float* slab = reinterpret_cast<float*>(slab_v);
      for (int f = t; f < rows * W; f += TILE) {
        const int r = f / W;
        slab[(int64_t)s_uid[r] * W + (f - r * W)] = s_row[f];
      }
    }
  }
}

// On a device's first launch of an instantiation: raise its shared-memory
// limit where the tile needs more than 48 KiB, and check that at least one
// block fits an SM (the resident blocks an SM, as gather_rows.cu works
// them out). Kept: a later launch costs no query.
template <int RULE, int D, int E, bool BF16>
cudaError_t prepare(int smem, int tile) {
  static std::mutex mu;
  static std::map<int, int> known;  // device -> resident blocks an SM
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (known.count(dev)) return cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(push_adagrad_kernel<RULE, D, E, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, push_adagrad_kernel<RULE, D, E, BF16>, tile, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known[dev] = per_sm;
  return cudaSuccess;
}

template <int RULE, int D, int E, bool BF16>
int launch(void* slab, const float* grads, const int* perm,
           const int* offsets, const int* uids, void* out, int n_uniq,
           uint32_t seed, const PushConf& conf, const RowPlan& plan,
           cudaStream_t stream) {
  using L = Layout<RULE, D, E>;
  constexpr int DWs = BF16 ? L::DW : 0;
  constexpr int tile = tile_for(L::W, L::G, DWs);
  constexpr int smem = stage_bytes(tile, L::W, L::G, DWs);
  if (BF16 && L::W > MAX_PLAN_COLS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare<RULE, D, E, BF16>(smem, tile);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_uniq + tile - 1) / tile;
  push_adagrad_kernel<RULE, D, E, BF16><<<blocks, tile, smem, stream>>>(
      slab, grads, perm, offsets, uids, out, n_uniq, seed, conf, plan);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(void* slab, const float* grads, const int* perm,
             const int* offsets, const int* uids, void* out, int n_uniq,
             int rule, int D, int E, uint32_t seed, const PushConf& conf,
             const RowPlan& plan, cudaStream_t s) {
#define PBT_PUSH_CASE(r, d, e)                                              \
  if (rule == r && D == d && E == e)                                        \
  return launch<r, d, e, BF16>(slab, grads, perm, offsets, uids, out,       \
                               n_uniq, seed, conf, plan, s)
  // adagrad at every embedx width of push_kernels.KERNEL_EMBEDX_DIMS
  PBT_PUSH_CASE(kAdagrad, 2, 0);
  PBT_PUSH_CASE(kAdagrad, 4, 0);
  PBT_PUSH_CASE(kAdagrad, 8, 0);
  PBT_PUSH_CASE(kAdagrad, 16, 0);
  PBT_PUSH_CASE(kAdagrad, 32, 0);
  PBT_PUSH_CASE(kAdagrad, 64, 0);
  // the other rules at KERNEL_RULE_DIMS
  PBT_PUSH_CASE(kAdam, 8, 0);
  PBT_PUSH_CASE(kAdamShared, 8, 0);
  PBT_PUSH_CASE(kNaive, 8, 0);
  // the expand block at KERNEL_EXPAND_DIMS
  PBT_PUSH_CASE(kAdagrad, 8, 64);
  PBT_PUSH_CASE(kNaive, 8, 64);
#undef PBT_PUSH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// slab [C, W] f32 (written in place when out is null), or under bf16 != 0
// the bf16 slab's 2-byte rows [C, DW], each decoded to f32, updated and
// encoded back; grads [K, 4 + D + E] f32, perm [K] i32, offsets [K + 1]
// i32, uids [K] i32 with uids[0 .. n_uniq) distinct rows of the slab, out
// null or [n_uniq, W] f32 ([n_uniq, DW] 2-byte under bf16); all contiguous
// on the current device. rule: 0 adagrad, 1 adam, 2 adam_shared, 3 naive
// (push_kernels.KERNEL_RULES); (rule, D, E) must be an instantiation above
// (push_kernels.kernel_built_for; any other gives cudaErrorInvalidValue).
// conf points at 23 host floats in PushConf order; plan_host (bf16 only)
// at 2 * W host ints, the layout's column plan: hi positions, then lo
// positions (-1 for a bf16 column), each below DW. Launches on `stream`;
// returns cudaGetLastError() (or the error of preparing the launch).
extern "C" int pbt_push(void* slab, const float* grads, const int* perm,
                        const int* offsets, const int* uids, void* out,
                        int n_uniq, int rule, int D, int E, int bf16,
                        int seed, const float* conf_host,
                        const int* plan_host, void* stream) {
  if (n_uniq <= 0) return 0;
  PushConf conf;
  float* dst = &conf.nonclk_coeff;
  for (int k = 0; k < kConfFloats; ++k) dst[k] = conf_host[k];
  RowPlan plan = {};
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t sd = (uint32_t)seed;
  if (bf16) {
    // W of the layout from the plan's length: the host passes 2 * W ints
    int W = 0;
    switch (rule) {
      case kAdagrad: W = 9 + D + (E ? E + 1 : 0); break;
      case kAdam: W = 13 + 3 * D; break;
      case kAdamShared: W = 15 + D; break;
      case kNaive: W = 7 + D + E; break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (W > MAX_PLAN_COLS || plan_host == nullptr)
      return (int)cudaErrorInvalidValue;
    for (int c = 0; c < W; ++c) {
      plan.hi[c] = (short)plan_host[c];
      plan.lo[c] = (short)plan_host[W + c];
    }
    return dispatch<true>(slab, grads, perm, offsets, uids, out, n_uniq, rule,
                          D, E, sd, conf, plan, s);
  }
  return dispatch<false>(slab, grads, perm, offsets, uids, out, n_uniq, rule,
                         D, E, sd, conf, plan, s);
}
