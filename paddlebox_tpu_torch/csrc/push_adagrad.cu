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
// Design: two, chosen at compile time by the row (Shape: lanes_for).
//
// The lane-group design (push_adagrad_kernel_group), where the wider of the value
// row and the push row has more than 48 columns (the expand block: W 79-82,
// G 76; adagrad at D = 64): a warp a unique, blocks decoupled from the
// row. A block of GTHREADS = 128 threads takes a tile of 16 consecutive
// uniques. (1) The tile's slab rows go in flight first by 4-byte cp.async
// (their uids read from global memory), then its uids, offsets and the
// perm entries of its first OCC = 40 occurrences land in shared memory,
// then the staged occurrences' push rows by cp.async (16 bytes where G %
// 4 == 0 and the rows are 16-byte aligned). (2) Each warp merges its
// unique's occurrences column-parallel: lane l sums columns l, l + 32, ...
// in ascending occurrence order into the merged row in shared memory (a
// hot key's occurrences past the staged ones are read from global memory
// in the same loop, so a run of any length is summed exactly); under bf16
// it first decodes the same columns. (3) One thread a unique takes the
// row-level step (row_step): show, click, delta, unseen, mf_size, the
// creation gate, embed_w and its state, and the rates of the column step
// (adagrad's embedx and expand ratios, adam's ratio and beta powers,
// adam_shared's means over the row and its step), each in column order
// from column 0. (4) The warps take the column step (column_step): the
// creation hash, or each embedx and expand column's update; adagrad's
// scaled grads are left in the merged row, and (5) one thread a unique
// sums their squares from column 0 into the shared g2sums (sq_step). (6)
// Under bf16 the warps encode every row: back into its staged words (in
// place), or into the tile's run of out. (7) The tile's rows go back: at
// their slab rows (the 2-byte rows by 4-byte words, a row's edge halves by
// 2-byte stores), or as one bulk asynchronous copy (cp.async.bulk) of the
// full tile's run of out. The tile's buffers are static shared memory (at
// most 26 KB, the bf16 expand row), 8 blocks an SM (53-55 registers); the
// flagship batch gives 4,821 tiles, so the blocks of later waves load
// while earlier ones compute.
//
// The thread design (push_adagrad_kernel), for the narrower rows (the
// flagship's 17 columns, adam's 37): a block of TILE threads takes a tile
// of TILE consecutive uniques (128 where the tile's shared memory fits in
// 64 KiB, else 64 or 32), a thread a unique. (1) It loads the tile's uids,
// offsets and the perm entries of its first 2 TILE occurrences into shared
// memory; (2) copies the tile's occurrence push rows and slab rows into
// shared memory with 4-byte cp.async, thread l taking flattened elements
// l, l + TILE, ..., every load of the tile in flight before the block
// waits; 2-byte rows wider than 32 columns by the words that hold them (as
// the lane groups), narrower ones by 2-byte loads through registers, 32 a
// thread in flight; (3) merges each unique's occurrences in registers and
// updates its row in one pass (update_row; D and E are template
// arguments, so the column loops unroll); (4) writes the tile's rows back,
// contiguous a row (in place) or as one contiguous run (rows out).
//
// On an H100 80GB HBM3 at 700 W (push_probe.py --forms --tree, the
// earlier source, a thread a unique at every width, and this one in one
// call, in the order earlier, this, this, earlier; rows out ms at the
// flagship batch; PERF.md §6): expand 0.0469-0.0470 against 0.0624-0.0626
// (bound 0.0228), naive expand 0.0424-0.0425 against 0.0615-0.0618, bf16
// expand 0.0585-0.0586 against 0.0838-0.0842 (bound 0.0161), bf16 naive
// expand 0.0543 against 0.0855-0.0858; at the chunk shape (410,407
// uniques) expand 0.2185-0.2186 against 0.2955-0.2970 (bound 0.1416); bf16
// adam 0.0281-0.0282 against 0.0327, bf16 adam_shared 0.0166-0.0167
// against 0.0219-0.0221 (the word staging); the other forms within 1% of
// the earlier source (adagrad 0.0124-0.0125, its source's code). Designs
// tried, each beside the earlier source in one call:
// - The lane-group design at every width, groups sized by the row (8
//   lanes at W 17, 16 at W 37), 16-unique tiles: adagrad 0.0230-0.0232
//   against 0.0127, adam 0.0278-0.0279 against 0.0180, bf16 adagrad 0.0273
//   against 0.0143, expand 0.0478 against 0.0631, bf16 expand 0.0649
//   against 0.0844 (its bf16 rows out then stored a 2-byte element a
//   thread through a per-element index; in another call 0.0635-0.0641
//   beside 0.0844, against 0.0581-0.0582 beside 0.0837 for the encoded
//   run and one bulk copy). The lane groups do not cut the
//   instructions a narrow row takes, and a 16-unique tile pays the load
//   chain and six block barriers for little work.
// - That design as persistent blocks walking contiguous tiles in a
//   three-stage pipeline (the next tile's rows and the ids of the one
//   after in flight while a tile computes; 37 KB of shared memory, 64
//   registers): adagrad 0.0172, adam 0.0215-0.0217, expand 0.0525-0.0529,
//   bf16 expand 0.0820-0.0822.
// - The thread design with the lane groups' split update (row, column and
//   sum steps): adagrad 0.01263-0.01298 against 0.01246-0.01257 and the
//   single-pass update's 0.01240-0.01244; with the slab rows issued before
//   the perm entries, each uid read from global memory by the thread that
//   copies its elements: 0.0138; the tile's loads and compute in two
//   halves, the first half computing while the second lands: 0.0148.
// - Word staging of the 2-byte rows in the thread design at every width:
//   bf16 adagrad (25 columns) 0.01448-0.01449 against 0.01426, bf16
//   naive (21) 0.01346-0.01350 against 0.01340-0.01348.
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
// the kernel: each unique's device row is staged in shared memory (by the
// 4-byte words that hold it: a row of odd width starts 4-byte aligned only
// on every other row, and a neighbour's half in its first or last word is
// never written back; or by 2-byte loads, see the designs above), decoded
// exactly to f32, updated by the same code as the f32 form, and encoded
// with the integer round to nearest even and the NaN quieting of
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The bf16 slab's column plan (embedding/accessor.py slab_codec_plan),
// passed as a kernel parameter and copied into shared memory: logical
// column c is the f32 bits (hi[c] << 16 | lo[c]) of device columns hi[c]
// and lo[c], or a bf16 at hi[c] when lo[c] is -1.
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

// ------------------------------------------------------ the tile's shape

constexpr int GTHREADS = 128;  // threads a lane-group block

// lanes a unique: a warp where the wider of the value and push rows has
// more than 48 columns (the expand block, adagrad at D = 64), else one
// thread (see the header)
__host__ __device__ constexpr int lanes_for(int W, int G) {
  return (W > G ? W : G) > 48 ? 32 : 1;
}

// Shared memory of a thread-design tile, in order: uids [TILE], offsets
// [TILE + 1], perm [OCC] (ints), slab rows [TILE][W] and push rows
// [OCC][G | 1] (floats: an odd stride, so the threads of the merge, each
// reading its own unique's rows, hit distinct banks), then under the bf16
// slab the staged device rows [TILE][RS] (2-byte).
__host__ __device__ constexpr int stage_bytes(int tile, int W, int G,
                                              int RS) {
  return (tile + tile + 1 + 2 * tile) * 4 +
         (tile * W + 2 * tile * (G | 1)) * 4 + tile * RS * 2;
}

// uniques a thread-design tile: 128 where its shared memory fits in 64
// KiB, else 64, else 32
__host__ __device__ constexpr int tile_for(int W, int G, int RS) {
  return stage_bytes(128, W, G, RS) <= 64 * 1024   ? 128
         : stage_bytes(64, W, G, RS) <= 64 * 1024 ? 64
                                                   : 32;
}

template <int RULE, int D, int E, bool BF16>
struct Shape {
  using L = Layout<RULE, D, E>;
  static constexpr int W = L::W, G = L::G, DW = L::DW;
  static constexpr int LANES = lanes_for(W, G);
  // bf16: the device rows are staged by the 4-byte words that hold them
  // (lane groups, and the thread design's rows wider than 32 2-byte
  // columns), else by 2-byte loads through registers
  static constexpr bool WORDS = BF16 && (LANES > 1 || DW > 32);
  // 2-byte elements of a staged device row: its aligned words, or the row
  static constexpr int RS = !BF16 ? 0 : WORDS ? 2 * (DW / 2 + 1) : DW;
  // uniques a tile (16 in the lane-group design) and its staged
  // occurrences
  static constexpr int TILE = LANES > 1 ? 16 : tile_for(W, G, RS);
  static constexpr int OCC = LANES > 1 ? 2 * TILE + 8 : 2 * TILE;
};

// what the column step does to a unique's row (row_step decides)
enum Mode { kPassThrough = 0, kHeaderOnly = 1, kCreate = 2, kUpdate = 3 };

// A lane-group tile's shared memory. row, raw and occ take cp.async (occ
// 16 bytes at a time: each of its rows starts 16-byte aligned when
// G % 4 == 0); raw is also the run a bulk copy writes out (16-byte
// aligned: row's bytes are a multiple of 64).
template <class S>
struct __align__(16) GroupTile {
  float row[S::TILE * S::W];   // the slab rows (decoded under bf16)
  uint16_t raw[S::TILE * (S::RS > 0 ? S::RS : 2)];  // bf16: staged rows
  float occ[S::OCC * S::G];    // the staged occurrences' push rows
  float m[S::TILE * S::G];     // merged push rows, then adagrad's scaled grads
  float sc[S::TILE * 2];       // the column step's rates, a unique
  int uid[S::TILE];
  int off[S::TILE + 1];        // occurrence offsets from the tile's first
  int perm[S::OCC];
  int mode[S::TILE];
  short hi[S::RS > 0 ? S::W : 1], lo[S::RS > 0 ? S::W : 1];  // bf16: the plan
};

// ------------------------------------------------------ the 2-byte rows

// the half of its first 4-byte word at which 2-byte row `uid` starts
template <int DW>
__device__ __forceinline__ int lead(const uint16_t* slab16, int uid) {
  return (int)((reinterpret_cast<uintptr_t>(slab16 + (int64_t)uid * DW) >>
                1) & 1);
}

// cp.async of a tile's device rows (slab rows uids[0 .. rows)) into raw
// [rows][RS] by the 4-byte words that hold them, thread t of n taking
// words t, t + n, ...
template <int DW, int RS>
__device__ __forceinline__ void stage_rows16(uint16_t* raw,
                                             const uint16_t* slab16,
                                             const int* uids, int rows,
                                             int t, int n) {
  constexpr int WPR = RS / 2;
  for (int f = t; f < rows * WPR; f += n) {
    const int r = f / WPR, w = f - r * WPR;
    const int uid = uids[r], h = lead<DW>(slab16, uid);
    if (w < (h + DW + 1) / 2)
      cp_async4(raw + r * RS + 2 * w, slab16 + (int64_t)uid * DW - h + 2 * w);
  }
}

// A tile's staged device rows back at their slab rows: each row's words as
// staged, a word shared with a neighbour's row writing only this row's
// half. uid: the tile's uids in shared memory.
template <int DW, int RS>
__device__ __forceinline__ void store_rows16(uint16_t* slab16,
                                             const uint16_t* raw,
                                             const int* uid, int rows, int t,
                                             int n) {
  constexpr int WPR = RS / 2;
  for (int f = t; f < rows * WPR; f += n) {
    const int r = f / WPR, w = f - r * WPR;
    const int h = lead<DW>(slab16, uid[r]);
    if (w >= (h + DW + 1) / 2) continue;
    const int e = 2 * w - h;  // the word's low half in the row
    uint32_t* gw =
        reinterpret_cast<uint32_t*>(slab16 + (int64_t)uid[r] * DW - h) + w;
    const uint16_t* sw = raw + r * RS + 2 * w;
    if (e >= 0 && e + 1 < DW)
      *gw = *reinterpret_cast<const uint32_t*>(sw);
    else if (e >= 0)
      reinterpret_cast<uint16_t*>(gw)[0] = sw[0];
    else
      reinterpret_cast<uint16_t*>(gw)[1] = sw[1];
  }
}

// One bulk asynchronous copy (cp.async.bulk, shared to global) of `bytes`
// (a multiple of 16, both ends 16-byte aligned), waited for: the caller's
// shared memory is read before the block exits. The threads' writes to it
// were fenced to the async proxy and synchronized before.
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group 0;\n" ::"l"(gmem),
      "r"(smem_u32(smem)), "r"((unsigned)bytes)
      : "memory");
}

// logical column c of device row `raw` (plan: hi, lo; lo < 0: a bf16)
__device__ __forceinline__ float decode_col(const uint16_t* raw, int hi,
                                            int lo) {
  return __uint_as_float(((uint32_t)raw[hi] << 16) |
                         (lo < 0 ? 0u : (uint32_t)raw[lo]));
}

__device__ __forceinline__ void encode_col(float v, uint16_t* raw, int hi,
                                           int lo) {
  const uint32_t x = __float_as_uint(v);
  if (lo < 0) {
    raw[hi] = bf16_rne(x);
  } else {
    raw[hi] = (uint16_t)(x >> 16);
    raw[lo] = (uint16_t)(x & 0xFFFFu);
  }
}

// ------------------------------------------------------ the update, split

// The row-level part of a unique's update (one thread): the header
// columns, embed_w and its state, and the rates the column step takes,
// each in column order from column 0 as the plain version. Sets *mode;
// sc[0] (adagrad's embedx ratio, adam's ratio, adam_shared's step) and
// sc[1] (adagrad's expand ratio).
template <int RULE, int D, int E>
__device__ __forceinline__ void row_step(float* v, const float* m,
                                         const PushConf& conf, int* mode,
                                         float* sc) {
  using L = Layout<RULE, D, E>;
  const float g_show = m[gShow];
  if (!(g_show > 0.0f)) {  // an inactive row passes through unchanged
    *mode = kPassThrough;
    return;
  }
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

  // embedx and the expand block: created, else updated once they exist;
  // here only their row-level state and rates
  float* xs = v + L::XSTATE;
  int md = kHeaderOnly;
  if (create) {
    md = kCreate;
  } else if (has_mf) {
    md = kUpdate;
    if (RULE == kAdagrad) {
      sc[0] = conf.mf_learning_rate *
              sqrtf(conf.mf_initial_g2sum / (conf.mf_initial_g2sum + xs[0]));
      if (E > 0)
        sc[1] = conf.mf_learning_rate *
                sqrtf(conf.mf_initial_g2sum /
                      (conf.mf_initial_g2sum + v[L::ESTATE]));
    } else if (RULE == kAdam) {
      // xs: m [D], v [D], b1p, b2p
      sc[0] = conf.learning_rate * sqrtf(1.0f - xs[2 * D + 1]) /
              (1.0f - xs[2 * D]);
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
      sc[0] = ratio * (nm / (sqrtf(nv) + conf.mf_ada_epsilon));
      xs[0] = nm;
      xs[1] = nv;
      xs[2] = xs[2] * conf.mf_beta1;
      xs[3] = xs[3] * conf.mf_beta2;
    }
  }
  v[kSlot] = slot;
  v[kShow] = show;
  v[kClick] = click;
  v[kDelta] = delta;
  v[kUnseen] = 0.0f;
  v[kMfSize] = create ? (float)D : mf_size;
  *mode = md;
}

// The column part (lane l of the unique's group): embedx column q < D or
// expand column q - D, for q = l, l + LANES, ...: created by the hash
// (expand column e hashes column D + e), or updated by the row's rates.
// Adagrad's scaled grads replace the merged ones in m for sq_step.
template <int RULE, int D, int E, int LANES>
__device__ __forceinline__ void column_step(float* v, float* m, int mode,
                                            const float* sc, uint32_t uid,
                                            uint32_t seed,
                                            const PushConf& conf, int l) {
  using L = Layout<RULE, D, E>;
  constexpr int QS = (D + E + LANES - 1) / LANES;  // columns a lane
  if (mode == kCreate) {
#pragma unroll
    for (int i = 0; i < QS; ++i) {
      const int q = l + i * LANES;
      if (q < D)
        v[L::EMBEDX + q] = fresh(uid, (uint32_t)q, seed, conf.mf_initial_range);
      else if (q < D + E)
        v[L::EXPAND + q - D] =
            fresh(uid, (uint32_t)q, seed, conf.mf_initial_range);
    }
    return;
  }
  if (mode != kUpdate) return;
  const float lo = conf.mf_min_bound, hi = conf.mf_max_bound;
  const float g_show = m[gShow];
#pragma unroll
  for (int i = 0; i < QS; ++i) {
    const int q = l + i * LANES;
    if (q >= D + E) continue;
    const float gq = m[gEmbedx + q];
    if (q < D) {
      float* w = v + L::EMBEDX + q;
      if (RULE == kAdagrad) {
        const float s = gq / g_show;
        *w = clip(*w + sc[0] * s, lo, hi);
        m[gEmbedx + q] = s;
      } else if (RULE == kAdam) {
        float* xs = v + L::XSTATE;
        adam_col(w, xs + q, xs + D + q, gq / g_show, sc[0], conf.mf_beta1,
                 conf.mf_beta2, conf.one_minus_mf_beta1,
                 conf.one_minus_mf_beta2, conf.mf_ada_epsilon, lo, hi);
      } else if (RULE == kAdamShared) {
        *w = clip(*w + sc[0], lo, hi);
      } else {
        *w = clip(*w + conf.mf_learning_rate * (gq / g_show), lo, hi);
      }
    } else {
      float* w = v + L::EXPAND + (q - D);
      if (RULE == kAdagrad) {
        const float s = gq / g_show;
        *w = clip(*w + sc[1] * s, lo, hi);
        m[gEmbedx + q] = s;
      } else {
        *w = clip(*w + conf.mf_learning_rate * (gq / g_show), lo, hi);
      }
    }
  }
}

// Adagrad's shared g2sums after the column step (one thread): each the
// mean of the row's squared scaled grads, summed from column 0.
template <int D, int E>
__device__ __forceinline__ void sq_step(float* v, const float* m) {
  using L = Layout<kAdagrad, D, E>;
  const float* s = m + gEmbedx;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < D; ++c) sq = sq + s[c] * s[c];
  v[L::XSTATE] = v[L::XSTATE] + sq / (float)D;
  if constexpr (E > 0) {
    float sqe = 0.0f;
#pragma unroll
    for (int c = 0; c < E; ++c) sqe = sqe + s[D + c] * s[D + c];
    v[L::ESTATE] = v[L::ESTATE] + sqe / (float)E;
  }
}

// ------------------------------------------------ the update, one pass

// The thread design's in-table update of one unique's row v [W] (shared
// memory) from its merged push row m [G]; the caller skips rows whose
// merged g_show is not positive (they pass through).
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

// ----------------------------------------------------------- the kernels

// Both designs take the same arguments. BF16: the slab (and out) hold the
// bf16 slab's 2-byte device rows of DW columns, decoded on read and
// encoded on write by `plan`; else f32 rows of W columns (plan unused).
// occ_vec: grads is 16-byte aligned; bulk_out: out is 16-byte aligned.
#define PBT_PUSH_PARAMS                                                     \
  void *__restrict__ slab_v, const float *__restrict__ grads,               \
      const int *__restrict__ perm, const int *__restrict__ offsets,        \
      const int *__restrict__ uids, void *__restrict__ out_v, int n_uniq,   \
      uint32_t seed, PushConf conf, bool occ_vec, bool bulk_out,            \
      const __grid_constant__ RowPlan plan

// The lane-group design (wide rows): a tile of 16 uniques a block of
// GTHREADS threads, a group of LANES lanes a unique.
template <int RULE, int D, int E, bool BF16>
__global__ void __launch_bounds__(GTHREADS, 8)
push_adagrad_kernel_group(PBT_PUSH_PARAMS) {
  using S = Shape<RULE, D, E, BF16>;
  constexpr int W = S::W, G = S::G, DW = S::DW, LANES = S::LANES,
                TILE = S::TILE, OCC = S::OCC, RS = S::RS;
  constexpr int NG = GTHREADS / LANES;  // groups a block
  __shared__ GroupTile<S> sm;
  const int t = threadIdx.x;
  const int l = t & (LANES - 1), grp = t / LANES;
  const int j0 = blockIdx.x * TILE;
  const int rows = min(TILE, n_uniq - j0);
  const int occ0 = __ldg(offsets + j0);
  const int n_occ = min(__ldg(offsets + j0 + rows) - occ0, OCC);
  uint16_t* slab16 = reinterpret_cast<uint16_t*>(slab_v);

  // (1) the slab rows in flight, then the tile's ids, offsets and staged
  // perm entries, then the staged occurrences' push rows
  if constexpr (BF16) {
    stage_rows16<DW, RS>(sm.raw, slab16, uids + j0, rows, t, GTHREADS);
  } else {
    const float* slab = reinterpret_cast<const float*>(slab_v);
    for (int f = t; f < rows * W; f += GTHREADS) {
      const int r = f / W;
      cp_async4(sm.row + f,
                slab + (int64_t)__ldg(uids + j0 + r) * W + (f - r * W));
    }
  }
  if (t < rows) sm.uid[t] = __ldg(uids + j0 + t);
  if (t <= rows) sm.off[t] = __ldg(offsets + j0 + t) - occ0;
  for (int o = t; o < n_occ; o += GTHREADS)
    sm.perm[o] = __ldg(perm + occ0 + o);
  if constexpr (BF16)
    for (int c = t; c < W; c += GTHREADS) {
      sm.hi[c] = plan.hi[c];
      sm.lo[c] = plan.lo[c];
    }
  __syncthreads();
  if (G % 4 == 0 && occ_vec) {
    constexpr int GV = G / 4;
    for (int f = t; f < n_occ * GV; f += GTHREADS) {
      const int o = f / GV, c = 4 * (f - o * GV);
      cp_async16(sm.occ + o * G + c, grads + (int64_t)sm.perm[o] * G + c);
    }
  } else {
    for (int f = t; f < n_occ * G; f += GTHREADS) {
      const int o = f / G;
      cp_async4(sm.occ + f, grads + (int64_t)sm.perm[o] * G + (f - o * G));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // (2) a group a unique: decode (bf16), then merge each column's
  // occurrences in ascending order, from 0
  for (int u = grp; u < rows; u += NG) {
    float* v = sm.row + u * W;
    if constexpr (BF16) {
      const uint16_t* raw = sm.raw + u * RS + lead<DW>(slab16, sm.uid[u]);
      for (int c = l; c < W; c += LANES)
        v[c] = decode_col(raw, sm.hi[c], sm.lo[c]);
    }
    const int k0 = sm.off[u], k1 = sm.off[u + 1];
#pragma unroll
    for (int i = 0; i < (G + LANES - 1) / LANES; ++i) {
      const int c = l + i * LANES;
      if (c >= G) continue;
      float acc = 0.0f;
      for (int k = k0; k < k1; ++k)
        acc += k < n_occ ? sm.occ[k * G + c]
                         : __ldg(grads +
                                 (int64_t)__ldg(perm + occ0 + k) * G + c);
      sm.m[u * G + c] = acc;
    }
  }
  __syncthreads();

  // (3) a thread a unique: the row-level step
  if (t < rows)
    row_step<RULE, D, E>(sm.row + t * W, sm.m + t * G, conf, sm.mode + t,
                         sm.sc + 2 * t);
  __syncthreads();

  // (4) a group a unique: the column step
  for (int u = grp; u < rows; u += NG)
    column_step<RULE, D, E, LANES>(sm.row + u * W, sm.m + u * G, sm.mode[u],
                                   sm.sc + 2 * u, (uint32_t)sm.uid[u], seed,
                                   conf, l);
  // (5) adagrad: a thread a unique, the shared g2sums
  if (RULE == kAdagrad) {
    __syncthreads();
    if (t < rows && sm.mode[t] == kUpdate)
      sq_step<D, E>(sm.row + t * W, sm.m + t * G);
  }
  __syncthreads();

  // (6) bf16: a group a unique encodes every row (pass-through rows too,
  // as the reference decodes, updates and encodes every unique's row):
  // back into its staged words (in place), or into the tile's run of out
  // laid out as in out, from the half at which out's run starts (the
  // staged rows were decoded in (2))
  uint16_t* run = out_v == nullptr ? nullptr
                                    : reinterpret_cast<uint16_t*>(out_v) +
                                          (int64_t)j0 * DW;
  const int h = (int)((reinterpret_cast<uintptr_t>(run) >> 1) & 1);
  if constexpr (BF16) {
    for (int u = grp; u < rows; u += NG) {
      const float* v = sm.row + u * W;
      uint16_t* raw = out_v != nullptr
                          ? sm.raw + h + u * DW
                          : sm.raw + u * RS + lead<DW>(slab16, sm.uid[u]);
      for (int c = l; c < W; c += LANES)
        encode_col(v[c], raw, sm.hi[c], sm.lo[c]);
    }
    if (out_v != nullptr)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // (7) the tile's rows back: at their slab rows, or as one run of out (one
  // bulk copy of a full tile, 16-byte aligned: TILE * DW * 2 and TILE * W *
  // 4 are multiples of 16)
  if constexpr (BF16) {
    if (out_v == nullptr) {
      store_rows16<DW, RS>(slab16, sm.raw, sm.uid, rows, t, GTHREADS);
    } else if (bulk_out && rows == TILE) {
      if (t == 0) bulk_store(run, sm.raw, TILE * DW * 2);
    } else {
      // the run's 4-byte words as encoded; its edge halves by 2-byte stores
      uint32_t* ow = reinterpret_cast<uint32_t*>(run - h);
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm.raw);
      const int n = rows * DW;
      for (int w = t; w < (h + n + 1) / 2; w += GTHREADS) {
        const int e = 2 * w - h;  // the word's low half in the run
        if (e >= 0 && e + 1 < n)
          ow[w] = sw[w];
        else if (e >= 0)
          reinterpret_cast<uint16_t*>(ow + w)[0] = sm.raw[2 * w];
        else
          reinterpret_cast<uint16_t*>(ow + w)[1] = sm.raw[2 * w + 1];
      }
    }
  } else if (out_v != nullptr) {
    float* o = reinterpret_cast<float*>(out_v) + (int64_t)j0 * W;
    if (bulk_out && rows == TILE) {
      // the rows written by the threads (the generic proxy) become visible
      // to the bulk copy (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t == 0) bulk_store(o, sm.row, TILE * W * 4);
    } else {
      for (int f = t; f < rows * W; f += GTHREADS) o[f] = sm.row[f];
    }
  } else {
    float* slab = reinterpret_cast<float*>(slab_v);
    for (int f = t; f < rows * W; f += GTHREADS) {
      const int r = f / W;
      slab[(int64_t)sm.uid[r] * W + (f - r * W)] = sm.row[f];
    }
  }
}

// The thread design (narrow rows): a tile of TILE uniques a block of TILE
// threads, a thread a unique.
template <int RULE, int D, int E, bool BF16>
__global__ void __launch_bounds__(Shape<RULE, D, E, BF16>::TILE)
push_adagrad_kernel(PBT_PUSH_PARAMS) {
  using S = Shape<RULE, D, E, BF16>;
  constexpr int W = S::W, G = S::G, GP = G | 1, DW = S::DW, TILE = S::TILE,
                OCC = S::OCC, RS = S::RS;
  extern __shared__ __align__(16) int smem[];
  int* s_uid = smem;
  int* s_off = s_uid + TILE;
  int* s_perm = s_off + TILE + 1;
  float* s_row = reinterpret_cast<float*>(s_perm + OCC);
  float* s_occ = s_row + TILE * W;
  uint16_t* s_raw = reinterpret_cast<uint16_t*>(s_occ + OCC * GP);
  uint16_t* slab16 = reinterpret_cast<uint16_t*>(slab_v);

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * TILE;
  const int rows = min(TILE, n_uniq - j0);
  const int occ0 = offsets[j0];
  const int occ_end = offsets[j0 + rows];
  const int n_occ = min(occ_end - occ0, OCC);

  // (1) the tile's ids, offsets and staged perm entries, coalesced, into
  // shared memory
  if (t < rows) {
    s_uid[t] = uids[j0 + t];
    s_off[t] = offsets[j0 + t] - occ0;
  }
  if (t == 0) s_off[rows] = occ_end - occ0;
  for (int o = t; o < n_occ; o += TILE) s_perm[o] = perm[occ0 + o];
  __syncthreads();

  // (2) push rows and slab rows into shared memory: the push rows and f32
  // slab rows by cp.async, all in flight before the block waits, thread l
  // taking flattened elements l, l + TILE, ... (a warp's loads cover a few
  // contiguous rows); the bf16 slab's 2-byte rows by their words
  // (S::WORDS), else through registers
  for (int f = t; f < n_occ * G; f += TILE) {
    const int o = f / G;
    const int c = f - o * G;
    cp_async4(s_occ + o * GP + c, grads + (int64_t)s_perm[o] * G + c);
  }
  if constexpr (S::WORDS) {
    stage_rows16<DW, RS>(s_raw, slab16, s_uid, rows, t, TILE);
  } else if constexpr (BF16) {
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

  // (3) a thread a unique: decode (bf16), merge in registers, the row and
  // column steps, encode (bf16; pass-through rows too)
  if (t < rows) {
    float* v = s_row + t * W;
    uint16_t* raw =
        s_raw + t * RS + (S::WORDS ? lead<DW>(slab16, s_uid[t]) : 0);
    if (BF16) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        v[c] = decode_col(raw, plan.hi[c], plan.lo[c]);
    }
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
    if (BF16) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        encode_col(v[c], raw, plan.hi[c], plan.lo[c]);
    }
  }
  __syncthreads();

  // (4) the tile's rows back: at their slab rows, or as one run of out
  if (BF16) {
    if (out_v != nullptr) {
      uint16_t* o = reinterpret_cast<uint16_t*>(out_v) + (int64_t)j0 * DW;
      for (int f = t; f < rows * DW; f += TILE) {
        const int r = f / DW;
        o[f] = S::WORDS
                   ? s_raw[r * RS + lead<DW>(slab16, s_uid[r]) + (f - r * DW)]
                   : s_raw[f];
      }
    } else if constexpr (S::WORDS) {
      store_rows16<DW, RS>(slab16, s_raw, s_uid, rows, t, TILE);
    } else {
      for (int f = t; f < rows * DW; f += TILE) {
        const int r = f / DW;
        slab16[(int64_t)s_uid[r] * DW + (f - r * DW)] = s_raw[f];
      }
    }
  } else if (out_v != nullptr) {
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

// On a device's first launch of a thread-design instantiation: raise its
// shared-memory limit where the tile needs more than 48 KiB, and check
// that one block fits an SM. Kept: a later launch costs no query.
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
  using S = Shape<RULE, D, E, BF16>;
  static_assert(S::TILE % 4 == 0, "a full tile's run is 16-byte aligned");
  if (BF16 && S::W > MAX_PLAN_COLS) return (int)cudaErrorInvalidValue;
  const int blocks = (n_uniq + S::TILE - 1) / S::TILE;
  const bool occ_vec = (reinterpret_cast<uintptr_t>(grads) & 15) == 0;
  const bool bulk_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if constexpr (S::LANES > 1) {
    push_adagrad_kernel_group<RULE, D, E, BF16><<<blocks, GTHREADS, 0, stream>>>(
        slab, grads, perm, offsets, uids, out, n_uniq, seed, conf, occ_vec,
        bulk_out, plan);
  } else {
    constexpr int smem = stage_bytes(S::TILE, S::W, S::G, S::RS);
    const cudaError_t e = prepare<RULE, D, E, BF16>(smem, S::TILE);
    if (e != cudaSuccess) return (int)e;
    push_adagrad_kernel<RULE, D, E, BF16><<<blocks, S::TILE, smem, stream>>>(
        slab, grads, perm, offsets, uids, out, n_uniq, seed, conf, occ_vec,
        bulk_out, plan);
  }
  return (int)cudaGetLastError();
}

#undef PBT_PUSH_PARAMS

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
