// Copy of paddlebox_tpu/native/route.cc for the PyTorch port (built from here by
// paddlebox_tpu_torch/native/host_lib.py); C ABI unchanged.
//
// Batch key routing for the sharded pass table: dedup + shard bucketing.
//
// Native analog of the reference's on-device dedup_keys_and_fillidx +
// split_input_to_shard (paddle/fluid/framework/fleet/heter_ps/
// heter_comm_inl.h:2231,1117) — here the routing runs host-side because the
// TPU step consumes pre-built static-shape buckets, so this is the per-batch
// host hot loop and must run at line rate (a Python dict loop was the
// wall-clock bottleneck at production key budgets).
//
// Two-level design:
//  * rt_index_create builds a pass-scoped open-addressing map
//    key -> slab-local id ONCE per pass (amortized over every batch) —
//    replaces per-key binary search (22 dependent cache misses) with one
//    probe (~1 miss).
//  * rt_bucketize runs one pass over a batch: per-batch dedup via a
//    generation-tagged scratch table (no per-call memset), first-occurrence
//    bucket slot assignment, overflow drop.
//
// THREAD CONTRACT: the pass index is probe-only after
// rt_index_create, and the per-batch dedup scratch is THREAD-LOCAL — so
// any number of threads may rt_bucketize/rt_lookup on ONE index
// concurrently (the sharded stager pool does exactly that, W workers per
// step). A scratch kept in RouteIndex would let concurrent callers draw
// the same generation and read each other's seen-marks, silently
// mis-routing an occurrence of a key both batches carried. Cost: one
// scratch table per ROUTING THREAD
// (~20 B per next_pow2(2K) slots, e.g. ~5 MB/thread at K=128k) instead of
// one per index. rt_index_create itself must still finish before the
// first concurrent consumer — the pass-cadence callers already guarantee
// that.
//
// C ABI for ctypes; caller owns the numpy buffers, the index owns its own.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint64_t kEmpty = ~0ull;

inline uint64_t mix64(uint64_t k) {
  k += 0x9E3779B97F4A7C15ull;
  k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9ull;
  k = (k ^ (k >> 27)) * 0x94D049BB133111EBull;
  return k ^ (k >> 31);
}

inline uint64_t next_pow2(uint64_t v) {
  uint64_t c = 1;
  while (c < v) c <<= 1;
  return c;
}

struct RouteIndex {
  // pass map: key -> local id (position in its shard's sorted key list).
  // PROBE-ONLY after rt_index_create — safely shared across threads.
  uint64_t cap = 0, mask = 0;
  uint64_t* keys = nullptr;
  int32_t* pos = nullptr;
  // the all-ones key is a legal feasign but collides with the kEmpty slot
  // sentinel — tracked out-of-band
  bool has_max_key = false;
  int32_t max_key_pos = 0;

  ~RouteIndex() {
    free(keys);
    free(pos);
  }
};

// Per-THREAD batch-dedup scratch, generation-tagged so calls skip the
// memset. Thread-local (NOT per-index): concurrent rt_bucketize callers
// on one index never share seen-marks or the generation counter — the
// cross-thread mis-route class this replaces is described in the file
// header. Shared across indexes on one thread, which is safe: every call
// bumps the thread's generation, so marks from any earlier call (either
// index) read as stale.
struct BucketScratch {
  uint64_t scap = 0, smask = 0;
  uint64_t* skeys = nullptr;
  int64_t* sslot = nullptr;
  uint32_t* sgen = nullptr;
  uint32_t gen = 0;

  ~BucketScratch() {
    free(skeys);
    free(sslot);
    free(sgen);
  }

  bool ensure(uint64_t want) {
    if (scap >= want) return true;
    free(skeys);
    free(sslot);
    free(sgen);
    uint64_t* nk = static_cast<uint64_t*>(malloc(want * 8));
    int64_t* ns = static_cast<int64_t*>(malloc(want * 8));
    uint32_t* ng = static_cast<uint32_t*>(calloc(want, 4));
    if (!nk || !ns || !ng) {
      free(nk);
      free(ns);
      free(ng);
      skeys = nullptr;
      sslot = nullptr;
      sgen = nullptr;
      scap = smask = 0;
      return false;
    }
    skeys = nk;
    sslot = ns;
    sgen = ng;
    scap = want;
    smask = scap - 1;
    gen = 0;
    return true;
  }
};

thread_local BucketScratch tls_scratch;

// ONE routing loop for both exported routers: the only
// policy-dependent step is where a FIRST occurrence's shard comes from
// — kShardFromArray=false compiles the baked k % P (rt_bucketize,
// byte-for-byte the pre-policy behavior), true reads the caller's
// pre-mixed shard[] (rt_bucketize_sharded) with a range check. A fix
// to the shared dedup/overflow/sentinel logic lands in both tiers by
// construction.
template <bool kShardFromArray>
inline int64_t bucketize_impl(RouteIndex* ix, const uint64_t* keys,
                              const int32_t* shard, uint8_t* valid,
                              int64_t K, int32_t P, int32_t KB,
                              int32_t* buckets, int32_t* restore,
                              uint64_t* missing_out) {
  BucketScratch& sc = tls_scratch;
  if (!sc.ensure(next_pow2(static_cast<uint64_t>(K) * 2 + 8))) {
    *missing_out = 0;
    return -2;
  }
  uint32_t gen = ++sc.gen;
  if (gen == 0) {  // wrapped: hard reset
    memset(sc.sgen, 0, sc.scap * 4);
    gen = sc.gen = 1;
  }
  // hoist the scratch fields: accesses through the TLS reference make
  // the compiler re-load them around every store (a uint32 store into
  // sgen[] could alias sc.gen through the TLS block) — locals keep the
  // hot loop's pointers in registers (measured ~26% of the whole
  // routing rate on this container's g++)
  const uint64_t smask = sc.smask;
  uint64_t* const skeys = sc.skeys;
  int64_t* const sslot = sc.sslot;
  uint32_t* const sgen = sc.sgen;

  int64_t* fill = static_cast<int64_t*>(calloc(P, sizeof(int64_t)));
  if (!fill) {
    *missing_out = 0;
    return -2;
  }
  int64_t overflow = 0;

  for (int64_t i = 0; i < K; ++i) {
    restore[i] = 0;
    if (!valid[i]) continue;
    uint64_t k = keys[i];
    uint64_t hs = mix64(k);
    uint64_t h = hs & smask;
    while (sgen[h] == gen && skeys[h] != k) h = (h + 1) & smask;
    if (sgen[h] == gen) {  // seen earlier in this batch
      int64_t slot = sslot[h];
      if (slot < 0) {  // that occurrence overflowed
        ++overflow;
        valid[i] = 0;
      } else {
        restore[i] = static_cast<int32_t>(slot);
      }
      continue;
    }
    // first occurrence in this batch: shard per the routing policy
    int32_t s;
    if (kShardFromArray) {
      s = shard[i];
      if (s < 0 || s >= P) {
        *missing_out = k;
        free(fill);
        return -3;
      }
    } else {
      s = static_cast<int32_t>(k % static_cast<uint64_t>(P));
    }
    int64_t slot;
    if (fill[s] >= KB) {
      ++overflow;
      valid[i] = 0;
      slot = -1;
    } else {
      int32_t local_pos;
      if (k == kEmpty) {  // sentinel-colliding key: out-of-band lookup
        if (!ix->has_max_key) {
          *missing_out = k;
          free(fill);
          return -1;
        }
        local_pos = ix->max_key_pos;
      } else {
        uint64_t g2 = hs & ix->mask;
        while (ix->keys[g2] != kEmpty && ix->keys[g2] != k)
          g2 = (g2 + 1) & ix->mask;
        if (ix->keys[g2] == kEmpty) {
          *missing_out = k;
          free(fill);
          return -1;
        }
        local_pos = ix->pos[g2];
      }
      int64_t j = fill[s]++;
      buckets[static_cast<int64_t>(s) * KB + j] = local_pos;
      slot = static_cast<int64_t>(s) * KB + j;
      restore[i] = static_cast<int32_t>(slot);
    }
    sgen[h] = gen;
    skeys[h] = k;
    sslot[h] = slot;
  }
  free(fill);
  return overflow;
}

}  // namespace

extern "C" {

// Build the pass index from the concatenated sorted shard key lists.
// sk_flat: all shards' sorted pass keys, sk_off[P+1] offsets.
void* rt_index_create(const uint64_t* sk_flat, const int64_t* sk_off,
                      int32_t P) {
  RouteIndex* ix = new RouteIndex();
  int64_t total = sk_off[P];
  ix->cap = next_pow2(static_cast<uint64_t>(total) * 2 + 8);
  ix->mask = ix->cap - 1;
  ix->keys = static_cast<uint64_t*>(malloc(ix->cap * 8));
  ix->pos = static_cast<int32_t*>(malloc(ix->cap * 4));
  if (!ix->keys || !ix->pos) {
    delete ix;
    return nullptr;
  }
  memset(ix->keys, 0xFF, ix->cap * 8);
  for (int32_t s = 0; s < P; ++s) {
    const uint64_t* sk = sk_flat + sk_off[s];
    int64_t n = sk_off[s + 1] - sk_off[s];
    for (int64_t i = 0; i < n; ++i) {
      uint64_t k = sk[i];
      if (k == kEmpty) {  // sentinel-colliding key lives out-of-band
        ix->has_max_key = true;
        ix->max_key_pos = static_cast<int32_t>(i);
        continue;
      }
      uint64_t h = mix64(k) & ix->mask;
      while (ix->keys[h] != kEmpty) h = (h + 1) & ix->mask;
      ix->keys[h] = k;
      ix->pos[h] = static_cast<int32_t>(i);
    }
  }
  return ix;
}

void rt_index_destroy(void* p) { delete static_cast<RouteIndex*>(p); }

// Routes one batch with the baked key % P shard (the BoxPS layout; the
// key-mod ShardingPolicy's tier). Returns overflow occurrence count
// (>=0), -1 when a key is not registered in the pass (first missing
// key -> *missing_out), -2 on allocation failure.
int64_t rt_bucketize(void* index, const uint64_t* keys, uint8_t* valid,
                     int64_t K, int32_t P, int32_t KB,
                     int32_t* buckets, int32_t* restore,
                     uint64_t* missing_out) {
  return bucketize_impl<false>(static_cast<RouteIndex*>(index), keys,
                               nullptr, valid, K, P, KB, buckets,
                               restore, missing_out);
}

// Policy-parameterized router (2-D sparse parallelism): the
// owning shard of each first occurrence comes from the caller-provided
// shard[] array (the ShardingPolicy's vectorized numpy shard_of,
// pre-mixed once per batch) — the shared native dedup/bucket-fill loop
// keeps its rate under any routing policy. Returns like rt_bucketize,
// plus -3 when a shard value falls outside [0, P) (a policy bug must
// fail loud, not write past the bucket array).
int64_t rt_bucketize_sharded(void* index, const uint64_t* keys,
                             const int32_t* shard, uint8_t* valid,
                             int64_t K, int32_t P, int32_t KB,
                             int32_t* buckets, int32_t* restore,
                             uint64_t* missing_out) {
  return bucketize_impl<true>(static_cast<RouteIndex*>(index), keys,
                              shard, valid, K, P, KB, buckets, restore,
                              missing_out);
}

// Plain key -> pass-local id translation over the pass index (the
// single-shard analog of rt_bucketize: no bucketing, no dedup). Replaces
// np.searchsorted's ~20 dependent cache misses per key with ~1 probe.
// valid==0 positions get padding_id. Returns 0, or -1 with *missing_out set
// when a valid key is not in the pass index.
int64_t rt_lookup(void* index, const uint64_t* keys, const uint8_t* valid,
                  int64_t K, int32_t padding_id, int32_t* out_ids,
                  uint64_t* missing_out) {
  RouteIndex* ix = static_cast<RouteIndex*>(index);
  for (int64_t i = 0; i < K; ++i) {
    if (valid && !valid[i]) {
      out_ids[i] = padding_id;
      continue;
    }
    uint64_t k = keys[i];
    if (k == kEmpty) {  // sentinel-colliding key lives out-of-band
      if (!ix->has_max_key) {
        *missing_out = k;
        return -1;
      }
      out_ids[i] = ix->max_key_pos;
      continue;
    }
    uint64_t h = mix64(k) & ix->mask;
    while (ix->keys[h] != kEmpty && ix->keys[h] != k) h = (h + 1) & ix->mask;
    if (ix->keys[h] == kEmpty) {
      *missing_out = k;
      return -1;
    }
    out_ids[i] = ix->pos[h];
  }
  return 0;
}

// Serving-tier key translation (the xbox mmap store's id lookup): like
// rt_lookup but a key absent from the index maps to miss_id instead of
// failing — unknown features read as zero rows at serving time
// (box_wrapper.cc:1286-1318 writes the views; this serves them).
int64_t rt_lookup_serve(void* index, const uint64_t* keys, int64_t K,
                        int32_t miss_id, int32_t* out_ids) {
  RouteIndex* ix = static_cast<RouteIndex*>(index);
  for (int64_t i = 0; i < K; ++i) {
    uint64_t k = keys[i];
    if (k == kEmpty) {
      out_ids[i] = ix->has_max_key ? ix->max_key_pos : miss_id;
      continue;
    }
    uint64_t h = mix64(k) & ix->mask;
    while (ix->keys[h] != kEmpty && ix->keys[h] != k) h = (h + 1) & ix->mask;
    out_ids[i] = (ix->keys[h] == kEmpty) ? miss_id : ix->pos[h];
  }
  return 0;
}

// Per-batch id dedup for the single-shard push (host analog of
// DedupKeysAndFillIdx, box_wrapper_impl.h:129): hash dedup + counting sort,
// no comparison sort. Outputs feed push_sparse_hostdedup:
//   uids[K]  unique ids in first-occurrence order, tail padded with
//            pad_base+i (unique, outside the slab -> scatter-dropped)
//   perm[K]  occurrence indices grouped by unique id (stable within a group)
//   inv[K]   merged-row index per PERMUTED occurrence — nondecreasing, so
//            the device merge is a sorted segment-sum, not a sort.
// scratch: caller-provided int64[2*K] (group id + counts/offsets).
// Returns the unique count, or -2 on allocation failure.
int64_t rt_dedup(const int32_t* ids, int64_t K, int32_t pad_base,
                 int32_t* uids, int32_t* perm, int32_t* inv,
                 int64_t* scratch) {
  // local gen-free open addressing over this batch's ids (K is small
  // enough that an on-stack-sized table per call is cheap to allocate)
  uint64_t cap = next_pow2(static_cast<uint64_t>(K) * 2 + 8);
  uint64_t mask = cap - 1;
  int32_t* hkeys = static_cast<int32_t*>(malloc(cap * 4));
  int32_t* hgrp = static_cast<int32_t*>(malloc(cap * 4));
  if (!hkeys || !hgrp) {
    free(hkeys);
    free(hgrp);
    return -2;
  }
  memset(hkeys, 0xFF, cap * 4);  // -1 = empty (ids are nonnegative)
  int64_t* ginv = scratch;       // [K] group per occurrence
  int64_t* count = scratch + K;  // [K] group sizes -> offsets
  int64_t n_u = 0;
  for (int64_t i = 0; i < K; ++i) {
    int32_t id = ids[i];
    uint64_t h = mix64(static_cast<uint64_t>(id)) & mask;
    while (hkeys[h] != -1 && hkeys[h] != id) h = (h + 1) & mask;
    int32_t g;
    if (hkeys[h] == -1) {
      g = static_cast<int32_t>(n_u);
      hkeys[h] = id;
      hgrp[h] = g;
      uids[n_u] = id;
      count[n_u] = 0;
      ++n_u;
    } else {
      g = hgrp[h];
    }
    ginv[i] = g;
    ++count[g];
  }
  free(hkeys);
  free(hgrp);
  // counting sort: group offsets, then stable placement
  int64_t run = 0;
  for (int64_t g = 0; g < n_u; ++g) {
    int64_t c = count[g];
    count[g] = run;
    run += c;
  }
  for (int64_t i = 0; i < K; ++i) {
    int64_t g = ginv[i];
    int64_t j = count[g]++;
    perm[j] = static_cast<int32_t>(i);
    inv[j] = static_cast<int32_t>(g);
  }
  for (int64_t i = n_u; i < K; ++i)
    uids[i] = pad_base + static_cast<int32_t>(i - n_u);
  return n_u;
}

// Sorted uid-wire dedup: presence-mark dedup collects the
// n_u uniques in O(K), then an LSD radix sort over the UNIQUES ONLY
// (4 x 8-bit passes, skip-if-constant per byte) orders them ascending —
// vs np.unique's comparison sort of the full K-occurrence vector. The
// uid wire ships only this vector (dedup_uids_sorted): perm/inv never
// materialize here, the device derives them by searchsorted.
//
// The presence array is calloc'd, NOT malloc+memset: the kernel hands
// back zero pages lazily, so a heavily-duplicated batch (the uid wire's
// motivating shape) faults in only the pages its uniques actually touch
// instead of paying a full-table memset per call. The mark is one
// predictable byte store per occurrence — no probe chain, no key
// compare.
//
// ENGAGEMENT: a predicate that declined whenever 2*pad_base > K would,
// at the wired callers (pad_base = table/shard capacity, ids = pass-local
// slab ids), engage only when a batch carried >= 2x the CAPACITY in
// occurrences — production shapes never do. But the presence-table cost
// the predicate guards tracks the live id SPAN (the pages the marks
// touch), not pad_base: pass-local ids cluster in [0, working set), with
// exactly one far outlier — the trash id pad_base-1 the bucket padding
// carries. A one-pass top-two scan finds that span: when max1 is the
// trash id it rides OUT-OF-BAND (a bool + one append after the sort —
// it is by construction the largest representable id, so it sorts last)
// and span = max2+1; otherwise span = max1+1. Decline when
// 2*span > K: since n_unique <= span, engaging guarantees mean
// duplication K/n_unique >= K/span >= 2 — the measured-win regime
// (K/n_unique is not computable before deduping; the span is its
// cheapest sound upper bound). Ids spread over the full [0, pad_base)
// still decline; the wired production shapes engage.
//   uids[K]  ascending uniques, tail padded with pad_base+i
//   scratch  caller int64[K] (>= n_u int32 ping-pong buffer)
// Returns the unique count, -1 when declining (low-duplication span, or
// an id outside [0, pad_base) — out-of-contract input must fall back to
// the numpy tier rather than write past the presence table), -2 on
// allocation failure.
int64_t rt_dedup_sorted(const int32_t* ids, int64_t K, int32_t pad_base,
                        int32_t* uids, int64_t* scratch) {
  // O(K) prepass: contract check + top-two distinct ids -> live span
  int64_t max1 = -1, max2 = -1;
  for (int64_t i = 0; i < K; ++i) {
    int32_t id = ids[i];
    if (static_cast<uint32_t>(id) >= static_cast<uint32_t>(pad_base))
      return -1;  // unsigned compare also catches id < 0
    if (id > max1) {
      max2 = max1;
      max1 = id;
    } else if (id < max1 && id > max2) {
      max2 = id;
    }
  }
  const bool oob_trash = (max1 == pad_base - 1 && max2 < max1);
  const int64_t span = oob_trash ? max2 + 1 : max1 + 1;
  if (span * 2 > K) return -1;
  bool seen_trash = false;
  uint8_t* seen =
      static_cast<uint8_t*>(span ? calloc(span, 1) : malloc(1));
  if (!seen) return -2;
  int64_t n_u = 0;
  for (int64_t i = 0; i < K; ++i) {
    int32_t id = ids[i];
    if (oob_trash && id == max1) {  // trash id: out-of-band presence
      seen_trash = true;
      continue;
    }
    if (!seen[id]) {
      seen[id] = 1;
      uids[n_u++] = id;
    }
  }
  free(seen);
  int32_t* a = uids;
  int32_t* b = reinterpret_cast<int32_t*>(scratch);
  int64_t count[256];
  for (int shift = 0; shift < 32; shift += 8) {
    memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n_u; ++i)
      ++count[(static_cast<uint32_t>(a[i]) >> shift) & 0xFF];
    // pass-local ids cluster low: high bytes are usually constant, and a
    // single-bucket histogram means the pass is the identity — skip it
    if (n_u && count[(static_cast<uint32_t>(a[0]) >> shift) & 0xFF] == n_u)
      continue;
    int64_t run = 0;
    for (int j = 0; j < 256; ++j) {
      int64_t c = count[j];
      count[j] = run;
      run += c;
    }
    for (int64_t i = 0; i < n_u; ++i)
      b[count[(static_cast<uint32_t>(a[i]) >> shift) & 0xFF]++] = a[i];
    int32_t* t = a;
    a = b;
    b = t;
  }
  if (a != uids) memcpy(uids, a, static_cast<size_t>(n_u) * 4);
  // the out-of-band trash id is larger than every in-table id by
  // construction — appending keeps the vector strictly ascending
  if (seen_trash) uids[n_u++] = pad_base - 1;
  for (int64_t i = n_u; i < K; ++i)
    uids[i] = pad_base + static_cast<int32_t>(i - n_u);
  return n_u;
}

}  // extern "C"
