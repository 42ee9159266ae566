// Copy of paddlebox_tpu/native/host_store.cc for the PyTorch port (built from here by
// paddlebox_tpu_torch/native/host_lib.py); C ABI unchanged.
//
// Host-DRAM embedding store: open-addressing uint64 → row hash table over a
// growable float row arena.
//
// Native analog of the reference's host value store (HeterPS MemoryPool +
// the open MemorySparseTable, paddle/fluid/distributed/ps/table/
// memory_sparse_table.cc; in-GPU analog cudf concurrent_unordered_map) —
// the tier the Python HostEmbeddingStore fronts. Single-writer per store
// (the framework shards stores per table shard, like the reference shards
// per device), so no internal locking; Python holds the GIL around calls.
//
// C ABI for ctypes. Row memory is owned here; Python reads/writes rows
// through bulk gather/scatter calls (no per-key Python overhead).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

namespace {

constexpr uint64_t kEmpty = ~0ull;  // sentinel key (feasign ~0 unused)

inline uint64_t mix64(uint64_t k) {
  // splitmix64 finalizer — same family as the reference's murmur-style
  // hash_functions.cuh
  k += 0x9E3779B97F4A7C15ull;
  k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9ull;
  k = (k ^ (k >> 27)) * 0x94D049BB133111EBull;
  return k ^ (k >> 31);
}

struct Store {
  // hash table: parallel arrays, power-of-two capacity
  uint64_t* slots = nullptr;  // keys, kEmpty = free
  int64_t* rows = nullptr;    // row index per slot
  uint64_t cap = 0;           // table capacity (pow2)
  uint64_t size = 0;          // live keys
  double max_load = 0.75;

  // row arena
  float* arena = nullptr;
  int64_t arena_cap = 0;      // rows allocated
  int64_t arena_top = 0;      // next fresh row
  int64_t* free_list = nullptr;
  int64_t free_cnt = 0;
  int64_t free_cap = 0;
  int32_t width = 0;

  void init_table(uint64_t c) {
    cap = c;
    slots = static_cast<uint64_t*>(malloc(cap * 8));
    rows = static_cast<int64_t*>(malloc(cap * 8));
    for (uint64_t i = 0; i < cap; ++i) slots[i] = kEmpty;
  }

  void grow_table() {
    uint64_t old_cap = cap;
    uint64_t* old_slots = slots;
    int64_t* old_rows = rows;
    init_table(cap * 2);
    for (uint64_t i = 0; i < old_cap; ++i) {
      if (old_slots[i] != kEmpty) insert_new(old_slots[i], old_rows[i]);
    }
    free(old_slots);
    free(old_rows);
  }

  inline uint64_t probe(uint64_t key) const {
    uint64_t mask = cap - 1;
    uint64_t i = mix64(key) & mask;
    while (slots[i] != kEmpty && slots[i] != key) i = (i + 1) & mask;
    return i;
  }

  void insert_new(uint64_t key, int64_t row) {
    uint64_t i = probe(key);
    slots[i] = key;
    rows[i] = row;
  }

  int64_t alloc_row() {
    if (free_cnt > 0) return free_list[--free_cnt];
    if (arena_top >= arena_cap) {
      int64_t ncap = arena_cap ? arena_cap * 2 : (1 << 16);
      arena = static_cast<float*>(
          realloc(arena, static_cast<size_t>(ncap) * width * 4));
      memset(arena + arena_cap * width, 0,
             static_cast<size_t>(ncap - arena_cap) * width * 4);
      arena_cap = ncap;
    }
    return arena_top++;
  }

  void push_free(int64_t row) {
    if (free_cnt >= free_cap) {
      free_cap = free_cap ? free_cap * 2 : (1 << 12);
      free_list = static_cast<int64_t*>(realloc(free_list, free_cap * 8));
    }
    memset(arena + row * width, 0, static_cast<size_t>(width) * 4);
    free_list[free_cnt++] = row;
  }
};

}  // namespace

extern "C" {

Store* hs_create(int32_t width, double max_load) {
  Store* s = new Store();
  s->width = width;
  s->max_load = max_load > 0 ? max_load : 0.75;
  s->init_table(1 << 16);
  return s;
}

void hs_destroy(Store* s) {
  if (!s) return;
  free(s->slots);
  free(s->rows);
  free(s->arena);
  free(s->free_list);
  delete s;
}

uint64_t hs_size(Store* s) { return s->size; }
int32_t hs_width(Store* s) { return s->width; }

// Bulk lookup: out_rows[i] = row index or -1 if absent.
void hs_lookup(Store* s, const uint64_t* keys, int64_t n, int64_t* out_rows) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t j = s->probe(keys[i]);
    out_rows[i] = (s->slots[j] == keys[i]) ? s->rows[j] : -1;
  }
}

// Bulk lookup-or-create: missing keys get fresh zero rows; created[i]=1 for
// fresh keys (caller applies accessor init to those rows).
void hs_lookup_or_create(Store* s, const uint64_t* keys, int64_t n,
                         int64_t* out_rows, uint8_t* created) {
  for (int64_t i = 0; i < n; ++i) {
    if ((s->size + 1) > static_cast<uint64_t>(s->cap * s->max_load))
      s->grow_table();
    uint64_t j = s->probe(keys[i]);
    if (s->slots[j] == keys[i]) {
      out_rows[i] = s->rows[j];
      if (created) created[i] = 0;
    } else {
      int64_t r = s->alloc_row();
      s->slots[j] = keys[i];
      s->rows[j] = r;
      s->size++;
      out_rows[i] = r;
      if (created) created[i] = 1;
    }
  }
}

// Gather rows into out [n, width]; row -1 → zeros.
void hs_gather(Store* s, const int64_t* rws, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    if (rws[i] >= 0)
      memcpy(out + i * s->width, s->arena + rws[i] * s->width,
             static_cast<size_t>(s->width) * 4);
    else
      memset(out + i * s->width, 0, static_cast<size_t>(s->width) * 4);
  }
}

// Scatter vals [n, width] into rows.
void hs_scatter(Store* s, const int64_t* rws, int64_t n, const float* vals) {
  for (int64_t i = 0; i < n; ++i) {
    if (rws[i] >= 0)
      memcpy(s->arena + rws[i] * s->width, vals + i * s->width,
             static_cast<size_t>(s->width) * 4);
  }
}

// Erase keys (bulk). Returns number erased. Open-addressing backward-shift
// deletion keeps probe chains intact.
int64_t hs_erase(Store* s, const uint64_t* keys, int64_t n) {
  int64_t erased = 0;
  uint64_t mask = s->cap - 1;
  for (int64_t t = 0; t < n; ++t) {
    uint64_t i = s->probe(keys[t]);
    if (s->slots[i] != keys[t]) continue;
    s->push_free(s->rows[i]);
    s->size--;
    ++erased;
    // backward-shift deletion
    uint64_t j = i;
    while (true) {
      j = (j + 1) & mask;
      if (s->slots[j] == kEmpty) break;
      uint64_t home = mix64(s->slots[j]) & mask;
      // can slot j move into hole i? yes iff home is cyclically outside (i, j]
      bool between = ((i < j) ? (home > i && home <= j)
                              : (home > i || home <= j));
      if (!between) {
        s->slots[i] = s->slots[j];
        s->rows[i] = s->rows[j];
        i = j;
      }
    }
    s->slots[i] = kEmpty;
  }
  return erased;
}

// Iterate all live (key, row) pairs into out arrays (caller sizes by
// hs_size). Returns count written.
int64_t hs_items(Store* s, uint64_t* out_keys, int64_t* out_rows) {
  int64_t w = 0;
  for (uint64_t i = 0; i < s->cap; ++i) {
    if (s->slots[i] != kEmpty) {
      out_keys[w] = s->slots[i];
      out_rows[w] = s->rows[i];
      ++w;
    }
  }
  return w;
}

// Add `delta` to one column of EVERY live row in place (the day-boundary
// unseen_days increment — a full-table gather/scatter via Python for a
// single-column += would double peak host memory). Returns rows touched.
int64_t hs_add_col(Store* s, int32_t col, float delta) {
  if (col < 0 || col >= s->width) return -1;
  int64_t touched = 0;
  for (uint64_t i = 0; i < s->cap; ++i) {
    if (s->slots[i] != kEmpty) {
      s->arena[s->rows[i] * s->width + col] += delta;
      ++touched;
    }
  }
  return touched;
}

// Fused lookup + gather: one probe per key writes the row straight into
// out [n, width] (zeros + found=0 for absent keys). Saves the [n] int64
// rows round trip AND a second ctypes call on the read-mostly paths
// (test-mode lookup, the feed-pass promote prefetcher, striped-store
// per-stripe reads) — at billion-key scale the two-call pattern's probe
// results no longer fit hot cache between the calls. Returns hit count.
int64_t hs_lookup_gather(Store* s, const uint64_t* keys, int64_t n,
                         float* out, uint8_t* found) {
  const size_t row_bytes = static_cast<size_t>(s->width) * 4;
  int64_t hits = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t j = s->probe(keys[i]);
    if (s->slots[j] == keys[i]) {
      memcpy(out + i * s->width, s->arena + s->rows[j] * s->width, row_bytes);
      if (found) found[i] = 1;
      ++hits;
    } else {
      memset(out + i * s->width, 0, row_bytes);
      if (found) found[i] = 0;
    }
  }
  return hits;
}

// Direct arena access for zero-copy numpy views (valid until next
// create/grow): base pointer + row capacity.
float* hs_arena(Store* s) { return s->arena; }
int64_t hs_arena_rows(Store* s) { return s->arena_cap; }

// Select the `want` coldest live keys (largest value in column `cold_col`,
// e.g. unseen_days — the SSD spill victim policy, ssd_sparse_table.cc /
// CheckNeedLimitMem box_wrapper.h:627-629). Writes keys + row ids; returns
// count (<= want). O(n) selection via nth_element.
int64_t hs_coldest(Store* s, int64_t want, int32_t cold_col,
                   uint64_t* out_keys, int64_t* out_rows) {
  int64_t n = static_cast<int64_t>(s->size);
  if (want <= 0 || n == 0) return 0;
  if (want > n) want = n;
  struct Item {
    float cold;
    uint64_t key;
    int64_t row;
  };
  Item* items = static_cast<Item*>(malloc(n * sizeof(Item)));
  if (!items) return -1;
  int64_t w = 0;
  for (uint64_t i = 0; i < s->cap; ++i) {
    if (s->slots[i] != kEmpty) {
      items[w].key = s->slots[i];
      items[w].row = s->rows[i];
      items[w].cold = s->arena[s->rows[i] * s->width + cold_col];
      ++w;
    }
  }
  std::nth_element(items, items + (want - 1), items + w,
                   [](const Item& a, const Item& b) {
                     return a.cold > b.cold ||
                            (a.cold == b.cold && a.key < b.key);
                   });
  for (int64_t i = 0; i < want; ++i) {
    out_keys[i] = items[i].key;
    out_rows[i] = items[i].row;
  }
  free(items);
  return want;
}

}  // extern "C"
