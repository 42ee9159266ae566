// Copy of paddlebox_tpu/native/slot_parser.cc for the PyTorch port (built from here by
// paddlebox_tpu_torch/native/host_lib.py); C ABI unchanged.
//
// Fast MultiSlot text parser emitting columnar batches.
//
// Native analog of the reference's C++ data-feed parse path
// (paddle/fluid/framework/data_feed.cc SlotRecordInMemoryDataFeed /
// SlotPaddleBoxDataFeed ParseOneInstance): one pass over the file buffer,
// no per-record Python objects — records come back as flat columnar arrays
// (keys + per-key slot/record ids, labels, dense floats) that the packer
// consumes directly. Exposed via a C ABI for ctypes (no pybind in image).
//
// Format per line (slots in config order):  <count> <v_1> ... <v_count>
// slot_types[i]: 0 = uint64 feasign slot, 1 = float slot.
// used[i]: 0/1. label_slot: index whose first value is the click label.
// Malformed lines are dropped (counted in n_bad), like the reference parser.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ParsedFile {
  uint64_t* keys = nullptr;     // [n_keys]
  int32_t* key_slot = nullptr;  // [n_keys] used-sparse-slot ordinal
  int64_t* key_rec = nullptr;   // [n_keys] record index
  int32_t* labels = nullptr;    // [n_recs]
  float* dense = nullptr;       // [n_recs * dense_dim] (row-major)
  int32_t* task_labels = nullptr;  // [n_recs * n_tasks] (row-major)
  int64_t n_keys = 0;
  int64_t n_recs = 0;
  int64_t n_bad = 0;
  int32_t dense_dim = 0;
  int32_t n_tasks = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline bool parse_u64(const char*& p, const char* end, uint64_t* out) {
  p = skip_ws(p, end);
  if (p >= end || *p < '0' || *p > '9') return false;
  uint64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10u + static_cast<uint64_t>(*p - '0');
    ++p;
  }
  *out = v;
  return true;
}

inline bool parse_f32(const char*& p, const char* end, float* out) {
  p = skip_ws(p, end);
  if (p >= end) return false;
  char* q = nullptr;
  float v = strtof(p, &q);
  if (q == p) return false;
  p = q;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Parse a whole file. Returns nullptr on open failure. Caller frees with
// psr_free(). dense layout: for each record, used float slots packed in
// config order at their fixed dims (dense_dims[i] per used float slot).
// task_slots[t] (may be null/n_tasks=0): slot indices whose first value is
// task t's label (multi-task heads, metrics.h MultiTask); a record missing
// that slot's value defaults to the click label (packer parity).
ParsedFile* psr_parse_file2(const char* path, const int32_t* slot_types,
                            const int32_t* used, const int32_t* dense_dims,
                            int32_t n_slots, int32_t label_slot,
                            const int32_t* task_slots, int32_t n_tasks) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(sz) + 1);
  size_t rd = fread(buf.data(), 1, static_cast<size_t>(sz), f);
  fclose(f);
  buf[rd] = '\n';

  int32_t dense_dim = 0;
  for (int i = 0; i < n_slots; ++i)
    if (used[i] && slot_types[i] == 1) dense_dim += dense_dims[i];

  std::vector<uint64_t> keys;
  std::vector<int32_t> key_slot;
  std::vector<int64_t> key_rec;
  std::vector<int32_t> labels;
  std::vector<float> dense;
  std::vector<int32_t> task_labels;
  keys.reserve(1 << 16);
  int64_t n_bad = 0;

  const char* p = buf.data();
  const char* bend = buf.data() + rd + 1;
  std::vector<float> dense_row(static_cast<size_t>(dense_dim), 0.0f);
  std::vector<uint64_t> rec_keys;
  std::vector<int32_t> rec_slot;
  std::vector<int32_t> tl_row(static_cast<size_t>(n_tasks), 0);
  std::vector<uint8_t> tl_seen(static_cast<size_t>(n_tasks), 0);

  while (p < bend) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(bend - p)));
    if (!line_end) break;
    const char* q = p;
    p = line_end + 1;
    // skip empty lines
    q = skip_ws(q, line_end);
    if (q >= line_end) continue;

    bool ok = true;
    int32_t label = 0;
    int u_ord = 0;
    int d_off = 0;
    rec_keys.clear();
    rec_slot.clear();
    std::fill(dense_row.begin(), dense_row.end(), 0.0f);
    std::fill(tl_seen.begin(), tl_seen.end(), 0);

    for (int s = 0; s < n_slots && ok; ++s) {
      uint64_t cnt = 0;
      if (!parse_u64(q, line_end, &cnt)) { ok = false; break; }
      int task = -1;  // n_tasks is tiny (a few heads): linear scan
      for (int t = 0; t < n_tasks; ++t)
        if (task_slots[t] == s) { task = t; break; }
      if (slot_types[s] == 0) {
        for (uint64_t j = 0; j < cnt; ++j) {
          uint64_t v;
          if (!parse_u64(q, line_end, &v)) { ok = false; break; }
          if (task >= 0 && j == 0) {
            tl_row[task] = static_cast<int32_t>(v);
            tl_seen[task] = 1;
          }
          if (used[s]) {
            rec_keys.push_back(v);
            rec_slot.push_back(u_ord);
          }
        }
        if (used[s]) ++u_ord;
      } else {
        for (uint64_t j = 0; j < cnt; ++j) {
          float v;
          if (!parse_f32(q, line_end, &v)) { ok = false; break; }
          if (s == label_slot && j == 0) label = static_cast<int32_t>(v);
          if (task >= 0 && j == 0) {
            tl_row[task] = static_cast<int32_t>(v);
            tl_seen[task] = 1;
          }
          if (used[s] && static_cast<int>(j) < dense_dims[s])
            dense_row[static_cast<size_t>(d_off) + j] = v;
        }
        if (used[s]) d_off += dense_dims[s];
      }
    }
    // trailing extras (e.g. appended ins_id columns) are ignored, matching
    // the Python MultiSlotParser's behavior
    if (!ok) {
      ++n_bad;
      continue;
    }
    int64_t rec = static_cast<int64_t>(labels.size());
    labels.push_back(label);
    for (int t = 0; t < n_tasks; ++t)
      task_labels.push_back(tl_seen[t] ? tl_row[t] : label);
    for (size_t j = 0; j < rec_keys.size(); ++j) {
      keys.push_back(rec_keys[j]);
      key_slot.push_back(rec_slot[j]);
      key_rec.push_back(rec);
    }
    if (dense_dim)
      dense.insert(dense.end(), dense_row.begin(), dense_row.end());
  }

  ParsedFile* out = new ParsedFile();
  out->n_keys = static_cast<int64_t>(keys.size());
  out->n_recs = static_cast<int64_t>(labels.size());
  out->n_bad = n_bad;
  out->dense_dim = dense_dim;
  if (out->n_keys) {
    out->keys = static_cast<uint64_t*>(malloc(keys.size() * 8));
    out->key_slot = static_cast<int32_t*>(malloc(key_slot.size() * 4));
    out->key_rec = static_cast<int64_t*>(malloc(key_rec.size() * 8));
    memcpy(out->keys, keys.data(), keys.size() * 8);
    memcpy(out->key_slot, key_slot.data(), key_slot.size() * 4);
    memcpy(out->key_rec, key_rec.data(), key_rec.size() * 8);
  }
  if (out->n_recs) {
    out->labels = static_cast<int32_t*>(malloc(labels.size() * 4));
    memcpy(out->labels, labels.data(), labels.size() * 4);
    if (dense_dim) {
      out->dense = static_cast<float*>(malloc(dense.size() * 4));
      memcpy(out->dense, dense.data(), dense.size() * 4);
    }
    if (n_tasks) {
      out->n_tasks = n_tasks;
      out->task_labels =
          static_cast<int32_t*>(malloc(task_labels.size() * 4));
      memcpy(out->task_labels, task_labels.data(), task_labels.size() * 4);
    }
  }
  return out;
}

// Legacy entry (pre-task-label plugin ABI): no task label extraction.
ParsedFile* psr_parse_file(const char* path, const int32_t* slot_types,
                           const int32_t* used, const int32_t* dense_dims,
                           int32_t n_slots, int32_t label_slot) {
  return psr_parse_file2(path, slot_types, used, dense_dims, n_slots,
                         label_slot, nullptr, 0);
}

int64_t psr_n_keys(ParsedFile* p) { return p->n_keys; }
int64_t psr_n_recs(ParsedFile* p) { return p->n_recs; }
int64_t psr_n_bad(ParsedFile* p) { return p->n_bad; }
int32_t psr_dense_dim(ParsedFile* p) { return p->dense_dim; }
uint64_t* psr_keys(ParsedFile* p) { return p->keys; }
int32_t* psr_key_slot(ParsedFile* p) { return p->key_slot; }
int64_t* psr_key_rec(ParsedFile* p) { return p->key_rec; }
int32_t* psr_labels(ParsedFile* p) { return p->labels; }
float* psr_dense(ParsedFile* p) { return p->dense; }
int32_t psr_n_tasks(ParsedFile* p) { return p->n_tasks; }
int32_t* psr_task_labels(ParsedFile* p) { return p->task_labels; }

void psr_free(ParsedFile* p) {
  if (!p) return;
  free(p->keys);
  free(p->key_slot);
  free(p->key_rec);
  free(p->labels);
  free(p->dense);
  free(p->task_labels);
  delete p;
}

}  // extern "C"
