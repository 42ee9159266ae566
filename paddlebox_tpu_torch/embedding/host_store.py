"""Host-DRAM embedding store in Python: every feature ever seen, as numpy
f32 rows.

Counterpart of paddlebox_tpu/embedding/host_store.py:37-295 and :399-505
without the SSD tier (so the tier sweep of shrink, the tier tick of
age_unseen_days, the spilled rows of save and the fault-in and spill
counters are absent). It is
the plain version of native_store.py's NativeHostEmbeddingStore, which the
pass table uses unless this store is passed in by name. Missing keys are
created by ``lookup_or_create``, in the order the caller passes them
(the pass table passes its sorted-unique key set, or the sorted keys it
still misses), with ``ValueLayout.new_rows`` drawing from one
``RandomState(seed)``, which is the rule both JAX stores follow, so the two
packages hold the same rows; ``assign`` (a journal replay) installs given
rows and draws nothing.
Live rows fill [0, len) of the row array: shrink compacts in place of a
free list, so a sorted ``state_items`` matches the JAX store's after any
sequence of calls.

The store has no lock of its own: growing replaces ``_values``. A caller
that reads it from another thread (the preload's promote prefetcher) holds
the pass table's ``store_lock``, as the table does around every store call.

Telemetry, under the reference's names (host_store.py:110-158, 285):
lookup_or_create counts sparse_keys_resident_hit and sparse_keys_created
and sets the gauges of ``tier_gauges``; shrink counts sparse_keys_shrunk.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import UNSEEN_DAYS, ValueLayout
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add

_GROW = 1 << 16
# the resident hit rate under which tier_hit_burn exceeds 1 (the
# reference's flag tier_hit_rate_warn, paddlebox_tpu/config/flags.py:683)
TIER_HIT_RATE_WARN = 0.05


def tier_gauges(resident_rows: int, hit_rate: float, cold: bool) -> None:
    """The tier ladder's gauges after a lookup_or_create that found keys
    the store knew (reference host_store.py:141-158): host_store_resident_rows,
    tier_hit_rate and, unless the store was empty before the call,
    tier_hit_burn = TIER_HIT_RATE_WARN / rate."""
    gauge_set("host_store_resident_rows", float(resident_rows))
    gauge_set("tier_hit_rate", float(hit_rate))
    if not cold:
        burn = TIER_HIT_RATE_WARN / max(float(hit_rate), 1e-9)
        gauge_set("tier_hit_burn", round(burn, 4))


class HostEmbeddingStore:
    """uint64 feasign -> fixed-width float32 row, in one growable array."""

    def __init__(self, layout: ValueLayout, table: TableConfig,
                 seed: int = 0) -> None:
        self.layout = layout
        self.table = table
        self._rng = np.random.RandomState(seed)
        self._index: Dict[int, int] = {}
        self._values = np.zeros((_GROW, layout.width), dtype=np.float32)

    def __len__(self) -> int:
        return len(self._index)

    def _rows_of(self, keys: np.ndarray, missing: int = -1) -> np.ndarray:
        idx = self._index
        return np.fromiter((idx.get(k, missing) for k in keys.tolist()),
                           dtype=np.int64, count=keys.size)

    def _reserve(self, extra: int) -> None:
        need = len(self._index) + extra
        cap = self._values.shape[0]
        if need > cap:
            new_cap = max(need, cap + max(_GROW, cap // 2))
            grown = np.zeros((new_cap, self.layout.width), np.float32)
            grown[:cap] = self._values
            self._values = grown

    def _add(self, keys: np.ndarray) -> np.ndarray:
        """Index new unique keys at rows [len, len + n), in order; returns
        those rows."""
        self._reserve(keys.size)
        base = len(self._index)
        new = np.arange(base, base + keys.size, dtype=np.int64)
        self._index.update(zip(keys.tolist(), new.tolist()))
        return new

    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        """Rows for unique keys, creating missing features in key order."""
        keys = np.asarray(keys, dtype=np.uint64)
        cold = not self._index
        rows = self._rows_of(keys)
        miss = np.nonzero(rows < 0)[0]
        n_res = int(keys.size) - int(miss.size)
        if keys.size:
            stat_add("sparse_keys_resident_hit", n_res)
        if miss.size:
            new = self._add(keys[miss])
            self._values[new] = self.layout.new_rows(
                miss.size, self._rng, self.table.optimizer)
            rows[miss] = new
            stat_add("sparse_keys_created", int(miss.size))
        if n_res > 0:
            # no tier: every key the store knew was resident
            tier_gauges(len(self._index), 1.0, cold)
        return self._values[rows].copy()

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for keys; missing keys read as zero rows and are not
        created."""
        return self.lookup_present(keys)[0]

    def lookup_present(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, found) for keys, creating nothing: missing keys read as
        zero rows with found False. The promote prefetcher's read: new keys
        are left for the pass boundary's sorted ``lookup_or_create``, so the
        creation draws stay in the full path's order."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        found = rows >= 0
        out = np.zeros((keys.size, self.layout.width), np.float32)
        out[found] = self._values[rows[found]]
        return out, found

    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of every feature in the store. The order is the
        store's own (here creation order, hash order in the native store):
        a caller that compares stores sorts by key."""
        keys = np.fromiter(self._index.keys(), dtype=np.uint64,
                           count=len(self._index))
        rows = np.fromiter(self._index.values(), dtype=np.int64,
                           count=len(self._index))
        return keys, self._values[rows].copy()

    def write_back(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Overwrite the rows of known keys (end-of-pass slab dump)."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        if (rows < 0).any():
            raise KeyError("write_back of keys the store never created")
        self._values[rows] = values

    def assign(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Create or overwrite the rows of unique keys verbatim, with no
        creation draw (a journal replay's ROWS record); new keys take rows
        [len, len + m) in the order given."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        miss = np.nonzero(rows < 0)[0]
        if miss.size:
            rows[miss] = self._add(keys[miss])
        self._values[rows] = values

    # ------------------------------------------------------------ lifecycle
    def shrink(self) -> int:
        """ShrinkTable: decay show/click of every row and delete the dead
        features (ctr_accessor.cc:63-79 via layout.shrink_mask), keeping
        the live rows in [0, len). Returns the deletions."""
        if not self._index:
            return 0
        keys, view = self.state_items()
        dead = self.layout.shrink_mask(view, self.table)
        keep = ~dead
        n = int(keep.sum())
        values = np.zeros_like(self._values)
        values[:n] = view[keep]
        self._values = values
        self._index = dict(zip(keys[keep].tolist(), range(n)))
        n_dead = int(dead.sum())
        if n_dead:
            stat_add("sparse_keys_shrunk", n_dead)
        return n_dead

    def age_unseen_days(self) -> None:
        """Add one day to every feature's unseen_days."""
        self._values[:len(self._index), UNSEEN_DAYS] += 1.0

    def update_stat_after_save(self, table: TableConfig, param: int
                               ) -> None:
        """UpdateStatAfterSave over every row, in place: param 1 clears the
        delta score of the rows a delta save covers, 3 ages unseen_days
        (layout.update_stat_after_save's arithmetic)."""
        # [0, len) is a view: the rewrite lands in place
        self.layout.update_stat_after_save(self._values[:len(self._index)],
                                           table, param)

    def save(self, path: str, flags: Optional[CkptFlags] = None) -> None:
        """Checkpoint every feature at ``path`` in ``flags``' format (the
        columnar manifest and parts by default, or the legacy pickle)."""
        flags = flags or CkptFlags()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys, values = self.state_items()
        ckpt_store.save_sparse_auto(
            path, keys, values, {"embedx_dim": self.layout.embedx_dim,
                                 "optimizer": self.layout.optimizer},
            fmt=flags.ckpt_format, parts=flags.ckpt_parts,
            threads=flags.ckpt_io_threads)

    def load(self, path: str, threads: int = 0) -> None:
        """Restore from either checkpoint format (sniffed)."""
        self.load_blob(ckpt_store.load_sparse_any(path, threads))

    def load_blob(self, blob: Dict) -> None:
        """Restore from a checkpoint dict ({"keys", "values", "embedx_dim",
        "optimizer"}), replacing every row; the creation randoms go on from
        where they were."""
        if blob["embedx_dim"] != self.layout.embedx_dim or \
                blob["optimizer"] != self.layout.optimizer:
            raise ValueError("checkpoint layout mismatch")
        keys = np.asarray(blob["keys"], np.uint64).ravel()
        n = int(keys.size)
        values = np.zeros((max(n, _GROW), self.layout.width), np.float32)
        values[:n] = blob["values"]
        self._values = values
        self._index = dict(zip(keys.tolist(), range(n)))
        if len(self._index) != n:
            raise ValueError("checkpoint holds a key twice")
