"""The native host embedding store: a C++ open-addressing hash table over a
growable row arena (native/host_store.cc).

Counterpart of paddlebox_tpu/embedding/native_store.py:40-265, :360-451 and
:454-475 without the SSD tier (no tier sweep, tier tick, spilled rows or
fault-in and spill counters), with the API of host_store.py's
HostEmbeddingStore, its
plain version. Each call is one bulk C call (or two) in place of a Python
dict loop. A key is created by ``lookup_or_create`` (or installed
verbatim by ``assign``, a journal replay, which draws nothing); the rows of
the keys it creates are drawn in Python by ``ValueLayout.new_rows`` from one
``RandomState(seed)`` in the order the caller passes the keys, as the plain
store draws them, so the two stores hold the same bits. ``state_items`` returns hash order. The day
lifecycle's arithmetic runs in numpy (the accessor's), on rows gathered from
and scattered back to the C++ arena; the one column add in C++ adds 1.0,
which no contraction changes.

Like the plain store it has no lock of its own: the pass table holds its
``store_lock`` around every call. The key 2**64 - 1 is the table's empty
sentinel and cannot be stored.

Telemetry, under the reference's names (native_store.py:121-264):
sparse_keys_resident_hit, sparse_keys_created and the tier gauges
(host_store.tier_gauges) at lookup_or_create, sparse_keys_shrunk and
sparse_rows_aged at the day boundary.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import (DELTA_SCORE, UNSEEN_DAYS,
                                                    ValueLayout)
from paddlebox_tpu_torch.embedding.host_store import tier_gauges
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.native.host_lib import F32P, I64P, U8P, U64P, ptr
from paddlebox_tpu_torch.utils.stats import stat_add

# the hash table grows past this load (the reference's
# sparse_table_load_factor default)
LOAD_FACTOR = 0.75


class NativeHostEmbeddingStore:
    """uint64 feasign -> fixed-width float32 row, held by the C++ store."""

    def __init__(self, layout: ValueLayout, table: TableConfig,
                 seed: int = 0) -> None:
        self._lib = host_lib.host_lib()
        self.layout = layout
        self.table = table
        self._rng = np.random.RandomState(seed)
        self._h = self._lib.hs_create(layout.width, LOAD_FACTOR)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.hs_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.hs_size(self._h))

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        """Arena rows of keys, -1 where absent."""
        rows = np.empty(keys.size, np.int64)
        self._lib.hs_lookup(self._h, ptr(keys, U64P), keys.size,
                            ptr(rows, I64P))
        return rows

    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        """Rows for unique keys, creating missing features in key order."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys.size
        cold = not len(self)
        rows = np.empty(n, np.int64)
        created = np.empty(n, np.uint8)
        self._lib.hs_lookup_or_create(self._h, ptr(keys, U64P), n,
                                      ptr(rows, I64P), ptr(created, U8P))
        out = np.empty((n, self.layout.width), np.float32)
        self._lib.hs_gather(self._h, ptr(rows, I64P), n, ptr(out, F32P))
        new = created.view(bool)
        n_new = int(new.sum())
        if n_new:
            fresh = np.ascontiguousarray(self.layout.new_rows(
                n_new, self._rng, self.table.optimizer), dtype=np.float32)
            new_rows = np.ascontiguousarray(rows[new])
            self._lib.hs_scatter(self._h, ptr(new_rows, I64P), n_new,
                                 ptr(fresh, F32P))
            out[new] = fresh
            stat_add("sparse_keys_created", n_new)
        n_res = n - n_new
        if n:
            stat_add("sparse_keys_resident_hit", n_res)
        if n_res > 0:
            # no tier: every key the store knew was resident
            tier_gauges(len(self), 1.0, cold)
        return out

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for keys; missing keys read as zero rows and are not
        created."""
        return self.lookup_present(keys)[0]

    def lookup_present(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, found) for keys, creating nothing: missing keys read as
        zero rows with found False (one probe a key, hs_lookup_gather)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((keys.size, self.layout.width), np.float32)
        found = np.empty(keys.size, np.uint8)
        self._lib.hs_lookup_gather(self._h, ptr(keys, U64P), keys.size,
                                   ptr(out, F32P), ptr(found, U8P))
        return out, found.view(bool)

    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of every feature in the store, in hash order."""
        n = len(self)
        keys = np.empty(n, np.uint64)
        rows = np.empty(n, np.int64)
        values = np.empty((n, self.layout.width), np.float32)
        if n:
            self._lib.hs_items(self._h, ptr(keys, U64P), ptr(rows, I64P))
            self._lib.hs_gather(self._h, ptr(rows, I64P), n,
                                ptr(values, F32P))
        return keys, values

    def write_back(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Overwrite the rows of known keys (end-of-pass slab dump)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        values = np.ascontiguousarray(values, dtype=np.float32)
        if values.shape != (keys.size, self.layout.width):
            raise ValueError("write_back of %s values for %d keys of width %d"
                             % (values.shape, keys.size, self.layout.width))
        rows = self._rows(keys)
        if (rows < 0).any():
            raise KeyError("write_back of keys the store never created")
        self._lib.hs_scatter(self._h, ptr(rows, I64P), keys.size,
                             ptr(values, F32P))

    def assign(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Create or overwrite the rows of unique keys verbatim, with no
        creation draw (a journal replay's ROWS record)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        values = np.ascontiguousarray(values, dtype=np.float32)
        if values.shape != (keys.size, self.layout.width):
            raise ValueError("assign of %s values for %d keys of width %d"
                             % (values.shape, keys.size, self.layout.width))
        rows = np.empty(keys.size, np.int64)
        created = np.empty(keys.size, np.uint8)
        self._lib.hs_lookup_or_create(self._h, ptr(keys, U64P), keys.size,
                                      ptr(rows, I64P), ptr(created, U8P))
        self._lib.hs_scatter(self._h, ptr(rows, I64P), keys.size,
                             ptr(values, F32P))

    # ------------------------------------------------------------ lifecycle
    def shrink(self) -> int:
        """ShrinkTable: decay show/click of every row and erase the dead
        features (layout.shrink_mask). Returns the deletions."""
        keys, values = self.state_items()
        if not keys.size:
            return 0
        dead = self.layout.shrink_mask(values, self.table)
        self.write_back(keys, values)  # the decay
        gone = np.ascontiguousarray(keys[dead])
        if gone.size:
            self._lib.hs_erase(self._h, ptr(gone, U64P), gone.size)
            stat_add("sparse_keys_shrunk", int(gone.size))
        return int(gone.size)

    def _add_col(self, col: int, delta: float) -> int:
        """Add ``delta`` to column ``col`` of every row; returns the rows."""
        touched = int(self._lib.hs_add_col(self._h, col, delta))
        if touched < 0:
            raise RuntimeError("hs_add_col(col=%d) refused by the native "
                               "store: its rows are narrower" % col)
        return touched

    def age_unseen_days(self) -> None:
        """Add one day to every feature's unseen_days, in place in C++."""
        stat_add("sparse_rows_aged", self._add_col(UNSEEN_DAYS, 1.0))

    def update_stat_after_save(self, table: TableConfig, param: int
                               ) -> None:
        """UpdateStatAfterSave over every row: param 3 is the column add;
        param 1 gathers every row once and writes back the covered rows
        with their delta score cleared (layout.update_stat_after_save's
        arithmetic)."""
        if param == 3:
            self._add_col(UNSEEN_DAYS, 1.0)
        elif param == 1:
            keys, values = self.state_items()
            if not keys.size:
                return
            before = values[:, DELTA_SCORE].view(np.uint32).copy()
            self.layout.update_stat_after_save(values, table, 1)
            covered = values[:, DELTA_SCORE].view(np.uint32) != before
            if covered.any():
                self.write_back(keys[covered], values[covered])

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
        "optimizer"}) into a new C++ store; the creation randoms go on from
        where they were."""
        if blob["embedx_dim"] != self.layout.embedx_dim or \
                blob["optimizer"] != self.layout.optimizer:
            raise ValueError("checkpoint layout mismatch")
        keys = np.ascontiguousarray(blob["keys"], np.uint64).ravel()
        values = np.ascontiguousarray(blob["values"], np.float32)
        if values.shape != (keys.size, self.layout.width):
            raise ValueError("checkpoint values %s for %d keys of width %d"
                             % (values.shape, keys.size, self.layout.width))
        h = self._lib.hs_create(self.layout.width, LOAD_FACTOR)
        self._lib.hs_destroy(self._h)
        self._h = h
        if keys.size:
            # insert in key order: a blob in a store's hash order (what
            # state_items gives) fills the growing table's probe chains in
            # runs, which made a 629k-row install 20x slower
            order = np.argsort(keys)
            keys = np.ascontiguousarray(keys[order])
            values = np.ascontiguousarray(values[order])
            rows = np.empty(keys.size, np.int64)
            created = np.empty(keys.size, np.uint8)
            self._lib.hs_lookup_or_create(self._h, ptr(keys, U64P),
                                          keys.size, ptr(rows, I64P),
                                          ptr(created, U8P))
            if not created.all():
                raise ValueError("checkpoint holds a key twice")
            self._lib.hs_scatter(self._h, ptr(rows, I64P), keys.size,
                                 ptr(values, F32P))


def make_host_store(layout: ValueLayout, table: TableConfig,
                    seed: int = 0) -> NativeHostEmbeddingStore:
    """The pass table's default store: the native one. Raises when the
    host library does not build; the plain HostEmbeddingStore is only
    ever passed in by name."""
    return NativeHostEmbeddingStore(layout, table, seed)
