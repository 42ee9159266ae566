"""The native host embedding store: a C++ open-addressing hash table over a
growable row arena (native/host_store.cc).

Counterpart of paddlebox_tpu/embedding/native_store.py:40-200 and :454-475
without the SSD tier and telemetry, with the API of host_store.py's
HostEmbeddingStore, its plain version. Each call is one bulk C call (or
two) in place of a Python dict loop. A key is created only by
``lookup_or_create``; the rows of the keys it creates are drawn in Python by
``ValueLayout.new_rows`` from one ``RandomState(seed)`` in the order the
caller passes the keys, as the plain store draws them, so the two stores
hold the same bits. ``state_items`` returns hash order.

Like the plain store it has no lock of its own: the pass table holds its
``store_lock`` around every call. The key 2**64 - 1 is the table's empty
sentinel and cannot be stored.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.native.host_lib import F32P, I64P, U8P, U64P, ptr

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


def make_host_store(layout: ValueLayout, table: TableConfig,
                    seed: int = 0) -> NativeHostEmbeddingStore:
    """The pass table's default store: the native one. Raises when the
    host library does not build; the plain HostEmbeddingStore is only
    ever passed in by name."""
    return NativeHostEmbeddingStore(layout, table, seed)
