"""The native host embedding store: a C++ open-addressing hash table over a
growable row arena (native/host_store.cc), with the SSD spill tier behind
it.

Counterpart of paddlebox_tpu/embedding/native_store.py:40-475, with the API
of host_store.py's HostEmbeddingStore, its plain version. Each call is one
bulk C call (or two) in place of a Python dict loop. A key is created by ``lookup_or_create`` (or installed
verbatim by ``assign``, a journal replay, which draws nothing); the rows of
the keys it creates are drawn in Python by ``ValueLayout.new_rows`` from one
``RandomState(seed)`` in the order the caller passes the keys, as the plain
store draws them, so the two stores hold the same bits. ``state_items`` returns hash order. The day
lifecycle's arithmetic runs in numpy (the accessor's), on rows gathered from
and scattered back to the C++ arena; the one column add in C++ adds 1.0,
which no contraction changes.

The SSD tier (embedding/ssd_tier.py) is the plain store's: the same
fault-in, peek, lazy aging, sweep and journal sink. ``spill`` picks its
victims in C++ (``hs_coldest``: the largest unseen_days, ties by ascending
key, so the keys a spill moves do not depend on the hash order), gathers
their rows and erases them from the arena. The plain store breaks ties by
its index order, so the two stores spill different keys of equal
unseen_days; rows are value-transparent either way.

Like the plain store it has no lock of its own: the pass table holds its
``store_lock`` around every call. The key 2**64 - 1 is the table's empty
sentinel and cannot be stored.

Telemetry, under the reference's names (native_store.py:121-264):
sparse_keys_resident_hit, sparse_keys_created, sparse_keys_faulted_in and
the tier gauges (host_store.tier_gauges) at lookup_or_create,
sparse_keys_faulted_in and sparse_keys_prefetch_faulted at lookup_present,
sparse_keys_spilled at spill, sparse_keys_shrunk and sparse_rows_aged at
the day boundary.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags, HostFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import (DELTA_SCORE, UNSEEN_DAYS,
                                                    ValueLayout)
from paddlebox_tpu_torch.embedding.host_store import tier_gauges
from paddlebox_tpu_torch.embedding.ssd_tier import (MV_FAULT_IN, MV_SPILL,
                                                    SpillTier)
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.native.host_lib import F32P, I64P, U8P, U64P, ptr
from paddlebox_tpu_torch.utils.stats import stat_add



class NativeHostEmbeddingStore:
    """uint64 feasign -> fixed-width float32 row, held by the C++ store."""

    def __init__(self, layout: ValueLayout, table: TableConfig,
                 seed: int = 0) -> None:
        self._lib = host_lib.host_lib()
        self.layout = layout
        self.table = table
        self._rng = np.random.RandomState(seed)
        # the hash table grows past this load (HostFlags'
        # sparse_table_load_factor when the store is made)
        self._load_factor = float(HostFlags().sparse_table_load_factor)
        self._h = self._lib.hs_create(layout.width, self._load_factor)
        # the block tag is the store's own (see HostEmbeddingStore)
        self._spill_dir = table.ssd_dir
        self._tier = SpillTier(layout.width, table.ssd_dir,
                               "%x_%x" % (os.getpid(), id(self)),
                               table.show_click_decay_rate)
        self._journal_sink = None

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

    def _scatter(self, rows: np.ndarray, values: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, np.int64)
        values = np.ascontiguousarray(values, np.float32)
        self._lib.hs_scatter(self._h, ptr(rows, I64P), rows.size,
                             ptr(values, F32P))

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows, np.int64)
        out = np.empty((rows.size, self.layout.width), np.float32)
        self._lib.hs_gather(self._h, ptr(rows, I64P), rows.size,
                            ptr(out, F32P))
        return out

    def _create(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, created) of ``keys``, creating the absent in the
        arena."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = np.empty(keys.size, np.int64)
        created = np.empty(keys.size, np.uint8)
        self._lib.hs_lookup_or_create(self._h, ptr(keys, U64P), keys.size,
                                      ptr(rows, I64P), ptr(created, U8P))
        return rows, created.view(bool)

    def _install(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Index new keys with their rows (a fault-in)."""
        self._scatter(self._create(keys)[0], values)

    def _erase(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.uint64)
        self._lib.hs_erase(self._h, ptr(keys, U64P), keys.size)

    def _journal_move(self, op: int, keys: np.ndarray) -> None:
        if self._journal_sink is not None:
            self._journal_sink(op, keys)

    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        """Rows for unique keys: the tier's fault back in (no creation
        draw for them), the others missing are created in key order."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys.size
        # a first lookup finds nothing to hit: construction, not thrashing
        cold = not len(self) and not len(self._tier)
        rows, created = self._create(keys)
        out = self._gather(rows)
        n_created = int(created.sum())
        new = created
        if n_created:
            if len(self._tier):
                spilled = np.zeros(n, bool)
                spilled[created] = self._tier.contains(keys[created])
                if spilled.any():
                    fkeys = keys[spilled]
                    out[spilled] = self._tier.read(fkeys, pop=True)
                    stat_add("sparse_keys_faulted_in", int(fkeys.size))
                    self._journal_move(MV_FAULT_IN, fkeys)
                    new = created & ~spilled
            n_new = int(new.sum())
            if n_new:
                out[new] = self.layout.new_rows(n_new, self._rng,
                                                self.table.optimizer)
                stat_add("sparse_keys_created", n_new)
            # the faulted and created rows into the arena
            self._scatter(rows[created], out[created])
        n_res = n - n_created
        if n:
            stat_add("sparse_keys_resident_hit", n_res)
        # the rate is over the keys the store knew (resident and faulted):
        # created keys give no sample
        known = n - int(new.sum())
        if known > 0:
            tier_gauges(len(self), n_res / known, cold)
        return out

    def _read_resident(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, found) of the resident keys, zero rows elsewhere (one
        probe a key, hs_lookup_gather)."""
        out = np.empty((keys.size, self.layout.width), np.float32)
        found = np.empty(keys.size, np.uint8)
        self._lib.hs_lookup_gather(self._h, ptr(keys, U64P), keys.size,
                                   ptr(out, F32P), ptr(found, U8P))
        return out, found.view(bool)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for keys; missing keys read as zero rows and are not
        created. The tier's rows are peeked at, not moved."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out, found = self._read_resident(keys)
        if len(self._tier) and not found.all():
            mi = np.nonzero(~found)[0]
            sp = mi[self._tier.contains(keys[mi])]
            if sp.size:
                out[sp] = self._tier.read(keys[sp], pop=False)
        return out

    def lookup_present(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, found) for keys, creating nothing: the tier's keys fault
        in (counted as sparse_keys_prefetch_faulted too), missing keys read
        as zero rows with found False (see HostEmbeddingStore)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out, found = self._read_resident(keys)
        if len(self._tier) and not found.all():
            mi = np.nonzero(~found)[0]
            fi = mi[self._tier.contains(keys[mi])]
            if fi.size:
                fkeys = keys[fi]
                vals = self._tier.read(fkeys, pop=True)
                self._install(fkeys, vals)
                out[fi] = vals
                found[fi] = True
                stat_add("sparse_keys_faulted_in", int(fi.size))
                stat_add("sparse_keys_prefetch_faulted", int(fi.size))
                self._journal_move(MV_FAULT_IN, fkeys)
        return out, found

    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of every resident feature, in hash order (the
        tier's are in ``spilled_snapshot``)."""
        n = len(self)
        keys = np.empty(n, np.uint64)
        rows = np.empty(n, np.int64)
        if n:
            self._lib.hs_items(self._h, ptr(keys, U64P), ptr(rows, I64P))
        return keys, self._gather(rows)

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
        self._scatter(rows, values)

    def assign(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Create or overwrite the rows of unique keys verbatim, with no
        creation draw (a journal replay's ROWS record); a tier entry of an
        assigned key is discarded unread."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        values = np.ascontiguousarray(values, dtype=np.float32)
        if values.shape != (keys.size, self.layout.width):
            raise ValueError("assign of %s values for %d keys of width %d"
                             % (values.shape, keys.size, self.layout.width))
        if len(self._tier):
            self._tier.discard(keys)
        self._scatter(self._create(keys)[0], values)

    # ------------------------------------------------------------ lifecycle
    def shrink(self) -> int:
        """ShrinkTable: decay show/click of every resident row and erase
        the dead features (layout.shrink_mask); then the tier's sweep by
        unseen days. Returns the deletions."""
        keys, values = self.state_items()
        n_dead = 0
        if keys.size:
            dead = self.layout.shrink_mask(values, self.table)
            self.write_back(keys, values)  # the decay
            if dead.any():
                self._erase(keys[dead])
            n_dead = int(dead.sum())
        # the tier's rows are swept even when nothing is resident
        n_dead += self._tier.sweep(self.table.delete_after_unseen_days)
        if n_dead:
            stat_add("sparse_keys_shrunk", n_dead)
        return n_dead

    def _add_col(self, col: int, delta: float) -> int:
        """Add ``delta`` to column ``col`` of every row; returns the rows."""
        touched = int(self._lib.hs_add_col(self._h, col, delta))
        if touched < 0:
            raise RuntimeError("hs_add_col(col=%d) refused by the native "
                               "store: its rows are narrower" % col)
        return touched

    def age_unseen_days(self) -> None:
        """Add one day to every feature's unseen_days, in place in C++ (the
        tier's lazily, by its day clock)."""
        stat_add("sparse_rows_aged", self._add_col(UNSEEN_DAYS, 1.0))
        self._tier.tick()

    def tick_spill_age(self) -> None:
        """Advance only the tier rows' day clock (see
        HostEmbeddingStore.tick_spill_age)."""
        self._tier.tick()

    def update_stat_after_save(self, table: TableConfig, param: int
                               ) -> None:
        """UpdateStatAfterSave over every resident row: param 3 is the
        column add; param 1 gathers every row once and writes back the
        covered rows with their delta score cleared
        (layout.update_stat_after_save's arithmetic)."""
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

    # ------------------------------------------------------------- SSD tier
    def set_journal_sink(self, sink) -> None:
        """Install the journal's MOVE recorder, ``sink(op, keys)`` (None
        detaches)."""
        self._journal_sink = sink

    def spill(self, max_resident: int) -> int:
        """Move the rows beyond ``max_resident`` with the largest
        unseen_days to the tier (CheckNeedLimitMem / ShrinkResource,
        box_wrapper.h:627-629): the victims picked in C++ (hs_coldest),
        gathered into one block and erased from the arena. Spills nothing
        without ``ssd_dir``. Returns the rows moved."""
        if not self._spill_dir:
            return 0
        excess = len(self) - max_resident
        if excess <= 0:
            return 0
        keys = np.empty(excess, np.uint64)
        rows = np.empty(excess, np.int64)
        got = int(self._lib.hs_coldest(self._h, excess, UNSEEN_DAYS,
                                       ptr(keys, U64P), ptr(rows, I64P)))
        if got < 0:
            raise MemoryError("hs_coldest could not allocate its scratch "
                              "for %d rows" % len(self))
        keys, rows = keys[:got], rows[:got]
        self._tier.spill_rows(keys, self._gather(rows))
        self._erase(keys)
        self._journal_move(MV_SPILL, keys)
        stat_add("sparse_keys_spilled", got)
        return got

    def spill_exact(self, keys: np.ndarray) -> int:
        """Move exactly these keys, those resident, to the tier (journal
        replay). Never journals. Returns the rows moved."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = self._rows(keys)
        present = rows >= 0
        if not present.any():
            return 0
        pkeys = keys[present]
        self._tier.spill_rows(pkeys, self._gather(rows[present]))
        self._erase(pkeys)
        return int(pkeys.size)

    def fault_in_keys(self, keys: np.ndarray) -> int:
        """Fault exactly these keys, those in the tier, back in (journal
        replay). Never journals. Returns the rows moved."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if not len(self._tier):
            return 0
        fkeys = keys[self._tier.contains(keys)]
        if fkeys.size:
            self._install(fkeys, self._tier.read(fkeys, pop=True))
        return int(fkeys.size)

    def rebase_spill_ages(self) -> None:
        """Pin a span boundary of the tier's lazy aging (a full save's
        journal anchor; SpillTier.rebase)."""
        self._tier.rebase()

    def load_spilled(self) -> int:
        """LoadSSD2Mem: fault every tier row back in. Returns the rows
        moved."""
        skeys = self._tier.live_keys()
        if not skeys.size:
            return 0
        self._install(skeys, self._tier.read(skeys, pop=True))
        self._journal_move(MV_FAULT_IN, skeys)
        stat_add("sparse_keys_faulted_in", int(skeys.size))
        return int(skeys.size)

    def spilled_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows at their effective values) of the tier, moving
        nothing."""
        return self._tier.snapshot()

    def spilled_keys(self) -> np.ndarray:
        """Every key in the tier (a full save's anchor record)."""
        return self._tier.live_keys()

    def spilled_count(self) -> int:
        """Rows in the tier."""
        return len(self._tier)

    # ----------------------------------------------------------- checkpoint
    def save(self, path: str, flags: Optional[CkptFlags] = None) -> None:
        """Checkpoint every feature, resident and in the tier (at its
        effective values), at ``path`` in ``flags``' format (the columnar
        manifest and parts by default, or the legacy pickle)."""
        flags = flags or CkptFlags()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        keys, values = self.state_items()
        skeys, svals = self.spilled_snapshot()
        if skeys.size:
            keys = np.concatenate([keys, skeys])
            values = np.vstack([values, svals])
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
        "optimizer"}) into a new C++ store, emptying the tier; the creation
        randoms go on from where they were."""
        if blob["embedx_dim"] != self.layout.embedx_dim or \
                blob["optimizer"] != self.layout.optimizer:
            raise ValueError("checkpoint layout mismatch")
        keys = np.ascontiguousarray(blob["keys"], np.uint64).ravel()
        values = np.ascontiguousarray(blob["values"], np.float32)
        if values.shape != (keys.size, self.layout.width):
            raise ValueError("checkpoint values %s for %d keys of width %d"
                             % (values.shape, keys.size, self.layout.width))
        h = self._lib.hs_create(self.layout.width, self._load_factor)
        self._lib.hs_destroy(self._h)
        self._h = h
        # a stale tier entry must not come back over a restored row
        self._tier.clear()
        if keys.size:
            # insert in key order: a blob in a store's hash order (what
            # state_items gives) fills the growing table's probe chains in
            # runs, which made a 629k-row install 20x slower
            order = np.argsort(keys)
            rows, created = self._create(keys[order])
            if not created.all():
                raise ValueError("checkpoint holds a key twice")
            self._scatter(rows, values[order])


def make_host_store(layout: ValueLayout, table: TableConfig,
                    seed: int = 0, stripes: int = 0):
    """The pass table's default store: the native one, or with ``stripes``
    > 0 (PassFlags.host_store_stripes) a StripedHostStore of that many
    native stores. Raises when the host library does not build; the plain
    HostEmbeddingStore is only ever passed in by name."""
    if stripes > 0:
        from paddlebox_tpu_torch.embedding.striped_store import \
            StripedHostStore
        return StripedHostStore(layout, table, seed, stripes)
    return NativeHostEmbeddingStore(layout, table, seed)
