"""Host-DRAM embedding store in Python: every feature ever seen, as numpy
f32 rows, with the SSD spill tier behind it.

Counterpart of paddlebox_tpu/embedding/host_store.py:37-505. It is the
plain version of native_store.py's NativeHostEmbeddingStore, which the pass
table uses unless this store is passed in by name. Missing keys are
created by ``lookup_or_create``, in the order the caller passes them (the
pass table passes its sorted-unique key set, or the sorted keys it still
misses), with ``ValueLayout.new_rows`` drawing from one
``RandomState(seed)``, which is the rule both JAX stores follow, so the two
packages hold the same rows; ``assign`` (a journal replay) installs given
rows and draws nothing.
Live rows fill [0, len) of the row array in the index's order: shrink and
spill compact in place of a free list, so the index's key order, and a
sorted ``state_items``, match the JAX store's after any sequence of calls.

The SSD tier (embedding/ssd_tier.py, ``TableConfig.ssd_dir``): ``spill``
moves the rows of the largest unseen_days beyond a row budget (a stable
argsort over the index's order, as the reference picks them) into a block
file; a key that sleeps there faults back in, in one batched read and
with no creation draw, where ``lookup_or_create`` or ``lookup_present``
(the promote prefetcher) asks for it, and ``lookup`` (test mode) peeks at
it without moving it. The tier's rows age lazily: ``age_unseen_days`` and
``tick_spill_age`` tick its day clock, ``shrink`` sweeps it by the
unseen-days rule alone (reference ssd_tier.py ``sweep``: a sleeping row is
never read for the score rule), and ``save`` and ``spilled_snapshot`` read
its rows at their effective values. Every move across the boundary reports
``(MV_SPILL | MV_FAULT_IN, keys)`` to the journal sink
(``set_journal_sink``); ``spill_exact`` and ``fault_in_keys`` are the
replay's moves, which report nothing.

The store has no lock of its own: growing replaces ``_values``. A caller
that reads it from another thread (the preload's promote prefetcher) holds
the pass table's ``store_lock``, as the table does around every store call.

Telemetry, under the reference's names (host_store.py:110-158, 285):
lookup_or_create counts sparse_keys_resident_hit, sparse_keys_created and
sparse_keys_faulted_in and sets the gauges of ``tier_gauges`` with the
hit rate over the keys the store knew; lookup_present counts
sparse_keys_faulted_in and sparse_keys_prefetch_faulted; spill counts
sparse_keys_spilled; shrink sparse_keys_shrunk.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.embedding import ckpt_store
from paddlebox_tpu_torch.embedding.accessor import UNSEEN_DAYS, ValueLayout
from paddlebox_tpu_torch.embedding.ssd_tier import (MV_FAULT_IN, MV_SPILL,
                                                    SpillTier)
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
        # the block tag is the store's own, so stores sharing one ssd_dir
        # never clobber each other's blocks, and carries the pid, so a
        # restarted process's construction sweep reclaims dead blocks
        self._spill_dir = table.ssd_dir
        self._tier = SpillTier(layout.width, table.ssd_dir,
                               "%x_%x" % (os.getpid(), id(self)),
                               table.show_click_decay_rate)
        self._journal_sink = None

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

    def _install(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Index new unique keys with their rows; returns the rows."""
        new = self._add(keys)
        self._values[new] = values
        return new

    def _keep(self, keys: np.ndarray, rows: np.ndarray,
              keep: np.ndarray) -> None:
        """Keep the features ``keys[keep]`` (``keys``, ``rows``: every
        feature in index order), moved to [0, n) in that order."""
        n = int(keep.sum())
        values = np.zeros_like(self._values)
        values[:n] = rows[keep]
        self._values = values
        self._index = dict(zip(keys[keep].tolist(), range(n)))

    def _drop(self, keys: np.ndarray) -> None:
        """Remove the resident features ``keys`` (each present)."""
        all_keys, rows = self.state_items()
        keep = np.ones(all_keys.size, bool)
        keep[self._rows_of(keys)] = False
        self._keep(all_keys, rows, keep)

    def _fault_in(self, keys: np.ndarray, rows: np.ndarray) -> int:
        """Fault the tier's keys among ``keys`` absent from the index
        (``rows`` -1) back in, in one batched read, setting their ``rows``
        in place and journaling the move; returns how many."""
        if not len(self._tier):
            return 0
        miss = np.nonzero(rows < 0)[0]
        fi = miss[self._tier.contains(keys[miss])]
        if fi.size:
            fkeys = keys[fi]
            rows[fi] = self._install(fkeys, self._tier.read(fkeys, pop=True))
            stat_add("sparse_keys_faulted_in", int(fi.size))
            if self._journal_sink is not None:
                self._journal_sink(MV_FAULT_IN, fkeys)
        return int(fi.size)

    def lookup_or_create(self, keys: np.ndarray) -> np.ndarray:
        """Rows for unique keys: the tier's fault back in (no creation
        draw for them), the others missing are created in key order."""
        keys = np.asarray(keys, dtype=np.uint64)
        # a first lookup finds nothing to hit: construction, not thrashing
        cold = not self._index and not len(self._tier)
        rows = self._rows_of(keys)
        n_res = int((rows >= 0).sum())
        if keys.size:
            stat_add("sparse_keys_resident_hit", n_res)
        self._fault_in(keys, rows)
        miss = np.nonzero(rows < 0)[0]
        if miss.size:
            rows[miss] = self._install(keys[miss], self.layout.new_rows(
                miss.size, self._rng, self.table.optimizer))
            stat_add("sparse_keys_created", int(miss.size))
        # the rate is over the keys the store knew (resident and faulted):
        # created keys give no sample
        known = int(keys.size) - int(miss.size)
        if known > 0:
            tier_gauges(len(self._index), n_res / known, cold)
        return self._values[rows].copy()

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for keys; missing keys read as zero rows and are not
        created. The tier's rows are peeked at, not moved (a test-mode
        read changes nothing and journals nothing)."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        found = rows >= 0
        out = np.zeros((keys.size, self.layout.width), np.float32)
        out[found] = self._values[rows[found]]
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
        as zero rows with found False. The promote prefetcher's read: new
        keys are left for the pass boundary's sorted ``lookup_or_create``,
        so the creation draws stay in the full path's order."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        faulted = self._fault_in(keys, rows)
        if faulted:
            stat_add("sparse_keys_prefetch_faulted", faulted)
        found = rows >= 0
        out = np.zeros((keys.size, self.layout.width), np.float32)
        out[found] = self._values[rows[found]]
        return out, found

    def state_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows) of every resident feature (the tier's are in
        ``spilled_snapshot``). The order is the store's own (here the
        index's, hash order in the native store): a caller that compares
        stores sorts by key."""
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
        [len, len + m) in the order given. A tier entry of an assigned key
        is discarded unread: it must not come back over the assigned
        row."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = self._rows_of(keys)
        miss = np.nonzero(rows < 0)[0]
        if miss.size:
            if len(self._tier):
                self._tier.discard(keys[miss])
            rows[miss] = self._add(keys[miss])
        self._values[rows] = values

    # ------------------------------------------------------------ lifecycle
    def shrink(self) -> int:
        """ShrinkTable: decay show/click of every resident row and delete
        the dead features (ctr_accessor.cc:63-79 via layout.shrink_mask),
        keeping the live rows in [0, len); then the tier's sweep by
        unseen days. Returns the deletions."""
        n_dead = 0
        if self._index:
            keys, view = self.state_items()
            dead = self.layout.shrink_mask(view, self.table)
            self._keep(keys, view, ~dead)
            n_dead = int(dead.sum())
        # the tier's rows are swept even when nothing is resident: the
        # coldest rows must not outlive their lifetime by sleeping
        n_dead += self._tier.sweep(self.table.delete_after_unseen_days)
        if n_dead:
            stat_add("sparse_keys_shrunk", n_dead)
        return n_dead

    def age_unseen_days(self) -> None:
        """Add one day to every feature's unseen_days (the tier's lazily,
        by its day clock)."""
        self._values[:len(self._index), UNSEEN_DAYS] += 1.0
        self._tier.tick()

    def tick_spill_age(self) -> None:
        """Advance only the tier rows' day clock: a day boundary whose
        resident rows a base save's stat rewrite already aged."""
        self._tier.tick()

    def update_stat_after_save(self, table: TableConfig, param: int
                               ) -> None:
        """UpdateStatAfterSave over every resident row, in place: param 1
        clears the delta score of the rows a delta save covers, 3 ages
        unseen_days (layout.update_stat_after_save's arithmetic)."""
        # [0, len) is a view: the rewrite lands in place
        self.layout.update_stat_after_save(self._values[:len(self._index)],
                                           table, param)

    # ------------------------------------------------------------- SSD tier
    def set_journal_sink(self, sink) -> None:
        """Install the journal's MOVE recorder, ``sink(op, keys)``, called
        where each move happens (None detaches)."""
        self._journal_sink = sink

    def spill(self, max_resident: int) -> int:
        """Move the rows beyond ``max_resident`` with the largest
        unseen_days (a stable argsort over the index's order) to the tier
        (CheckNeedLimitMem / ShrinkResource, box_wrapper.h:627-629).
        Spills nothing without ``ssd_dir``. Returns the rows moved."""
        if not self._spill_dir:
            return 0
        excess = len(self._index) - max_resident
        if excess <= 0:
            return 0
        keys, rows = self.state_items()
        order = np.argsort(-rows[:, UNSEEN_DAYS], kind="stable")[:excess]
        vkeys = keys[order]
        self._tier.spill_rows(vkeys, rows[order])
        keep = np.ones(keys.size, bool)
        keep[order] = False
        self._keep(keys, rows, keep)
        if self._journal_sink is not None:
            self._journal_sink(MV_SPILL, vkeys)
        stat_add("sparse_keys_spilled", excess)
        return excess

    def spill_exact(self, keys: np.ndarray) -> int:
        """Move exactly these keys, those resident, to the tier (the
        replay of an MV_SPILL record, and of a full save's anchor). Never
        journals. Returns the rows moved."""
        keys = np.asarray(keys, dtype=np.uint64)
        present = keys[self._rows_of(keys) >= 0]
        if not present.size:
            return 0
        self._tier.spill_rows(present, self._values[self._rows_of(present)])
        self._drop(present)
        return int(present.size)

    def fault_in_keys(self, keys: np.ndarray) -> int:
        """Fault exactly these keys, those in the tier, back in (the replay
        of an MV_FAULT_IN record). Never journals. Returns the rows
        moved."""
        keys = np.asarray(keys, dtype=np.uint64)
        if not len(self._tier):
            return 0
        fkeys = keys[self._tier.contains(keys)]
        if fkeys.size:
            self._install(fkeys, self._tier.read(fkeys, pop=True))
        return int(fkeys.size)

    def rebase_spill_ages(self) -> None:
        """Pin a span boundary of the tier's lazy aging at its current day
        (a full save's journal anchor; SpillTier.rebase)."""
        self._tier.rebase()

    def load_spilled(self) -> int:
        """LoadSSD2Mem: fault every tier row back in, in one batched read.
        Returns the rows moved."""
        skeys = self._tier.live_keys()
        if not skeys.size:
            return 0
        self._install(skeys, self._tier.read(skeys, pop=True))
        if self._journal_sink is not None:
            self._journal_sink(MV_FAULT_IN, skeys)
        stat_add("sparse_keys_faulted_in", int(skeys.size))
        return int(skeys.size)

    def spilled_snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, rows at their EFFECTIVE values) of the tier, moving
        nothing: the missed days apply to the copy. Every snapshot beyond
        state_items reads the tier through this."""
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
        "optimizer"}), replacing every row and emptying the tier (a stale
        tier entry must not come back over a restored row); the creation
        randoms go on from where they were."""
        if blob["embedx_dim"] != self.layout.embedx_dim or \
                blob["optimizer"] != self.layout.optimizer:
            raise ValueError("checkpoint layout mismatch")
        keys = np.asarray(blob["keys"], np.uint64).ravel()
        n = int(keys.size)
        values = np.zeros((max(n, _GROW), self.layout.width), np.float32)
        values[:n] = blob["values"]
        self._tier.clear()
        self._values = values
        self._index = dict(zip(keys.tolist(), range(n)))
        if len(self._index) != n:
            raise ValueError("checkpoint holds a key twice")
