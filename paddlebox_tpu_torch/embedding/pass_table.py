"""Pass-lifecycle sparse table on one device.

Counterpart of paddlebox_tpu/embedding/pass_table.py (single device, with
the incremental lifecycle, test mode and the day boundary, :114-126,
:345-360, :464-712, :735-785, :846-902):

  begin_feed_pass / add_keys / end_feed_pass  collect the pass key set,
        give each key a dense pass-local id (its rank in the sorted-unique
        key array) and build the pass's route index (a native key -> id
        hash index over that array)
  begin_pass   the pass slab, one [capacity, width] f32 tensor on the device
        (under the bf16 diet [capacity, device_width] int16, the codec's
        rows: embedding/accessor.py)
  lookup_ids   keys -> ids (one probe a key of the route index); padding ->
        trash row; marks the ids' rows touched
  dedup_for_push  the per-batch sorted dedup the push consumes (with
        segment_offsets, its runs over the real occurrences)
  uids_for_push / pos_for_rebuild  the uid wire's sorted uid vector
        (native first) and the rebuild write's position map
  end_pass     the pass's rows -> host store
  shrink_table / end_day / save / load   the day boundary on the store

With ``PassFlags.incremental_pass`` (the default) the slab stays resident
after end_pass. The next begin_pass diffs its key set against the resident
one, moves the rows of the keys it keeps to their new sorted positions on
the device (``delta_promote``, a row gather on the gather_rows kernel) and
reads only the other keys' rows from the host store: rows the preload's
prefetcher staged first, then one sorted ``lookup_or_create``, so new keys
are created in the full path's order. end_pass gathers the rows that
lookup_ids touched (the same kernel) and writes back only those. Both give
the full path's bits: ids are the sorted-unique positions, rows move
without arithmetic, and the tail beyond the pass keys is zero. With the
flag off, begin_pass builds the slab from the host store and end_pass
writes back [0, n) and drops it.

Under ``embed_dtype="bfloat16"`` (the flag ``slab_embed_dtype``, resolved
once at construction; reference pass_table.py:98-104, 325, 544-580,
627-645) the store's f32 rows are encoded with the numpy codec where they
enter the slab (the full build, a promote's misses), resident rows move as
raw 2-byte bits through the 2-byte gather, and the write-back decodes the
gathered rows with the numpy codec before it journals and stores them:
host stores, checkpoints and the journal stay f32.

The last slab row (capacity-1) is the trash row that padding key slots
address; it never reaches the host store. The train step updates the slab
IN PLACE (the JAX step donates it, trainer.py:715-742): there is one live
slab per pass, and two only while a delta promote runs. Every store call
holds ``store_lock``, the lock the promote prefetcher reads under.

The host tier is native by default (native/host_lib.py): the store is
``make_host_store``'s C++ store unless a caller passes one (the plain
HostEmbeddingStore, by name), and ``lookup_ids`` and the resident diff
probe route indexes (reference pass_table.py:419-475, 762-770). The ended
pass's index is kept across the feed boundary while it covers the resident
key set, so the next begin_pass diffs by one probe a key; both indexes are
dropped in begin_pass, invalidate_residency and ``__del__``. The promote
prefetcher diffs against a numpy snapshot of the key set, never an index.
``lookup_ids_plain`` (searchsorted) is the plain version the tests hold the
index against. The per-batch dedup stays the sorted numpy tier: the push
kernel and the blocked write need ascending uids.

Test mode (SetTestMode, ``set_test_mode``) makes a pass an eval pass: its
begin_pass creates nothing (missing keys read as zero rows through
``store.lookup``) and consumes a resident slab as a train pass would, with
no second copy kept; it neither uses nor clears the prefetcher's staged
rows and keeps no touched rows; its end_pass writes nothing back and drops
the residency (the eval slab holds zero rows for keys the store lacks), so
the next train pass builds in full. The day boundary's store changes
(shrink, aging, a load) go around the pass cadence, so each first drops the
residency.

The SSD tier (TableConfig.ssd_dir and ssd_threshold_mb; reference
pass_table.py:659, 714-735, 847-901): every end_pass ends with
``check_need_limit_mem``, which spills the host store's coldest rows down
to its row budget under store_lock and, where it spilled, drops the
residency, so the next begin_pass builds in full and the rows it needs
fault back in from the tier. ``end_day(age=False)`` ticks the tier's day
clock, shrink sweeps it, and ``load_ssd_to_mem`` brings every spilled row
back.

With a touched-row journal attached (``attach_journal``; the checkpoint
manager attaches one under ckpt_journal), every train pass records the rows
it hands to the store: a delta promote's misses (which lookup_or_create may
have just created), a full build's rows and the write-back's rows, the
exact arrays the store gets; shrink and aging record an event, and a load
outside the checkpoint plane taints the journal's epoch (reference
pass_table.py:362-386, :530-535, :570-572, :627-643, :846-891). Test-mode
passes record nothing.

Telemetry (reference pass_table.py:492-660): the row counters ``COUNTERS``
go to the process-wide stat registry and to the table's own ``counters``;
begin_pass sets the gauge pass_rows and records the span pass_begin,
end_pass the span pass_end.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.config.flags import CkptFlags, PassFlags
from paddlebox_tpu_torch.device import DeviceLike, resolve_device
from paddlebox_tpu_torch.embedding.accessor import (PushLayout, ValueLayout,
                                                    decode_slab_rows_np,
                                                    slab_rows_np)
from paddlebox_tpu_torch.embedding.native_store import make_host_store
from paddlebox_tpu_torch.embedding.optimizers import push_sparse_dedup
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.obs.device import account_d2h, account_h2d
from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.ops.row_kernels import gather_rows
from paddlebox_tpu_torch.ops.sparse import (gather_slab_rows,
                                            pull_view_from_rows)
from paddlebox_tpu_torch.utils.journal_format import (EV_AGE_DAYS, EV_SHRINK,
                                                     EV_TICK_SPILL_AGE)
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add

# the reference's row counters (stat names): counted in the process-wide
# stat registry, as the reference counts them, and per table
COUNTERS = ("pass_rows_promote_hit", "pass_rows_promote_new",
            "pass_rows_promote_prefetched", "pass_rows_written_back",
            "pass_rows_writeback_skipped")


def sorted_member(sorted_keys: np.ndarray, keys: np.ndarray):
    """(pos, hit) of ``keys`` against a sorted unique key array: pos[i] is
    the index of keys[i] in sorted_keys where hit[i], a clamped index
    elsewhere. The one membership probe of the incremental lifecycle (the
    resident diff, the staged rows, the prefetcher's known set)."""
    if sorted_keys.size == 0:
        return (np.zeros(keys.size, np.int64),
                np.zeros(keys.size, bool))
    pos = np.minimum(np.searchsorted(sorted_keys, keys),
                     sorted_keys.size - 1)
    return pos, sorted_keys[pos] == keys


def lookup_ids_plain(pass_keys: np.ndarray, keys: np.ndarray,
                     valid: Optional[np.ndarray], padding_id: int
                     ) -> np.ndarray:
    """int32 ids of ``keys`` against a sorted unique ``pass_keys`` by
    searchsorted, padding_id where ``valid`` is False; raises KeyError for
    a valid key not in pass_keys. The plain version of
    ``host_lib.route_lookup``."""
    n = pass_keys.size
    ids = np.minimum(np.searchsorted(pass_keys, keys), max(n - 1, 0))
    hit = pass_keys[ids] == keys if n else np.zeros(keys.shape, bool)
    if valid is not None:
        ids = np.where(valid, ids, padding_id)
        hit = hit | ~valid
    if not hit.all():
        raise KeyError("keys not registered in feed pass (first few: %s)"
                       % keys[~hit][:5])
    return ids.astype(np.int32)


def delta_promote(old_slab: torch.Tensor, old_pos: np.ndarray,
                  new_rows: np.ndarray) -> torch.Tensor:
    """The next pass's slab from the resident one: row i < n is
    old_slab[old_pos[i]] where old_pos[i] >= 0 (the key at new position i
    was resident there), and the next of ``new_rows`` (host device rows of
    old_slab's dtype, one per position with old_pos -1, in order) where it
    is -1; rows n and after are zero. Returns a new tensor on old_slab's
    device.

    The counterpart of _delta_promote_impl (paddlebox_tpu/embedding/
    pass_table.py:73-84), bit for bit: the kept rows move by one row gather
    (gather_rows: the kernel on a CUDA slab) over [0, n), the misses
    reading any row since the promoted rows then overwrite every one of
    them (index_copy_); nothing is padded."""
    n = old_pos.shape[0]
    dev = old_slab.device
    hit = old_pos >= 0
    new = torch.empty_like(old_slab)
    if hit.any():
        src = np.where(hit, old_pos, 0).astype(np.int32)
        account_h2d(src.nbytes, "promote")
        gather_rows(old_slab, torch.from_numpy(src).to(dev), out=new[:n])
    new[n:].zero_()
    miss = np.flatnonzero(~hit)
    if miss.size:
        account_h2d(miss.nbytes + new_rows.nbytes, "promote")
        new.index_copy_(0, torch.from_numpy(miss).to(dev),
                        torch.from_numpy(new_rows).to(dev))
    return new


def dedup_ids(ids: np.ndarray, pad_base: int):
    """Host per-batch dedup (the numpy argsort tier of the JAX dedup_ids,
    pass_table.py:128-189), so uids always come back STRICTLY ASCENDING —
    the blocked write relies on that.

    Returns int32 [K] arrays (uids, perm, inv) and n_uniq:
      uids  unique ids, tail padded with pad_base+i (out of the slab)
      perm  occurrence indices grouped by unique id, ascending within each
      inv   merged-row index per permuted occurrence (nondecreasing)
      n_uniq  how many leading uids are real ids."""
    raw = np.asarray(ids)
    ids = np.ascontiguousarray(raw, dtype=np.int32)
    K = ids.shape[0]
    if K and (ids.min() < 0 or (raw.dtype != np.int32 and
                                np.uint64(raw.max()) > np.uint64(2**31 - 1))):
        raise ValueError("dedup_ids expects nonnegative int32 pass-local "
                         "ids, got range [%s, %s]" % (raw.min(), raw.max()))
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sorted_ids = ids[perm]
    newseg = np.empty(K, dtype=bool)
    if K:
        newseg[0] = True
        np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=newseg[1:])
    inv = np.cumsum(newseg, dtype=np.int32) - 1
    real = sorted_ids[newseg]
    n_uniq = int(real.shape[0])
    uids = np.empty(K, dtype=np.int32)
    uids[:n_uniq] = real
    uids[n_uniq:] = pad_base + np.arange(K - n_uniq, dtype=np.int32)
    return uids, perm, inv, n_uniq


def segment_offsets(inv: np.ndarray, n_valid: int) -> np.ndarray:
    """[K+1] int32 offsets of each unique's run among the first n_valid
    sorted occurrences: unique j's real occurrences are perm[offsets[j]:
    offsets[j+1]], i.e. offsets = searchsorted(inv[:n_valid], arange(K+1)).

    The padding key slots all address the trash row, the largest id, so
    they sort last: the first n_valid sorted occurrences are the real keys
    and cover uniques 0..m-1. Each run starts where inv steps (the walk
    dedup_ids made); the trash row and the padding tail get empty runs at
    n_valid, so the push merges them to zero rows."""
    K = inv.shape[0]
    offsets = np.full(K + 1, n_valid, np.int32)
    if n_valid:
        live = inv[:n_valid]
        newseg = np.empty(n_valid, bool)
        newseg[0] = True
        np.not_equal(live[1:], live[:-1], out=newseg[1:])
        starts = np.flatnonzero(newseg)
        offsets[:starts.shape[0]] = starts
    return offsets


def dedup_uids_sorted(ids: np.ndarray, pad_base: int) -> np.ndarray:
    """[K] int32 SORTED unique ids of ``ids``, the tail padded with
    pad_base + i: the uid wire's one host product (reference
    pass_table.py:192-248). The native tier (host_lib.dedup_sorted) runs
    where its span screen lets it engage (the largest id below pad_base,
    and either twice the live span at most K or the trash id pad_base - 1
    on top, which the kernel tracks apart); where it declines, the numpy
    tier (np.unique) runs. Both give the same array."""
    ids = np.ascontiguousarray(np.asarray(ids), np.int32)
    K = ids.shape[0]
    if K and ids.min() < 0:
        raise ValueError("dedup_uids_sorted expects nonnegative int32 "
                         "pass-local ids")
    if K:
        m = int(ids.max())
        if m < pad_base and (2 * (m + 1) <= K or m == pad_base - 1):
            out = host_lib.dedup_sorted(ids, pad_base)
            if out is not None:
                return out
    uniq = np.unique(ids)
    out = np.empty(K, np.int32)
    n = uniq.shape[0]
    out[:n] = uniq
    out[n:] = pad_base + np.arange(K - n, dtype=np.int32)
    return out


def delta_encode_uids(uids: np.ndarray, pad_base: int):
    """(base, d16, cut) of a sorted uid vector: the delta wire
    (wire_delta_ids; reference pass_table.py:251-285). The data ids, those
    below the trash id pad_base - 1, are uids[i] = base + cumsum(d16)[i]
    for i < cut (d16[0] = 0); from cut on nothing is coded, and the device
    decodes position i as (pad_base - 1) + (i - cut), which is the uid
    vector's tail when the trash id is in it. When it is not, position cut
    decodes to the trash id, which no occurrence maps to: the push's
    n_uniq leaves it out. A data gap above int16 raises."""
    uids = np.asarray(uids, np.int32)
    cut = int(np.searchsorted(uids, pad_base - 1))
    d = np.zeros(uids.shape[0], np.int32)
    if cut:
        d[1:cut] = np.diff(uids[:cut])
    if d.size and int(d.max(initial=0)) > np.iinfo(np.int16).max:
        raise ValueError(
            "wire_delta_ids: inter-uid gap %d exceeds int16 — this pass "
            "shape is too sparse for the delta wire (unset the flag)"
            % int(d.max()))
    base = uids[0] if cut else np.int32(0)
    return np.int32(base), d.astype(np.int16), np.int32(cut)


def pos_for_rebuild(uids: np.ndarray, capacity: int) -> np.ndarray:
    """[capacity] int32 position map of the rebuild write: pos[r] is the
    index into the push's new rows of slab row r where a uid names it, -1
    elsewhere (reference pass_table.py:305-315). The port's uids below
    capacity are exactly its push's n_uniq (the trash row among them when
    the batch has padding), so the map covers the rows 'scatter' writes."""
    pos = np.full(capacity, -1, np.int32)
    m = uids < capacity
    pos[uids[m]] = np.arange(uids.shape[0], dtype=np.int32)[m]
    return pos


def uniq_count(uids: np.ndarray, capacity: int) -> int:
    """The push's n_uniq of a sorted uid vector: its uids below the slab's
    capacity (the padding tail starts at capacity)."""
    return int(np.searchsorted(uids, capacity))


class PassTable:
    """Single-device sparse table with the BoxPS pass lifecycle."""

    def __init__(self, table: TableConfig, seed: int = 0,
                 device: DeviceLike = None,
                 flags: Optional[PassFlags] = None,
                 store=None, embed_dtype: str = "float32") -> None:
        """``embed_dtype``: the device slab's storage (DtypeFlags.
        slab_embed_dtype), 'float32' or 'bfloat16'."""
        self.device = resolve_device(device)
        self.config = table
        self.flags = flags or PassFlags()
        # the table's rule and expand block (reference pass_table.py:
        # 322-327); the rows of every width take the same lifecycle
        self.layout = ValueLayout(table.embedx_dim,
                                  table.optimizer.optimizer,
                                  expand_dim=table.expand_embed_dim,
                                  embed_dtype=embed_dtype)
        self.push_layout = PushLayout.of(self.layout)
        self.store = (store if store is not None
                      else make_host_store(self.layout, table, seed,
                                           self.flags.host_store_stripes))
        self.store_lock = make_lock("PassTable.store_lock")
        # the share of the SSD budget this table's store holds: 1, or the
        # sharded table's ranks on a host (check_need_limit_mem)
        self.budget_split = 1
        self.capacity = int(table.pass_capacity)
        self._feed_keys: List[np.ndarray] = []
        self._pass_keys: Optional[np.ndarray] = None
        self._slab: Optional[torch.Tensor] = None
        # the pass's route index and the key array it maps; the ended
        # pass's index, kept for the next begin_pass's diff
        self._route_index: Optional[int] = None
        self._route_for: Optional[np.ndarray] = None
        self._prev_route: Optional[int] = None
        self._in_feed_pass = False
        self._in_pass = False
        # the incremental lifecycle: the keys of the resident slab's rows
        # [0, len), the pass's touched-row mirror (bool [capacity]) and
        # whether any id marked it, a mid-pass invalidation, and the rows
        # the promote prefetcher staged for the next begin_pass
        self._resident_keys: Optional[np.ndarray] = None
        self._touched: Optional[np.ndarray] = None
        self._touch_seen = False
        self._residency_poisoned = False
        self._staged: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._test_mode = False
        self.counters: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
        # host-clock seconds in begin_pass and end_pass (the reference's
        # build and end timers; begin_pass returns before the device work
        # it queues has run), and of end_pass the SSD tier's spill
        self.seconds: Dict[str, float] = {"begin_pass": 0.0, "end_pass": 0.0,
                                          "spill": 0.0}
        # the touched-row journal (train/journal.py), when one is attached
        self._journal = None
        # the standalone push's seeds (``push``): a host int a call from
        # the table's own generator, as the trainer draws its steps'
        # (``seed_fn`` may be replaced, as the trainer's)
        self._seed_gen = torch.Generator().manual_seed(seed)
        self.seed_fn: Callable[[], int] = self._draw_seed

    # --------------------------------------------------------------- journal
    def attach_journal(self, journal) -> None:
        """Attach a train.journal.TouchedRowJournal (None detaches): the
        pass records its store rows, the day boundary its events, and the
        store's SSD-tier moves (spill, fault-in) their MOVE records
        through the sink installed here."""
        self._journal = journal
        # a store without a sink (the PS-backed one: its tier is the
        # server's) journals no moves, and its spills taint instead
        set_sink = getattr(self.store, "set_journal_sink", None)
        if set_sink is not None:
            set_sink(None if journal is None else journal.append_move)

    def _journal_rows(self, keys: np.ndarray, rows: np.ndarray) -> None:
        if self._journal is not None and not self._test_mode:
            self._journal.append_rows(keys, rows)

    def _host_rows(self, dev_rows: torch.Tensor) -> np.ndarray:
        """Slab rows as host f32 rows: one copy to the host (the transfer
        ledger's write-back), then the numpy codec's decoding under
        bf16."""
        host = dev_rows.cpu().numpy()
        account_d2h(host.nbytes, "writeback")
        return decode_slab_rows_np(host, self.layout)

    def _journal_event(self, code: int) -> None:
        if self._journal is not None:
            self._journal.append_event(code)

    # ------------------------------------------------------- pass lifecycle
    def begin_feed_pass(self) -> None:
        if self._in_feed_pass:
            raise RuntimeError("feed pass already open")
        self._feed_keys = []
        self._in_feed_pass = True

    def add_keys(self, keys: np.ndarray) -> None:
        if not self._in_feed_pass:
            raise RuntimeError("add_keys outside feed pass")
        self._feed_keys.append(np.asarray(keys, dtype=np.uint64))

    def end_feed_pass(self) -> None:
        """Freeze the pass key set; ids are positions in its sorted-unique
        array, which the pass's route index maps. The outgoing index is
        kept when it maps the resident key set (the identity check on the
        array end_pass made resident)."""
        if not self._in_feed_pass:
            raise RuntimeError("end_feed_pass without begin_feed_pass")
        if self._feed_keys:
            self._pass_keys = np.unique(np.concatenate(self._feed_keys))
        else:
            self._pass_keys = np.empty(0, dtype=np.uint64)
        if self._pass_keys.size > self.capacity - 1:
            raise RuntimeError(
                "pass working set %d exceeds table pass_capacity %d"
                % (self._pass_keys.size, self.capacity))
        self._drop_prev_route()
        if (self._resident_keys is not None
                and self._route_for is self._resident_keys):
            self._prev_route, self._route_index = self._route_index, None
        self._drop_route_index()
        self._route_index = host_lib.create_route_index(self._pass_keys)
        self._route_for = self._pass_keys
        self._feed_keys = []
        self._in_feed_pass = False

    def _drop_route_index(self) -> None:
        host_lib.destroy_route_index(self._route_index)
        self._route_index = None
        self._route_for = None

    def _drop_prev_route(self) -> None:
        host_lib.destroy_route_index(self._prev_route)
        self._prev_route = None

    def __del__(self) -> None:
        try:
            self._drop_route_index()
            self._drop_prev_route()
        except Exception:  # an interpreter that is shutting down
            pass

    @property
    def route_index(self) -> Optional[int]:
        """The native route index of the pass key set (an opaque handle),
        None before the first end_feed_pass."""
        return self._route_index

    def _resident_pos(self, keys: np.ndarray) -> np.ndarray:
        """[n] int32 resident slab row of each key, -1 where not resident:
        one probe a key of the ended pass's route index. Where that index
        was not kept (a second feed pass before this begin_pass), an index
        of the resident keys is built here."""
        if self._resident_keys is None:
            return np.full(keys.size, -1, np.int32)
        if self._prev_route is None:
            self._prev_route = host_lib.create_route_index(
                self._resident_keys)
        return host_lib.route_lookup_serve(self._prev_route, keys, -1)

    def _promote_missing_rows(self, missing_keys: np.ndarray) -> np.ndarray:
        """Host rows of the sorted keys a delta promote brings in: the rows
        the prefetcher staged first, the rest by one sorted
        lookup_or_create, which creates new keys in the full path's order.
        In test mode: all of them by store.lookup, which creates
        nothing."""
        rows = np.empty((missing_keys.size, self.layout.width), np.float32)
        need = np.ones(missing_keys.size, bool)
        if self._staged is not None and not self._test_mode:
            skeys, srows = self._staged
            pos, hit = sorted_member(skeys, missing_keys)
            rows[hit] = srows[pos[hit]]
            need = ~hit
            self._count("pass_rows_promote_prefetched", int(hit.sum()))
        if need.any():
            with self.store_lock:
                rows[need] = self._store_rows(missing_keys[need])
        return rows

    def _store_rows(self, keys: np.ndarray) -> np.ndarray:
        """The store's rows of sorted ``keys``: created where missing, or in
        test mode zero rows where missing. The caller holds store_lock."""
        if self._test_mode:
            return self.store.lookup(keys)
        return self.store.lookup_or_create(keys)

    def begin_pass(self) -> None:
        """Make the pass slab. Incremental (a slab is resident): the delta
        promote. Otherwise: host rows of every pass key (created on first
        sight; in test mode zero rows where the store lacks the key) in
        [0, n), zeros after, one host-to-device copy."""
        if self._in_pass:
            raise RuntimeError("pass already open")
        if self._pass_keys is None:
            raise RuntimeError("begin_pass before feed pass completed")
        t0 = time.perf_counter()
        keys = self._pass_keys
        n = keys.size
        gauge_set("pass_rows", n)
        if self.flags.incremental_pass and self._resident_keys is not None:
            old_pos = self._resident_pos(keys)
            hit = old_pos >= 0
            new_rows = self._promote_missing_rows(keys[~hit])
            # lookup_or_create may have created these rows just now, and
            # the write-back need not revisit them; store-present rows
            # record an upsert of equal bits
            self._journal_rows(keys[~hit], new_rows)
            # the resident slab is dropped here: two slabs live only while
            # the promote runs
            self._slab = delta_promote(self._slab, old_pos,
                                       slab_rows_np(new_rows, self.layout))
            self._count("pass_rows_promote_hit", int(hit.sum()))
            self._count("pass_rows_promote_new", int(n - hit.sum()))
        else:
            slab = torch.zeros((self.capacity, self.layout.device_width),
                               dtype=self.layout.device_dtype,
                               device=self.device)
            if n:
                with self.store_lock:
                    rows = self._store_rows(keys)
                self._journal_rows(keys, rows)
                host = slab_rows_np(rows, self.layout)
                account_h2d(host.nbytes, "build")
                slab[:n].copy_(torch.from_numpy(host))
            self._slab = slab
        self._drop_prev_route()
        self._resident_keys = None
        self._touch_seen = False
        self._residency_poisoned = False
        if not self._test_mode:
            self._staged = None
            if self.flags.incremental_pass:
                self._touched = np.zeros(self.capacity, bool)
        self._in_pass = True
        t1 = time.perf_counter()
        record_span("pass_begin", t0, t1)
        self.seconds["begin_pass"] += t1 - t0

    def _count(self, name: str, n: int) -> None:
        self.counters[name] += n
        stat_add(name, n)

    def note_touched(self, ids: np.ndarray) -> None:
        """Mark the rows of ``ids`` touched this pass (lookup_ids calls it
        for every batch): end_pass writes back only those. No-op outside an
        incremental pass. The chunk driver's staging threads call it at
        once: each writes True into its own rows' bytes of one bool array,
        and nothing reads the array before end_pass, so the writes need no
        lock."""
        if self._touched is not None:
            self._touched[ids] = True
            self._touch_seen = True

    def end_pass(self) -> None:
        """Write the pass's rows back to the host store. Incremental: only
        the touched rows, gathered on the device and copied once (all of
        [0, n) when no id marked the pass, as for a caller that bypassed
        lookup_ids); the slab stays resident unless the residency was
        invalidated during the pass. Otherwise: [0, n), and the slab is
        dropped. Test mode: nothing is written back and the slab is
        dropped."""
        if not self._in_pass:
            raise RuntimeError("end_pass without begin_pass")
        t0 = time.perf_counter()
        keys = self._pass_keys
        n = keys.size
        if n and not self._test_mode:
            if self._touched is not None and self._touch_seen:
                self._touched[self.padding_id] = False
                idx = np.flatnonzero(self._touched[:n])
                if idx.size:
                    ids32 = idx.astype(np.int32)
                    account_h2d(ids32.nbytes, "writeback_ids")
                    ids = torch.from_numpy(ids32).to(self.device)
                    rows = self._host_rows(gather_rows(self._slab, ids))
                    self._journal_rows(keys[idx], rows)
                    with self.store_lock:
                        self.store.write_back(keys[idx], rows)
                self._count("pass_rows_written_back", int(idx.size))
                self._count("pass_rows_writeback_skipped", n - int(idx.size))
            else:
                rows = self._host_rows(self._slab[:n])
                self._journal_rows(keys, rows)
                with self.store_lock:
                    self.store.write_back(keys, rows)
        if (self.flags.incremental_pass and not self._residency_poisoned
                and not self._test_mode):
            self._resident_keys = keys
        else:
            self._slab = None
        self._touched = None
        self._residency_poisoned = False
        self._in_pass = False
        t_spill = time.perf_counter()
        self.check_need_limit_mem()
        t1 = time.perf_counter()
        self.seconds["spill"] += t1 - t_spill
        record_span("pass_end", t0, t1)
        self.seconds["end_pass"] += t1 - t0

    def check_need_limit_mem(self) -> int:
        """The pass-end memory limiter (CheckNeedLimitMem /
        ShrinkResource, box_wrapper.h:627-629): where the host store holds
        more rows than its budget allows, spill the coldest down to it,
        under ``store_lock`` (the promote prefetcher must not see a spill
        half done); a spill drops the residency, so the next begin_pass
        builds in full. The budget is ``TableConfig.ssd_max_resident_rows``
        divided by ``budget_split`` (the sharded table's ranks on a host),
        or whole for a store whose tier is table-wide (``spill_table_wide``:
        the PS-backed one, whose primary spills on the server). A spill by
        a store with no journal sink taints an attached journal (the
        reference's sharded_table.py:1066-1101). No-op without ``ssd_dir``
        and ``ssd_threshold_mb``. Returns the rows spilled."""
        budget = self.config.ssd_max_resident_rows(self.layout.width)
        if budget is None or not hasattr(self.store, "spill"):
            return 0
        if not getattr(self.store, "spill_table_wide", False):
            budget //= max(1, self.budget_split)
        with self.store_lock:
            n = self.store.spill(budget)
        if n:
            self.invalidate_residency()
            if (self._journal is not None
                    and not hasattr(self.store, "set_journal_sink")):
                self._journal.taint(
                    "%d rows spilled on a server-side tier (outside the "
                    "journaled MOVE cadence)" % n)
        return n

    def invalidate_residency(self) -> None:
        """Drop the resident state (slab, its key map, staged rows). Call it
        after any change to the host store outside the pass cadence, or the
        next delta promote would reuse stale rows; the next begin_pass then
        builds in full. During a pass the live slab stays (the pass needs
        it) and end_pass does not make it resident."""
        if self._in_pass:
            self._residency_poisoned = True
        else:
            self._slab = None
        self._resident_keys = None
        self._staged = None
        self._drop_prev_route()

    # ------------------------------------------------- preload promote hooks
    def promote_prefetch_ctx(self) -> Optional[
            Tuple[Callable[[np.ndarray], np.ndarray], object,
                  threading.Lock]]:
        """(known_fn, store, lock) for train.preload.PromotePrefetcher, or
        None when the prefetch cannot run (a flag off, a store without
        lookup_present such as the PS-backed one, or no pass key set to
        diff against). known_fn marks the keys of this pass's set: the set
        that will be resident when the next begin_pass diffs. It reads a
        numpy snapshot of the set, never the route index, which the main
        thread may drop while the prefetcher runs. None in test mode: an
        eval pass leaves nothing resident to diff against."""
        if (not self.flags.incremental_pass
                or not self.flags.preload_promote
                or not hasattr(self.store, "lookup_present")
                or self._test_mode
                or self._pass_keys is None or self._pass_keys.size == 0):
            return None
        snapshot = self._pass_keys

        def known(keys: np.ndarray) -> np.ndarray:
            return sorted_member(snapshot, keys)[1]

        return known, self.store, self.store_lock

    def accept_staged_rows(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Keep the prefetcher's (sorted unique keys, rows) for the next
        begin_pass."""
        if keys.size:
            self._staged = (keys, rows)

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self._seed_gen))

    # ---------------------------------------------------------- pull / push
    def pull(self, ids: torch.Tensor) -> torch.Tensor:
        """PullSparseGPU (reference pass_table.py:806-814): the pull view
        [K, 3+D] (show, click, embed_w, embedx) of the slab's rows ``ids``
        (int32 on the table's device; padding ids read the trash row),
        through gather_slab_rows: the gather_rows kernel on the card, its
        decoding form on the bf16 slab."""
        if not self._in_pass:
            raise RuntimeError("pull outside pass")
        return pull_view_from_rows(gather_slab_rows(self.slab, ids,
                                                    self.layout), self.layout)

    def push(self, ids: torch.Tensor, grads: torch.Tensor) -> None:
        """PushSparseGPU (reference pass_table.py:816-830): ``grads`` [K,
        push width] of the occurrences ``ids`` [K] merged by id and applied
        through the table's in-table rule, IN PLACE: push_sparse_dedup
        (the fused push_adagrad kernel on the card) with a seed from
        ``seed_fn``. Padding occurrences address the trash row and must
        carry zero grads. The rows are marked touched first; a test-mode
        pass pushes nothing."""
        if not self._in_pass:
            raise RuntimeError("push outside pass")
        if self._test_mode:
            return
        self.note_touched(ids.cpu().numpy())
        n_valid = int((ids != self.padding_id).sum())
        push_sparse_dedup(self.slab, ids, n_valid, grads, self.seed_fn(),
                          self.layout, self.config.optimizer)

    def set_test_mode(self, test: bool) -> None:
        """SetTestMode (box_wrapper.cc:183): eval passes, which create no
        feature and write nothing back."""
        self._test_mode = bool(test)

    @property
    def test_mode(self) -> bool:
        return self._test_mode

    # ------------------------------------------------------------- id space
    @property
    def pass_size(self) -> int:
        return 0 if self._pass_keys is None else int(self._pass_keys.size)

    @property
    def pass_keys(self) -> Optional[np.ndarray]:
        return self._pass_keys

    @property
    def padding_id(self) -> int:
        return self.capacity - 1

    def lookup_ids(self, keys: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Feasign keys -> int32 pass-local ids by the route index;
        positions where ``valid`` is False map to the trash row.
        Unregistered keys raise KeyError. Marks the ids' rows touched."""
        if self._pass_keys is None:
            raise RuntimeError("no active pass key set")
        ids = host_lib.route_lookup(self._route_index, keys, valid,
                                    self.padding_id)
        self.note_touched(ids)
        return ids

    def dedup_for_push(self, ids: np.ndarray):
        """dedup_ids with padding uids starting at this table's capacity."""
        return dedup_ids(ids, self.capacity)

    def uids_for_push(self, ids: np.ndarray) -> np.ndarray:
        """dedup_uids_sorted with padding uids starting at this table's
        capacity: the uid wire's product."""
        return dedup_uids_sorted(ids, self.capacity)

    def pos_for_rebuild(self, uids: np.ndarray) -> np.ndarray:
        """The rebuild write's [capacity] position map of ``uids``."""
        return pos_for_rebuild(uids, self.capacity)

    @property
    def resident_slab(self) -> Optional[torch.Tensor]:
        """The slab on the device, in a pass or kept after it under the
        incremental lifecycle; None where there is none."""
        return self._slab

    @property
    def slab(self) -> torch.Tensor:
        """The live pass slab; train steps update it in place."""
        if self._slab is None:
            raise RuntimeError("no slab outside begin_pass/end_pass")
        return self._slab

    # ------------------------------------------------------------ lifecycle
    def shrink_table(self) -> int:
        """ShrinkTable (box_wrapper.h:627): decay and delete on the host
        store. Returns the rows deleted."""
        self.invalidate_residency()
        with self.store_lock:
            n = self.store.shrink()
        self._journal_event(EV_SHRINK)
        return n

    def end_day(self, age: bool = True) -> int:
        """The day boundary: age every feature's unseen_days (shrink's
        delete_after_unseen_days rule reads it; the SSD tier's rows by its
        day clock), then shrink. Returns the rows deleted. age=False where
        CheckpointManager.save_base already aged the resident rows at this
        boundary (aging twice a day would halve every feature's lifetime):
        then only the tier's day clock ticks, since the save's rewrite
        touches resident rows only. Each event is journaled inside the
        store_lock hold, so that a prefetcher's fault-in journals before
        or after it as it happened."""
        self.invalidate_residency()
        with self.store_lock:
            if age:
                self.store.age_unseen_days()
                self._journal_event(EV_AGE_DAYS)
            else:
                self.store.tick_spill_age()
                self._journal_event(EV_TICK_SPILL_AGE)
        return self.shrink_table()

    def save(self, path: str, flags: Optional[CkptFlags] = None) -> None:
        """The host store's checkpoint at ``path`` (store.save)."""
        with self.store_lock:
            self.store.save(path, flags)

    def load(self, path: str, threads: int = 0) -> None:
        """Replace the host store's rows with the checkpoint at ``path``.
        An attached journal's epoch is tainted: CheckpointManager.load_base
        is the load that re-anchors it."""
        self.invalidate_residency()
        if self._journal is not None:
            self._journal.taint("store loaded outside the checkpoint plane")
        with self.store_lock:
            self.store.load(path, threads)

    def load_ssd_to_mem(self) -> int:
        """LoadSSD2Mem (box_wrapper.cc:1319): fault every row of the SSD
        tier back into the host store (with its missed days applied), the
        warm-up after a load before the day's first pass. Drops the
        residency. Returns the rows moved."""
        self.invalidate_residency()
        if not hasattr(self.store, "load_spilled"):
            return 0
        with self.store_lock:
            return self.store.load_spilled()
