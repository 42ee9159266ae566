"""The SSD spill tier: columnar block files and a sorted probe index.

Counterpart of paddlebox_tpu/embedding/ssd_tier.py (SSDSparseTable's
shape), with the same arithmetic, so a store that spills in the port and
one that spills in the reference hold the same bits:

  * blocks are the checkpoint plane's columnar part files
    (``ckpt_store.write_part`` / ``map_part``): a fault-in is one mmap and
    one fancy-index a touched block;
  * the index over spilled keys is three parallel numpy arrays (sorted
    keys, block id, offset in the block) probed with ``searchsorted``;
  * per-block liveness drives compaction: a block of at least
    ``_COMPACT_MIN_ROWS`` rows less than half alive is rewritten with its
    live rows only (the same raw bytes and spill epoch), an all-dead block
    is unlinked;
  * aging is block-granular and lazy: every row of a block shares one
    spill epoch, and the days it slept apply when it is read, one SPAN at
    a time, split at every rebase boundary (a full save's journal anchor):
    in f32 ``decay**(a+b)`` is not ``decay**a * decay**b``, and a replayed
    store crosses the anchor mid-sleep.

Memory mode (``dirpath=None``) keeps the blocks as arrays in memory: the
journal's replay runs the live store's spill and fault-in cadence on a
scratch store without touching the live ``ssd_dir``.

No lock: the owning store's caller (the pass table's ``store_lock``)
serializes every call. Telemetry under the reference's names: the stats
ssd_keys_spilled, ssd_keys_promoted, ssd_keys_peeked, the histogram
ssd_promote_us and the gauges ssd_tier_live_keys, _index_entries,
_dead_entries and _blocks, all from disk-mode tiers only (a replay's
scratch tier stays silent).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch.embedding.accessor import CLICK, SHOW, UNSEEN_DAYS
from paddlebox_tpu_torch.embedding.ckpt_store import map_part, write_part
from paddlebox_tpu_torch.utils.journal_format import (  # noqa: F401
    MV_FAULT_IN, MV_SPILL)
from paddlebox_tpu_torch.utils.stats import gauge_set, hist_observe, stat_add


def apply_missed_days(vals: np.ndarray, missed, decay_rate: float) -> None:
    """IN PLACE: add the day boundaries rows slept through on disk and
    the show/click time decay those boundaries would have applied (the
    ONE aging/decay rule — assumes the reference's one-shrink-per-day
    cadence). vals: [N, width] (or a single row); missed: scalar or
    [N]."""
    vals = np.atleast_2d(vals)
    missed = np.asarray(missed, np.float32)
    vals[:, UNSEEN_DAYS] += missed
    decay = np.asarray(decay_rate, np.float32) ** missed
    vals[:, SHOW] *= decay
    vals[:, CLICK] *= decay


def sweep_stale_blocks(dirpath: str) -> int:
    """Construction-time GC of a reused ``ssd_dir``: remove spill block
    files (and their torn ``.tmp`` strays) whose embedded creator pid no
    longer runs — a restarted process can never fault their rows back
    in (its spill index died with it), so they are pure leaked bytes
    (the journal's ``seg-*`` construction sweep reasons alike). Block
    names carry ``<prefix>_<pidhex>_<storehex>_<seq>``; legacy ``.npy``
    blocks from the pre-tier layout are swept by the same rule."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return 0
    removed = 0
    for name in names:
        if not name.startswith(("spill_", "nspill_")):
            continue
        if not name.endswith((".part", ".npy", ".tmp")):
            continue
        parts = name.split("_")
        try:
            pid = int(parts[1], 16)
        except (IndexError, ValueError):
            continue
        if pid == os.getpid() or os.path.exists("/proc/%d" % pid):
            continue
        try:
            os.remove(os.path.join(dirpath, name))
            removed += 1
        except OSError:
            pass  # concurrent sibling-shard sweep got it first
    return removed


class _Block:
    """One spill block: the on-disk (or in-RAM) raw rows plus the
    host-resident metadata the tier keeps per block — key column, live
    mask, the shared spill epoch, and the raw unseen-days column at
    spill time (the shrink sweep's input, so sweeping never pages the
    row bytes in)."""

    __slots__ = ("path", "vals", "keys", "live", "n_live", "e0",
                 "unseen0")

    def __init__(self, path: Optional[str], vals: Optional[np.ndarray],
                 keys: np.ndarray, e0: int,
                 unseen0: np.ndarray) -> None:
        self.path = path          # disk mode: part file path
        self.vals = vals          # memory mode: [n, width] f32
        self.keys = keys          # [n] uint64, block row order
        self.live = np.ones(keys.size, bool)
        self.n_live = int(keys.size)
        self.e0 = e0
        self.unseen0 = unseen0    # [n] f32 raw UNSEEN_DAYS at spill

    def values(self) -> np.ndarray:
        if self.vals is not None:
            return self.vals
        _keys, vals = map_part(self.path)
        return vals


# a block earns a live-rows-only rewrite once it is big enough to
# matter and less than half alive (every rewrite halves at most, so the
# total rewrite bytes per block are bounded by ~2x its original size)
_COMPACT_MIN_ROWS = 4096


class SpillTier:
    """Columnar spill blocks + sorted probe index + block-lazy aging.

    All keys are uint64 arrays; values are raw [n, width] f32 rows in
    the owner's ValueLayout. ``read``/``snapshot`` return EFFECTIVE
    values (missed-day spans applied to a copy); the disk bytes are
    immutable from spill to discard."""

    def __init__(self, width: int, dirpath: Optional[str], tag: str,
                 decay_rate: float) -> None:
        self.width = int(width)
        self.dir = dirpath
        self.tag = tag
        self._decay = float(decay_rate)
        self._seq = 0
        self._next_bid = 0
        self.epoch = 0
        self._rebases: List[int] = []
        self._blocks: Dict[int, _Block] = {}
        self._idx_keys = np.empty(0, np.uint64)
        self._idx_bid = np.empty(0, np.int32)
        self._idx_off = np.empty(0, np.int64)
        self._idx_live = np.empty(0, bool)
        self._idx_dead = 0
        self._n_live = 0
        if dirpath:
            sweep_stale_blocks(dirpath)

    # ------------------------------------------------------------- clocks
    def __len__(self) -> int:
        return self._n_live

    def tick(self) -> None:
        """One day boundary for the sleeping rows (lazy: applied as
        missed-day spans at read/snapshot)."""
        self.epoch += 1

    def rebase(self) -> None:
        """Pin a span boundary at the current epoch — called exactly
        when a full save anchors the journal (the snapshot stored the
        effective values up to here, and replay re-applies decay only
        from here): later reads must apply pre/post-anchor decay as two
        sequential f32 spans or they diverge from the replayed store."""
        if self._rebases and self._rebases[-1] == self.epoch:
            return
        self._rebases.append(self.epoch)

    def _span_lengths(self, e0: int) -> List[int]:
        bounds = [e0] + [r for r in self._rebases if r > e0] + [self.epoch]
        return [b - a for a, b in zip(bounds, bounds[1:]) if b > a]

    def _apply_spans(self, vals: np.ndarray, e0: int) -> None:
        for s in self._span_lengths(e0):
            apply_missed_days(vals, np.float32(s), self._decay)

    # -------------------------------------------------------------- index
    def _probe(self, keys: np.ndarray) -> np.ndarray:
        """Index positions of ``keys`` (-1 where absent or dead)."""
        pos = np.full(keys.size, -1, np.int64)
        if self._idx_keys.size == 0 or keys.size == 0:
            return pos
        p = np.searchsorted(self._idx_keys, keys)
        pc = np.minimum(p, self._idx_keys.size - 1)
        hit = (self._idx_keys[pc] == keys) & self._idx_live[pc]
        pos[hit] = pc[hit]
        return pos

    def contains(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        return self._probe(keys) >= 0

    def live_keys(self) -> np.ndarray:
        """All live spilled keys (block order — callers treat the tier
        as a set)."""
        if not self._blocks:
            return np.empty(0, np.uint64)
        return np.concatenate([b.keys[b.live]
                               for b in self._blocks.values()])

    def block_files(self) -> List[str]:
        return [b.path for b in self._blocks.values()
                if b.path is not None]

    # -------------------------------------------------------------- spill
    def spill_rows(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Write one block of raw rows and index it. Keys must not be
        live in the tier already (a key is either resident or spilled,
        never both — the owners maintain it); a DEAD index entry for a
        re-spilled key is purged here."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        if keys.size == 0:
            return
        order = np.argsort(keys, kind="stable")
        keys, values = keys[order], values[order]
        unseen0 = values[:, UNSEEN_DAYS].copy()
        bid = self._next_bid
        self._next_bid += 1
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"spill_{self.tag}_{self._seq:08d}.part")
            self._seq += 1
            # fsync=False: spill blocks are a cache of DRAM state, not
            # durability — a crash loses the process's whole spill index
            # anyway (the construction sweep reclaims the bytes)
            write_part(path, keys, values, fsync=False)
            blk = _Block(path, None, keys, self.epoch, unseen0)
        else:
            blk = _Block(None, values.copy(), keys, self.epoch, unseen0)
        self._blocks[bid] = blk
        self._purge_dead_entries(keys)
        pos = np.searchsorted(self._idx_keys, keys)
        self._idx_keys = np.insert(self._idx_keys, pos, keys)
        self._idx_bid = np.insert(self._idx_bid, pos,
                                  np.int32(bid)).astype(np.int32)
        self._idx_off = np.insert(self._idx_off, pos,
                                  np.arange(keys.size, dtype=np.int64))
        self._idx_live = np.insert(self._idx_live, pos, True)
        self._n_live += int(keys.size)
        if self.dir:
            stat_add("ssd_keys_spilled", int(keys.size))
            self._occupancy_gauges()

    def _occupancy_gauges(self) -> None:
        """Host-index occupancy of the LIVE (on-disk) tier into the
        stat registry. Memory-mode tiers (replay scratch,
        spill-less tables) stay silent — a journal replay must never
        overwrite the live process's tier gauges with scratch state."""
        gauge_set("ssd_tier_live_keys", float(self._n_live))
        gauge_set("ssd_tier_index_entries", float(self._idx_keys.size))
        gauge_set("ssd_tier_dead_entries", float(self._idx_dead))
        gauge_set("ssd_tier_blocks", float(len(self._blocks)))

    def _purge_dead_entries(self, keys: np.ndarray) -> None:
        """Hard-remove dead index entries for keys about to be
        re-inserted (the index invariant: at most one entry per key, so
        probes never have to scan duplicate runs)."""
        if self._idx_keys.size == 0:
            return
        p = np.searchsorted(self._idx_keys, keys)
        pc = np.minimum(p, self._idx_keys.size - 1)
        dup = self._idx_keys[pc] == keys
        if not dup.any():
            return
        if self._idx_live[pc[dup]].any():
            raise AssertionError(
                "spill_rows: key already live in the SSD tier")
        keep = np.ones(self._idx_keys.size, bool)
        keep[pc[dup]] = False
        self._compact_index(keep)

    # --------------------------------------------------------------- read
    def read(self, keys: np.ndarray, pop: bool) -> np.ndarray:
        """Effective values for ``keys`` (ALL must be live in the tier),
        grouped by block: one mmap + one fancy-index per touched block.
        pop=True consumes the entries (fault-in); pop=False peeks
        (test-mode reads, snapshots)."""
        keys = np.asarray(keys, np.uint64)
        out = np.empty((keys.size, self.width), np.float32)
        if keys.size == 0:
            return out
        t0 = time.perf_counter() if self.dir else 0.0
        pos = self._probe(keys)
        if (pos < 0).any():
            raise KeyError("read of a key not live in the SSD tier")
        bids = self._idx_bid[pos]
        offs = self._idx_off[pos]
        for bid in np.unique(bids):
            m = bids == bid
            blk = self._blocks[int(bid)]
            rows = np.array(blk.values()[offs[m]])
            self._apply_spans(rows, blk.e0)
            out[m] = rows
        if pop:
            self._kill(pos, bids, offs)
        if self.dir:
            # SSD-promote rung of the tier hit ladder: how
            # many keys crossed up, and how long one batched promote
            # took — memory-mode (replay scratch) stays silent
            if pop:
                stat_add("ssd_keys_promoted", int(keys.size))
                hist_observe("ssd_promote_us",
                             (time.perf_counter() - t0) * 1e6)
                self._occupancy_gauges()
            else:
                stat_add("ssd_keys_peeked", int(keys.size))
        return out

    def discard(self, keys: np.ndarray) -> int:
        """Tombstone any live entries for ``keys`` without reading them
        (the assign path: a stale spill entry must not resurrect over
        the assigned value). Returns entries killed."""
        keys = np.asarray(keys, np.uint64)
        pos = self._probe(keys)
        pos = pos[pos >= 0]
        if pos.size == 0:
            return 0
        self._kill(pos, self._idx_bid[pos], self._idx_off[pos])
        return int(pos.size)

    def _kill(self, pos: np.ndarray, bids: np.ndarray,
              offs: np.ndarray) -> None:
        self._idx_live[pos] = False
        self._idx_dead += int(pos.size)
        self._n_live -= int(pos.size)
        for bid in np.unique(bids):
            blk = self._blocks[int(bid)]
            m = bids == bid
            blk.live[offs[m]] = False
            blk.n_live -= int(m.sum())
            self._retire_or_compact(int(bid))
        if self._idx_dead > max(65536, self._idx_keys.size - self._idx_dead):
            self._compact_index(self._idx_live.copy())

    def _compact_index(self, keep: np.ndarray) -> None:
        self._idx_keys = self._idx_keys[keep]
        self._idx_bid = self._idx_bid[keep]
        self._idx_off = self._idx_off[keep]
        self._idx_live = self._idx_live[keep]
        self._idx_dead = int((~self._idx_live).sum())

    def _retire_or_compact(self, bid: int) -> None:
        blk = self._blocks[bid]
        if blk.n_live == 0:
            del self._blocks[bid]
            if blk.path is not None:
                try:
                    os.remove(blk.path)
                except OSError:
                    pass  # already swept (load_blob clear / stale sweep)
            return
        total = blk.keys.size
        if total >= _COMPACT_MIN_ROWS and blk.n_live * 2 < total:
            self._rewrite_block(bid)

    def _rewrite_block(self, bid: int) -> None:
        """Live-rows-only rewrite, preserving RAW bytes and the spill
        epoch (merging blocks with different epochs — or materializing
        the aging — would break span parity with journal replay)."""
        blk = self._blocks[bid]
        lo = np.nonzero(blk.live)[0]
        keys_l = blk.keys[lo]
        rows = np.array(blk.values()[lo])
        old_path = blk.path
        if old_path is not None:
            new_path = os.path.join(
                self.dir, f"spill_{self.tag}_{self._seq:08d}.part")
            self._seq += 1
            write_part(new_path, keys_l, rows, fsync=False)
            blk.path = new_path
            blk.vals = None
        else:
            blk.vals = rows
        blk.keys = keys_l
        blk.unseen0 = blk.unseen0[lo]
        blk.live = np.ones(keys_l.size, bool)
        blk.n_live = int(keys_l.size)
        pos = self._probe(keys_l)
        self._idx_off[pos] = np.arange(keys_l.size, dtype=np.int64)
        if old_path is not None:
            try:
                os.remove(old_path)
            except OSError:
                pass  # already swept (load_blob clear / stale sweep)

    # ----------------------------------------------------------- lifecycle
    def snapshot(self):
        """(keys, EFFECTIVE values) of every live row, without consuming
        anything — the checkpoint read (missed-day spans applied to the
        returned copy; the tier keeps its raw bytes and epochs)."""
        if not self._blocks:
            return (np.empty(0, np.uint64),
                    np.empty((0, self.width), np.float32))
        keys_parts, vals_parts = [], []
        for blk in self._blocks.values():
            lo = np.nonzero(blk.live)[0]
            if lo.size == 0:
                continue
            rows = np.array(blk.values()[lo])
            self._apply_spans(rows, blk.e0)
            keys_parts.append(blk.keys[lo])
            vals_parts.append(rows)
        if not keys_parts:
            return (np.empty(0, np.uint64),
                    np.empty((0, self.width), np.float32))
        return np.concatenate(keys_parts), np.vstack(vals_parts)

    def sweep(self, delete_after_days: float) -> int:
        """Delete spilled rows past the unseen-days lifetime WITHOUT
        faulting them in (the coldest rows — exactly the deletion
        candidates — must not be immortal). Dead iff raw unseen at
        spill + epochs slept > lifetime — integer-exact, no decay math,
        and read entirely from the host-resident block metadata."""
        dead_total = 0
        for bid in list(self._blocks):
            blk = self._blocks[bid]
            slept = self.epoch - blk.e0
            lo = np.nonzero(blk.live)[0]
            dead = lo[blk.unseen0[lo] + slept > delete_after_days]
            if dead.size == 0:
                continue
            pos = self._probe(blk.keys[dead])
            self._kill(pos, self._idx_bid[pos], self._idx_off[pos])
            dead_total += int(dead.size)
        return dead_total

    def clear(self) -> None:
        """Drop every block and index entry (store load: stale spill
        state must not resurrect over restored rows). Disk blocks are
        unlinked."""
        for blk in self._blocks.values():
            if blk.path is not None:
                try:
                    os.remove(blk.path)
                except OSError:
                    pass  # already swept
        self._blocks.clear()
        self._idx_keys = np.empty(0, np.uint64)
        self._idx_bid = np.empty(0, np.int32)
        self._idx_off = np.empty(0, np.int64)
        self._idx_live = np.empty(0, bool)
        self._idx_dead = 0
        self._n_live = 0
