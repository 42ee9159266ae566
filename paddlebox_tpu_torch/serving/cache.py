"""The hot-key row cache in front of the mmap view stack
(paddlebox_tpu/serving/cache.py, the same admission, eviction and
counters).

Serving keys are zipf-hot, so a small resident array of the hottest rows
answers most probes before they touch the mapped rows. Both rules resist
scans:

  * admission is gated by frequency: a missed key enters only after
    ``admit`` misses within the sketch's window, so one sweep over cold
    keys cannot flush the hot set; the sketch is a dict aged by halving
    once it outgrows its cap;
  * eviction is CLOCK: a hit sets the slot's reference bit, and the hand
    clears bits until it finds an unreferenced slot to evict.

An entry is valid for one view generation. The view manager bumps the
epoch at every swap (``clear``); ``get_many(epoch=)`` reports all-miss
for a stale epoch, so one response never mixes two generations, and
``admit_many(epoch=)`` drops rows read under a stale one.

The counters serving_cache_hit, _miss, _evict and _admit and the gauge
serving_cache_fill go to the process's StatRegistry.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add


class HotKeyCache:
    """A fixed-capacity key -> row cache, shared by the pull pool's
    threads under ``_lock``; its [capacity, dim] rows are all the memory
    it holds."""

    def __init__(self, capacity: int, dim: int, admit: int = 2,
                 sketch_cap: Optional[int] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.admit = max(1, int(admit))
        self._sketch_cap = int(sketch_cap or max(1024, 4 * capacity))
        self._lock = make_lock("HotKeyCache._lock")
        self._slot_of: Dict[int, int] = {}  # guarded-by: _lock
        self._keys = np.zeros(capacity, np.uint64)  # guarded-by: _lock
        self._rows = np.zeros((capacity, dim), np.float32)  # guarded-by: _lock
        self._ref = np.zeros(capacity, bool)  # guarded-by: _lock
        self._used = 0  # guarded-by: _lock
        self._hand = 0  # guarded-by: _lock
        self._freq: Dict[int, int] = {}  # guarded-by: _lock
        self._epoch = 0  # guarded-by: _lock

    def get_many(self, keys: np.ndarray, out: np.ndarray,
                 epoch: Optional[int] = None) -> np.ndarray:
        """Fill the hit rows of ``out`` [K, dim] for [K] uint64 ``keys``;
        returns the miss mask. ``epoch``: the one grabbed with the stack
        the caller reads misses from; a stale one reports all-miss. None
        skips the check."""
        miss = np.ones(keys.size, bool)
        if not keys.size:
            return miss
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                stat_add("serving_cache_miss", int(keys.size))
                return miss
            slot_of = self._slot_of
            hit_idx = []
            hit_slots = []
            for i, k in enumerate(keys.tolist()):
                s = slot_of.get(k)
                if s is not None:
                    hit_idx.append(i)
                    hit_slots.append(s)
            if hit_idx:
                idx = np.asarray(hit_idx, np.int64)
                slots = np.asarray(hit_slots, np.int64)
                out[idx] = self._rows[slots]
                self._ref[slots] = True
                miss[idx] = False
        nhit = keys.size - int(miss.sum())
        if nhit:
            stat_add("serving_cache_hit", nhit)
        if nhit != keys.size:
            stat_add("serving_cache_miss", keys.size - nhit)
        return miss

    def admit_many(self, keys: np.ndarray, rows: np.ndarray,
                   epoch: int) -> int:
        """Offer missed keys and the rows read for them: a key whose
        sketch count reaches ``admit`` is inserted (evicting by CLOCK when
        full), the rest only count. ``epoch``: the generation the rows
        were read under; a stale one drops the whole offer. Returns the
        keys admitted."""
        if not keys.size:
            return 0
        admitted = 0
        evicted = 0
        with self._lock:
            if epoch != self._epoch:
                return 0
            if len(self._freq) > self._sketch_cap:
                self._freq = {k: c >> 1 for k, c in self._freq.items()
                              if c >> 1}
            freq = self._freq
            for i, k in enumerate(keys.tolist()):
                if k in self._slot_of:
                    continue                # another thread admitted it
                c = freq.get(k, 0) + 1
                if c < self.admit:
                    freq[k] = c
                    continue
                freq.pop(k, None)
                if self._used < self.capacity:
                    s = self._used
                    self._used += 1
                else:
                    s = self._clock_evict()
                    self._slot_of.pop(int(self._keys[s]), None)
                    evicted += 1
                self._keys[s] = k
                self._rows[s] = rows[i]
                self._ref[s] = False
                self._slot_of[k] = s
                admitted += 1
            fill = self._used
        if admitted:
            stat_add("serving_cache_admit", admitted)
        if evicted:
            stat_add("serving_cache_evict", evicted)
        gauge_set("serving_cache_fill", fill / self.capacity)
        return admitted

    def _clock_evict(self) -> int:
        """The victim slot: the hand's first unreferenced slot, clearing
        reference bits on the way (at most two sweeps). The caller holds
        ``_lock``."""
        ref = self._ref
        n = self.capacity
        h = self._hand
        for _ in range(2 * n):
            if not ref[h]:
                break
            ref[h] = False
            h = (h + 1) % n
        self._hand = (h + 1) % n
        return h

    def clear(self) -> int:
        """Drop every entry and bump the epoch (a view swap); returns the
        new epoch. The sketch stays: hotness belongs to the traffic."""
        with self._lock:
            self._slot_of.clear()
            self._ref[:] = False
            self._used = 0
            self._hand = 0
            self._epoch += 1
            gauge_set("serving_cache_fill", 0.0)
            return self._epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def __len__(self) -> int:
        with self._lock:
            return len(self._slot_of)
