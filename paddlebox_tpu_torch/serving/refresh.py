"""The generation swap and the refresh watcher
(paddlebox_tpu/serving/refresh.py, the same rules).

The trainer lands views (a delta save every few passes, a base at the
day's end) while the fleet answers traffic. Here:

  * ``ViewManager`` owns the current (generation, stack, cache epoch). A
    lookup grabs all three under one lock and runs on what it grabbed; a
    swap installs a new stack and never touches the old one, so a lookup
    in flight finishes on the view it started on. The old stack's stores
    free their native indexes when the last lookup holding them drops it
    (refcounting: the stack's object graph holds no cycle).
  * ``DeltaRefreshWatcher`` polls the xbox root every
    ``serving_refresh_secs``; a change in the completed views (a delta's
    DONE, a day's base, a new day) or in the journal's overlay builds a
    new stack and swaps it in.
  * ``JournalDeltaSource`` tails the trainer's touched-row journal
    (train/journal.py, utils/journal_format.py) and keeps the served
    columns of every touched row as an overlay, stacked freshest: a
    touched row is served one poll after it is flushed instead of a delta
    save later.

The cache is cleared (its epoch bumped) inside the swap lock, and a miss's
rows are offered with the epoch they were read under, so a lookup racing a
swap never plants an old row in the new generation's cache.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config.flags import ServingFlags
from paddlebox_tpu_torch.obs import log
from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.serving.cache import HotKeyCache
from paddlebox_tpu_torch.serving.store import (MmapViewStack, ShardSpec,
                                               build_stack, discover_days,
                                               discover_xbox_sources,
                                               write_xbox_columnar)
from paddlebox_tpu_torch.utils import journal_format as jf
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add


class ViewManager:
    """The swap point between refresh and traffic. ``swap`` only drops
    the manager's reference to the outgoing stack; its stores close
    through ``__del__`` once no lookup holds them."""

    def __init__(self, stack: MmapViewStack,
                 cache: Optional[HotKeyCache] = None) -> None:
        self._swap_lock = make_lock("ViewManager._swap_lock")
        self.cache = cache
        self._current: Tuple[int, MmapViewStack] = (0, stack)  # guarded-by: _swap_lock
        # the cache's epoch as clear() returns it, never assumed equal to
        # the generation (a cache cleared before the manager was made)
        self._cache_epoch = cache.epoch if cache is not None else 0  # guarded-by: _swap_lock
        gauge_set("serving_view_gen", 0)

    def current(self) -> Tuple[int, MmapViewStack]:
        with self._swap_lock:
            return self._current

    def _grab(self) -> Tuple[int, MmapViewStack, int]:
        """(gen, stack, cache epoch) in one hold of the lock."""
        with self._swap_lock:
            gen, stack = self._current
            return gen, stack, self._cache_epoch

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, int]:
        """[K] uint64 -> ([K, dim] float32, the generation served): the
        cache first, the grabbed stack for its misses, which are then
        offered for admission."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        gen, stack, epoch = self._grab()
        cache = self.cache
        if cache is None:
            return stack.lookup(keys), gen
        out = np.zeros((keys.size, stack.dim), np.float32)
        # a swap since the grab makes the probe all-miss: the rows then
        # come from the grabbed stack alone, one generation a response
        miss = cache.get_many(keys, out, epoch=epoch)
        if miss.any():
            miss_idx = np.nonzero(miss)[0]
            rows = stack.lookup(keys[miss_idx])
            out[miss_idx] = rows
            cache.admit_many(keys[miss_idx], rows, epoch=epoch)
        return out, gen

    def swap(self, stack: MmapViewStack) -> int:
        """Install a new generation; returns it."""
        with self._swap_lock:
            gen, _old = self._current
            self._current = (gen + 1, stack)
            if self.cache is not None:
                self._cache_epoch = self.cache.clear()
            gauge_set("serving_view_gen", gen + 1)
        stat_add("serving_refresh_swaps")
        return gen + 1

    def close(self) -> None:
        """Close the current stack now; the caller has drained every
        lookup (ServingServer.drain)."""
        with self._swap_lock:
            self._current[1].close()


class JournalDeltaSource:
    """The served projection of every row the trainer's journal touched,
    kept per journal directory (one a trainer rank) and compiled on demand
    into one columnar overlay file.

      * ROWS records are absolute: their ``jf.xbox_embed_cols`` columns
        are the row the next delta save would publish.
      * EV_STAT_SAVE_* rewrite header columns only: ignored. MOVE records
        move rows between tiers without changing them: ignored.
      * EV_AGE_DAYS, EV_SHRINK and EV_TAINT change or delete rows out of
        band: the directory's overlay is dropped until rows are touched
        again.
      * a tailer reset (a new epoch at a full base, a lost segment, a
        layout change) drops the directory's rows and rebuilds from what
        the same poll re-read.
      * WATERMARK records raise the directory's watermark (the newest
        source birth trained); the source's watermark is the lowest over
        directories that have one.

    All directories must agree on (embedx_dim, optimizer); a mismatch
    raises at poll."""

    def __init__(self, journal_dirs: Sequence[str],
                 scratch_dir: Optional[str] = None) -> None:
        dirs = [journal_dirs] if isinstance(journal_dirs, str) \
            else list(journal_dirs)
        if not dirs:
            raise ValueError("need at least one journal dir")
        self._tailers = [jf.SegmentTailer(d) for d in dirs]
        self._rows: List[Dict[int, np.ndarray]] = [{} for _ in dirs]
        self._cols: Optional[np.ndarray] = None
        self._proj: Optional[Tuple[int, str]] = None
        # the newest born_max polled a directory, never lowered (a reset
        # drops rows, not what was trained); _wm_low is one float the pull
        # threads read without a lock and only the watcher's thread writes
        self._wm: List[float] = [0.0] * len(dirs)
        self._wm_low = 0.0
        # publish_ts of the oldest watermark polled and not yet compiled
        self._oldest_unapplied: Optional[float] = None
        self._own_scratch = scratch_dir is None
        self._scratch = scratch_dir or tempfile.mkdtemp(
            prefix="pbtpu-journal-feed-")
        self._seq = 0
        self._compiled: Optional[str] = None

    def _set_projection(self, hdr: Dict) -> None:
        proj = (int(hdr["embedx_dim"]), str(hdr["optimizer"]))
        if self._proj is None:
            self._proj = proj
            self._cols = jf.xbox_embed_cols(*proj)
        elif proj != self._proj:
            raise ValueError(
                "journal dirs disagree on the served projection: "
                f"{proj} vs {self._proj} — one serving overlay cannot "
                "compose rows of different layouts")

    def poll(self) -> bool:
        """Tail every directory once; True when the overlay changed."""
        changed = False
        for i, t in enumerate(self._tailers):
            recs, reset = t.poll()
            if reset:
                stat_add("serving_journal_resets")
                if self._rows[i]:
                    changed = True
                self._rows[i] = {}
            rows = self._rows[i]
            for kind, payload in recs:
                if kind == jf.KIND_HEADER:
                    self._set_projection(t.header)
                elif kind == jf.KIND_ROWS:
                    keys, vals = jf.decode_rows_payload(payload)
                    proj = np.ascontiguousarray(vals[:, self._cols])
                    rows.update(zip(keys.tolist(), proj))
                    changed = True
                elif kind == jf.KIND_EVENT:
                    (code,) = struct.unpack_from("<I", payload)
                    if code in (jf.EV_AGE_DAYS, jf.EV_SHRINK,
                                jf.EV_TAINT):
                        if rows:
                            changed = True
                        self._rows[i] = rows = {}
                elif kind == jf.KIND_WATERMARK:
                    _born_min, born_max, pub_ts, trace = \
                        jf.unpack_watermark(payload)
                    if born_max > self._wm[i]:
                        self._wm[i] = born_max
                    if self._oldest_unapplied is None:
                        self._oldest_unapplied = pub_ts
                    if trace:
                        # the publisher's trace ends at this tailer
                        now_pc = time.perf_counter()
                        record_span("journal_watermark_apply",
                                    now_pc, now_pc, trace=trace)
        stat_add("serving_journal_polls")
        wms = [w for w in self._wm if w > 0.0]
        if wms:
            self._wm_low = min(wms)
            gauge_set("serving_watermark_ts", self._wm_low)
            gauge_set("serving_watermark_age_secs",
                      max(0.0, time.time() - self._wm_low))
        gauge_set("serving_unapplied_watermark_age_secs",
                  max(0.0, time.time() - self._oldest_unapplied)
                  if self._oldest_unapplied else 0.0)
        if changed:
            gauge_set("serving_journal_rows",
                      sum(len(r) for r in self._rows))
        return changed

    def applied_watermark(self) -> float:
        """Every source row born at or before this unix time has been
        trained, journaled and polled into the overlay (the lowest over
        directories; 0.0 before the first watermark). Safe from any
        thread."""
        return self._wm_low

    def compile_overlay(self) -> Optional[str]:
        """The overlay as a columnar file in the scratch directory (its
        path), or None when empty. The previous file is unlinked: a stack
        that maps it keeps its inode until the stack is dropped."""
        merged: Dict[int, np.ndarray] = {}
        for rows in self._rows:
            merged.update(rows)
        prev, self._compiled = self._compiled, None
        path = None
        if merged:
            keys = np.fromiter(merged.keys(), np.uint64, len(merged))
            order = np.argsort(keys)
            rows = np.stack([merged[int(k)] for k in keys[order]])
            self._seq += 1
            path = os.path.join(self._scratch,
                                "overlay-%06d.xcol" % self._seq)
            write_xbox_columnar(path, keys[order],
                                np.ascontiguousarray(rows, np.float32))
            self._compiled = path
        if prev is not None:
            try:
                os.unlink(prev)
            except OSError:
                pass
        self._oldest_unapplied = None
        gauge_set("serving_unapplied_watermark_age_secs", 0.0)
        return path

    def close(self) -> None:
        if self._own_scratch:
            shutil.rmtree(self._scratch, ignore_errors=True)


class DeltaRefreshWatcher:
    """A daemon thread: poll the views (and the journal), build the new
    stack, swap it in."""

    def __init__(self, manager: ViewManager, xbox_model_dir: str,
                 days: Optional[Sequence[str]] = None,
                 poll_secs: Optional[float] = None,
                 known_sources: Sequence = (),
                 journal: Optional[JournalDeltaSource] = None,
                 shard_spec: Optional[ShardSpec] = None,
                 flags: Optional[ServingFlags] = None) -> None:
        """``days``: the day list in cadence order, or None to find the
        days at every poll (store.discover_days). ``poll_secs``: default
        ``flags.serving_refresh_secs`` (ServingFlags()), floor 0.05.
        ``known_sources``: the sources of the manager's current stack
        (build_stack returns them), so the first poll does not swap in
        the same view. ``journal``: its overlay stacks freshest.
        ``shard_spec``: every new stack filtered to this box's slice."""
        if poll_secs is None:
            poll_secs = float((flags or ServingFlags()).serving_refresh_secs)
        self.manager = manager
        self.root = xbox_model_dir
        self.days = list(days) if days else None
        self.poll_secs = max(0.05, float(poll_secs))
        self.journal = journal
        self.shard_spec = shard_spec
        self._known = tuple(known_sources)  # watcher thread only
        self._err_streak = 0                # watcher thread only
        self._stop = threading.Event()
        self._woke = threading.Event()      # set a poll (tests wait on it)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-refresh")

    def start(self) -> "DeltaRefreshWatcher":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except FileNotFoundError as e:
                # a day being written reads as missing for one poll; a
                # lasting miss (the base day pruned) warns once a streak
                stat_add("serving_refresh_errors")
                self._err_streak += 1
                if self._err_streak == 2:
                    log.warning("serving refresh sources missing for "
                                "2+ polls — serving a stale generation",
                                error=repr(e))
            except Exception as e:  # noqa: BLE001 (refresh never stops serving)
                stat_add("serving_refresh_errors")
                self._err_streak += 1
                log.warning("serving refresh poll failed", error=repr(e))
            else:
                self._err_streak = 0
            self._woke.set()
            self._stop.wait(self.poll_secs)

    def poll_once(self) -> bool:
        """One discovery; swaps and returns True when the completed views
        or the journal's overlay changed since the last swap."""
        j_changed = self.journal.poll() if self.journal else False
        days = self.days or discover_days(self.root)
        if not days:
            return False
        sources = tuple(discover_xbox_sources(self.root, days))
        if sources == self._known and not j_changed:
            return False
        extra = ()
        if self.journal is not None:
            overlay = self.journal.compile_overlay()
            if overlay:
                extra = (overlay,)
        stack = MmapViewStack(sources, shard_spec=self.shard_spec,
                              extra_files=extra)
        self._known = sources
        gen = self.manager.swap(stack)
        log.info("serving view refreshed", gen=gen,
                 sources=len(sources), overlay=bool(extra),
                 newest=sources[-1].path.rsplit("/", 1)[-1])
        return True

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)


def make_manager(xbox_model_dir: str,
                 days: Optional[Sequence[str]] = None,
                 cache_rows: Optional[int] = None,
                 cache_admit: Optional[int] = None,
                 shard_spec: Optional[ShardSpec] = None,
                 flags: Optional[ServingFlags] = None
                 ) -> Tuple[ViewManager, tuple]:
    """A manager over the current composed view and its sources (hand
    them to DeltaRefreshWatcher as ``known_sources``). ``cache_rows`` and
    ``cache_admit`` default to ``flags``' (ServingFlags()); 0 rows: no
    cache. ``shard_spec``: this box's slice (give the watcher the same)."""
    flags = flags or ServingFlags()
    if cache_rows is None:
        cache_rows = int(flags.serving_cache_rows)
    if cache_admit is None:
        cache_admit = int(flags.serving_cache_admit)
    stack, sources = build_stack(xbox_model_dir, days,
                                 shard_spec=shard_spec)
    cache = (HotKeyCache(cache_rows, stack.dim, admit=cache_admit)
             if cache_rows > 0 else None)
    return ViewManager(stack, cache), sources
