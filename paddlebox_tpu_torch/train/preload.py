"""Pass preload overlap: load pass N+1 while pass N trains.

Counterpart of paddlebox_tpu/train/preload.py:36-253 (the BoxHelper cadence,
PreLoadIntoMemory / WaitFeedPassDone): the dataset's reader thread for the
NEXT pass runs while the device steps of the CURRENT pass are queued. Keys
are buffered outside the table (a plain list), so the pass that trains keeps
its key set; the unique + sort of end_feed_pass stays at the pass boundary.

With the incremental lifecycle (PassFlags, both switches on), a
PromotePrefetcher thread diffs each arriving key chunk against the current
pass's key set (what will be resident when the next begin_pass diffs) and
reads the rows of the keys the host store already holds while the current
pass trains. It never creates a key: new keys are created at the pass
boundary by one sorted lookup_or_create, so the creation draws, and with
them every bit, match the full path.

The reader's parse is one native call a file on the default (columnar)
dataset, which releases the interpreter lock; the prefetcher's numpy diffs
and the record path's parsing run Python beside the main thread's staging,
so the interpreter lock bounds what they can hide.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.embedding.pass_table import sorted_member
from paddlebox_tpu_torch.obs.tracer import span


class PromotePrefetcher:
    """Background diff and host-store read of the next pass's non-resident
    keys (the overlapped half of the incremental begin_pass).

    known_fn(keys) -> bool mask of the keys in the current pass's set;
    store.lookup_present(keys) -> (rows, found) reads without creating;
    ``lock`` (the table's store_lock) is held around every store call, so
    the read never races the current pass's end_pass write-back or a
    store that grows."""

    def __init__(self, known_fn: Callable[[np.ndarray], np.ndarray], store,
                 lock: threading.Lock) -> None:
        self._known = known_fn
        self._store = store
        self._lock = lock
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        # the sorted set of keys already diffed, kept in numpy (a Python set
        # at the feed's key rate would cost this thread far more)
        self._seen = np.empty(0, np.uint64)
        self._keys: List[np.ndarray] = []
        self._rows: List[np.ndarray] = []
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="promote-prefetch")
        self._thread.start()

    def feed(self, keys: np.ndarray) -> None:
        self._q.put(np.asarray(keys, np.uint64))

    def _run(self) -> None:
        try:
            done = False
            while not done:
                chunk = self._q.get()
                if chunk is None:
                    return
                # take every chunk already queued: one union over them beats
                # one re-sort of the seen set a chunk
                parts = [chunk]
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        done = True
                        break
                    parts.append(nxt)
                cand = np.unique(np.concatenate(parts))
                cand = cand[~self._known(cand)]
                cand = cand[~sorted_member(self._seen, cand)[1]]
                if not cand.size:
                    continue
                self._seen = np.union1d(self._seen, cand)
                with self._lock:
                    rows, found = self._store.lookup_present(cand)
                if found.any():
                    self._keys.append(cand[found])
                    self._rows.append(rows[found])
        except BaseException as e:  # raised again by finish()
            self._err = e

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Join the worker; (sorted unique keys, rows) it read."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
        if not self._keys:
            return np.empty(0, np.uint64), np.empty((0, 0), np.float32)
        keys = np.concatenate(self._keys)
        rows = np.vstack(self._rows)
        order = np.argsort(keys, kind="stable")
        return keys[order], rows[order]

    def stop(self) -> None:
        """Abandon the prefetch (error paths): unblock and join the worker,
        dropping what it read."""
        self._q.put(None)
        self._thread.join(timeout=30.0)


class PassPreloader:
    """One preload in flight at a time, like BoxHelper's single feed
    agent. ``wait_s`` is the host-clock seconds of the last wait()."""

    def __init__(self, table) -> None:
        self.table = table
        self._buffer: Optional[List[np.ndarray]] = None
        self._dataset = None
        self._prefetch: Optional[PromotePrefetcher] = None
        self.wait_s = 0.0

    def preload(self, dataset) -> None:
        """Start the dataset's reader thread, and the promote prefetcher
        when the table hands out its context; returns at once."""
        if self._dataset is not None:
            raise RuntimeError("a preload is already in flight")
        self._buffer = []
        self._dataset = dataset
        try:
            ctx = self.table.promote_prefetch_ctx()
            if ctx is not None:
                self._prefetch = PromotePrefetcher(*ctx)
                buf, pre = self._buffer, self._prefetch

                def add(keys: np.ndarray) -> None:
                    buf.append(keys)
                    pre.feed(keys)

                dataset.preload_into_memory(add_keys_fn=add)
            else:
                dataset.preload_into_memory(add_keys_fn=self._buffer.append)
        except BaseException:
            # a failed start must not wedge the preloader, or leave the
            # prefetcher parked on its queue
            self._reset()
            raise

    def _reset(self) -> None:
        """Drop every in-flight preload state, so a fresh preload() is
        accepted."""
        if self._prefetch is not None:
            try:
                self._prefetch.stop()
            finally:
                self._prefetch = None
        self._buffer = None
        self._dataset = None

    def feed_pass(self, allgather=None) -> None:
        """The table's feed pass over the buffered keys; ``allgather`` (the
        fleet's all_gather, given only above one rank, where the table is
        a ShardedPassTable) unions the ranks' keys, as the reference's wait
        does (preload.py:199-209)."""
        self.table.begin_feed_pass()
        for ks in self._buffer or []:
            self.table.add_keys(ks)
        if allgather is None:
            self.table.end_feed_pass()
        else:
            self.table.end_feed_pass(allgather=allgather)

    def wait(self, dataset, allgather=None) -> None:
        """Join the load, hand the prefetched rows to the table and run its
        feed pass over the buffered keys (WaitFeedPassDone; ``feed_pass``),
        under the spans ingest_wait_preload (what of the load the overlap
        did not hide) and ingest_feed_pass. On any error the preloader
        resets, so a caller may preload again."""
        if dataset is not self._dataset:
            raise RuntimeError("wait() for a dataset that was not preloaded")
        t0 = time.perf_counter()
        try:
            with span("ingest_wait_preload"):
                dataset.wait_preload_done()
            pre, self._prefetch = self._prefetch, None
            if pre is not None:
                keys, rows = pre.finish()
                self.table.accept_staged_rows(keys, rows)
            with span("ingest_feed_pass"):
                self.feed_pass(allgather)
        except BaseException:
            self._reset()
            raise
        else:
            self._buffer = None
            self._dataset = None
        finally:
            self.wait_s = time.perf_counter() - t0


def run_preloaded_passes(trainer, datasets: Iterable,
                         after_pass: Optional[Callable[[int, Dict], None]]
                         = None) -> List[Dict[str, float]]:
    """Train a sequence of datasets, loading pass N+1 while pass N trains.

    Each pass's ``trainer.pass_times`` starts with ``wait``, the seconds
    the preloader's wait took, in place of ``feed``. after_pass(index,
    stats), when given, runs after each pass with the next pass's readers
    already started; each dataset's records are released after its pass.
    Over a ShardedBoxTrainer above one rank each feed pass unions the
    ranks' keys with the fleet's all_gather (reference preload.py:231-233).
    Returns the passes' stats."""
    allgather = (trainer.fleet.all_gather
                 if getattr(trainer, "multiprocess", False) else None)
    pre = PassPreloader(trainer.table)
    results: List[Dict[str, float]] = []
    it = iter(datasets)
    cur = next(it, None)
    if cur is None:
        return results
    pre.preload(cur)
    while cur is not None:
        pre.wait(cur, allgather=allgather)
        wait_s = pre.wait_s
        nxt = next(it, None)
        if nxt is not None:
            # pass N+1's reader starts before pass N trains
            pre.preload(nxt)
        results.append(trainer.train_pass(cur, preloaded=True))
        trainer.pass_times = {"wait": wait_s, **trainer.pass_times}
        if after_pass is not None:
            after_pass(len(results) - 1, results[-1])
        cur.release_memory()
        cur = nxt
    return results
