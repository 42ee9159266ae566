"""Continuous training: the day and pass cadence collapsed into micro-passes
(paddlebox_tpu/train/streaming_runner.py, the same cadence, gauges and
stats).

``StreamingRunner`` drives a BoxTrainer or a ShardedBoxTrainer from a
StreamingDataset (data/streaming.py) as ``run_preloaded_passes`` drives a
day's datasets:

  * a fetcher thread forms windows (watcher poll, line count, BoxDataset:
    no table or trainer state) into a bounded queue of 2 while the train
    thread works;
  * window N+1's reader (and the promote prefetcher) starts before window
    N trains, so the train thread waits on ingest only when the source is
    dry: ``ingest_wait_secs`` a pass;
  * each loaded window passes drift-gated admission before it touches the
    table: the runner's own SlotDriftMonitor scores it against the rolling
    reference of admitted windows (``preview_block``); a refused window
    drops its buffered keys and the prefetcher's staged rows, never
    reaches begin_pass, and never enters the reference;
  * every boundary publishes the journal (``TouchedRowJournal.publish``,
    with the window's born span as a watermark record while
    ``ObsFlags.obs_watermark`` is on), so a serving tailer picks the rows
    up without a delta save; the first admitted pass and every
    ``streaming_base_every``-th one land ``save_base(mode='auto')`` under
    day ``stream-NNNNNN``; then the ledger commit and a ``micro_pass``
    StepReport;
  * the gauges streaming_ingest_lag_secs, streaming_publish_lag_secs,
    streaming_admission_score and streaming_examples_per_sec, and the stats
    streaming_micro_passes and streaming_windows_refused.

Over a ShardedBoxTrainer above one rank, ``run`` passes the fleet's
``all_gather`` to ``wait_admit``, and the table's feed pass unions the
ranks' keys with it (``end_feed_pass(allgather=)``), as the reference's
runner does. Each rank's admission gate decides alone, as in the
reference: the ranks must admit and refuse the same windows (a window
every rank refuses leaves every store as it was). Where they disagree, an
admitting rank's all_gather pairs with another rank's next window, the
ranks fall out of step, and one of them raises in a collective its peer
never makes: at the process group's timeout, or sooner where the peer's
group has closed. A rank that ends first may return normally, having
trained a window whose key set was unioned with another window's.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

from paddlebox_tpu_torch.config.flags import StreamFlags
from paddlebox_tpu_torch.metrics.drift import SlotDriftMonitor
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs import watermark as obs_watermark
from paddlebox_tpu_torch.obs.tracer import (current_trace, set_trace, span,
                                            step_trace_id)
from paddlebox_tpu_torch.obs.watchdog import beat
from paddlebox_tpu_torch.train.preload import PassPreloader
from paddlebox_tpu_torch.utils.stats import gauge_set, stat_add


class _GatedPreloader(PassPreloader):
    """A PassPreloader with the admission gate between the load's join and
    the table's feed pass: a refused window leaves the table and the store
    as they were (the prefetcher's staged rows are dropped, not
    accepted)."""

    def wait_admit(self, dataset, admit_fn=None, allgather=None) -> bool:
        """Wait for the preload of ``dataset``, then gate it: refused
        (False) leaves the table as it was; admitted (True) runs the feed
        pass (``feed_pass``), its key set unioned across the ranks by
        ``allgather`` (the fleet's all_gather) where it is given."""
        if dataset is not self._dataset:
            raise RuntimeError("wait_admit() for a dataset that was not "
                               "preloaded")
        t0 = time.perf_counter()
        try:
            with span("streaming_wait_ingest"):
                dataset.wait_preload_done()
            if admit_fn is not None and not admit_fn(dataset):
                self._reset()
                return False
            pre, self._prefetch = self._prefetch, None
            if pre is not None:
                keys, rows = pre.finish()
                if keys.size:
                    self.table.accept_staged_rows(keys, rows)
            with span("streaming_feed_pass"):
                self.feed_pass(allgather)
        except BaseException:
            self._reset()
            raise
        else:
            self._buffer = None
            self._dataset = None
        finally:
            self.wait_s = time.perf_counter() - t0
        return True


class StreamingRunner:
    """Micro-pass training over a StreamingDataset.

    trainer: a BoxTrainer or a ShardedBoxTrainer; stream: a
    StreamingDataset; cm: a CheckpointManager over the trainer's table, or
    None (then no publish and no micro-checkpoint). ``base_every``, ``admission_max_drift``: the
    StreamFlags values when None.

    run() owns the train thread; the one fetcher thread only forms windows;
    they meet at a queue of 2."""

    def __init__(self, trainer, stream, cm=None,
                 base_every: Optional[int] = None,
                 admission_max_drift: Optional[float] = None,
                 drift_monitor: Optional[SlotDriftMonitor] = None,
                 flags: Optional[StreamFlags] = None) -> None:
        self.flags = flags or StreamFlags()
        self.trainer = trainer
        self.stream = stream
        self.cm = cm
        self.base_every = int(base_every if base_every is not None
                              else self.flags.streaming_base_every)
        self.admission_max_drift = float(
            admission_max_drift if admission_max_drift is not None
            else self.flags.streaming_admission_max_drift)
        self.monitor = drift_monitor or SlotDriftMonitor()
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._fetcher: Optional[threading.Thread] = None
        self._fetch_err: Optional[BaseException] = None
        self._eos = False
        self._stop = threading.Event()
        self.admitted = 0
        self.refused = 0
        self.passes: List[Dict] = []

    # ------------------------------------------------------------- fetcher
    def _fetch_loop(self, max_windows: Optional[int],
                    idle_timeout: float) -> None:
        try:
            n = 0
            while not self._stop.is_set():
                if max_windows is not None and n >= max_windows:
                    break
                deadline = (time.time() + idle_timeout
                            if idle_timeout > 0 else None)
                win = self.stream.next_window(deadline=deadline)
                if win is None:
                    break   # idle timeout or stopped
                # blocks the fetcher, never the train thread
                while not self._stop.is_set():
                    try:
                        self._q.put(win, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                n += 1
        except BaseException as e:   # raised on the train thread
            self._fetch_err = e
        finally:
            while True:
                try:
                    self._q.put(None, timeout=0.2)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def _next(self, block: bool) -> Optional[object]:
        """The next formed window; None when none is ready (non-blocking)
        or the stream ended (latched, so a later blocking pop cannot hang
        on a finished fetcher)."""
        if self._eos:
            return None
        try:
            win = self._q.get(block=block)
        except queue.Empty:
            return None
        if win is None:
            self._eos = True
            if self._fetch_err is not None:
                raise self._fetch_err
            return None
        return win

    # ------------------------------------------------------------ admission
    def _admit(self, win) -> bool:
        """Score the loaded window before it touches the table."""
        if self.admission_max_drift <= 0:
            win.drift_score = 0.0
            return True
        block = getattr(win.dataset, "block", None)
        if block is None:   # record path: nothing to score
            win.drift_score = 0.0
            return True
        score = self.monitor.preview_block(block)
        win.drift_score = score
        gauge_set("streaming_admission_score", score)
        if score >= self.admission_max_drift:
            stat_add("streaming_windows_refused")
            obs_log.warning(
                "streaming admission refused a micro-pass window",
                window=win.index, score=score,
                threshold=self.admission_max_drift,
                files=str([f.rsplit("/", 1)[-1] for f in win.files][:4]))
            return False
        # only admitted windows advance the reference
        self.monitor.admit_block(block)
        return True

    # ------------------------------------------------------------- boundary
    def _boundary(self, win, admitted: bool) -> None:
        """Journal publish, micro-checkpoint, ledger commit, report."""
        journal = self.cm.journal if self.cm is not None else None
        if journal is not None and admitted:
            with span("streaming_publish"):
                if obs_watermark.enabled(self.trainer.obs_flags):
                    journal.publish(born_min=win.born_min_ts,
                                    born_max=win.born_ts,
                                    trace=current_trace())
                else:
                    journal.publish()
            gauge_set("streaming_publish_lag_secs",
                      max(0.0, time.time() - win.born_ts))
        if (admitted and self.cm is not None and self.base_every > 0
                and (self.admitted == 1
                     or self.admitted % self.base_every == 0)):
            # the first admitted pass anchors a full base, so every later
            # decimated save is a touched one
            with span("streaming_micro_checkpoint"):
                self.cm.save_base(self.trainer.params,
                                  self.trainer.opt_state,
                                  day="stream-%06d" % win.index, mode="auto")
        self.stream.commit_window(win)
        stat_add("streaming_micro_passes")
        beat("micro_pass")
        self.trainer.reporter.maybe_report(
            self.trainer._step_count, force=True,
            extra={"event": "micro_pass", "window": win.index,
                   "admitted": admitted, "instances": win.instances,
                   "drift_score": round(getattr(win, "drift_score", 0.0),
                                        4)})

    # ------------------------------------------------------------------ run
    def run(self, max_micro_passes: Optional[int] = None,
            idle_timeout: Optional[float] = None) -> Dict:
        """Train micro-passes until the stream is dry for ``idle_timeout``
        seconds (streaming_idle_timeout_secs when None; 0 never),
        ``max_micro_passes`` windows were processed, or stop(). Returns the
        run's totals with each pass's record under "passes"."""
        if idle_timeout is None:
            idle_timeout = float(self.flags.streaming_idle_timeout_secs)
        # the feed pass's key union across the ranks (reference :265-268)
        allgather = (self.trainer.fleet.all_gather
                     if getattr(self.trainer, "multiprocess", False)
                     else None)
        self._stop.clear()
        self._eos = False
        self._fetch_err = None
        self.passes = []
        self.admitted = 0
        self.refused = 0
        self.stream.resume()    # runnable again after a drain
        self._fetcher = threading.Thread(
            target=self._fetch_loop, args=(max_micro_passes, idle_timeout),
            daemon=True, name="stream-fetch")
        self._fetcher.start()
        pre = _GatedPreloader(self.trainer.table)
        t_run = time.perf_counter()
        instances = 0
        try:
            wait0 = time.perf_counter()
            cur = self._next(block=True)
            cur_wait = time.perf_counter() - wait0
            if cur is not None:
                pre.preload(cur.dataset)
            while cur is not None and not self._stop.is_set():
                t0 = time.perf_counter()
                win = cur
                # one trace id for every span of this micro-pass on the
                # train thread; the watermark record carries it
                set_trace(step_trace_id(obs_log.get_rank(), cur.index))
                admitted = pre.wait_admit(
                    cur.dataset, admit_fn=lambda _ds: self._admit(win),
                    allgather=allgather)
                ingest_wait = cur_wait + (time.perf_counter() - t0)
                # window N+1's reader starts before N trains
                nxt = self._next(block=False)
                if nxt is not None:
                    pre.preload(nxt.dataset)
                stats: Dict = {"window": cur.index, "admitted": admitted,
                               "instances": cur.instances,
                               "drift_score": getattr(cur, "drift_score",
                                                      0.0)}
                if admitted:
                    lag = max(0.0, time.time() - cur.born_ts)
                    gauge_set("streaming_ingest_lag_secs", lag)
                    stats["ingest_lag_secs"] = lag
                    t1 = time.perf_counter()
                    stats.update(self.trainer.train_pass(cur.dataset,
                                                         preloaded=True))
                    stats["train_secs"] = time.perf_counter() - t1
                    self.admitted += 1
                    instances += cur.instances
                else:
                    self.refused += 1
                self._boundary(cur, admitted)
                cur.dataset.release_memory()
                stats["ingest_wait_secs"] = ingest_wait
                self.passes.append(stats)
                if nxt is None and not self._eos:
                    # the source-bound wait, measured a pass
                    wait0 = time.perf_counter()
                    nxt = self._next(block=True)
                    cur_wait = time.perf_counter() - wait0
                    if nxt is not None:
                        pre.preload(nxt.dataset)
                else:
                    cur_wait = 0.0
                cur = nxt
        finally:
            set_trace(None)
            self._stop.set()
            self.stream.stop()
            pre._reset()    # a preload left in flight by stop()
            # drain the queue so the fetcher's put cannot wedge the join
            while True:
                try:
                    win = self._q.get_nowait()
                except queue.Empty:
                    break
                if win is not None:
                    win.dataset.release_memory()
            if self._fetcher is not None:
                self._fetcher.join(timeout=30.0)
        if self._fetch_err is not None:
            raise self._fetch_err
        wall = max(time.perf_counter() - t_run, 1e-9)
        rate = instances / wall
        gauge_set("streaming_examples_per_sec", rate)
        return {"micro_passes": len(self.passes),
                "admitted": self.admitted, "refused": self.refused,
                "instances": instances, "wall_secs": wall,
                "examples_per_sec": rate,
                "max_ingest_wait_secs": max(
                    (p["ingest_wait_secs"] for p in self.passes),
                    default=0.0),
                "passes": self.passes}

    def stop(self) -> None:
        """Wind down after the current micro-pass."""
        self._stop.set()
        self.stream.stop()
