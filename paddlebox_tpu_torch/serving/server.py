"""One serving process: batched pulls over the framed transport
(paddlebox_tpu/serving/server.py, the same wire and telemetry).

A FramedServer reads each connection on a thread of its own, and every
pull runs on a bounded pool of ``serving_pull_threads`` workers: open
connections cost sockets, not lookup concurrency, and overload queues
(the queueing shows in the latency histogram). The port speaks the plain
codec only (serving/codec.py): the transport refuses a class-bearing
pickle before the handler runs.

``drain()`` refuses new pulls (a retryable error: the client fails over),
waits up to ``serving_drain_secs`` for the pulls in flight, then stops the
watcher, the pool and the transport.

Telemetry: each pull observes ``serving_lookup_us`` and records a
``serving_pull`` span under the client's trace id; every
``serving_report_requests`` pulls a StepReport (keys/s as its examples
rate) carries the window's cache hit rate, and the gauges
``serving_slo_burn`` (the window's p99 over ``serving_slo_us``),
``serving_freshness_burn`` and ``serving_tier_hit_rate`` are set from the
window's deltas (obs/health.py reads the first two). A pull's response
carries the journal's applied watermark.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

from paddlebox_tpu_torch.config.flags import (ObsFlags, ServingFlags,
                                              ShardFlags)
from paddlebox_tpu_torch.obs import log, make_step_reporter
from paddlebox_tpu_torch.obs import watermark as obs_watermark
from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.serving import codec
from paddlebox_tpu_torch.serving.refresh import (DeltaRefreshWatcher,
                                                 JournalDeltaSource,
                                                 ViewManager, make_manager)
from paddlebox_tpu_torch.serving.store import ShardSpec, read_hot_keys
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.rpc import FramedServer, plain_loads
from paddlebox_tpu_torch.utils.stats import (StatRegistry, gauge_get,
                                             gauge_set, hist_observe,
                                             hist_percentile, stat_add,
                                             stat_get)

#: the largest request frame accepted (about a 16M-key pull)
MAX_FRAME_BYTES = 128 << 20


class ServingServer:
    """One process of the serving fleet."""

    def __init__(self, xbox_model_dir: Optional[str] = None,
                 days: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 manager: Optional[ViewManager] = None,
                 watch: bool = True,
                 pull_threads: Optional[int] = None,
                 report_every: Optional[int] = None,
                 flags: Optional[ServingFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 shard_flags: Optional[ShardFlags] = None) -> None:
        """Serve the composed view under ``xbox_model_dir``, or a manager
        made by the caller (then no watcher runs unless a root is given
        too). ``flags`` (ServingFlags()) set the cache, the refresh, the
        pool, the drain, the report cadence, the SLO, this box's shard
        and the journal; ``obs_flags`` (ObsFlags()) the reporter and the
        watermark plane; ``shard_flags`` (ShardFlags()) the policy's
        parameters and its name where ``serving_shard_policy`` is ''."""
        self.flags = flags or ServingFlags()
        self._obs_flags = obs_flags or ObsFlags()
        self.shard_spec = self._shard_spec_from_flags(
            self.flags, shard_flags or ShardFlags())
        self._journal = self._journal_from_flags(self.flags)
        if manager is None:
            if xbox_model_dir is None:
                raise ValueError("need xbox_model_dir or manager")
            manager, sources = make_manager(xbox_model_dir, days,
                                            shard_spec=self.shard_spec,
                                            flags=self.flags)
        else:
            # the sources the caller's stack composed (none for a stack
            # of files), so the first poll does not swap in the same view
            sources = manager.current()[1].sources
        self.manager = manager
        self.watcher: Optional[DeltaRefreshWatcher] = None
        if watch and xbox_model_dir is not None:
            self.watcher = DeltaRefreshWatcher(
                manager, xbox_model_dir, days,
                known_sources=sources, journal=self._journal,
                shard_spec=self.shard_spec, flags=self.flags).start()
        n_threads = max(1, int(pull_threads if pull_threads is not None
                               else self.flags.serving_pull_threads))
        self._pool = ThreadPoolExecutor(n_threads,
                                        thread_name_prefix="serve-pull")
        self._state_cv = threading.Condition()
        self._inflight = 0  # guarded-by: _state_cv
        self._draining = False  # guarded-by: _state_cv
        self._requests = 0  # guarded-by: _report_lock
        self._prev_hit = 0  # guarded-by: _report_lock
        self._prev_miss = 0  # guarded-by: _report_lock
        self._prev_lat = None  # guarded-by: _report_lock
        self._prev_fresh = None  # guarded-by: _report_lock
        self._slo_us = float(self.flags.serving_slo_us)
        self._report_lock = make_lock("ServingServer._report_lock")
        # the rank is the replica's PBTPU_RANK (serving/fleet.py), so each
        # replica's reports and flight files are its own
        every = (report_every if report_every is not None
                 else int(self.flags.serving_report_requests))
        self.reporter = make_step_reporter(
            rank=log.get_rank(),
            flags=dataclasses.replace(self._obs_flags,
                                      obs_report_every=int(every)))
        self._server = FramedServer(self._handle, loads=plain_loads,
                                    host=host, port=port,
                                    max_frame_bytes=MAX_FRAME_BYTES)
        log.info("serving server up", port=self.port,
                 threads=n_threads,
                 watch=int(self.watcher is not None),
                 shard=self.shard_spec.describe()
                 if self.shard_spec else "full",
                 journal=int(self._journal is not None))

    @staticmethod
    def _shard_spec_from_flags(flags: ServingFlags,
                               shard_flags: ShardFlags
                               ) -> Optional[ShardSpec]:
        """This box's slice (serving_shard_index >= 0), or None: the full
        view."""
        index = int(flags.serving_shard_index)
        if index < 0:
            return None
        from paddlebox_tpu_torch.parallel.sharding import \
            resolve_sharding_policy
        name = str(flags.serving_shard_policy) or None
        hot_path = str(flags.serving_hot_keys)
        hot = read_hot_keys(hot_path) if hot_path else None
        return ShardSpec(index, resolve_sharding_policy(
            int(flags.serving_num_shards), name=name, flags=shard_flags),
            hot_keys=hot)

    @staticmethod
    def _journal_from_flags(flags: ServingFlags
                            ) -> Optional[JournalDeltaSource]:
        dirs = [d for d in str(flags.serving_journal_dir).split(",") if d]
        return JournalDeltaSource(dirs) if dirs else None

    @property
    def port(self) -> int:
        return self._server.port

    def _handle(self, req: Dict[str, Any]) -> Any:
        method = req.get("method")
        if method == "pull":
            return self._handle_pull(req)
        if method == "ping":
            return {"gen": self.manager.current()[0]}
        if method == "stats":
            return self._stats()
        if method == "drain":
            # answer first and drain on another thread: this request is
            # itself in flight
            threading.Thread(target=self.drain, daemon=True,
                             name="serve-drain").start()
            return {"draining": True}
        raise ValueError(f"unknown serving method {method!r}")

    def _handle_pull(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._state_cv:
            if self._draining:
                raise RuntimeError("draining: replica is shutting down")
            self._inflight += 1
        try:
            t0 = time.perf_counter()
            declared = codec.decode_shard(req)
            if (declared is not None and self.shard_spec is not None
                    and declared != self.shard_spec.index):
                # answering would give zero rows for every key this box
                # does not hold
                raise ValueError(
                    f"pull routed to shard {declared} but this box "
                    f"serves {self.shard_spec.describe()}")
            keys = codec.decode_pull_keys(req)
            # the connection's thread waits on the bounded pool; the wait
            # is part of the latency published
            rows, gen = self._pool.submit(
                self.manager.lookup, keys).result()
            t1 = time.perf_counter()
            hist_observe("serving_lookup_us", (t1 - t0) * 1e6)
            record_span("serving_pull", t0, t1,
                        trace=codec.decode_trace(req))
            stat_add("serving_requests")
            stat_add("serving_keys", int(keys.size))
            self._note_report(int(keys.size))
            wm = (self._journal.applied_watermark()
                  if self._journal is not None else 0.0)
            if wm > 0.0 and obs_watermark.enabled(self._obs_flags):
                obs_watermark.observe_freshness(wm)
                return codec.encode_rows(rows, gen, watermark=wm)
            return codec.encode_rows(rows, gen)
        finally:
            with self._state_cv:
                self._inflight -= 1
                if self._inflight == 0:
                    self._state_cv.notify_all()

    def _note_report(self, n_keys: int) -> None:
        """The report cadence in pulls; any pool or connection thread may
        carry the Nth, so it is serialized."""
        with self._report_lock:
            self._requests += 1
            self.reporter.note_examples(n_keys)
            if not self.reporter.due(self._requests):
                return
            hit = stat_get("serving_cache_hit")
            miss = stat_get("serving_cache_miss")
            d_hit = hit - self._prev_hit
            d_tot = d_hit + (miss - self._prev_miss)
            self._prev_hit, self._prev_miss = hit, miss
            # the gauges are set before the record is assembled, so this
            # window's record carries them
            if self._slo_us > 0:
                counts = StatRegistry.instance().hist_counts(
                    "serving_lookup_us")
                if counts:
                    prev = self._prev_lat
                    delta = ([c - p for c, p in zip(counts, prev)]
                             if prev else counts)
                    self._prev_lat = list(counts)
                    if sum(delta) > 0:
                        gauge_set("serving_slo_burn", round(
                            hist_percentile(delta, 0.99) / self._slo_us, 4))
            fresh = StatRegistry.instance().hist_counts(
                obs_watermark.FRESHNESS_HIST)
            if fresh:
                prevf = self._prev_fresh
                deltaf = ([c - p for c, p in zip(fresh, prevf)]
                          if prevf else fresh)
                self._prev_fresh = list(fresh)
                burn = obs_watermark.freshness_burn(
                    deltaf, self._obs_flags.freshness_slo_secs)
                if burn is not None:
                    gauge_set("serving_freshness_burn", round(burn, 4))
            if d_tot:
                gauge_set("serving_tier_hit_rate", round(d_hit / d_tot, 4))
            self.reporter.maybe_report(self._requests, extra={
                "role": "serving",
                "gen": self.manager.current()[0],
                "cache_hit_rate": round(d_hit / d_tot, 4)
                if d_tot else None,
                "freshness_e2e_secs_p99": round(gauge_get(
                    "freshness_e2e_secs_p99"), 4),
            })

    def _stats(self) -> Dict[str, Any]:
        """What the fleet client merges across replicas: raw histogram
        counts (summed elementwise into fleet percentiles), requests and
        a timestamp (QPS between two calls), the watermark (min-reduced)
        and the freshness counts."""
        gen, stack = self.manager.current()
        reg = StatRegistry.instance()
        return {
            "gen": gen,
            "view_rows": stack.total_rows,
            "requests": stat_get("serving_requests"),
            "keys": stat_get("serving_keys"),
            "cache_hit": stat_get("serving_cache_hit"),
            "cache_miss": stat_get("serving_cache_miss"),
            "cache_evict": stat_get("serving_cache_evict"),
            "last_report": self.reporter.peek(),
            "shard": (self.shard_spec.describe()
                      if self.shard_spec else ""),
            "journal_rows": int(gauge_get("serving_journal_rows")),
            "lookup_us_counts": list(
                reg.hist_counts("serving_lookup_us") or ()),
            "watermark_ts": (float(self._journal.applied_watermark())
                             if self._journal is not None else 0.0),
            "freshness_ms_counts": list(
                reg.hist_counts(obs_watermark.FRESHNESS_HIST) or ()),
            "ts": time.time(),
        }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new pulls, wait for those in flight (up to ``timeout``,
        default ``serving_drain_secs``), then stop the watcher, the pool
        and the transport. Idempotent; True when the pulls in flight
        finished inside the bound."""
        if timeout is None:
            timeout = float(self.flags.serving_drain_secs)
        deadline = time.monotonic() + timeout
        with self._state_cv:
            already = self._draining
            self._draining = True
            clean = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    clean = False
                    break
                self._state_cv.wait(left)
        if already:
            return clean
        if self.watcher is not None:
            self.watcher.stop()
        self._server.stop()
        self._pool.shutdown(wait=True)
        self.reporter.close()
        self.manager.close()
        if self._journal is not None:
            self._journal.close()
        log.info("serving server drained", clean=int(clean))
        return clean

    close = drain
