"""Serving clients: pulls against one box's replicas, and the router over
many boxes (paddlebox_tpu/serving/client.py, the same wire and rules).

``ServingClient`` talks to the replicas of one box, which serve the same
view (they map the same files): a pull goes to the next replica round
robin and fails over to the others on a transport error. A replica that
failed k times in a row is skipped for min(2^(k-1), BACKOFF_SKIP_CAP)
attempts before one probe is let through, so a dead replica costs a dial
timeout only every so many pulls and a recovered one is dialed again
within a bounded number. Each pull carries a trace id from
``next_trace_id``, which the server's span records too.

``FleetClient`` routes across boxes: every pull is split by the policy the
boxes filter by (parallel/sharding.py ``partition_pull``), the hot set's
keys going to a box that rotates pull by pull (every box holds them), and
the slices are scattered back into the caller's order. A worker a box
coalesces the pulls queued during the previous flight into one deduped
request.

Responses are unpickled with ``plain_loads`` too: a server cannot hand the
client a class.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.obs import watermark as obs_watermark
from paddlebox_tpu_torch.obs.tracer import next_trace_id, record_span
from paddlebox_tpu_torch.serving import codec
from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.rpc import FramedClient, plain_loads
from paddlebox_tpu_torch.utils.stats import (gauge_set, hist_percentile,
                                             stat_add)

#: the most attempts a failing replica is skipped for before a probe
BACKOFF_SKIP_CAP = 16


class ServingClient:
    """Thread-safe: each FramedClient serializes its own connection, and
    the replica choice and backoff ride one lock. ``obs_flags``
    (ObsFlags()) switches the client's freshness samples."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 timeout: float = 30.0,
                 obs_flags: Optional[ObsFlags] = None) -> None:
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        self._timeout = float(timeout)
        self._watermark = obs_watermark.enabled(obs_flags)
        self._lock = make_lock("ServingClient._lock")
        self._clients: List = [None] * len(self.endpoints)  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock
        self.last_gen = -1  # guarded-by: _lock
        self.last_watermark = 0.0  # guarded-by: _lock
        self._fail_streak = [0] * len(self.endpoints)  # guarded-by: _lock
        self._skip_left = [0] * len(self.endpoints)  # guarded-by: _lock

    def _client_at(self, i: int) -> FramedClient:
        with self._lock:
            c = self._clients[i]
        if c is None:
            # dial outside the lock: a blackholed replica's dial would
            # otherwise stall every thread's pulls to the healthy ones
            h, p = self.endpoints[i]
            c = FramedClient(h, p, loads=plain_loads,
                             timeout=self._timeout)
            with self._lock:
                if self._clients[i] is None:
                    self._clients[i] = c
                else:           # another thread dialed first
                    c.close()
                    c = self._clients[i]
        return c

    def _drop_client(self, i: int) -> None:
        with self._lock:
            c, self._clients[i] = self._clients[i], None
        if c is not None:
            c.close()

    def _pick(self) -> int:
        with self._lock:
            i = self._rr % len(self.endpoints)
            self._rr += 1
        return i

    def _attempt_order(self, start: int) -> List[int]:
        """The round-robin order from ``start`` less the replicas in
        backoff, each of which spends one skip. Where that leaves none,
        all of them: a pull probes rather than fails untried."""
        n = len(self.endpoints)
        order = [(start + k) % n for k in range(n)]
        with self._lock:
            live = []
            for i in order:
                if self._skip_left[i] > 0:
                    self._skip_left[i] -= 1
                    stat_add("serving_client_skips")
                else:
                    live.append(i)
        return live or order

    def _note_failure(self, i: int) -> None:
        with self._lock:
            self._fail_streak[i] += 1
            self._skip_left[i] = min(BACKOFF_SKIP_CAP,
                                     2 ** (self._fail_streak[i] - 1))

    def _note_success(self, i: int) -> None:
        with self._lock:
            recovered = self._fail_streak[i] > 0
            self._fail_streak[i] = 0
            self._skip_left[i] = 0
        if recovered:
            stat_add("serving_client_reprobes")

    def pull(self, keys: np.ndarray,
             shard: Optional[int] = None,
             trace: Optional[int] = None) -> np.ndarray:
        """[K] uint64 keys -> [K, dim] float32 rows. Tries each replica
        outside backoff once; a dead connection or a draining replica
        fails over. ``trace``: the request's id (default a new one; the
        fleet router passes its flight's). ``shard``: the box the router
        chose, which a sharded server checks."""
        if trace is None:
            trace = next_trace_id()
        req = codec.encode_pull(keys, trace=trace, shard=shard)
        t_pull = time.perf_counter()
        order = self._attempt_order(self._pick())
        last_err: Exception = RuntimeError("no endpoints")
        for i in order:
            try:
                resp = self._client_at(i).call(req)
            except OSError as e:
                # refused, a dial timeout, no route, or the transport
                # failing mid-call (ConnectionError): fail over
                self._drop_client(i)
                self._note_failure(i)
                last_err = e
                continue
            except RuntimeError as e:
                # a draining replica's refusal is retryable on another
                if "draining" in str(e):
                    last_err = e
                    continue
                raise
            self._note_success(i)
            wm = codec.decode_watermark(resp)
            with self._lock:
                self.last_gen = int(resp.get("gen", -1))
                if wm is not None:
                    self.last_watermark = wm
            if wm is not None and self._watermark:
                # the freshness the consumer saw, the RPC hop included
                obs_watermark.observe_freshness(wm)
            record_span("serving_pull_client", t_pull,
                        time.perf_counter(), trace=trace)
            return codec.decode_rows(resp)
        raise ConnectionError(
            f"all {len(self.endpoints)} serving replicas failed"
        ) from last_err

    def _call_at(self, i: int, req: Dict[str, Any]) -> Any:
        return self._client_at(i).call(req)

    def ping(self, i: int = 0) -> Dict[str, Any]:
        return self._call_at(i, {"method": "ping"})

    def stats(self, i: int = 0) -> Dict[str, Any]:
        return self._call_at(i, {"method": "stats"})

    def drain_all(self) -> None:
        """Ask every replica to drain."""
        for i in range(len(self.endpoints)):
            try:
                self._call_at(i, {"method": "drain"})
            except (ConnectionError, RuntimeError):
                pass                        # already down

    def close(self) -> None:
        with self._lock:
            clients, self._clients = self._clients, [None] * len(
                self.endpoints)
        for c in clients:
            if c is not None:
                c.close()


class _PullWaiter:
    """One caller's part of a coalesced flight."""

    __slots__ = ("keys", "done", "rows", "err")

    def __init__(self, keys: np.ndarray) -> None:
        self.keys = keys
        self.done = threading.Event()
        self.rows: Optional[np.ndarray] = None
        self.err: Optional[Exception] = None

    def result(self) -> np.ndarray:
        self.done.wait()
        if self.err is not None:
            raise self.err
        return self.rows


class _ShardCoalescer:
    """One box's flights: a worker takes every waiter queued while the
    previous RPC flew, sends the union of their keys once, deduped, and
    hands each waiter its rows. The window is the round trip itself: at
    concurrency 1 a pull goes at once. ``coalesce=False`` sends one RPC a
    waiter through the same worker."""

    def __init__(self, client: ServingClient, shard: int,
                 coalesce: bool = True) -> None:
        self.client = client
        self.shard = int(shard)
        self.coalesce = bool(coalesce)
        self._cv = threading.Condition()
        self._queue: List[_PullWaiter] = []  # guarded-by: _cv
        self._stopped = False  # guarded-by: _cv
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-pull-s{shard}")
        self._thread.start()

    def submit(self, keys: np.ndarray) -> _PullWaiter:
        w = _PullWaiter(keys)
        with self._cv:
            if self._stopped:
                raise RuntimeError("fleet client is closed")
            self._queue.append(w)
            self._cv.notify()
        return w

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
                batch, self._queue = self._queue, []
            if self.coalesce:
                self._flight_coalesced(batch)
                continue
            for w in batch:
                try:
                    w.rows = self.client.pull(w.keys, shard=self.shard)
                    stat_add("serving_fleet_rpcs")
                    stat_add("serving_fleet_keys_sent", int(w.keys.size))
                except Exception as e:  # noqa: BLE001 (the caller's)
                    w.err = e
                w.done.set()

    def _flight_coalesced(self, batch: List[_PullWaiter]) -> None:
        union = np.unique(np.concatenate([w.keys for w in batch]))
        # one trace id a flight: its span, the pull's and the server's
        trace = next_trace_id()
        t0 = time.perf_counter()
        try:
            rows = self.client.pull(union, shard=self.shard, trace=trace)
            record_span("fleet_pull_flight", t0, time.perf_counter(),
                        trace=trace)
            stat_add("serving_fleet_rpcs")
            stat_add("serving_fleet_keys_sent", int(union.size))
            if len(batch) > 1:
                stat_add("serving_fleet_coalesced", len(batch) - 1)
        except Exception as e:  # noqa: BLE001 (every waiter's)
            for w in batch:
                w.err = e
                w.done.set()
            return
        for w in batch:
            # union is sorted, unique and holds w.keys
            w.rows = rows[np.searchsorted(union, w.keys)]
            w.done.set()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with self._cv:
            stuck, self._queue = self._queue, []
        for w in stuck:
            w.err = RuntimeError("fleet client is closed")
            w.done.set()


class FleetClient:
    """The router over B boxes: one ServingClient (replica failover) and
    one coalescing worker a box. Thread-safe; a pull waits only on its
    own boxes' flights."""

    def __init__(self, shard_endpoints: Sequence[Sequence[Tuple[str, int]]],
                 policy=None,
                 hot_keys: Optional[np.ndarray] = None,
                 timeout: float = 30.0,
                 coalesce: bool = True,
                 obs_flags: Optional[ObsFlags] = None) -> None:
        """``shard_endpoints``: one replica list a box, by shard index.
        ``policy``: the partition the boxes filtered by (default
        KeyModPolicy over the boxes). ``hot_keys``: the replicated hot
        set (every box holds its rows)."""
        from paddlebox_tpu_torch.parallel.sharding import (KeyModPolicy,
                                                           partition_pull)
        if not shard_endpoints:
            raise ValueError("need at least one shard")
        self.policy = policy if policy is not None \
            else KeyModPolicy(len(shard_endpoints))
        if self.policy.num_shards != len(shard_endpoints):
            raise ValueError(
                f"policy routes {self.policy.num_shards} shards but "
                f"{len(shard_endpoints)} endpoint groups were given")
        self._partition = partition_pull
        self.hot = (np.unique(np.asarray(hot_keys, np.uint64))
                    if hot_keys is not None and len(hot_keys) else None)
        self.clients = [ServingClient(eps, timeout=timeout,
                                      obs_flags=obs_flags)
                        for eps in shard_endpoints]
        self._coalescers = [_ShardCoalescer(c, s, coalesce=coalesce)
                            for s, c in enumerate(self.clients)]
        self._lock = make_lock("FleetClient._lock")
        self._rot = 0  # guarded-by: _lock
        self._prev_stats: Optional[Tuple[float, int]] = None  # guarded-by: _lock

    def pull(self, keys: np.ndarray) -> np.ndarray:
        """[K] uint64 -> [K, dim] float32, bit-identical to one box
        serving the full view."""
        keys = np.asarray(keys, np.uint64).reshape(-1)
        stat_add("serving_fleet_pulls")
        stat_add("serving_fleet_keys_in", int(keys.size))
        with self._lock:
            rot = self._rot
            self._rot += 1
        parts = self._partition(self.policy, keys, self.hot, hot_dest=rot)
        if self.hot is not None and keys.size:
            pos = np.searchsorted(self.hot, keys)
            hot = (pos < self.hot.size) & (
                self.hot[np.minimum(pos, self.hot.size - 1)] == keys)
            stat_add("serving_fleet_hot_routed", int(hot.sum()))
        waiters = [(idx, self._coalescers[s].submit(keys[idx]))
                   for s, idx in enumerate(parts) if idx.size]
        if not waiters:
            return np.zeros((0, 0), np.float32)
        out = None
        err: Optional[Exception] = None
        for idx, w in waiters:
            try:
                rows = w.result()
            except Exception as e:  # noqa: BLE001 (raised below)
                err = err or e
                continue
            if out is None:
                out = np.zeros((keys.size, rows.shape[1]), np.float32)
            out[idx] = rows
        if err is not None:
            raise err
        return out

    def fleet_stats(self) -> Dict[str, Any]:
        """Every reachable replica's stats merged: summed lookup
        histograms (fleet p50 and p99), requests and keys, QPS since the
        previous call (None on the first), the lowest watermark and the
        merged freshness percentiles."""
        counts: Optional[List[int]] = None
        fresh: Optional[List[int]] = None
        wm_low: Optional[float] = None
        requests = keys = 0
        replicas = []
        for s, c in enumerate(self.clients):
            for i in range(len(c.endpoints)):
                try:
                    st = c.stats(i)
                except (OSError, RuntimeError):
                    continue
                replicas.append({"shard": s, "replica": i,
                                 "gen": st.get("gen"),
                                 "shard_tag": st.get("shard", "")})
                requests += int(st.get("requests", 0))
                keys += int(st.get("keys", 0))
                hist = st.get("lookup_us_counts") or []
                if hist:
                    counts = ([a + b for a, b in zip(counts, hist)]
                              if counts else list(hist))
                fh = st.get("freshness_ms_counts") or []
                if fh:
                    fresh = ([a + b for a, b in zip(fresh, fh)]
                             if fresh else list(fh))
                w = st.get("watermark_ts") or 0.0
                if isinstance(w, (int, float)) and w > 0:
                    # the fleet is as fresh as its stalest box
                    wm_low = w if wm_low is None else min(wm_low, w)
        now = time.time()
        with self._lock:
            prev, self._prev_stats = self._prev_stats, (now, requests)
        qps = None
        if prev is not None and now > prev[0]:
            qps = (requests - prev[1]) / (now - prev[0])
            gauge_set("serving_fleet_qps", qps)
        return {
            "boxes": len(self.clients),
            "replicas": replicas,
            "requests": requests,
            "keys": keys,
            "qps": qps,
            "p50_us": hist_percentile(counts, 0.50) if counts else None,
            "p99_us": hist_percentile(counts, 0.99) if counts else None,
            "watermark_ts": wm_low,
            "freshness_age_secs": (max(0.0, now - wm_low)
                                   if wm_low else None),
            "freshness_p50_secs": (hist_percentile(fresh, 0.50) / 1e3
                                   if fresh and sum(fresh) else None),
            "freshness_p99_secs": (hist_percentile(fresh, 0.99) / 1e3
                                   if fresh and sum(fresh) else None),
        }

    def drain_all(self) -> None:
        for c in self.clients:
            c.drain_all()

    def close(self) -> None:
        for co in self._coalescers:
            co.stop()
        for c in self.clients:
            c.close()
