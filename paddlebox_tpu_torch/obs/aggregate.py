"""Cluster telemetry: the ranks' StepReports merged on rank 0 (a copy of
paddlebox_tpu/obs/aggregate.py over the port's store transport).

At every report a rank other than 0 publishes its StepReport to rank 0
(``ClusterAggregator.publish``) over ``StoreObsTransport``: one key a
rank, ``<namespace>/<rank>``, overwritten with the latest report on the
fleet's KV store (fleet/store.py), so the store holds O(world) keys for
ever and no rank waits for another. Rank 0 stores its own, drains the
reports that arrived since its last merge, and emits one merged
``cluster_report`` through its sink: per metric (stats, gauges, timers'
ms, examples/s) the ranks' min, median, max and values, the histograms'
counts summed before their percentiles, and the quality plane's tables
summed; ranks with no new report are listed stale. With a HealthMonitor
(obs/health.py) the ``cluster_health`` record follows it.

Publishing never fails a step: three failures in a row start a backoff
counted in skipped publishes (1, 2, 4, ... up to BACKOFF_SKIP_CAP, within
BACKOFF_CAP_S seconds), and any success resets it. The reference's socket
mesh transport (MeshObsTransport) has no counterpart: the port's MeshComm
is gloo's all_to_all, so ``make_transport`` takes the store whenever the
fleet has a client and more than one rank (ROADMAP.md C).
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.obs import flight
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs.report import (SCHEMA_VERSION, MetricsSink,
                                            NullSink)
from paddlebox_tpu_torch.utils.stats import hist_percentile


class StoreObsTransport:
    """Rank r overwrites its one key, ``<namespace>/<r>``, with its latest
    report (a head line of [epoch, seq], then the payload); rank 0 reads
    the others' keys without waiting and keeps those with a sequence it
    has not merged."""

    def __init__(self, store, namespace: str, rank: int, world: int) -> None:
        self._store = store
        self._ns = namespace.rstrip("/")
        self.rank = int(rank)
        self.world = int(world)
        self._last_seq: Dict[int, Tuple[str, int]] = {}
        self._seq = 0
        # a rank restarted after a failure starts a fresh transport whose
        # seq restarts at 0: the epoch keeps rank 0 reading it
        self._epoch = uuid.uuid4().hex[:12]

    def _key(self, rank: int) -> str:
        return "%s/%d" % (self._ns, rank)

    def publish(self, payload: bytes) -> None:
        self._seq += 1
        framed = (json.dumps([self._epoch, self._seq]).encode()
                  + b"\n" + payload)
        self._store.set(self._key(self.rank), framed)

    def drain(self) -> List[bytes]:
        out = []
        for r in range(self.world):
            if r == self.rank:
                continue
            raw = self._store.get(self._key(r))
            if raw is None:
                continue
            head, _, payload = bytes(raw).partition(b"\n")
            epoch, seq = json.loads(head)
            last = self._last_seq.get(r)
            if (last is not None and last[0] == epoch
                    and int(seq) <= last[1]):
                continue            # already merged this window
            self._last_seq[r] = (str(epoch), int(seq))
            out.append(payload)
        return out


def make_transport(fleet=None):
    """The store transport of ``fleet`` (its KV store client, its run's
    namespace) when it has a client and more than one rank, else None.
    The reference's first choice, its socket mesh, has no counterpart in
    the port."""
    if fleet is not None and getattr(fleet, "initialized", False):
        client = fleet.store_client()
        if client is not None and fleet.worker_num() > 1:
            return StoreObsTransport(client, fleet.obs_namespace(),
                                     fleet.worker_index(),
                                     fleet.worker_num())
    return None


def merge_cluster_reports(reports: List[dict]) -> dict:
    """Rank-0 merge of one window's per-rank StepReports: per-metric
    min/median/max + per_rank values over stats/gauges/timer-ms/
    examples_per_sec; histogram counts sum elementwise before the
    percentile math."""
    per_metric: Dict[str, Dict[int, float]] = {}
    hist_sums: Dict[str, List[int]] = {}
    ranks = []
    step = 0
    for rec in reports:
        r = int(rec.get("rank", 0))
        ranks.append(r)
        step = max(step, int(rec.get("step", 0)))
        per_metric.setdefault("examples_per_sec", {})[r] = float(
            rec.get("examples_per_sec", 0.0))
        for k, v in (rec.get("stats") or {}).items():
            per_metric.setdefault("stats." + k, {})[r] = float(v)
        for k, v in (rec.get("gauges") or {}).items():
            per_metric.setdefault("gauges." + k, {})[r] = float(v)
        for k, v in (rec.get("timers") or {}).items():
            per_metric.setdefault("timers.%s.ms" % k, {})[r] = float(
                v.get("ms", 0.0))
        for k, h in (rec.get("hists") or {}).items():
            counts = h.get("counts") or []
            cur = hist_sums.get(k)
            if cur is None:
                hist_sums[k] = list(counts)
            else:
                for i, c in enumerate(counts):
                    if i < len(cur):
                        cur[i] += c
                    else:
                        cur.append(c)
    metrics = {}
    for k, by_rank in sorted(per_metric.items()):
        vals = sorted(by_rank.values())
        n = len(vals)
        med = (vals[n // 2] if n % 2 else
               0.5 * (vals[n // 2 - 1] + vals[n // 2]))
        metrics[k] = {"min": vals[0], "med": round(med, 3),
                      "max": vals[-1],
                      "per_rank": {str(r): by_rank[r]
                                   for r in sorted(by_rank)}}
    hists = {}
    for k, counts in sorted(hist_sums.items()):
        hists[k] = {"count": sum(counts),
                    "p50": round(hist_percentile(counts, 0.50), 3),
                    "p90": round(hist_percentile(counts, 0.90), 3),
                    "p99": round(hist_percentile(counts, 0.99), 3)}
    out = {"type": "cluster_report", "v": SCHEMA_VERSION, "step": step,
           "ranks": sorted(set(ranks)), "metrics": metrics, "hists": hists}
    # tagged quality plane (round 18): pass_end reports ship each
    # rank's sum-mergeable quality state — sum the bucket tables and
    # compute the CLUSTER-wide tagged auc/copc/ctr (per-rank AUCs do
    # not average; their tables sum, exactly the reference's allreduce)
    qstates = [rec["quality_state"] for rec in reports
               if rec.get("quality_state")]
    if qstates:
        from paddlebox_tpu_torch.metrics.quality import merged_report
        q = merged_report(qstates)
        if q is not None:
            out["quality"] = q
    return out


class ClusterAggregator:
    """The rank's side of the merge (module docstring). Ranks other than
    0 publish each report to rank 0; rank 0 keeps its own, merges it with
    the reports that arrived since its last merge (a rank that stopped
    publishing drops out of the metrics and reads stale, never merged
    again with an old window), emits the merged record and, with
    ``health``, the cluster_health record behind it. A failed publish
    warns and never fails the step; past MAX_PUBLISH_FAILURES in a row it
    skips 1, 2, 4, ... publishes (at most BACKOFF_SKIP_CAP, within
    BACKOFF_CAP_S seconds) before it tries again, so a short outage costs
    a bounded number of stale windows, and a success resets the count.
    """

    #: consecutive failures before backoff starts
    MAX_PUBLISH_FAILURES = 3
    #: max publishes skipped per backoff round (bounds stale windows)
    BACKOFF_SKIP_CAP = 16
    #: wall-clock ceiling on one backoff round (slow-cadence jobs)
    BACKOFF_CAP_S = 60.0

    def __init__(self, transport, rank: int, world: int,
                 sink: Optional[MetricsSink] = None,
                 health=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.transport = transport
        self.rank = int(rank)
        self.world = int(world)
        self.sink = sink or NullSink()
        self.health = health
        self._clock = clock
        self._window: Dict[int, dict] = {}   # rank -> report THIS window
        self.last_cluster_report: Optional[dict] = None
        self.last_cluster_health: Optional[dict] = None
        self._failures = 0
        self._skip_remaining = 0
        self._backoff_until = 0.0

    def publish(self, report: dict) -> Optional[dict]:
        if (self._skip_remaining > 0
                and self._clock() < self._backoff_until):
            self._skip_remaining -= 1
            return None             # backing off; re-probe after the skips
        try:
            if self.rank != 0:
                self.transport.publish(json.dumps(report).encode())
                self._failures = 0
                self._skip_remaining = 0
                self._backoff_until = 0.0
                return None
            self._window[0] = report
            merged = self.collect_and_emit()
            self._failures = 0
            self._skip_remaining = 0
            self._backoff_until = 0.0
            return merged
        except Exception as e:  # noqa: BLE001 — telemetry must not kill a step
            self._failures += 1
            skips = 0
            if self._failures >= self.MAX_PUBLISH_FAILURES:
                # stop paying the publish cost every cadence, but KEEP
                # re-probing: skipped-publish count doubles per failure
                # past the threshold, capped — a transient blip costs a
                # bounded number of stale windows, never the job
                skips = min(
                    self.BACKOFF_SKIP_CAP,
                    2 ** (self._failures - self.MAX_PUBLISH_FAILURES))
                self._skip_remaining = skips
                self._backoff_until = self._clock() + self.BACKOFF_CAP_S
            obs_log.warning(
                "cluster telemetry publish failed%s" % (
                    " — skipping next %d publish(es)" % skips if skips
                    else ""), error=repr(e)[:200],
                failures=self._failures)
            return None

    def collect_and_emit(self) -> dict:
        for payload in self.transport.drain():
            try:
                rec = json.loads(payload.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            self._window[int(rec.get("rank", -1))] = rec
        # merge ONLY this window's arrivals: a rank that published once
        # and then wedged must drop out of the metrics and read as
        # stale, not have its old window merged as current forever (the
        # straggler diagnostic)
        merged = merge_cluster_reports(list(self._window.values()))
        merged["stale_ranks"] = sorted(
            set(range(self.world)) - set(self._window))
        self._window = {}
        self.last_cluster_report = merged
        self.sink.emit(merged)
        fr = flight.active()
        if fr is not None:
            fr.on_report(merged)
        if self.health is not None:
            hrec = self.health.update(merged)
            self.last_cluster_health = hrec
            self.sink.emit(hrec)
            if fr is not None:
                fr.on_report(hrec)
        return merged

    def close(self) -> None:
        self.sink.close()
