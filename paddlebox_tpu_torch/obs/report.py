"""StepReport: the per-cadence telemetry record and its sinks
(paddlebox_tpu/obs/report.py:1-242, the same record schema).

Every ``every`` steps the trainer assembles one record from the process-wide
StatRegistry and its stage timers: the timers' deltas (ms, calls), the
counters' deltas, the gauges' values, each histogram's bucket deltas with
p50/p90/p99, examples and examples/s over the window, and whatever the
caller adds (the pass_end record's loss, AUC and quality bundles). It goes
to a MetricsSink: a JSONL file, stderr, a list (tests), or nowhere; the
last record is kept either way (``last_report``).

A record describes its window: deltas since the reporter's previous record
(the first one since the registry was last reset or the process began, as
in the reference).

Each assembly also writes the stall watchdog's beat age (``beat_age_s``,
obs/watchdog.py) and samples the device plane's HBM ledger
(obs/device.py ``on_report``) into the gauges it reads, and hands the
record to the active flight recorder (obs/flight.py), then to the
reporter's ``aggregator`` when it has one (obs/aggregate.py: the sharded
trainer's above world 1), which publishes it to rank 0 or, on rank 0,
merges the ranks' records.
"""

from __future__ import annotations

import copy
import json
import sys
import time
from typing import Callable, Dict, List, Optional

from paddlebox_tpu_torch.utils.channel import poll_depth_gauges
from paddlebox_tpu_torch.utils.stats import StatRegistry, hist_percentile

SCHEMA_VERSION = 1


class MetricsSink:
    """Where reports go."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(MetricsSink):
    def emit(self, record: dict) -> None:
        pass


class ListSink(MetricsSink):
    """Keeps the records in memory."""

    def __init__(self) -> None:
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)


class JsonlSink(MetricsSink):
    """One JSON object a line, appended and flushed a record."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StderrSink(MetricsSink):
    def emit(self, record: dict) -> None:
        sys.stderr.write(json.dumps(record) + "\n")


def make_sink(spec: str) -> MetricsSink:
    """'' -> NullSink, 'stderr' -> StderrSink, anything else ->
    JsonlSink(spec)."""
    spec = (spec or "").strip()
    if not spec:
        return NullSink()
    if spec == "stderr":
        return StderrSink()
    return JsonlSink(spec)


class StepReporter:
    """Assembles StepReports at a step cadence. note_examples and
    maybe_report come from one driver thread at a time."""

    def __init__(self, rank: int = 0, every: int = 20,
                 sink: Optional[MetricsSink] = None,
                 timers: Optional[Dict] = None,
                 aggregator=None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.rank = int(rank)
        self.every = int(every)
        self.sink = sink if sink is not None else NullSink()
        self.timers = timers or {}
        self.aggregator = aggregator
        self._clock = clock
        self._registry = StatRegistry.instance()
        self._prev_counters: Dict[str, int] = {}
        self._prev_hists: Dict[str, List[int]] = {}
        self._prev_timers: Dict[str, tuple] = {}
        self._examples = 0
        self._last_step = 0
        self._last_t = clock()
        self.last_report: Optional[dict] = None

    # ------------------------------------------------------------ cadence
    def note_examples(self, n: int) -> None:
        self._examples += int(n)

    def due(self, step: int) -> bool:
        return self.every > 0 and (step - self._last_step) >= self.every

    def maybe_report(self, step: int, extra: Optional[dict] = None,
                     force: bool = False) -> Optional[dict]:
        """Assemble and emit when the cadence is due, or at ``force`` (pass
        boundaries). ``every <= 0`` is off, force included."""
        if self.every <= 0:
            return None
        if not force and not self.due(step):
            return None
        return self._report(step, extra)

    def peek(self) -> Optional[dict]:
        """A deep copy of the last record (the watchdog's dump and the
        exporter's /report); never assembles one."""
        rep = self.last_report
        return copy.deepcopy(rep) if rep is not None else None

    # ----------------------------------------------------------- assembly
    def _report(self, step: int, extra: Optional[dict]) -> dict:
        now = self._clock()
        interval = max(now - self._last_t, 1e-9)
        poll_depth_gauges()
        from paddlebox_tpu_torch.obs import device, flight, watchdog
        w = watchdog.active()
        if w is not None:
            self._registry.set_gauge("beat_age_s", w.beat_age())
        device.on_report()
        snap = self._registry.snapshot_all()

        stats_delta = {}
        for k, v in snap["counters"].items():
            d = v - self._prev_counters.get(k, 0)
            if d:
                stats_delta[k] = d
        hists = {}
        for k, counts in snap["hists"].items():
            prev = self._prev_hists.get(k)
            delta = ([c - p for c, p in zip(counts, prev)] if prev
                     else list(counts))
            n = sum(delta)
            if n <= 0:
                continue
            hists[k] = {
                "count": n,
                "counts": delta,
                "p50": round(hist_percentile(delta, 0.50), 3),
                "p90": round(hist_percentile(delta, 0.90), 3),
                "p99": round(hist_percentile(delta, 0.99), 3),
            }
        timers = {}
        for name, t in self.timers.items():
            ms, calls = t.elapsed_ms(), t.count
            pms, pcalls = self._prev_timers.get(name, (0.0, 0))
            if ms - pms > 1e-6 or calls != pcalls:
                timers[name] = {"ms": round(ms - pms, 3),
                                "calls": calls - pcalls}
            self._prev_timers[name] = (ms, calls)

        record = {
            "type": "step_report",
            "v": SCHEMA_VERSION,
            "ts": time.time(),
            "rank": self.rank,
            "step": int(step),
            "interval_s": round(interval, 6),
            "examples": self._examples,
            "examples_per_sec": round(self._examples / interval, 2),
            "timers": timers,
            "stats": stats_delta,
            "gauges": {k: round(v, 6) for k, v in snap["gauges"].items()},
            "hists": hists,
        }
        if extra:
            record.update(extra)

        self._prev_counters = snap["counters"]
        self._prev_hists = snap["hists"]
        self._examples = 0
        self._last_step = int(step)
        self._last_t = now
        self.last_report = record
        self.sink.emit(record)
        fr = flight.active()
        if fr is not None:
            fr.on_report(record)
        if self.aggregator is not None:
            self.aggregator.publish(record)
        return record

    def close(self) -> None:
        self.sink.close()
        if self.aggregator is not None:
            self.aggregator.close()
