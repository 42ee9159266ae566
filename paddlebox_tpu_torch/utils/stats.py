"""Named stat registry: counters, gauges and fixed-bucket histograms.

Counterpart of paddlebox_tpu/utils/stats.py:1-179 (the platform::Monitor /
StatRegistry role): the same names, the same bucket bounds and the same
process-wide instance, so a report of a port run reads as a reference run's
does. Thread-safe under one lock.

  * counters: int64 running totals (``stat_add``); a StepReport ships their
    deltas;
  * gauges: last-written floats (``gauge_set``); a report ships the value;
  * histograms: counts over FIXED power-of-two buckets (``HIST_BOUNDS``),
    so windows and processes merge by an elementwise sum.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence

# bucket upper bounds (inclusive): 2^0 .. 2^25, plus an implicit +inf
# overflow bucket
HIST_BOUNDS: Sequence[float] = tuple(float(2 ** i) for i in range(26))


def new_hist_counts() -> List[int]:
    return [0] * (len(HIST_BOUNDS) + 1)


def hist_percentile(counts: Sequence[int], q: float) -> float:
    """Percentile estimate from fixed-bucket counts (q in [0, 1]): linear
    interpolation inside the bucket where the cumulative count crosses
    q * total; the overflow bucket reports its lower bound. 0.0 for an
    empty histogram."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= target:
            lo = HIST_BOUNDS[i - 1] if i > 0 else 0.0
            if i >= len(HIST_BOUNDS):       # overflow bucket: saturate
                return HIST_BOUNDS[-1]
            hi = HIST_BOUNDS[i]
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return HIST_BOUNDS[-1]


class StatRegistry:
    _instance: Optional["StatRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[int]] = {}

    @classmethod
    def instance(cls) -> "StatRegistry":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    # ------------------------------------------------------------- counters
    def add(self, name: str, value: int) -> int:
        with self._lock:
            cur = self._stats.get(name, 0) + int(value)
            self._stats[name] = cur
            return cur

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._stats[name] = int(value)

    def get(self, name: str) -> int:
        with self._lock:
            return self._stats.get(name, 0)

    def peek(self, name: str) -> int:
        """Counter read without the lock (a signal handler's read: dict.get
        of an int is atomic under the interpreter lock)."""
        return self._stats.get(name, 0)

    # --------------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    # ----------------------------------------------------------- histograms
    def observe(self, name: str, value: float) -> None:
        """One sample into the named fixed-bucket histogram."""
        idx = bisect.bisect_left(HIST_BOUNDS, float(value))
        with self._lock:
            counts = self._hists.get(name)
            if counts is None:
                counts = new_hist_counts()
                self._hists[name] = counts
            counts[idx] += 1

    def hist_counts(self, name: str) -> Optional[List[int]]:
        with self._lock:
            counts = self._hists.get(name)
            return list(counts) if counts is not None else None

    # ------------------------------------------------------------ lifecycle
    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._stats.clear()
                self._gauges.clear()
                self._hists.clear()
            else:
                self._stats.pop(name, None)
                self._gauges.pop(name, None)
                self._hists.pop(name, None)

    def snapshot(self) -> Dict[str, int]:
        """The counters."""
        with self._lock:
            return dict(self._stats)

    def snapshot_all(self) -> Dict[str, dict]:
        """Every kind under one lock hold: {"counters", "gauges",
        "hists"} (what a StepReport is assembled from)."""
        with self._lock:
            return {"counters": dict(self._stats),
                    "gauges": dict(self._gauges),
                    "hists": {k: list(v) for k, v in self._hists.items()}}


def stat_add(name: str, value: int = 1) -> int:
    return StatRegistry.instance().add(name, value)


def stat_get(name: str) -> int:
    return StatRegistry.instance().get(name)


def stat_peek(name: str) -> int:
    return StatRegistry.instance().peek(name)


def stat_reset(name: Optional[str] = None) -> None:
    StatRegistry.instance().reset(name)


def gauge_set(name: str, value: float) -> None:
    StatRegistry.instance().set_gauge(name, value)


def gauge_get(name: str, default: float = 0.0) -> float:
    return StatRegistry.instance().get_gauge(name, default)


def hist_observe(name: str, value: float) -> None:
    StatRegistry.instance().observe(name, value)
