"""Accumulating stopwatch (paddlebox_tpu/utils/timer.py, the
platform::Timer role): start/pause add into a running total and count the
closed intervals, which a StepReport's timer deltas read
(``elapsed_ms``, ``count``); ``TimerScope`` times a ``with`` block."""

from __future__ import annotations

import time


class Timer:
    __slots__ = ("_start", "_elapsed", "_count", "_running")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._start = 0.0
        self._elapsed = 0.0
        self._count = 0
        self._running = False

    def start(self) -> None:
        if not self._running:
            self._start = time.perf_counter()
            self._running = True

    def pause(self) -> None:
        if self._running:
            self._elapsed += time.perf_counter() - self._start
            self._count += 1
            self._running = False

    def resume(self) -> None:
        self.start()

    @property
    def count(self) -> int:
        return self._count

    def elapsed_sec(self) -> float:
        extra = (time.perf_counter() - self._start) if self._running else 0.0
        return self._elapsed + extra

    def elapsed_ms(self) -> float:
        return self.elapsed_sec() * 1e3

    def elapsed_us(self) -> float:
        return self.elapsed_sec() * 1e6

    def __repr__(self) -> str:
        return "Timer(elapsed=%.6fs, count=%d)" % (self.elapsed_sec(),
                                                   self._count)


class TimerScope:
    """``with TimerScope(t): ...`` starts ``t`` and pauses it at the
    block's end."""

    __slots__ = ("_timer",)

    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self) -> Timer:
        self._timer.start()
        return self._timer

    def __exit__(self, *exc) -> None:
        self._timer.pause()
