"""The stall watchdog: a heartbeat thread that turns a silent hang into a
report (paddlebox_tpu/obs/watchdog.py).

The trainer beats at its chunk boundaries (``beat("scan_chunk")`` in
train/trainer.py ``run_scan_chunks``, one monotonic read and one tuple
store) and the streaming runner at each micro-pass. A daemon thread checks
the age of the last beat; past ``ObsFlags.obs_watchdog_secs`` it writes to
stderr the last beat's label and age, the last spans, every thread's stack
and the last StepReport, once a silence, and seals the flight recorder
with the dump. With ``obs_watchdog_action='raise'`` it then interrupts the
main thread.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.obs import flight as _flight


class StallWatchdog:
    def __init__(self, threshold_s: float, action: str = "dump",
                 tracer=None, report_fn: Optional[Callable] = None,
                 on_stall: Optional[Callable[[str], None]] = None,
                 stream=None, poll_interval: Optional[float] = None,
                 last_k_spans: int = 48) -> None:
        if action not in ("dump", "raise"):
            raise ValueError("watchdog action must be 'dump' or 'raise', "
                             "got %r" % (action,))
        self.threshold_s = float(threshold_s)
        self.action = action
        self.tracer = tracer
        self.report_fn = report_fn
        self.on_stall = on_stall
        self.stream = stream
        self.last_k_spans = int(last_k_spans)
        self._poll = poll_interval or max(0.05, min(1.0,
                                                    self.threshold_s / 4.0))
        # (monotonic, label), swapped as one tuple: beat() takes no lock
        self._beat = (time.monotonic(), "start")
        self._fired_at: Optional[tuple] = None
        self.fires = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, label: str) -> None:
        self._beat = (time.monotonic(), label)

    def beat_age(self) -> float:
        return max(0.0, time.monotonic() - self._beat[0])

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pbtpu-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self._poll + 1.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            beat = self._beat
            age = time.monotonic() - beat[0]
            if age < self.threshold_s or self._fired_at == beat:
                continue
            self._fired_at = beat      # once a silence window
            self.fire(beat[1], age)

    def render_dump(self, label: str, age: float) -> str:
        lines: List[str] = ["=" * 72]
        lines.append("PBTPU STALL WATCHDOG: no progress beat for %.1fs "
                     "(threshold %.1fs); last beat: %r"
                     % (age, self.threshold_s, label))
        if self.tracer is not None:
            lines.append("-- last %d spans (most recent last) --"
                         % self.last_k_spans)
            for name, tid, tname, t0, t1, trace in self.tracer.last_spans(
                    self.last_k_spans):
                lines.append("  %-28s %10.3fms  [%s/%d]%s"
                             % (name, (t1 - t0) * 1e3, tname, tid,
                                " trace=0x%x" % trace
                                if trace is not None else ""))
        lines.append("-- per-thread stacks --")
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            lines.append("  thread %s (%d):" % (names.get(tid, "?"), tid))
            for entry in traceback.format_stack(frame):
                lines.extend("    " + ln
                             for ln in entry.rstrip().splitlines())
        if self.report_fn is not None:
            try:
                rep = self.report_fn()
            except Exception as e:  # noqa: BLE001 (the dump must not die)
                rep = {"report_error": repr(e)[:200]}
            if rep is not None:
                lines.append("-- last StepReport --")
                lines.append("  " + json.dumps(rep, default=repr))
        lines.append("=" * 72)
        return "\n".join(lines)

    def fire(self, label: str, age: float) -> None:
        self.fires += 1
        text = self.render_dump(label, age)
        stream = self.stream or sys.stderr
        try:
            stream.write(text + "\n")
            stream.flush()
        except (OSError, ValueError):
            pass
        # the process may not survive the stall: the black box keeps it
        _flight.seal_active("watchdog_stall:%s" % label, extra_text=text)
        if self.on_stall is not None:
            self.on_stall(text)
        if self.action == "raise":
            import _thread
            _thread.interrupt_main()


# ------------------------------------------------------------- module API
_ACTIVE: Optional[StallWatchdog] = None


def active() -> Optional[StallWatchdog]:
    return _ACTIVE


def set_active(w: Optional[StallWatchdog]) -> Optional[StallWatchdog]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, w
    return prev


def beat(label: str) -> None:
    """A progress mark: two global reads when neither the watchdog nor the
    flight recorder runs."""
    w = _ACTIVE
    if w is not None:
        w.beat(label)
    fr = _flight._ACTIVE
    if fr is not None:
        fr.on_beat(label)


def ensure_from_flags(tracer=None, report_fn=None,
                      flags: Optional[ObsFlags] = None
                      ) -> Optional[StallWatchdog]:
    """Start, once, the watchdog ``flags.obs_watchdog_secs`` asks for
    (<= 0: none started; one already running stays). A later caller
    refreshes the report function, so the dump shows the live trainer's
    last report."""
    global _ACTIVE
    flags = flags or ObsFlags()
    secs = float(flags.obs_watchdog_secs)
    if secs <= 0:
        return _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = StallWatchdog(secs, action=flags.obs_watchdog_action,
                                tracer=tracer, report_fn=report_fn).start()
    elif report_fn is not None:
        _ACTIVE.report_fn = report_fn
    return _ACTIVE
