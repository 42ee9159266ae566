"""The flight recorder: an always-on, bounded, on-disk black box of one
rank (paddlebox_tpu/obs/flight.py, the same record and manifest schema).

Records go as flushed JSONL lines into segment files under
``ObsFlags.obs_flight_dir`` (``flight_r<rank>_NNNN.jsonl``), rotated at
``obs_flight_segment_bytes`` with at most ``obs_flight_segments`` kept, the
oldest deleted; each segment opens with a header (flags, env, git sha,
argv), so any surviving one names its run. The records: every StepReport
and the span window that produced it, the warning and error log lines
(obs/log.py forwards them), and the watchdog beats, sampled at most one a
``beat_secs``.

``seal`` writes the SEALED manifest: the reason, the exception, the last
spans, every thread's stack, the last reports, the log tail, the segment
list and the device plane's snapshot (obs/device.py). The crash hooks seal
on ``sys.excepthook`` and on SIGABRT / SIGTERM (then re-deliver), and
enable faulthandler into ``fatal_r<rank>.txt``; the watchdog seals when it
fires. Nothing here raises into the run it records: a full disk closes the
recorder.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import IO, List, Optional

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.utils.lockwatch import make_rlock

SCHEMA_VERSION = 1

#: SEALED manifests kept a rank: later seals get numbered siblings, so a
#: watchdog seal cannot mask the crash that follows it
MAX_SEALS = 4

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _git_sha() -> str:
    """HEAD of the checkout this package lies in, read from its ``.git``
    (no subprocess); '' when there is none."""
    git = os.path.join(_REPO, ".git")
    try:
        with open(os.path.join(git, "HEAD")) as fh:
            head = fh.read().strip()
        if not head.startswith("ref:"):
            return head[:40]
        ref = head.split(None, 1)[1]
        ref_path = os.path.join(git, ref)
        if os.path.exists(ref_path):
            with open(ref_path) as fh:
                return fh.read().strip()[:40]
        packed = os.path.join(git, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as fh:
                for ln in fh:
                    if ln.strip().endswith(ref):
                        return ln.split()[0][:40]
    except (OSError, IndexError):
        return ""
    return ""


def _thread_stacks() -> dict:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        out["%s/%d" % (names.get(tid, "?"), tid)] = [
            ln.rstrip() for entry in traceback.format_stack(frame)
            for ln in entry.splitlines()]
    return out


def _trace_hex(trace) -> Optional[str]:
    return ("0x%016x" % (trace & (2**64 - 1))) if trace is not None else None


class FlightRecorder:
    """One rank's black box; every method may be called from any thread
    (one reentrant lock around the file, so a fatal-signal seal that
    interrupted a record cannot deadlock)."""

    def __init__(self, flight_dir: str, rank: int = 0,
                 segment_bytes: int = 4 << 20, max_segments: int = 4,
                 beat_secs: float = 1.0, last_k_spans: int = 96,
                 flags: Optional[ObsFlags] = None) -> None:
        self.dir = flight_dir
        self.rank = int(rank)
        self.segment_bytes = int(segment_bytes)
        self.max_segments = max(1, int(max_segments))
        self.beat_secs = float(beat_secs)
        self.last_k_spans = int(last_k_spans)
        self._flags = dataclasses.asdict(flags or ObsFlags())
        self._lock = make_rlock("FlightRecorder._lock")
        self._fh: Optional[IO[str]] = None
        self._seg_idx = 0
        self._seg_bytes = 0
        self._seals = 0
        self._closed = False
        # the beat gate: one float store, read without the lock
        self._last_beat_rec = 0.0
        self._last_reports: deque = deque(maxlen=3)
        self._log_tail: deque = deque(maxlen=64)
        self._last_span_t = 0.0
        os.makedirs(self.dir, exist_ok=True)
        self._open_segment(0)

    # ------------------------------------------------------------ segments
    def _seg_path(self, idx: int) -> str:
        return os.path.join(self.dir,
                            "flight_r%d_%04d.jsonl" % (self.rank, idx))

    def header(self) -> dict:
        return {"type": "header", "v": SCHEMA_VERSION, "ts": time.time(),
                "rank": self.rank, "pid": os.getpid(),
                "argv": list(sys.argv), "python": sys.version.split()[0],
                "git_sha": _git_sha(), "flags": dict(self._flags),
                "env": {k: v for k, v in sorted(os.environ.items())
                        if k.startswith("PBTPU_")
                        or k == "CUDA_VISIBLE_DEVICES"}}

    def _open_segment(self, idx: int) -> None:
        # the header is written directly: a header larger than the bound
        # must not recurse into rotation
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
            self._seg_idx = idx
            self._fh = open(self._seg_path(idx), "a", encoding="utf-8")
            self._seg_bytes = self._fh.tell()
            drop = self._seg_path(idx - self.max_segments)
            if os.path.exists(drop):
                try:
                    os.unlink(drop)
                except OSError:
                    pass
            try:
                line = json.dumps(self.header(), default=repr) + "\n"
                self._fh.write(line)
                self._fh.flush()
                self._seg_bytes += len(line.encode("utf-8"))
            except (OSError, TypeError, ValueError):
                pass

    def segments(self) -> List[str]:
        with self._lock:
            lo = max(0, self._seg_idx - self.max_segments + 1)
            return [self._seg_path(i) for i in range(lo, self._seg_idx + 1)
                    if os.path.exists(self._seg_path(i))]

    # ------------------------------------------------------------- records
    def record(self, rtype: str, **fields) -> None:
        """Append one flushed line; rotate past the byte bound (encoded
        bytes). Never raises."""
        rec = {"type": rtype, "v": SCHEMA_VERSION, "ts": time.time(),
               "rank": self.rank}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=repr) + "\n"
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._closed or self._fh is None:
                return
            try:
                self._fh.write(line)
                self._fh.flush()
            except (OSError, ValueError):
                return
            self._seg_bytes += len(line.encode("utf-8"))
            if self._seg_bytes >= self.segment_bytes:
                try:
                    self._open_segment(self._seg_idx + 1)
                except OSError:
                    self._closed = True

    def on_report(self, report: dict) -> None:
        """A StepReport, recorded as it is, then the span window."""
        with self._lock:
            if report.get("type") == "step_report":
                self._last_reports.append(report)
        self.record("report", report=report)
        self._record_span_window()

    def _record_span_window(self) -> None:
        """The spans that ended since the last window (at most 256)."""
        from paddlebox_tpu_torch.obs.tracer import get_tracer
        with self._lock:
            cut = self._last_span_t
            spans = [s for s in get_tracer().all_spans() if s[4] > cut]
            if not spans:
                return
            self._last_span_t = max(s[4] for s in spans)
        spans = spans[-256:]
        self.record("spans", n=len(spans), spans=[
            [name, tid, round(t0, 6), round((t1 - t0) * 1e3, 3),
             _trace_hex(trace)]
            for name, tid, _tname, t0, t1, trace in spans])

    def on_log(self, level: str, line: str) -> None:
        with self._lock:
            self._log_tail.append((time.time(), level, line))
        self.record("log", level=level, line=line[:2000])

    def on_beat(self, label: str) -> None:
        """Sampled: one beat record a ``beat_secs`` at most."""
        now = time.monotonic()
        if now - self._last_beat_rec < self.beat_secs:
            return
        self._last_beat_rec = now
        self.record("beat", label=label)

    # --------------------------------------------------------------- seal
    def seal(self, reason: str, exc: Optional[BaseException] = None,
             extra_text: Optional[str] = None) -> Optional[str]:
        """Write the SEALED manifest (``SEALED_r<rank>.json``, then
        ``SEALED_r<rank>.<n>.json``); its path, or None past MAX_SEALS or on
        an unwritable directory."""
        from paddlebox_tpu_torch.obs.tracer import get_tracer
        with self._lock:
            if self._seals >= MAX_SEALS:
                return None
            self._seals += 1
            n = self._seals
            last_reports = list(self._last_reports)
            log_tail = [{"ts": t, "level": lv, "line": ln}
                        for t, lv, ln in self._log_tail]
        spans = get_tracer().last_spans(self.last_k_spans)
        manifest = {
            "type": "sealed", "v": SCHEMA_VERSION, "ts": time.time(),
            "rank": self.rank, "pid": os.getpid(), "reason": reason,
            "seal_index": n,
            "exception": ("".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-8000:]
                if exc is not None else None),
            "spans": [[name, tid, tname, round(t0, 6),
                       round((t1 - t0) * 1e3, 3), _trace_hex(trace)]
                      for name, tid, tname, t0, t1, trace in spans],
            "threads": _thread_stacks(),
            "last_reports": last_reports,
            "log_tail": log_tail,
            "segments": [os.path.basename(p) for p in self.segments()],
            "header": self.header(),
        }
        try:
            from paddlebox_tpu_torch.obs import device as _device
            manifest["device"] = _device.snapshot()
        except Exception:  # noqa: BLE001 (a seal never raises)
            manifest["device"] = None
        if extra_text:
            manifest["extra_text"] = extra_text[-8000:]
        self.record("sealed", reason=reason, seal_index=n)
        path = os.path.join(
            self.dir, "SEALED_r%d.json" % self.rank if n == 1
            else "SEALED_r%d.%d.json" % (self.rank, n))
        try:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(manifest, fh, default=repr)
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            return None
        return path

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# ------------------------------------------------------------- module API
_ACTIVE: Optional[FlightRecorder] = None
_HOOKS_INSTALLED = False
_FATAL_FH: Optional[IO[str]] = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def set_active(fr: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, fr
    return prev


def on_beat(label: str) -> None:
    fr = _ACTIVE
    if fr is not None:
        fr.on_beat(label)


def seal_active(reason: str, exc: Optional[BaseException] = None,
                extra_text: Optional[str] = None) -> Optional[str]:
    fr = _ACTIVE
    if fr is None:
        return None
    try:
        return fr.seal(reason, exc=exc, extra_text=extra_text)
    except Exception:  # noqa: BLE001 (a seal never raises)
        return None


def _excepthook(exc_type, exc, tb):
    seal_active("excepthook:%s" % getattr(exc_type, "__name__", "?"),
                exc=exc)
    _PREV_EXCEPTHOOK(exc_type, exc, tb)


def _thread_excepthook(args):
    # a dead worker thread is evidence, not a process death: recorded, not
    # sealed (the watchdog seals if the run then wedges)
    fr = _ACTIVE
    if fr is not None:
        fr.on_log("ERROR", "uncaught in thread %r: %s" % (
            getattr(args.thread, "name", "?"),
            "".join(traceback.format_exception(
                args.exc_type, args.exc_value, args.exc_traceback))[-2000:]))
    _PREV_THREADHOOK(args)


def _signal_handler(signum, frame):
    name = signal.Signals(signum).name
    seal_active("signal:%s" % name)
    # restore what was there and re-deliver: the exit is the one without
    # the recorder
    prev = _PREV_SIGNAL.get(signum, signal.SIG_DFL)
    signal.signal(signum, prev if callable(prev) or prev in (
        signal.SIG_DFL, signal.SIG_IGN) else signal.SIG_DFL)
    os.kill(os.getpid(), signum)


_PREV_EXCEPTHOOK = sys.excepthook
_PREV_THREADHOOK = threading.excepthook
_PREV_SIGNAL: dict = {}


def install_crash_hooks(fr: FlightRecorder) -> None:
    """Chain sys.excepthook and threading.excepthook, enable faulthandler
    into ``fatal_r<rank>.txt`` and, from the main thread, handle SIGABRT
    and SIGTERM (seal, then re-deliver). The hooks read the active
    recorder when they fire, so they are installed once."""
    global _HOOKS_INSTALLED, _PREV_EXCEPTHOOK, _PREV_THREADHOOK, _FATAL_FH
    try:
        import faulthandler
        fh = open(os.path.join(fr.dir, "fatal_r%d.txt" % fr.rank), "w",
                  encoding="utf-8")
        faulthandler.enable(file=fh, all_threads=True)
        prev, _FATAL_FH = _FATAL_FH, fh   # the C handler keeps the fd
        if prev is not None:
            try:
                prev.close()
            except OSError:
                pass
    except (OSError, RuntimeError):
        pass
    if _HOOKS_INSTALLED:
        return
    _PREV_EXCEPTHOOK = sys.excepthook
    sys.excepthook = _excepthook
    _PREV_THREADHOOK = threading.excepthook
    threading.excepthook = _thread_excepthook
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGABRT, signal.SIGTERM):
            try:
                _PREV_SIGNAL[sig] = signal.signal(sig, _signal_handler)
            except (OSError, ValueError):
                pass
    _HOOKS_INSTALLED = True


def ensure_from_flags(flags: Optional[ObsFlags] = None,
                      rank: int = 0) -> Optional[FlightRecorder]:
    """The recorder ``flags.obs_flight_dir`` asks for ('' closes and clears
    the active one); the same directory and rank reuse it. An unusable
    directory warns and leaves the recorder off."""
    global _ACTIVE
    flags = flags or ObsFlags()
    d = str(flags.obs_flight_dir).strip()
    if not d:
        if _ACTIVE is not None:
            _ACTIVE.close()
            _ACTIVE = None
        return None
    if (_ACTIVE is not None and _ACTIVE.dir == d
            and _ACTIVE.rank == int(rank)):
        return _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.close()
        _ACTIVE = None
    try:
        fr = FlightRecorder(d, rank=rank,
                            segment_bytes=flags.obs_flight_segment_bytes,
                            max_segments=flags.obs_flight_segments,
                            flags=flags)
    except OSError as e:
        from paddlebox_tpu_torch.obs import log as obs_log
        obs_log.warning("flight recorder disabled: dir unusable", dir=d,
                        error=repr(e)[:200])
        return None
    install_crash_hooks(fr)
    _ACTIVE = fr
    return fr
