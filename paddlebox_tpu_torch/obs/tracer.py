"""Span tracer: per-thread rings of named spans, exported as chrome-tracing
JSON (paddlebox_tpu/obs/tracer.py:66-336, the platform::RecordEvent role).

A span is one perf_counter pair appended to the calling thread's own ring
(no lock on the record path); each ring keeps its thread's last
``capacity`` spans. ``export_chrome`` writes the reference's document:
complete ("X") events in microseconds since this module's import, thread
name metadata, the wall-clock origin and, for a span recorded under a trace
id, the id as a hex string. With the tracer disabled ``span`` returns one
shared no-op.

Trace ids are the reference's per-step ids: ``step_trace_id(rank, step)``
puts the rank in the high 16 bits, and ``trace_ctx`` / ``set_trace`` set
the calling thread's current id.

The reference opens a jax TraceAnnotation beside each span while a profile
runs (``set_jax_annotation``); here ``set_annotation(factory)`` takes any
callable of the span's name that returns a context manager, such as
``torch.profiler.record_function``. None (the default) keeps spans in the
rings only.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.utils.lockwatch import make_rlock

# chrome ts fields are microseconds since _EPOCH; _EPOCH_UNIX is the same
# instant on the wall clock
_EPOCH = time.perf_counter()
_EPOCH_UNIX = time.time()

_ANNOTATE: Optional[Callable] = None


def set_annotation(factory: Optional[Callable]) -> None:
    """Open ``factory(name)`` around every span from now on (None: off)."""
    global _ANNOTATE
    _ANNOTATE = factory


# ------------------------------------------------------------- trace ids
_TRACE_CTX = threading.local()
# request ids (the serving client's pulls): a counter under a 15-bit salt
# of the pid mixed with random bytes, so two processes whose pids agree
# mod 2^15 do not mint the same sequence
_NEXT_REQ = itertools.count(1)
_REQ_SALT = ((os.getpid() ^ (os.getpid() >> 15)
              ^ int.from_bytes(os.urandom(2), "little")) & 0x7FFF)


def step_trace_id(rank: int, step: int) -> int:
    """Per-step 64-bit id: the rank in the high 16 bits, the step below."""
    return ((int(rank) & 0xFFFF) << 48) | (int(step) & 0xFFFFFFFFFFFF)


def next_trace_id() -> int:
    """Per-request 64-bit id for planes without a step counter: bit 63
    set (so it never equals a ``step_trace_id``), the process's salt in
    bits 48-62 and a counter below."""
    return ((1 << 63) | (_REQ_SALT << 48)
            | (next(_NEXT_REQ) & 0xFFFFFFFFFFFF))


def current_trace() -> Optional[int]:
    return getattr(_TRACE_CTX, "id", None)


def set_trace(trace: Optional[int]) -> Optional[int]:
    """Set this thread's current trace id; returns the previous one."""
    prev = getattr(_TRACE_CTX, "id", None)
    _TRACE_CTX.id = trace
    return prev


class trace_ctx:
    """``with trace_ctx(tid): ...``: spans inside carry ``tid``."""

    __slots__ = ("_id", "_prev")

    def __init__(self, trace: Optional[int]) -> None:
        self._id = trace

    def __enter__(self):
        self._prev = set_trace(self._id)
        return self._id

    def __exit__(self, *exc):
        set_trace(self._prev)
        return False


Span = Tuple[str, float, float, Optional[int]]


class _ThreadRing:
    """One thread's ring; only that thread writes it, readers take a
    best-effort snapshot."""

    __slots__ = ("buf", "idx", "cap", "tid", "tname", "owner")

    def __init__(self, cap: int, tid: int, tname: str, owner) -> None:
        self.buf: List[Optional[Span]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.tid = tid
        self.tname = tname
        self.owner = owner      # weakref to the owning thread

    def record(self, name: str, t0: float, t1: float,
               trace: Optional[int] = None) -> None:
        i = self.idx
        self.buf[i % self.cap] = (name, t0, t1, trace)
        self.idx = i + 1

    def spans(self) -> List[Span]:
        """The live slots, oldest first."""
        i, cap = self.idx, self.cap
        if i <= cap:
            out = self.buf[:i]
        else:
            cut = i % cap
            out = self.buf[cut:] + self.buf[:cut]
        return [s for s in out if s is not None]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str) -> None:
        self._tr = tracer
        self.name = name

    def __enter__(self):
        ann = _ANNOTATE
        if ann is not None:
            self._ann = ann(self.name)
            self._ann.__enter__()
        else:
            self._ann = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tr._ring().record(self.name, self.t0, t1,
                                getattr(_TRACE_CTX, "id", None))
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class SpanTracer:
    """The per-thread rings and their chrome export."""

    # rings of finished threads kept (newest first) so an export after a
    # pass still shows its stager's spans; older ones are pruned when a new
    # thread registers
    MAX_DEAD_RINGS = 32

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = int(capacity)
        self.enabled = True
        self._rings: List[_ThreadRing] = []
        self._reg_lock = make_rlock("SpanTracer._reg_lock")
        self._local = threading.local()

    def _ring(self) -> _ThreadRing:
        r = getattr(self._local, "ring", None)
        if r is None:
            t = threading.current_thread()
            r = _ThreadRing(self.capacity, t.ident or 0, t.name,
                            weakref.ref(t))
            self._local.ring = r
            with self._reg_lock:
                dead = [x for x in self._rings
                        if (th := x.owner()) is None or not th.is_alive()]
                if len(dead) > self.MAX_DEAD_RINGS:
                    drop = {id(x) for x in dead[:-self.MAX_DEAD_RINGS]}
                    self._rings = [x for x in self._rings
                                   if id(x) not in drop]
                self._rings.append(r)
        return r

    def span(self, name: str):
        """Context manager timing one named region on this thread."""
        if not self.enabled:
            return _NULL
        return _Span(self, name)

    def record_span(self, name: str, t0: float, t1: float,
                    trace: Optional[int] = None) -> None:
        """A span from perf_counter stamps the caller took; an explicit
        ``trace`` wins over this thread's current one."""
        if self.enabled:
            if trace is None:
                trace = getattr(_TRACE_CTX, "id", None)
            self._ring().record(name, t0, t1, trace)

    def clear(self) -> None:
        with self._reg_lock:
            self._rings = []
        # each thread registers a fresh ring at its next span
        self._local = threading.local()

    # ------------------------------------------------------------- readers
    def all_spans(self) -> List[Tuple[str, int, str, float, float,
                                      Optional[int]]]:
        """(name, tid, thread_name, t0, t1, trace) of every thread, by t0."""
        with self._reg_lock:
            rings = list(self._rings)
        out = []
        for r in rings:
            for name, t0, t1, trace in r.spans():
                out.append((name, r.tid, r.tname, t0, t1, trace))
        out.sort(key=lambda s: s[3])
        return out

    def last_spans(self, k: int = 64) -> List[Tuple[str, int, str, float,
                                                    float, Optional[int]]]:
        """The ``k`` spans that started last, oldest first."""
        return self.all_spans()[-k:]

    def export_chrome(self, path: Optional[str] = None, pid: int = 0,
                      meta: Optional[Dict] = None) -> dict:
        """The chrome-tracing document (Perfetto, chrome://tracing); also
        written to ``path`` when given."""
        events = []
        seen_tids = set()
        for name, tid, tname, t0, t1, trace in self.all_spans():
            if tid not in seen_tids:
                seen_tids.add(tid)
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tid, "args": {"name": tname}})
            ev = {"ph": "X", "cat": "obs", "name": name, "pid": pid,
                  "tid": tid, "ts": round((t0 - _EPOCH) * 1e6, 3),
                  "dur": round((t1 - t0) * 1e6, 3)}
            if trace is not None:
                # a hex string: 64-bit ids exceed what JSON numbers carry
                ev["args"] = {"trace": "0x%016x" % (trace & (2**64 - 1))}
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"rank": pid,
                            "clock_origin_unix_s": _EPOCH_UNIX}}
        if meta:
            doc["metadata"].update(dict(meta))
        if path:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
        return doc


# ---------------------------------------------------------------- module API
_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


def span(name: str):
    """``with span("host_stage"): ...``; a shared no-op when disabled."""
    if not _TRACER.enabled:
        return _NULL
    return _Span(_TRACER, name)


def record_span(name: str, t0: float, t1: float,
                trace: Optional[int] = None) -> None:
    _TRACER.record_span(name, t0, t1, trace)


def configure(enabled: bool, capacity: int) -> None:
    """Set the module tracer from ObsFlags' obs_trace and
    obs_trace_capacity (the reference's configure_from_flags): a new
    capacity clears the rings."""
    _TRACER.enabled = bool(enabled)
    cap = int(capacity)
    if cap > 0 and cap != _TRACER.capacity:
        _TRACER.capacity = cap
        _TRACER.clear()


def configure_from_flags(flags=None) -> None:
    """``configure`` from an ObsFlags (None: ObsFlags(), which reads the
    PBTPU_ environment)."""
    if flags is None:
        from paddlebox_tpu_torch.config.flags import ObsFlags
        flags = ObsFlags()
    configure(flags.obs_trace, flags.obs_trace_capacity)
