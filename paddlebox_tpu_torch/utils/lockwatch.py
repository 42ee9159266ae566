"""Runtime lock-order validator.

Counterpart of paddlebox_tpu/utils/lockwatch.py. With the switch on, the
port's locks are made through ``make_lock`` / ``make_rlock``, which

  * keep each thread's stack of held locks (thread-local; the registry's
    lock is taken only for a nesting pair seen for the first time),
  * keep the process-wide nesting graph in ``Class._attr`` names (the
    reference's names for the same locks),
  * record an inversion the first time some thread takes B while holding
    A after any thread took A while holding B (the AB/BA deadlock
    precondition, caught without the interleaving that deadlocks), log it
    once a pair and count ``lockwatch_inversions`` in the StatRegistry,
  * observe each hold's microseconds into the histogram
    ``lock_hold_us_<name>`` (dots as underscores).

With it off the factories return plain ``threading.Lock`` / ``RLock``:
the choice is made when a lock is made, and costs an acquire nothing.

The switch is process-wide, as the reference's flag is. Its default is
HostFlags().debug_lock_order (PBTPU_DEBUG_LOCK_ORDER), read once when this
module is imported; ``set_enabled`` changes it for the locks made after
the call (tests do). A lock made before keeps its kind, so set it before
building the objects to watch (a trainer, its table and its planes).

The StatRegistry's own locks are never watched (utils/stats.py): a
release publishes its hold time into the registry, so watching the
registry's lock would recurse.

``assert_consistent()`` raises on any recorded inversion or on a cycle of
three or more locks in the nesting graph; ``order_report()`` lists the
edges.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from paddlebox_tpu_torch.config.flags import HostFlags

__all__ = ["enabled", "set_enabled", "make_lock", "make_rlock", "reset",
           "edges", "inversions", "assert_consistent", "order_report",
           "order_cycles", "current_held"]

_ENABLED = bool(HostFlags().debug_lock_order)


def enabled() -> bool:
    """Whether locks made now are watched."""
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Watch the locks made from now on (or not); returns the previous
    setting."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


class _Watch:
    """The process-wide order graph and inversion record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}  # guarded-by: _lock
        self._inversions: List[dict] = []             # guarded-by: _lock
        self._warned: set = set()                     # guarded-by: _lock
        self._tls = threading.local()
        # every thread's stack, so clear() can empty them all — a foreign
        # release (lock handed across threads) otherwise leaves a phantom
        # "held" entry that fabricates edges forever after
        self._stacks: List[List[Tuple[str, float]]] = []  # guarded-by: _lock

    # ------------------------------------------------------------ tls stack
    def _held(self) -> List[Tuple[str, float]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
            with self._lock:
                self._stacks.append(held)
        return held

    # ------------------------------------------------------------- events
    def on_acquired(self, name: str) -> None:
        held = self._held()
        names = [n for n, _ in held]
        if names and name not in names:   # reentrant re-entry: no edge
            with self._lock:
                for h in names:
                    pair = (h, name)
                    first = pair not in self._edges
                    self._edges[pair] = self._edges.get(pair, 0) + 1
                    if first and (name, h) in self._edges:
                        self._record_inversion_locked(pair)
        held.append((name, time.perf_counter()))

    def on_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                self._observe_hold(name, time.perf_counter() - t0)
                return
        # release of a lock this thread never acquired through the
        # wrapper (e.g. handed across threads) — count it, don't crash
        from paddlebox_tpu_torch.utils.stats import stat_add
        stat_add("lockwatch_foreign_release")

    def _record_inversion_locked(self, pair: Tuple[str, str]) -> None:
        """Record ``pair``'s inversion; the caller holds ``_lock``."""
        key = tuple(sorted(pair))
        self._inversions.append({
            "pair": pair, "thread": threading.current_thread().name,
            "stack_names": [n for n, _ in self._held()]})
        from paddlebox_tpu_torch.utils.stats import stat_add
        stat_add("lockwatch_inversions")
        if key not in self._warned:
            self._warned.add(key)
            try:
                from paddlebox_tpu_torch.obs import log
                log.warning(
                    "LOCK-ORDER INVERSION: %s acquired while holding %s, "
                    "but the opposite nesting was also observed — AB/BA "
                    "deadlock precondition" % (pair[1], pair[0]),
                    thread=threading.current_thread().name)
            except Exception:  # rationale: inversion reporting must never
                # take down the locking it observes; the counter + record
                # above already carry the finding
                pass

    def _observe_hold(self, name: str, secs: float) -> None:
        from paddlebox_tpu_torch.utils.stats import hist_observe
        hist_observe("lock_hold_us_%s" % name.replace(".", "_"),
                     secs * 1e6)

    # -------------------------------------------------------------- queries
    def snapshot_edges(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._edges)

    def snapshot_inversions(self) -> List[dict]:
        with self._lock:
            return list(self._inversions)

    def clear(self) -> None:
        """Test-isolation reset: callers quiesce their threads first —
        emptying a stack out from under a thread mid-critical-section
        would only skew that lock's hold-time sample."""
        with self._lock:
            self._edges.clear()
            self._inversions.clear()
            self._warned.clear()
            for s in self._stacks:
                del s[:]


_WATCH = _Watch()


class _WatchedLock:
    """threading.Lock/RLock wrapper reporting to the watch. Supports the
    full context-manager + acquire/release + ``Condition(lock)`` surface
    for BOTH kinds: the Condition protocol methods (``_is_owned``,
    ``_release_save``, ``_acquire_restore``) are implemented here with
    watch bookkeeping, because hiding the inner RLock's versions would
    make ``Condition(make_rlock(...)).wait`` misbehave exactly and only
    when the debug flag is on — a debug flag must never change
    semantics."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner) -> None:
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _WATCH.on_acquired(self._name)
        return ok

    def release(self) -> None:
        _WATCH.on_released(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # ---- Condition(lock) protocol (threading.Condition duck types) ----
    def _is_owned(self) -> bool:
        inner_io = getattr(self._inner, "_is_owned", None)
        if inner_io is not None:
            return inner_io()
        # plain Lock: Condition's own default probe, mirrored so it
        # rides the INNER lock without fabricating watch events
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        rs = getattr(self._inner, "_release_save", None)
        if rs is None:        # plain Lock: one level, through release()
            self.release()
            return None
        # RLock: full recursive release — pop every held level
        levels = max(1, sum(1 for n, _ in _WATCH._held()
                            if n == self._name))
        state = rs()
        for _ in range(levels):
            _WATCH.on_released(self._name)
        return (state, levels)

    def _acquire_restore(self, state) -> None:
        if state is None:     # plain Lock
            self.acquire()
            return
        inner_state, levels = state
        self._inner._acquire_restore(inner_state)
        for _ in range(levels):
            _WATCH.on_acquired(self._name)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WatchedLock {self._name} {self._inner!r}>"


def make_lock(name: str) -> threading.Lock:
    """A mutex registered under ``name`` (``Class._attr``): a plain
    ``threading.Lock`` while the switch is off."""
    if not enabled():
        return threading.Lock()
    return _WatchedLock(name, threading.Lock())


def make_rlock(name: str) -> threading.RLock:
    """Reentrant variant of :func:`make_lock`. Reentrant re-acquisition
    records no self-edge (the held-stack dedups by name)."""
    if not enabled():
        return threading.RLock()
    return _WatchedLock(name, threading.RLock())


# ----------------------------------------------------------------- queries

def edges() -> Dict[Tuple[str, str], int]:
    """(outer, inner) -> times observed, across all threads so far."""
    return _WATCH.snapshot_edges()


def inversions() -> List[dict]:
    return _WATCH.snapshot_inversions()


def current_held() -> List[str]:
    """Names this thread currently holds (outermost first)."""
    return [n for n, _ in _WATCH._held()]


def reset() -> None:
    """Drop all recorded edges/inversions (test isolation)."""
    _WATCH.clear()


def order_cycles() -> List[List[str]]:
    """Cycles in the observed nesting graph, each as a node list. AB/BA
    pairs surface eagerly as inversions; cycles of length >= 3 (A->B,
    B->C, C->A — every pair individually consistent) only exist in the
    graph view, so the consistency check must walk it: this is the same
    deadlock precondition)."""
    graph: Dict[str, List[str]] = {}
    for (a, b) in _WATCH.snapshot_edges():
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    cycles: List[List[str]] = []
    color: Dict[str, int] = {}   # 0/absent=white, 1=on stack, 2=done

    def dfs(v: str, path: List[str]) -> None:
        color[v] = 1
        path.append(v)
        for w in sorted(graph[v]):
            if color.get(w, 0) == 1:
                cycles.append(path[path.index(w):] + [w])
            elif color.get(w, 0) == 0:
                dfs(w, path)
        path.pop()
        color[v] = 2

    for v in sorted(graph):
        if color.get(v, 0) == 0:
            dfs(v, [])
    return cycles


def assert_consistent() -> None:
    """Raise AssertionError when any AB/BA inversion was observed OR the
    nesting graph contains a cycle (length >= 3 cycles never trip the
    eager pairwise check — see order_cycles)."""
    inv = _WATCH.snapshot_inversions()
    if inv:
        lines = ", ".join("%s after %s (thread %s)"
                          % (i["pair"][1], i["pair"][0], i["thread"])
                          for i in inv[:5])
        raise AssertionError(
            f"lock-order inversions observed ({len(inv)}): {lines}")
    cycles = order_cycles()
    if cycles:
        shown = "; ".join(" -> ".join(c) for c in cycles[:3])
        raise AssertionError(
            f"lock-order cycle(s) observed ({len(cycles)}): {shown}")


def order_report() -> str:
    """The observed nesting edges, one a line, and the counts."""
    es = _WATCH.snapshot_edges()
    lines = [f"{a} -> {b} x{n}" for (a, b), n in sorted(es.items())]
    inv = _WATCH.snapshot_inversions()
    lines.append(f"# {len(es)} edges, {len(inv)} inversions")
    return "\n".join(lines)
