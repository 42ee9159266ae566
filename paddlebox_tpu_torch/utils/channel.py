"""The bounded multi-producer, multi-consumer channel and named queue
depths as StepReport gauges (paddlebox_tpu/utils/channel.py).

``Channel`` is framework::Channel's role: a blocking queue with batched
reads and close-with-drain (a closed channel hands out what it holds,
then raises ChannelClosed). The dataset's reader pool hands its workers
the file list through one (data/dataset.py).

A queue-like object registered under a name (a named Channel registers
itself) is sampled into the gauge ``chan_<name>_depth`` (the sum of the
live objects' ``len``) each time a report is assembled, never per put or
get. A name whose objects are all collected gets one last 0 and is
dropped.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Generic, Iterable, List, Optional, TypeVar

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import gauge_set

T = TypeVar("T")

_named: dict = {}           # gauge name -> weakref.WeakSet of queues
_named_lock = make_lock("channel._named_lock")


def register_depth_gauge(name: str, obj) -> None:
    """Sample ``len(obj)`` (weakly held) into gauge ``chan_<name>_depth``."""
    with _named_lock:
        _named.setdefault("chan_%s_depth" % name,
                          weakref.WeakSet()).add(obj)


def poll_depth_gauges() -> None:
    """Write every registered name's live depth into the stat registry
    (StepReporter calls this once a report)."""
    with _named_lock:
        snap = [(g, list(ws)) for g, ws in _named.items()]
        for g, live in snap:
            if not live:
                del _named[g]
    for gauge_name, live in snap:
        gauge_set(gauge_name, float(sum(len(c) for c in live)))


class ChannelClosed(Exception):
    pass


class Channel(Generic[T]):
    """``capacity`` 0: unbounded; else ``put`` blocks while the channel
    holds that many items. ``name``: registers its depth gauge."""

    def __init__(self, capacity: int = 0, name: str = "") -> None:
        self._capacity = int(capacity)
        self._deque: collections.deque = collections.deque()
        self._mutex = make_lock("Channel._mutex")
        self._not_empty = threading.Condition(self._mutex)
        self._not_full = threading.Condition(self._mutex)
        self._closed = False
        if name:
            register_depth_gauge(name, self)

    def put(self, item: T) -> None:
        with self._mutex:
            while (not self._closed and self._capacity
                   and len(self._deque) >= self._capacity):
                self._not_full.wait()
            if self._closed:
                raise ChannelClosed("put on closed channel")
            self._deque.append(item)
            self._not_empty.notify()

    def put_many(self, items: Iterable[T]) -> None:
        for it in items:
            self.put(it)

    def close(self) -> None:
        """Refuse further puts; readers drain what is held, then get
        ChannelClosed."""
        with self._mutex:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def get(self, timeout: Optional[float] = None) -> T:
        """Blocking pop; ChannelClosed once closed and drained,
        TimeoutError after ``timeout`` seconds with nothing to pop."""
        with self._mutex:
            while not self._deque:
                if self._closed:
                    raise ChannelClosed("channel closed and drained")
                if not self._not_empty.wait(timeout):
                    raise TimeoutError("channel get timed out")
            item = self._deque.popleft()
            self._not_full.notify()
            return item

    def get_many(self, max_items: int) -> List[T]:
        """Pop 1 to ``max_items`` items (blocking for the first);
        ChannelClosed once closed and drained."""
        out: List[T] = []
        with self._mutex:
            while not self._deque:
                if self._closed:
                    raise ChannelClosed("channel closed and drained")
                self._not_empty.wait()
            while self._deque and len(out) < max_items:
                out.append(self._deque.popleft())
            self._not_full.notify_all()
        return out

    def drain(self) -> List[T]:
        """Pop everything held now, without blocking."""
        with self._mutex:
            out = list(self._deque)
            self._deque.clear()
            self._not_full.notify_all()
            return out

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except ChannelClosed:
                return

    def __len__(self) -> int:
        with self._mutex:
            return len(self._deque)

    @property
    def closed(self) -> bool:
        with self._mutex:
            return self._closed
