"""The elastic heartbeat manager (a copy of paddlebox_tpu/fleet/elastic.py).

The skeleton of python/paddle/distributed/fleet/elastic/manager.py: each
rank adds one to its store counter ``elastic/hb/<rank>`` every
``heartbeat_interval`` seconds; a watcher thread reads the other ranks'
counters and judges a peer dead when its counter has not moved for
``stale_after`` seconds on the watcher's own monotonic clock (no time is
compared across hosts, so clock skew cannot fake a death). It then keeps
the dead ranks, calls ``on_fault(dead)`` and stops watching, while the
heartbeat goes on. ``check()``, at a pass boundary, raises DeadRankError:
train/recovery.py RecoverableRunner calls it before every pass, and a
restarted job resumes from its last saved pass (the BoxPS path is gang
scheduled: a rank's failure ends the job).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.fleet.store import TcpStoreClient


class DeadRankError(RuntimeError):
    """A peer's heartbeat stopped (ElasticManager.check)."""


class ElasticManager:
    """This rank's heartbeat and its watch over the other ranks' (module
    docstring); ``start`` begins both, ``stop`` ends them."""

    def __init__(self, client: TcpStoreClient, rank: int, world: int,
                 heartbeat_interval: float = 2.0,
                 stale_after: float = 10.0,
                 on_fault: Optional[Callable[[List[int]], None]] = None):
        self.client = client
        self.rank = rank
        self.world = world
        self.interval = heartbeat_interval
        self.stale_after = stale_after
        self.on_fault = on_fault
        self._stop = threading.Event()
        self._dead: List[int] = []
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._watch_thread = threading.Thread(target=self._watch_loop,
                                              daemon=True)

    def start(self) -> None:
        self._beat()
        self._hb_thread.start()
        self._watch_thread.start()

    def _key(self, rank: int) -> str:
        return "elastic/hb/%d" % rank

    def _beat(self) -> None:
        self.client.add(self._key(self.rank), 1)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._beat()
            except (ConnectionError, OSError, RuntimeError):
                return  # store gone; the job is ending

    def _watch_loop(self) -> None:
        # (counter value, local time it last changed) per peer
        seen: Dict[int, Tuple[int, float]] = {}
        start = time.monotonic()
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            dead = []
            for r in range(self.world):
                if r == self.rank:
                    continue
                try:
                    c = self.client.counter(self._key(r))
                except (ConnectionError, OSError, RuntimeError):
                    return
                last = seen.get(r)
                if last is None or c != last[0]:
                    seen[r] = (c, now)
                    continue
                born = start if last[0] == 0 else last[1]
                if now - born > self.stale_after:
                    dead.append(r)
            if dead:
                # flag and notify, but KEEP heartbeating: surviving ranks
                # must not look dead to each other while a restart hook
                # replaces the lost one
                self._dead = dead
                if self.on_fault is not None:
                    self.on_fault(dead)
                return

    @property
    def dead_ranks(self) -> List[int]:
        return list(self._dead)

    def check(self) -> None:
        """Raise if a peer died (call at pass boundaries — the natural
        recovery unit, SURVEY.md §5.3)."""
        if self._dead:
            raise DeadRankError("dead ranks: %s" % self._dead)

    def stop(self) -> None:
        self._stop.set()
