"""The host-side asynchronous dense parameter table.

Counterpart of paddlebox_tpu/train/async_dense.py (BoxPSAsynDenseTable,
paddle/fluid/framework/boxps_worker.cc:57-366): the dense parameters live
on the host as ONE flat f32 vector, in the order convert.flatten_params
gives it, with Adam's two moment vectors beside it. Each step pulls a
snapshot (``pull``) and pushes its raw flat gradient to a queue
(``push``); a background thread merges a burst of up to ``merge_limit``
queued gradients (cc:234-260) and applies a hand-written Adam (cc:262-326)
to their mean; the data_norm summary slots (a bool ``summary_mask``) take
the burst's raw sum instead (running-sum semantics, cc:89-95).

The arithmetic is the reference's, operation for operation, in numpy
(Python-float bias corrections on f32 arrays), so the same bursts give the
same bits in both packages. Which grads form a burst depends on when the
thread wakes: a run is repeatable only where every push waits for the
drain (``wait_drained``). Telemetry: the stats async_dense_applies and
async_dense_stop_timeouts.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from paddlebox_tpu_torch.utils.lockwatch import make_lock
from paddlebox_tpu_torch.utils.stats import stat_add

log = logging.getLogger(__name__)


class AsyncDenseTable:
    def __init__(self, init_params: np.ndarray,
                 lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8,
                 summary_mask: Optional[np.ndarray] = None,
                 merge_limit: int = 4) -> None:
        # the params, the two Adam moments and the step count, guarded by
        # _lock
        self._params = np.array(init_params, dtype=np.float32)
        self._mom1 = np.zeros_like(self._params)
        self._mom2 = np.zeros_like(self._params)
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps
        # True where the param is a data-norm summary stat: plain += grad
        self._summary = (summary_mask.astype(bool)
                         if summary_mask is not None else None)
        self.merge_limit = merge_limit
        self._t = 0
        self._lock = make_lock("AsyncDenseTable._lock")
        self._queue: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self._thread = threading.Thread(target=self._update_loop, daemon=True,
                                        name="async-dense")
        self._thread.start()

    # ------------------------------------------------------------ worker API
    def pull(self) -> np.ndarray:
        """Snapshot of the current params (PullDense, cc:329-338)."""
        with self._lock:
            return self._params.copy()

    def push(self, grad: np.ndarray) -> None:
        """Queue a flat grad for the background optimizer
        (PushDense, cc:340-347)."""
        self._queue.put(np.asarray(grad, dtype=np.float32))

    @property
    def steps_applied(self) -> int:
        with self._lock:
            return self._t

    def wait_drained(self, timeout: float = 60.0) -> None:
        """Block until every queued grad has been applied; TimeoutError
        after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._queue.all_tasks_done:
            while self._queue.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._queue.all_tasks_done.wait(
                        remaining):
                    raise TimeoutError("async dense update not finished")

    def stop(self, timeout: float = 30.0) -> None:
        """Apply what is queued and end the thread. Bounded and loud: a
        thread still running after ``timeout`` seconds is abandoned with a
        warning and the stat async_dense_stop_timeouts (stop runs at
        teardown, which a wedged thread must not hang)."""
        # unbounded queue: the sentinel put never blocks
        self._queue.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            log.warning("async dense worker still alive after a %.1f s stop "
                        "timeout; abandoning it", timeout)
            stat_add("async_dense_stop_timeouts")

    # ------------------------------------------------------- background loop
    def _update_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            merged: List[np.ndarray] = [item]
            # merge a limited burst of queued grads into one apply
            # (AsyncUpdate merge loop, cc:234-260)
            while len(merged) < self.merge_limit:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._apply(merged)
                    for _ in merged:
                        self._queue.task_done()
                    self._queue.task_done()
                    return
                merged.append(nxt)
            self._apply(merged)
            for _ in merged:
                self._queue.task_done()

    def _apply(self, grads: List[np.ndarray]) -> None:
        gsum = grads[0] if len(grads) == 1 else np.sum(grads, axis=0)
        # adam consumes the mean of the merged burst; summary slots must
        # accumulate the RAW sum (running-total semantics, cc:89-95)
        g = gsum / float(len(grads)) if len(grads) > 1 else gsum
        with self._lock:
            self._t += 1
            self._mom1 *= self.beta1
            self._mom1 += (1 - self.beta1) * g
            self._mom2 *= self.beta2
            self._mom2 += (1 - self.beta2) * np.square(g)
            bc1 = 1 - self.beta1 ** self._t
            bc2 = 1 - self.beta2 ** self._t
            step = (self.lr * (self._mom1 / bc1)
                    / (np.sqrt(self._mom2 / bc2) + self.eps))
            if self._summary is not None:
                # summary stats accumulate raw "grads" (running sums)
                step = np.where(self._summary, -gsum, step)
            self._params -= step
        stat_add("async_dense_applies", 1)

    # ------------------------------------------------------------ checkpoint
    def state(self) -> dict:
        with self._lock:
            return {"params": self._params.copy(),
                    "mom1": self._mom1.copy(), "mom2": self._mom2.copy(),
                    "t": self._t}

    def load_state(self, st: dict) -> None:
        with self._lock:
            self._params[...] = st["params"]
            self._mom1[...] = st["mom1"]
            self._mom2[...] = st["mom2"]
            self._t = int(st["t"])
