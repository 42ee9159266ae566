"""The parameter server's tables: a sharded sparse table and a dense one.

Counterpart of paddlebox_tpu/ps/table.py. ``SparseTable`` is
``shard_num`` host stores (the port's ``make_host_store``, the native C++
store), a key routed to shard key % shard_num (MemorySparseTable's shard
layout, memory_sparse_table.cc); its push applies ps/sgd_rule.py's numpy
rule on the server, its pass-end ``assign`` stores rows verbatim, and its
``check_need_limit_mem`` spills to each store's SSD tier (the
SSDSparseTable role). Shard i's store is seeded seed + i and its push
RandomState seed + 101 + i, as the reference's, so the same calls give the
same rows. ``DenseTable`` is MemoryDenseTable: a flat f32 vector with the
adam, sgd or summary rule applied on push.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from paddlebox_tpu_torch.config.configs import TableConfig
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.embedding.native_store import make_host_store
from paddlebox_tpu_torch.ps.sgd_rule import numpy_apply_push
from paddlebox_tpu_torch.utils.lockwatch import make_lock


class SparseTable:
    def __init__(self, table: TableConfig, shard_num: int = 8,
                 seed: int = 0) -> None:
        self.config = table
        self.layout = ValueLayout(table.embedx_dim, table.optimizer.optimizer,
                                  expand_dim=table.expand_embed_dim)
        self.push_layout = PushLayout.of(self.layout)
        self.shard_num = shard_num
        self.shards = [make_host_store(self.layout, table, seed=seed + i)
                       for i in range(shard_num)]
        self._locks = [threading.Lock() for _ in range(shard_num)]
        self._rngs = [np.random.RandomState(seed + 101 + i)
                      for i in range(shard_num)]

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def _route(self, keys: np.ndarray) -> np.ndarray:
        return (keys % np.uint64(self.shard_num)).astype(np.int64)

    # -------------------------------------------------------------- pull/push
    def pull(self, keys: np.ndarray, create: bool = True) -> np.ndarray:
        """Full value rows of (not necessarily unique) keys, the server's
        half of PullSparse. create=False is the test-mode pull
        (SetTestMode, box_wrapper.cc:183): a missing key reads as a zero
        row and nothing is inserted."""
        keys = np.asarray(keys, dtype=np.uint64)
        out = np.empty((keys.size, self.layout.width), np.float32)
        shard_of = self._route(keys)
        for s in range(self.shard_num):
            m = shard_of == s
            if not m.any():
                continue
            uniq, inv = np.unique(keys[m], return_inverse=True)
            with self._locks[s]:
                rows = (self.shards[s].lookup_or_create(uniq) if create
                        else self.shards[s].lookup(uniq))
            out[m] = rows[inv]
        return out

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        """Apply push-layout gradients; duplicate keys merge first (summed,
        the slot taken from a contributor), as the worker's dedup before
        PushSparse."""
        keys = np.asarray(keys, dtype=np.uint64)
        grads = np.asarray(grads, dtype=np.float32)
        shard_of = self._route(keys)
        for s in range(self.shard_num):
            m = shard_of == s
            if not m.any():
                continue
            uniq, inv = np.unique(keys[m], return_inverse=True)
            merged = np.zeros((uniq.size, grads.shape[1]), np.float32)
            np.add.at(merged, inv, grads[m])
            # the slot is a tag, not additive
            merged[inv, self.push_layout.SLOT] = grads[
                m, self.push_layout.SLOT]
            with self._locks[s]:
                rows = self.shards[s].lookup_or_create(uniq)
                newrows = numpy_apply_push(rows, merged, self._rngs[s],
                                           self.layout, self.config.optimizer)
                self.shards[s].write_back(uniq, newrows)

    def assign(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Overwrite full value rows, creating missing keys: the server's
        half of the pass-end dump (PSGPUWrapper::EndPass, dump_to_cpu,
        ps_gpu_wrapper.cc:983+), whose rows the device's rule already
        updated. Duplicate keys keep their first occurrence's row."""
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.float32)
        uniq, first = np.unique(keys, return_index=True)
        keys, values = uniq, values[first]
        shard_of = self._route(keys)
        for s in range(self.shard_num):
            m = shard_of == s
            if not m.any():
                continue
            with self._locks[s]:
                self.shards[s].assign(keys[m], values[m])

    # ------------------------------------------------------------- lifecycle
    def shrink(self) -> int:
        total = 0
        for s, lock in zip(self.shards, self._locks):
            with lock:
                total += s.shrink()
        return total

    def age_unseen_days(self) -> None:
        """The server's day boundary: every feature's unseen_days + 1 (the
        delete_after_unseen_days clock)."""
        for s, lock in zip(self.shards, self._locks):
            with lock:
                s.age_unseen_days()

    def check_need_limit_mem(self, max_resident: Optional[int] = None) -> int:
        """The server's DRAM budget (CheckNeedLimitMem / ShrinkResource,
        box_wrapper.h:627-629): spill the coldest rows over the budget to
        the table's ssd_dir. The budget (default the config's
        ssd_threshold_mb in rows) divides evenly over the shards. Returns
        the rows spilled."""
        budget = (max_resident if max_resident is not None
                  else self.config.ssd_max_resident_rows(self.layout.width))
        if budget is None:
            return 0
        per = budget // max(1, self.shard_num)
        total = 0
        for s, lock in zip(self.shards, self._locks):
            with lock:
                total += s.spill(per)
        return total

    def save(self, dirpath: str) -> List[str]:
        """A file a shard (MemorySparseTable::Save's layout), in the
        stores' own format."""
        os.makedirs(dirpath, exist_ok=True)
        paths = []
        for i, (s, lock) in enumerate(zip(self.shards, self._locks)):
            p = os.path.join(dirpath, "shard-%05d.pkl" % i)
            with lock:
                s.save(p)
            paths.append(p)
        return paths

    def load(self, dirpath: str) -> None:
        for i, (s, lock) in enumerate(zip(self.shards, self._locks)):
            p = os.path.join(dirpath, "shard-%05d.pkl" % i)
            with lock:
                s.load(p)


class DenseTable:
    """A flat dense parameter vector with the server's rule
    (MemoryDenseTable: adam, sgd or summary)."""

    def __init__(self, size: int, rule: str = "adam", lr: float = 1e-3,
                 init: Optional[np.ndarray] = None) -> None:
        if rule not in ("adam", "sgd", "summary"):
            raise ValueError(rule)
        self.rule = rule
        self.lr = lr
        self.params = (np.array(init, np.float32) if init is not None
                       else np.zeros(size, np.float32))  # guarded-by: _lock
        self._mom1 = np.zeros_like(self.params)  # guarded-by: _lock
        self._mom2 = np.zeros_like(self.params)  # guarded-by: _lock
        self._t = 0  # guarded-by: _lock
        self._lock = make_lock("DenseTable._lock")

    def pull(self) -> np.ndarray:
        with self._lock:
            return self.params.copy()

    def push(self, grad: np.ndarray) -> None:
        g = np.asarray(grad, np.float32)
        with self._lock:
            if self.rule == "summary":
                self.params += g  # a running sum (data_norm's statistics)
                return
            if self.rule == "sgd":
                self.params -= self.lr * g
                return
            self._t += 1
            self._mom1 = 0.9 * self._mom1 + 0.1 * g
            self._mom2 = 0.999 * self._mom2 + 0.001 * g * g
            bc1 = 1 - 0.9 ** self._t
            bc2 = 1 - 0.999 ** self._t
            self.params -= (self.lr * (self._mom1 / bc1)
                            / (np.sqrt(self._mom2 / bc2) + 1e-8))

    def state(self) -> dict:
        with self._lock:
            return {"params": self.params.copy(), "mom1": self._mom1.copy(),
                    "mom2": self._mom2.copy(), "t": self._t,
                    "rule": self.rule, "lr": self.lr}

    def load_state(self, st: dict) -> None:
        with self._lock:
            self.params = np.asarray(st["params"], np.float32).copy()
            self._mom1 = np.asarray(st["mom1"], np.float32).copy()
            self._mom2 = np.asarray(st["mom2"], np.float32).copy()
            self._t = int(st["t"])
