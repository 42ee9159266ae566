"""The native MultiSlot parser: a whole file to one ColumnarBlock.

Counterpart of paddlebox_tpu/data/native_parser.py:16-110 over
``psr_parse_file2`` (native/slot_parser.cc). Same format contract as
data/parser.py: one instance a line, slots in feed-config order, each
``<count> <v_1> ... <v_count>``, the first value of the float slot "click"
is the label, each used float slot fills its fixed ``dim`` columns of the
record's dense row (cut to the dim, zero where values are missing), and the
first value of each ``task_label_slots`` slot is that task's label (the
click label where the record has none). Malformed lines are dropped and
counted in ``bad_lines``, as in the reference. The parse is one ctypes
call, which releases the interpreter lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.columnar import ColumnarBlock
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.native.host_lib import I32P, ptr


class NativeMultiSlotParser:
    def __init__(self, feed: DataFeedConfig, label_slot: str = "click",
                 lib_path: str = None) -> None:
        """``label_slot``: the slot whose first value is the record's click
        label, as MultiSlotParser's. ``lib_path``: a parser plugin's shared
        object with the psr_* entries (data/plugin.py) instead of the
        port's host library."""
        self.label_slot = label_slot
        self._lib = (host_lib.bind_parser(ctypes.CDLL(lib_path))
                     if lib_path is not None else host_lib.host_lib())
        self.feed = feed
        slots = list(feed.slots)
        self._slot_types = np.array(
            [0 if s.type == "uint64" else 1 for s in slots], np.int32)
        self._used = np.array([s.is_used for s in slots], np.int32)
        self._dense_dims = np.array([s.dim for s in slots], np.int32)
        index = {s.name: i for i, s in enumerate(slots)}
        self._label_idx = index.get(self.label_slot, -1)
        for task, name in feed.task_label_slots:
            if name not in index:
                raise ValueError("task label slot %r (task %r) not in the "
                                 "feed config" % (name, task))
        self._task_names = [t for t, _ in feed.task_label_slots]
        self._task_idx = np.array([index[n] for _, n in
                                   feed.task_label_slots], np.int32)
        self.bad_lines = 0
        self._bad_lock = threading.Lock()

    def parse_file_columnar(self, path: str) -> ColumnarBlock:
        lib = self._lib
        n_tasks = len(self._task_names)
        handle = lib.psr_parse_file2(
            path.encode(), ptr(self._slot_types, I32P),
            ptr(self._used, I32P), ptr(self._dense_dims, I32P),
            self._slot_types.size, self._label_idx,
            ptr(self._task_idx, I32P), n_tasks)
        if not handle:
            raise FileNotFoundError(path)
        try:
            n_keys = lib.psr_n_keys(handle)
            n_recs = lib.psr_n_recs(handle)
            dense_dim = lib.psr_dense_dim(handle)
            with self._bad_lock:    # the dataset's readers share a parser
                self.bad_lines += int(lib.psr_n_bad(handle))

            def arr(p, shape, dt):
                if int(np.prod(shape)) == 0:
                    return np.empty(shape, dt)
                return np.ctypeslib.as_array(p, shape=shape).astype(
                    dt, copy=True)

            dense = (arr(lib.psr_dense(handle), (n_recs, dense_dim),
                         np.float32) if dense_dim and n_recs else None)
            task_labels = None
            if n_tasks and n_recs:
                tl = arr(lib.psr_task_labels(handle), (n_recs, n_tasks),
                         np.int32)
                task_labels = {t: np.ascontiguousarray(tl[:, i])
                               for i, t in enumerate(self._task_names)}
            return ColumnarBlock.from_key_rec(
                arr(lib.psr_keys(handle), (n_keys,), np.uint64),
                arr(lib.psr_key_slot(handle), (n_keys,), np.int32),
                arr(lib.psr_key_rec(handle), (n_keys,), np.int64),
                arr(lib.psr_labels(handle), (n_recs,), np.int32),
                dense, task_labels)
        finally:
            lib.psr_free(handle)
