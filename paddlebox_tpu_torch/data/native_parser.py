"""The native MultiSlot parser: a whole file to one ColumnarBlock.

Counterpart of paddlebox_tpu/data/native_parser.py:16-110 over
``psr_parse_file`` (native/slot_parser.cc; the task-label entry waits for
multi-task heads). Same format contract as data/parser.py: one instance a
line, slots in feed-config order, each ``<count> <v_1> ... <v_count>``, the
first value of the float slot "click" is the label. Malformed lines are
dropped and counted in ``bad_lines``, as in the reference. The parse is one
ctypes call, which releases the interpreter lock.
"""

from __future__ import annotations

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.columnar import ColumnarBlock
from paddlebox_tpu_torch.native import host_lib
from paddlebox_tpu_torch.native.host_lib import I32P, ptr


class NativeMultiSlotParser:
    label_slot = "click"

    def __init__(self, feed: DataFeedConfig) -> None:
        self._lib = host_lib.host_lib()
        self.feed = feed
        slots = list(feed.slots)
        self._slot_types = np.array(
            [0 if s.type == "uint64" else 1 for s in slots], np.int32)
        self._used = np.array([s.is_used for s in slots], np.int32)
        # the port's feed has no dense inputs (BatchPacker refuses them)
        self._dense_dims = np.zeros(len(slots), np.int32)
        self._label_idx = next((i for i, s in enumerate(slots)
                                if s.name == self.label_slot), -1)
        self.bad_lines = 0

    def parse_file_columnar(self, path: str) -> ColumnarBlock:
        lib = self._lib
        handle = lib.psr_parse_file(
            path.encode(), ptr(self._slot_types, I32P),
            ptr(self._used, I32P), ptr(self._dense_dims, I32P),
            self._slot_types.size, self._label_idx)
        if not handle:
            raise FileNotFoundError(path)
        try:
            n_keys = lib.psr_n_keys(handle)
            n_recs = lib.psr_n_recs(handle)
            self.bad_lines += int(lib.psr_n_bad(handle))

            def arr(p, n, dt):
                if n == 0:
                    return np.empty(0, dt)
                return np.ctypeslib.as_array(p, shape=(n,)).astype(dt,
                                                                   copy=True)

            return ColumnarBlock.from_key_rec(
                arr(lib.psr_keys(handle), n_keys, np.uint64),
                arr(lib.psr_key_slot(handle), n_keys, np.int32),
                arr(lib.psr_key_rec(handle), n_keys, np.int64),
                arr(lib.psr_labels(handle), n_recs, np.int32))
        finally:
            lib.psr_free(handle)
