"""One training instance: label, per-slot uint64 feasign lists, per-slot
dense floats, per-task labels, and the join phase's fields.

Counterpart of paddlebox_tpu/data/slot_record.py, the same fields with the
same defaults: the instance id (a ``parse_ins_id`` line's first token, the
InputTable's key), the pv fields (``search_id`` groups a search session's
ads, ``rank`` is an ad's position in it, ``cmatch`` its channel; the
rank-offset feed and the cmatch-rank metrics read them), the PCOC q-value,
and the ReplicaCache row of a ``use_cache_idx`` feed (-1: none).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SlotRecord:
    __slots__ = ("label", "uint64_slots", "float_slots", "ins_id", "rank",
                 "cmatch", "qvalue", "search_id", "extra_labels",
                 "cache_idx")

    def __init__(self, label: int = 0,
                 uint64_slots: Optional[Dict[int, np.ndarray]] = None,
                 float_slots: Optional[Dict[int, np.ndarray]] = None,
                 ins_id: str = "", rank: int = 0, cmatch: int = 0,
                 qvalue: float = 0.0, search_id: int = 0,
                 extra_labels: Optional[Dict[str, int]] = None,
                 cache_idx: int = -1) -> None:
        self.label = label
        # used sparse slot ordinal -> feasigns
        self.uint64_slots = uint64_slots or {}
        # used float slot ordinal -> float32 values
        self.float_slots = float_slots or {}
        self.ins_id = ins_id
        self.rank = rank
        self.cmatch = cmatch
        self.qvalue = qvalue
        self.search_id = search_id
        # task name -> label (tasks absent here train on the click label)
        self.extra_labels = extra_labels or {}
        self.cache_idx = cache_idx

    def all_keys(self) -> np.ndarray:
        if not self.uint64_slots:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(list(self.uint64_slots.values()))

    def shuffle_hash(self) -> int:
        """The cross-host shuffle's hash (general_shuffle_func,
        data_set.cc:2420-2436): the XOR of the record's feasigns mod
        0x7FFFFFFF, its label where it has none."""
        keys = self.all_keys()
        if keys.size == 0:
            return self.label
        return int(np.bitwise_xor.reduce(keys) % np.uint64(0x7FFFFFFF))
