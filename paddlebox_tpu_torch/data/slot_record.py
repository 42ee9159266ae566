"""One training instance: label, per-slot uint64 feasign lists, per-slot
dense floats and per-task labels.

Counterpart of paddlebox_tpu/data/slot_record.py, reduced to the fields the
port reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SlotRecord:
    __slots__ = ("label", "uint64_slots", "float_slots", "extra_labels")

    def __init__(self, label: int = 0,
                 uint64_slots: Optional[Dict[int, np.ndarray]] = None,
                 float_slots: Optional[Dict[int, np.ndarray]] = None,
                 extra_labels: Optional[Dict[str, int]] = None) -> None:
        self.label = label
        # used sparse slot ordinal -> feasigns
        self.uint64_slots = uint64_slots or {}
        # used float slot ordinal -> float32 values
        self.float_slots = float_slots or {}
        # task name -> label (tasks absent here train on the click label)
        self.extra_labels = extra_labels or {}

    def all_keys(self) -> np.ndarray:
        if not self.uint64_slots:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(list(self.uint64_slots.values()))
