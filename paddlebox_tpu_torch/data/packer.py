"""Static-shape batch packer.

Counterpart of paddlebox_tpu/data/packer.py: a batch's sparse keys flatten
into ONE fixed-capacity key vector with a segment id per key
(instance * num_slots + slot), written instance-major and slot-ascending, so
the segment vector is nondecreasing; the padding tail is pinned to the last
segment and marked invalid. Keys beyond a slot's max_len (or the batch's key
capacity) are dropped, as in the reference, and counted
(``packer_keys_dropped``; ``ingest_ins_packed`` counts the packed
instances).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.utils.stats import stat_add


@dataclasses.dataclass
class PackedBatch:
    keys: np.ndarray       # [KCAP] uint64, padding = 0
    slots: np.ndarray      # [KCAP] int32 slot ordinal per key
    segments: np.ndarray   # [KCAP] int32 = ins*num_slots + slot
    valid: np.ndarray      # [KCAP] bool
    labels: np.ndarray     # [B] int32 (padded instances = 0)
    ins_valid: np.ndarray  # [B] bool
    n_ins: int

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


class BatchPacker:
    def __init__(self, feed: DataFeedConfig) -> None:
        if feed.used_dense_slots():
            raise ValueError("the port's packer takes sparse slots only; "
                             "dense inputs wait for a later slice")
        self.feed = feed
        self.sparse_slots = feed.used_sparse_slots()
        self.num_slots = len(self.sparse_slots)
        self.batch_size = feed.batch_size
        self.kcap = feed.key_capacity()

    def pack(self, records: Sequence[SlotRecord]) -> PackedBatch:
        B = self.batch_size
        n = min(len(records), B)
        keys = np.zeros(self.kcap, dtype=np.uint64)
        slots = np.zeros(self.kcap, dtype=np.int32)
        segments = np.full(self.kcap, B * self.num_slots - 1, dtype=np.int32)
        valid = np.zeros(self.kcap, dtype=bool)
        labels = np.zeros(B, dtype=np.int32)
        ins_valid = np.zeros(B, dtype=bool)
        w = 0
        dropped = 0
        for i in range(n):
            rec = records[i]
            labels[i] = rec.label
            ins_valid[i] = True
            for si, slot_cfg in enumerate(self.sparse_slots):
                vals = rec.uint64_slots.get(si)
                if vals is None or vals.size == 0:
                    continue
                take = min(vals.size, slot_cfg.max_len, self.kcap - w)
                dropped += vals.size - take
                if take <= 0:
                    continue
                keys[w:w + take] = vals[:take]
                slots[w:w + take] = si
                segments[w:w + take] = i * self.num_slots + si
                valid[w:w + take] = True
                w += take
        if dropped:
            stat_add("packer_keys_dropped", dropped)
        stat_add("ingest_ins_packed", n)
        return PackedBatch(keys=keys, slots=slots, segments=segments,
                           valid=valid, labels=labels, ins_valid=ins_valid,
                           n_ins=n)
