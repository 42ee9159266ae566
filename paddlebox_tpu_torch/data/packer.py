"""Static-shape batch packer.

Counterpart of paddlebox_tpu/data/packer.py: a batch's sparse keys flatten
into ONE fixed-capacity key vector with a segment id per key
(instance * num_slots + slot), written instance-major and slot-ascending, so
the segment vector is nondecreasing; the padding tail is pinned to the last
segment and marked invalid. Keys beyond a slot's max_len (or the batch's key
capacity) are dropped, as in the reference, and counted
(``packer_keys_dropped``; ``ingest_ins_packed`` counts the packed
instances). Each used dense slot is written at its fixed dim into
``dense`` [B, dense_dim] float32 (cut to the dim, zero where a record lacks
values, zero on padding rows); ``task_labels`` holds a [B] int32 label
column for each task of the feed's ``task_label_slots``, the click label
where a record has none of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

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
    dense: Optional[np.ndarray] = None    # [B, dense_dim] float32
    task_labels: Optional[Dict[str, np.ndarray]] = None  # task -> [B] int32

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


class BatchPacker:
    def __init__(self, feed: DataFeedConfig) -> None:
        self.feed = feed
        self.sparse_slots = feed.used_sparse_slots()
        self.dense_slots = feed.used_dense_slots()
        self.num_slots = len(self.sparse_slots)
        self.dense_dim = sum(s.dim for s in self.dense_slots)
        self.task_names = [t for t, _ in feed.task_label_slots]
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
        dense = (np.zeros((B, self.dense_dim), dtype=np.float32)
                 if self.dense_dim else None)
        task_labels = ({t: np.zeros(B, dtype=np.int32)
                        for t in self.task_names}
                       if self.task_names else None)
        w = 0
        dropped = 0
        for i in range(n):
            rec = records[i]
            labels[i] = rec.label
            ins_valid[i] = True
            if task_labels is not None:
                for t in self.task_names:
                    task_labels[t][i] = rec.extra_labels.get(t, rec.label)
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
            if dense is not None:
                off = 0
                for fi, slot_cfg in enumerate(self.dense_slots):
                    vals = rec.float_slots.get(fi)
                    d = slot_cfg.dim
                    if vals is not None:
                        m = min(vals.size, d)
                        dense[i, off:off + m] = vals[:m]
                    off += d
        if dropped:
            stat_add("packer_keys_dropped", dropped)
        stat_add("ingest_ins_packed", n)
        return PackedBatch(keys=keys, slots=slots, segments=segments,
                           valid=valid, labels=labels, ins_valid=ins_valid,
                           n_ins=n, dense=dense, task_labels=task_labels)
