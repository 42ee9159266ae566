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

The join phase's extras (reference packer.py:27-52, 100-202): each batch
carries ``qvalues`` [B] float32, ``ins_ids`` (the packed records' ids) and
``cmatch_rank`` [B] uint64, ``(cmatch << 32) | (rank & 0xff)`` a record
(the cmatch-rank metrics' variable; 0 on padding rows); under the feed's
``rank_offset`` the pv rank-offset matrix [B, 1 + 2 * max_rank] int32,
-1 filled, whose pvs group the batch's records by search_id
(``_build_rank_offset``). An ``input_table`` (embedding/side_tables.py
InputTable) translates each record's ins_id to its aux row,
``use_cache_idx`` takes the record's ReplicaCache row instead: either
fills ``aux_offset`` [B] int32 (0 on padding rows). A ReplicaCache has no
zero row, so a record without a cache_idx raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.pv import effective_rank
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
    dense: Optional[np.ndarray]  # [B, dense_dim] float32 or None
    n_ins: int
    rank_offset: Optional[np.ndarray] = None  # [B, 2*max_rank+1] int32
    qvalues: Optional[np.ndarray] = None      # [B] float32
    ins_ids: Optional[List[str]] = None       # [n_ins]
    cmatch_rank: Optional[np.ndarray] = None  # [B] uint64
    task_labels: Optional[Dict[str, np.ndarray]] = None  # task -> [B] int32
    aux_offset: Optional[np.ndarray] = None   # [B] int32

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


class BatchPacker:
    def __init__(self, feed: DataFeedConfig, max_rank: int = 3,
                 input_table=None, use_cache_idx: bool = False) -> None:
        if input_table is not None and use_cache_idx:
            raise ValueError("input_table and use_cache_idx are exclusive "
                             "aux-offset sources")
        self.feed = feed
        self.max_rank = max_rank
        self.input_table = input_table
        self.use_cache_idx = use_cache_idx
        self.sparse_slots = feed.used_sparse_slots()
        self.dense_slots = feed.used_dense_slots()
        self.num_slots = len(self.sparse_slots)
        self.dense_dim = sum(s.dim for s in self.dense_slots)
        self.task_names = [t for t, _ in feed.task_label_slots]
        self.batch_size = feed.batch_size
        self.kcap = feed.key_capacity()

    def pack(self, records: Sequence[SlotRecord],
             with_rank_offset: Optional[bool] = None) -> PackedBatch:
        """``with_rank_offset``: build the pv rank-offset matrix; None
        (the default) follows ``feed.rank_offset``."""
        if with_rank_offset is None:
            with_rank_offset = self.feed.rank_offset
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
        qvalues = np.zeros(B, dtype=np.float32)
        cmatch_rank = np.zeros(B, dtype=np.uint64)
        w = 0
        dropped = 0
        for i in range(n):
            rec = records[i]
            labels[i] = rec.label
            ins_valid[i] = True
            qvalues[i] = rec.qvalue
            cmatch_rank[i] = ((np.uint64(rec.cmatch) << np.uint64(32))
                              | np.uint64(rec.rank & 0xFF))
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
        batch = PackedBatch(keys=keys, slots=slots, segments=segments,
                            valid=valid, labels=labels, ins_valid=ins_valid,
                            n_ins=n, dense=dense, task_labels=task_labels,
                            qvalues=qvalues,
                            ins_ids=[r.ins_id for r in records[:n]],
                            cmatch_rank=cmatch_rank)
        if self.input_table is not None or self.use_cache_idx:
            batch.aux_offset = self._aux_offset(records[:n], B)
        if with_rank_offset:
            batch.rank_offset = self._build_rank_offset(records[:n], B)
        return batch

    def _aux_offset(self, records: Sequence[SlotRecord],
                    B: int) -> np.ndarray:
        """[B] int32: each record's InputTable row (a miss is the zero row
        0, counted by the table) or its ReplicaCache row."""
        aux = np.zeros(B, dtype=np.int32)
        for i, rec in enumerate(records):
            if self.input_table is not None:
                aux[i] = self.input_table.get_index_offset(rec.ins_id)
            elif rec.cache_idx < 0:
                # a ReplicaCache's row 0 is a real cached row: a record
                # without an index would train on another record's row
                raise ValueError(
                    "use_cache_idx: record %d (ins_id=%r) has no cache_idx "
                    "- every instance needs a ReplicaCache row index"
                    % (i, rec.ins_id))
            else:
                aux[i] = rec.cache_idx
        return aux

    def _build_rank_offset(self, records: Sequence[SlotRecord],
                           B: int) -> np.ndarray:
        """The batch's rank-offset matrix [B, 1 + 2 * max_rank] int32 (-1
        filled): col 0 a record's effective rank (data/pv.py), then (rank,
        row) of each valid peer, by the peer's rank, among the batch's
        records of the same search_id, the record itself included."""
        mr = self.max_rank
        out = np.full((B, 2 * mr + 1), -1, dtype=np.int32)
        by_pv: Dict[int, List[int]] = {}
        eff = []
        for row, rec in enumerate(records):
            by_pv.setdefault(rec.search_id, []).append(row)
            eff.append(effective_rank(rec.rank, rec.cmatch, mr))
        for row, rec in enumerate(records):
            out[row, 0] = eff[row]
            if eff[row] <= 0:
                continue
            for peer in by_pv[rec.search_id]:
                if eff[peer] > 0:
                    m = eff[peer] - 1
                    out[row, 2 * m + 1] = records[peer].rank
                    out[row, 2 * m + 2] = peer
        return out
