"""Columnar record blocks and their vectorized batch packing.

Counterpart of paddlebox_tpu/data/columnar.py:24-213: the native parser
(data/native_parser.py) returns each file as flat arrays (keys with their
slot ordinals, per-record key offsets, labels, the dense columns and the
task labels), and a batch is packed by numpy indexing, with no per-record
Python object.
``pack_columnar`` gives the bytes ``BatchPacker.pack`` gives for the same
records in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.packer import PackedBatch
from paddlebox_tpu_torch.utils.stats import stat_add


@dataclasses.dataclass
class ColumnarBlock:
    """Records in struct-of-arrays form: record r's keys are
    keys[rec_offsets[r]:rec_offsets[r+1]], in used-slot order."""

    keys: np.ndarray         # [K] uint64
    key_slot: np.ndarray     # [K] int32 used sparse slot ordinal
    labels: np.ndarray       # [N] int32
    rec_offsets: np.ndarray  # [N+1] int64
    dense: Optional[np.ndarray] = None   # [N, dense_dim] float32
    task_labels: Optional[Dict[str, np.ndarray]] = None  # task -> [N] int32

    @property
    def n_recs(self) -> int:
        return self.labels.shape[0]

    @property
    def n_keys(self) -> int:
        return self.keys.shape[0]

    @staticmethod
    def from_key_rec(keys: np.ndarray, key_slot: np.ndarray,
                     key_rec: np.ndarray, labels: np.ndarray,
                     dense: Optional[np.ndarray] = None,
                     task_labels: Optional[Dict[str, np.ndarray]] = None
                     ) -> "ColumnarBlock":
        """From parser output where key_rec[i] is key i's record index
        (keys grouped by record)."""
        n = labels.shape[0]
        counts = (np.bincount(key_rec, minlength=n) if keys.size
                  else np.zeros(n, np.int64))
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return ColumnarBlock(keys, key_slot, labels, offsets, dense,
                             task_labels)

    def select(self, rec_idx: np.ndarray) -> "ColumnarBlock":
        """The block of the given records, in that order (fresh
        arrays)."""
        rec_idx = np.asarray(rec_idx, np.int64)
        starts = self.rec_offsets[rec_idx]
        counts = self.rec_offsets[rec_idx + 1] - starts
        flat = np.repeat(starts, counts) + _run_aranges(counts)
        offsets = np.zeros(rec_idx.size + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return ColumnarBlock(
            self.keys[flat], self.key_slot[flat], self.labels[rec_idx],
            offsets, None if self.dense is None else self.dense[rec_idx],
            None if self.task_labels is None else
            {t: c[rec_idx] for t, c in self.task_labels.items()})

    @staticmethod
    def concat(blocks: Sequence["ColumnarBlock"]) -> "ColumnarBlock":
        blocks = [b for b in blocks if b.n_recs]
        if not blocks:
            return ColumnarBlock(np.empty(0, np.uint64),
                                 np.empty(0, np.int32),
                                 np.empty(0, np.int32),
                                 np.zeros(1, np.int64))
        offs = [blocks[0].rec_offsets]
        shift = blocks[0].rec_offsets[-1]
        for b in blocks[1:]:
            offs.append(b.rec_offsets[1:] + shift)
            shift += b.rec_offsets[-1]
        b0 = blocks[0]
        return ColumnarBlock(
            np.concatenate([b.keys for b in blocks]),
            np.concatenate([b.key_slot for b in blocks]),
            np.concatenate([b.labels for b in blocks]),
            np.concatenate(offs),
            None if b0.dense is None else
            np.concatenate([b.dense for b in blocks]),
            None if b0.task_labels is None else
            {t: np.concatenate([b.task_labels[t] for b in blocks])
             for t in b0.task_labels})


def pack_columnar(block: ColumnarBlock, rec_idx: np.ndarray,
                  feed: DataFeedConfig, kcap: int, num_slots: int,
                  max_lens: np.ndarray) -> PackedBatch:
    """Pack the records ``rec_idx`` (at most feed.batch_size of them) of
    ``block`` into one static-shape batch. Each (record, slot) run is cut
    to the slot's max_len and the batch to ``kcap`` keys, as BatchPacker
    does. The parser emits each record's keys in used-slot order, so the
    segment vector comes out nondecreasing; the padding tail is pinned to
    the last segment and marked invalid. The dense columns and the task
    labels follow the feed config, not the block, so a block of no record
    packs the schema the record path packs."""
    B = feed.batch_size
    n = min(rec_idx.shape[0], B)
    rec_idx = rec_idx[:n]
    starts = block.rec_offsets[rec_idx]
    counts = (block.rec_offsets[rec_idx + 1] - starts).astype(np.int64)

    labels = np.zeros(B, dtype=np.int32)
    labels[:n] = block.labels[rec_idx]
    ins_valid = np.zeros(B, dtype=bool)
    ins_valid[:n] = True
    dense_dim = sum(s.dim for s in feed.used_dense_slots())
    dense = None
    if dense_dim:
        dense = np.zeros((B, dense_dim), np.float32)
        if block.dense is not None:
            dense[:n] = block.dense[rec_idx]
    task_labels = None
    if feed.task_label_slots:
        task_labels = {}
        for t, _ in feed.task_label_slots:
            col = np.zeros(B, dtype=np.int32)
            have = (block.task_labels or {}).get(t)
            col[:n] = have[rec_idx] if have is not None else labels[:n]
            task_labels[t] = col
    stat_add("ingest_ins_packed", n)
    keys = np.zeros(kcap, dtype=np.uint64)
    slots = np.zeros(kcap, dtype=np.int32)
    segments = np.full(kcap, B * num_slots - 1, dtype=np.int32)
    valid = np.zeros(kcap, dtype=bool)

    if counts.sum():
        # each batch record's key run, by flat index expansion
        flat = np.repeat(starts, counts) + _run_aranges(counts)
        bkeys = block.keys[flat]
        bslots = block.key_slot[flat]
        brec = np.repeat(np.arange(n, dtype=np.int64), counts)
        # the ordinal within each (record, slot) run, for max_len
        keep = _group_cumcount(brec * num_slots + bslots) < max_lens[bslots]
        bkeys, bslots, brec = bkeys[keep], bslots[keep], brec[keep]
        w = min(bkeys.shape[0], kcap)
        dropped = int((~keep).sum()) + bkeys.shape[0] - w
        if dropped:
            stat_add("packer_keys_dropped", dropped)
        keys[:w] = bkeys[:w]
        slots[:w] = bslots[:w]
        segments[:w] = (brec[:w] * num_slots + bslots[:w]).astype(np.int32)
        valid[:w] = True
    # the blocks carry no pv field or q-value: zero columns, as the
    # reference's columnar packer gives them
    return PackedBatch(keys=keys, slots=slots, segments=segments,
                       valid=valid, labels=labels, ins_valid=ins_valid,
                       n_ins=n, dense=dense, task_labels=task_labels,
                       qvalues=np.zeros(B, dtype=np.float32),
                       cmatch_rank=np.zeros(B, dtype=np.uint64))


def _run_aranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - counts,
                                                        counts)


def _group_cumcount(group: np.ndarray) -> np.ndarray:
    """Ordinal of each element within its (contiguous) run of equal
    values."""
    if group.size == 0:
        return np.empty(0, np.int64)
    change = np.empty(group.size, dtype=bool)
    change[0] = True
    np.not_equal(group[1:], group[:-1], out=change[1:])
    starts = np.nonzero(change)[0]
    idx = np.arange(group.size, dtype=np.int64)
    return idx - np.repeat(starts, np.diff(np.append(starts, group.size)))
