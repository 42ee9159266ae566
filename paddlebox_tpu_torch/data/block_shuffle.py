"""The block codec of the cross-host instance shuffle (a copy of
paddlebox_tpu/data/block_shuffle.py: the same frames, byte for byte).

The shuffle's unit is a whole ColumnarBlock (data/columnar.py):

  codec    ``serialize_block`` / ``deserialize_block``: one header
           (``<IIqqii``: magic "PBXB", version 1, records, keys, the dense
           width or -1, the task count), the task names, then each column's
           raw bytes (labels int32, rec_offsets int64, keys uint64,
           key_slot int32, dense float32, each task's labels int32); the
           decoded columns are read-only views over the frame.
  routing  ``block_shuffle_dests``: each record's destination rank, its
           hash mod world. ``block_record_hash`` is SlotRecord's shuffle
           hash vectorized: the XOR of the record's feasigns mod
           0x7FFFFFFF, its label where it has none, one reduceat over the
           key column.
  split    ``split_block``: one block into a sub-block a destination (None
           where no record goes), by ColumnarBlock.select.

``records_to_block`` and ``block_to_records`` convert between the two
codecs record by record (not a hot path): the merge's conversion of a
codec mix, and the tests' oracle.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.columnar import ColumnarBlock
from paddlebox_tpu_torch.data.slot_record import SlotRecord

#: frame magic ("PBXB") — sniffed against the record codec's "PBXR" by
#: ShufflerBase._deliver so one transport carries either frame kind
BLOCK_MAGIC = 0x50425842
_VERSION = 1
# magic, version, n_recs, n_keys, dense_dim (-1 = none), n_tasks
_HDR = struct.Struct("<IIqqii")
_HASH_MOD = np.uint64(0x7FFFFFFF)


# ---------------------------------------------------------------------------
# codec: header + raw column bytes
# ---------------------------------------------------------------------------


def serialize_block(block: ColumnarBlock) -> bytes:
    """Header + raw column bytes; no per-record loop anywhere."""
    dense = block.dense
    tasks = sorted(block.task_labels) if block.task_labels else []
    parts: List[bytes] = [_HDR.pack(
        BLOCK_MAGIC, _VERSION, block.n_recs, block.n_keys,
        -1 if dense is None else int(dense.shape[1]), len(tasks))]
    for t in tasks:
        tb = t.encode("utf-8")
        parts.append(struct.pack("<H", len(tb)))
        parts.append(tb)
    parts.append(np.ascontiguousarray(block.labels, np.int32).tobytes())
    parts.append(np.ascontiguousarray(block.rec_offsets, np.int64).tobytes())
    parts.append(np.ascontiguousarray(block.keys, np.uint64).tobytes())
    parts.append(np.ascontiguousarray(block.key_slot, np.int32).tobytes())
    if dense is not None:
        parts.append(np.ascontiguousarray(dense, np.float32).tobytes())
    for t in tasks:
        parts.append(np.ascontiguousarray(block.task_labels[t],
                                          np.int32).tobytes())
    return b"".join(parts)


def deserialize_block(buf: bytes) -> ColumnarBlock:
    """Inverse of serialize_block. Columns are ZERO-COPY read-only views
    over `buf` — every downstream consumer (concat, pack_columnar,
    split_batches) only reads or copies-by-fancy-index."""
    magic, ver, n_recs, n_keys, dense_dim, n_tasks = _HDR.unpack_from(buf, 0)
    if magic != BLOCK_MAGIC:
        raise ValueError("bad block shuffle magic 0x%x" % magic)
    if ver != _VERSION:
        raise ValueError("unsupported block codec version %d" % ver)
    off = _HDR.size
    tasks: List[str] = []
    for _ in range(n_tasks):
        (tlen,) = struct.unpack_from("<H", buf, off)
        off += 2
        tasks.append(buf[off:off + tlen].decode("utf-8"))
        off += tlen

    def arr(dt, count):
        nonlocal off
        a = np.frombuffer(buf, dtype=dt, count=count, offset=off)
        off += a.nbytes
        return a

    labels = arr(np.int32, n_recs)
    rec_offsets = arr(np.int64, n_recs + 1)
    keys = arr(np.uint64, n_keys)
    key_slot = arr(np.int32, n_keys)
    dense = None
    if dense_dim >= 0:
        dense = arr(np.float32, n_recs * dense_dim).reshape(n_recs,
                                                            dense_dim)
    task_labels = None
    if tasks:
        task_labels = {t: arr(np.int32, n_recs) for t in tasks}
    return ColumnarBlock(keys=keys, key_slot=key_slot, labels=labels,
                         rec_offsets=rec_offsets, dense=dense,
                         task_labels=task_labels)


# ---------------------------------------------------------------------------
# routing: vectorized shuffle hash + fancy-index split
# ---------------------------------------------------------------------------


def block_record_hash(block: ColumnarBlock) -> np.ndarray:
    """[N] int64 per-record shuffle hash, bit-parity with
    `SlotRecord.shuffle_hash()`: XOR of the record's feasigns mod
    0x7FFFFFFF; a record with zero keys hashes to its label. ONE
    reduceat over the key column — nonempty records' start offsets are
    exactly the segment boundaries (empty records contribute no keys)."""
    h = block.labels.astype(np.int64)
    if block.n_keys:
        counts = np.diff(block.rec_offsets)
        nz = counts > 0
        starts = block.rec_offsets[:-1][nz]
        xr = np.bitwise_xor.reduceat(block.keys, starts)
        h[nz] = (xr % _HASH_MOD).astype(np.int64)
    return h


def block_shuffle_dests(block: ColumnarBlock, world: int) -> np.ndarray:
    """[N] int64 destination rank per record (general_shuffle_func
    analog, data_set.cc:2420-2436, vectorized)."""
    return block_record_hash(block) % int(world)


def split_block(block: ColumnarBlock, dests: np.ndarray,
                world: int) -> List[Optional[ColumnarBlock]]:
    """Split one block into per-destination sub-blocks by fancy index;
    empty destinations map to None (nothing travels)."""
    out: List[Optional[ColumnarBlock]] = []
    for d in range(world):
        idx = np.nonzero(dests == d)[0]
        out.append(block.select(idx) if idx.size else None)
    return out


# ---------------------------------------------------------------------------
# record-path oracle converter (NOT a hot path)
# ---------------------------------------------------------------------------


def records_to_block(recs: Sequence[SlotRecord],
                     feed: DataFeedConfig) -> ColumnarBlock:
    """SlotRecords → ColumnarBlock with the native parser's column
    conventions (keys per record in used-slot-ordinal order, dense slots
    concatenated in config order and dim-padded, task labels falling
    back to the click label). Per-record Python loop — the parity-test
    oracle and archive-compat converter, never the production parse."""
    sparse = feed.used_sparse_slots()
    dense_slots = feed.used_dense_slots()
    dense_dim = sum(s.dim for s in dense_slots)
    task_names = [t for t, _ in getattr(feed, "task_label_slots", ())]
    n = len(recs)
    labels = np.zeros(n, np.int32)
    offsets = np.zeros(n + 1, np.int64)
    dense = np.zeros((n, dense_dim), np.float32) if dense_dim else None
    tls = {t: np.zeros(n, np.int32) for t in task_names} if task_names \
        else None
    key_parts: List[np.ndarray] = []
    slot_parts: List[np.ndarray] = []
    for i, r in enumerate(recs):
        labels[i] = r.label
        cnt = 0
        for si in range(len(sparse)):
            v = r.uint64_slots.get(si)
            if v is None or v.size == 0:
                continue
            key_parts.append(np.ascontiguousarray(v, np.uint64))
            slot_parts.append(np.full(v.size, si, np.int32))
            cnt += v.size
        offsets[i + 1] = offsets[i] + cnt
        if dense is not None:
            off = 0
            for fi, s in enumerate(dense_slots):
                v = r.float_slots.get(fi)
                if v is not None:
                    m = min(v.size, s.dim)
                    dense[i, off:off + m] = v[:m]
                off += s.dim
        if tls is not None:
            for t in task_names:
                tls[t][i] = r.extra_labels.get(t, r.label)
    keys = (np.concatenate(key_parts) if key_parts
            else np.empty(0, np.uint64))
    key_slot = (np.concatenate(slot_parts) if slot_parts
                else np.empty(0, np.int32))
    return ColumnarBlock(keys=keys, key_slot=key_slot, labels=labels,
                         rec_offsets=offsets, dense=dense, task_labels=tls)


def block_to_records(block: ColumnarBlock,
                     feed: DataFeedConfig) -> List[SlotRecord]:
    """Inverse of records_to_block (per-record loop, NOT a hot path):
    the codec-mix compat converter — a record-path pass receiving block
    frames from a columnar peer degrades to this instead of dying.
    Fields the block codec does not carry (ins_id, qvalue, pv rank/
    cmatch/search_id, cache_idx) come back at their defaults, exactly
    the fields whose consumers force the record path at dataset
    construction anyway."""
    dense_slots = feed.used_dense_slots()
    tasks = sorted(block.task_labels) if block.task_labels else []
    out: List[SlotRecord] = []
    for r in range(block.n_recs):
        lo, hi = int(block.rec_offsets[r]), int(block.rec_offsets[r + 1])
        slots = block.key_slot[lo:hi]
        u64 = {int(s): block.keys[lo:hi][slots == s].copy()
               for s in np.unique(slots)}
        f32 = {}
        if block.dense is not None:
            off = 0
            for fi, s in enumerate(dense_slots):
                f32[fi] = block.dense[r, off:off + s.dim].copy()
                off += s.dim
        extra = {t: int(block.task_labels[t][r]) for t in tasks}
        out.append(SlotRecord(label=int(block.labels[r]), uint64_slots=u64,
                              float_slots=f32, extra_labels=extra))
    return out
