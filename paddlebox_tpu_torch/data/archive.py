"""The pass's binary archive spill and the SlotRecord codec it carries.

Counterpart of paddlebox_tpu/data/archive.py (PreLoadIntoDisk /
DumpIntoDisk / LoadIntoDiskedFile, data_set.cc:2090-2215): record batches
written to rotating shard files ``<prefix>-NNNNN.bin``, each block a
``<II`` header (magic "PBXA", payload length) and the payload, so a pass
larger than host memory streams from local disk. A read worker takes an
archive file in place of a text file (``is_archive`` sniffs the magic).

The payload is the record codec ``serialize_records`` /
``deserialize_records``, a byte-equal copy of the reference's
(paddlebox_tpu/data/shuffle.py:73-135, the cross-host shuffle's record
frames, which data/shuffle.py imports from here): a ``<II`` header (magic "PBXR",
count), then a record's label, rank, 16 bits of cmatch, its ins_id's
length, search_id, qvalue and sparse slot count (``<iiHHQfH``), the
ins_id, each sparse slot (``<HI`` slot, count, then uint64 values), the
float slots the same way with float32 values, and the task labels. As in
the reference the codec keeps only the low 16 bits of ``cmatch`` and drops
``cache_idx`` (a decoded record has -1). Files either package writes read
in the other.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Sequence

import numpy as np

from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.data.slot_record import SlotRecord

_REC_MAGIC = 0x50425852    # "PBXR"
_REC_HEAD = struct.Struct("<iiHHQfH")
_BLOCK_MAGIC = 0x50425841  # "PBXA"
_BLOCK_HDR = struct.Struct("<II")  # magic, payload length


def serialize_records(recs: Sequence[SlotRecord]) -> bytes:
    """One batch of records as the codec's bytes."""
    parts: List[bytes] = [struct.pack("<II", _REC_MAGIC, len(recs))]
    for r in recs:
        ins_id = r.ins_id.encode("utf-8")
        u64_items = sorted(r.uint64_slots.items())
        f32_items = sorted(r.float_slots.items())
        parts.append(_REC_HEAD.pack(r.label, r.rank, r.cmatch & 0xFFFF,
                                    len(ins_id), r.search_id, r.qvalue,
                                    len(u64_items)))
        parts.append(ins_id)
        for slot, vals in u64_items:
            v = np.ascontiguousarray(vals, dtype=np.uint64)
            parts.append(struct.pack("<HI", slot, v.size))
            parts.append(v.tobytes())
        parts.append(struct.pack("<H", len(f32_items)))
        for slot, vals in f32_items:
            v = np.ascontiguousarray(vals, dtype=np.float32)
            parts.append(struct.pack("<HI", slot, v.size))
            parts.append(v.tobytes())
        extra = sorted(r.extra_labels.items())
        parts.append(struct.pack("<H", len(extra)))
        for task, lab in extra:
            tb = task.encode("utf-8")
            parts.append(struct.pack("<Hi", len(tb), int(lab)))
            parts.append(tb)
    return b"".join(parts)


def _slots(buf: bytes, off: int, n: int, dtype) -> tuple:
    """(slot -> values, offset after them) of ``n`` ``<HI``-headed slot
    arrays of ``dtype`` at ``off``."""
    out: Dict[int, np.ndarray] = {}
    size = np.dtype(dtype).itemsize
    for _ in range(n):
        slot, cnt = struct.unpack_from("<HI", buf, off)
        off += 6
        out[slot] = np.frombuffer(buf, dtype=dtype, count=cnt,
                                  offset=off).copy()
        off += size * cnt
    return out, off


def deserialize_records(buf: bytes) -> List[SlotRecord]:
    """The records of one ``serialize_records`` batch."""
    magic, n = struct.unpack_from("<II", buf, 0)
    if magic != _REC_MAGIC:
        raise ValueError("bad shuffle record magic 0x%x" % magic)
    off = 8
    out: List[SlotRecord] = []
    for _ in range(n):
        (label, rank, cmatch, id_len, search_id, qvalue,
         n_u64) = _REC_HEAD.unpack_from(buf, off)
        off += _REC_HEAD.size
        ins_id = buf[off:off + id_len].decode("utf-8")
        off += id_len
        u64_slots, off = _slots(buf, off, n_u64, np.uint64)
        (n_f32,) = struct.unpack_from("<H", buf, off)
        float_slots, off = _slots(buf, off + 2, n_f32, np.float32)
        (n_extra,) = struct.unpack_from("<H", buf, off)
        off += 2
        extra_labels: Dict[str, int] = {}
        for _ in range(n_extra):
            tlen, lab = struct.unpack_from("<Hi", buf, off)
            off += 6
            extra_labels[buf[off:off + tlen].decode("utf-8")] = lab
            off += tlen
        out.append(SlotRecord(label=label, uint64_slots=u64_slots,
                              float_slots=float_slots, ins_id=ins_id,
                              rank=rank, cmatch=cmatch, qvalue=qvalue,
                              search_id=search_id,
                              extra_labels=extra_labels))
    return out


def is_archive(path: str) -> bool:
    """Whether ``path`` starts with an archive block's magic."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    return len(head) == 4 and struct.unpack("<I", head)[0] == _BLOCK_MAGIC


class BinaryArchiveWriter:
    """Rotating archive shards ``<prefix>-NNNNN.bin``: a block opens a new
    shard when it would take a non-empty one past ``max_bytes``
    (HostFlags' ``dump_file_max_bytes`` when 0)."""

    def __init__(self, prefix: str, max_bytes: int = 0):
        self.prefix = prefix
        self.max_bytes = max_bytes or HostFlags().dump_file_max_bytes
        self._file = None
        self._file_bytes = 0
        self._file_idx = 0
        self.files: List[str] = []
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    def _rotate(self) -> None:
        if self._file is not None:
            self._file.close()
        path = "%s-%05d.bin" % (self.prefix, self._file_idx)
        self._file_idx += 1
        self._file = open(path, "wb")
        self._file_bytes = 0
        self.files.append(path)

    def write_records(self, recs: Sequence[SlotRecord]) -> None:
        if not recs:
            return
        payload = serialize_records(recs)
        if self._file is None or (
                self._file_bytes
                and self._file_bytes + len(payload) > self.max_bytes):
            self._rotate()
        self._file.write(_BLOCK_HDR.pack(_BLOCK_MAGIC, len(payload)))
        self._file.write(payload)
        self._file_bytes += _BLOCK_HDR.size + len(payload)

    def close(self) -> List[str]:
        """Close the open shard; the shards written, in order."""
        if self._file is not None:
            self._file.close()
            self._file = None
        return self.files


def read_archive(path: str) -> Iterator[List[SlotRecord]]:
    """The record batches of one archive shard, in write order."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_BLOCK_HDR.size)
            if not hdr:
                return
            if len(hdr) < _BLOCK_HDR.size:
                raise IOError("truncated archive block header in " + path)
            magic, length = _BLOCK_HDR.unpack(hdr)
            if magic != _BLOCK_MAGIC:
                raise IOError("bad archive magic 0x%x in %s" % (magic, path))
            payload = f.read(length)
            if len(payload) < length:
                raise IOError("truncated archive block in " + path)
            yield deserialize_records(payload)
