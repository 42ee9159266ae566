"""The touched-row journal's segment format.

The port's copy of paddlebox_tpu/utils/journal_format.py, byte for byte in
what it writes and reads, so either package replays and tails what the
other wrote: the magic, the framing, the record kinds, the event and move
codes, the segment iterator, the ROWS payload decoder, the xbox column
math and the incremental tailer (``SegmentTailer``). train/journal.py
writes segments in this format and replays them.

Segment format: 8-byte magic, then framed records (u32 kind + u64 payload
bytes). Every segment opens with a JSON header record carrying the row
layout (width, embedx_dim, optimizer) and its (epoch, seq) position, so
any surviving segment is self-interpreting. Records are flushed per
append: a reader that hits a torn tail (a crash or a write in progress)
sees a clean end of the segment, never garbage; re-reading later picks up
the completed frames.

The port writes MOVE records (the SSD tier's key moves, train/journal.py
``append_move``) and WATERMARK records (the streaming runner's publish,
``TouchedRowJournal.publish``) as the reference does.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

SEG_MAGIC = b"PBTJRNL1"
FRAME = struct.Struct("<IQ")  # kind, payload bytes

KIND_HEADER = 0
KIND_ROWS = 1
KIND_EVENT = 2
KIND_MOVE = 3             # resident<->SSD-tier key movement
KIND_WATERMARK = 4        # feed-to-serve freshness lineage

# event codes — the deterministic out-of-cadence store mutations
EV_STAT_SAVE_DELTA = 1    # update_stat_after_save param=1 (clear delta)
EV_STAT_SAVE_AGE = 3      # update_stat_after_save param=3 (age residents)
EV_AGE_DAYS = 10          # store.age_unseen_days()
EV_SHRINK = 11            # store.shrink() (decay + delete rule)
EV_TICK_SPILL_AGE = 12    # store.tick_spill_age() (save-day boundary)
EV_TAINT = 20             # epoch unsound from here (loss/external load)

# MOVE directions (KIND_MOVE payload op field)
MV_SPILL = 1              # resident rows -> SSD tier
MV_FAULT_IN = 2           # SSD tier -> resident

MOVE_HEAD = struct.Struct("<IIq")  # op, pad, n keys

# KIND_WATERMARK payload: the micro-pass window's source-file mtime span
# (born_min/born_max, unix secs), the publish wall time, and the
# publisher's trace id (0 = none) so the serving tailer can pin its
# apply span to the SAME stitched timeline as the training boundary.
# Appended once per journal publish, immediately before the seal.
# Replay and tailers fall through kinds they do not know, so readers and
# writers of either age interoperate without a format epoch bump.
WM_REC = struct.Struct("<dddQ")    # born_min, born_max, publish_ts, trace


def pack_watermark(born_min: float, born_max: float, publish_ts: float,
                   trace: int = 0) -> bytes:
    """KIND_WATERMARK payload for one published window."""
    return WM_REC.pack(float(born_min), float(born_max),
                       float(publish_ts), int(trace) & (2 ** 64 - 1))


def unpack_watermark(payload: bytes
                     ) -> Tuple[float, float, float, int]:
    """(born_min, born_max, publish_ts, trace) from a KIND_WATERMARK
    payload. Tolerates a longer payload (later writers may append
    fields) but not a shorter one."""
    born_min, born_max, publish_ts, trace = WM_REC.unpack_from(payload)
    return born_min, born_max, publish_ts, trace


def iter_segment(path: str):
    """Yield (kind, payload) records; a truncated tail record (crash
    mid-append) terminates the iteration cleanly."""
    with open(path, "rb") as f:
        if f.read(8) != SEG_MAGIC:
            raise ValueError(f"{path}: not a journal segment")
        while True:
            head = f.read(FRAME.size)
            if len(head) < FRAME.size:
                return
            kind, nbytes = FRAME.unpack(head)
            payload = f.read(nbytes)
            if len(payload) < nbytes:
                return  # torn tail — records before it are intact
            yield kind, payload


def segment_header(path: str) -> Dict:
    for kind, payload in iter_segment(path):
        if kind == KIND_HEADER:
            return json.loads(payload.decode())
        break
    raise ValueError(f"{path}: journal segment missing header record")


def decode_rows_payload(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """KIND_ROWS payload → (keys [n] uint64, values [n, width] f32)
    read-only views over the payload bytes."""
    n, width = struct.unpack_from("<qq", payload)
    off = 16
    keys = np.frombuffer(payload, np.uint64, n, off)
    vals = np.frombuffer(payload, np.float32, n * width,
                         off + keys.nbytes).reshape(n, width)
    return keys, vals


# --------------------------------------------------------------------------
# xbox view column math (the serving projection of a full-width row)
# --------------------------------------------------------------------------

#: header columns of a store row: slot, show, click, delta_score,
#: unseen_days, mf_size, embed_w — embed optimizer state starts at 7
#: (embedding/accessor.py's header columns)
XBOX_HEADER_W = 7
#: column of the 1-d embed weight (accessor.EMBED_W)
EMBED_W_COL = 6

#: embed optimizer state width per sparse optimizer, as ValueLayout gives
#: it (embedding/accessor.py _state_widths)
_EMBED_STATE_DIM = {"adagrad": 1, "adam": 4, "adam_shared": 4, "naive": 0}


def xbox_embed_cols(embedx_dim: int, optimizer: str) -> np.ndarray:
    """Column indices of the SERVED embedding — [embed_w, embedx_0..D)
    — inside a full-width journal/store row: the column math of
    CheckpointManager._xbox_view without a ValueLayout.
    The journal's header record carries (width, embedx_dim, optimizer),
    so a tailed ROWS record projects to exactly the vector a SaveDelta
    view would serve for that key."""
    state = _EMBED_STATE_DIM.get(str(optimizer))
    if state is None:
        raise ValueError(f"unknown sparse optimizer {optimizer!r}")
    embedx_w = XBOX_HEADER_W + state
    return np.concatenate([
        np.array([EMBED_W_COL], np.int64),
        np.arange(embedx_w, embedx_w + int(embedx_dim), dtype=np.int64)])


# --------------------------------------------------------------------------
# Incremental segment tailer (the serving-side journal feed)
# --------------------------------------------------------------------------

_STEM_RE = re.compile(r"(seg-(\d+)-(\d+))\.(open|jrnl)$")


class SegmentTailer:
    """Incremental reader over one journal directory: each ``poll``
    returns the framed records that became durable since the last one,
    in append order, across segment rotations and the ``.open`` →
    ``.jrnl`` seal rename (the sealed file is byte-identical to the
    open one — offsets survive the rename because they key on the
    segment STEM).

    Torn tails are the normal case, not an error: the writer flushes
    per record, so a poll racing an append reads the complete-frame
    prefix and leaves its offset BEFORE the partial frame; the next
    poll re-reads it once it is whole.

    Reset semantics (the honesty boundary): ``poll`` reports
    ``reset=True`` — and re-reads everything that survives from byte 0
    — whenever the incremental history broke:

      * a new EPOCH appeared (anchor_full: a full base landed and the
        old epoch's segments were deleted — the on-disk views now cover
        what the journal covered);
      * a previously-tailed segment VANISHED mid-epoch (rotation bound
        dropped the oldest, or a restart swept the dir) — rows whose
        last touch lived only there are unrecoverable here;
      * a segment's header disagrees on the row layout (width change).

    A consumer holding derived state (the serving overlay) must drop it
    on reset and rebuild from the records of the same poll: every ROWS
    record carries absolute row values, so replaying the surviving
    suffix yields bit-correct rows for every key it contains, and keys
    lost with a dropped segment fall through to the on-disk views."""

    def __init__(self, dirpath: str) -> None:
        self.dir = dirpath
        self._epoch: Optional[int] = None
        self._offsets: Dict[str, int] = {}   # stem -> bytes consumed
        self.header: Optional[Dict] = None   # newest header seen

    def _scan(self) -> List[Tuple[int, int, str, str]]:
        """[(epoch, seq, stem, path)] sorted in append order; a sealed
        ``.jrnl`` shadows its ``.open`` twin (same bytes, final name)."""
        best: Dict[str, Tuple[int, int, str]] = {}
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        for name in names:
            m = _STEM_RE.fullmatch(name)
            if not m:
                continue
            stem, epoch, seq, ext = (m.group(1), int(m.group(2)),
                                     int(m.group(3)), m.group(4))
            cur = best.get(stem)
            if cur is None or ext == "jrnl":
                best[stem] = (epoch, seq, os.path.join(self.dir, name))
        return sorted((e, s, stem, path)
                      for stem, (e, s, path) in best.items())

    def _read_from(self, path: str, offset: int
                   ) -> Tuple[List[Tuple[int, bytes]], int]:
        """Complete frames from byte ``offset`` (0 = validate magic
        first); returns (records, new offset). The offset never crosses
        a partial frame."""
        records: List[Tuple[int, bytes]] = []
        with open(path, "rb") as f:
            if offset == 0:
                magic = f.read(8)
                if len(magic) < 8:
                    return records, 0        # racing creation: retry later
                if magic != SEG_MAGIC:
                    raise ValueError(f"{path}: not a journal segment")
                offset = 8
            else:
                f.seek(offset)
            while True:
                head = f.read(FRAME.size)
                if len(head) < FRAME.size:
                    return records, offset
                kind, nbytes = FRAME.unpack(head)
                payload = f.read(nbytes)
                if len(payload) < nbytes:
                    return records, offset
                records.append((kind, payload))
                offset += FRAME.size + nbytes

    def poll(self) -> Tuple[List[Tuple[int, bytes]], bool]:
        """(new records in append order, reset) — see class docstring.
        On reset the returned records are the full re-read of every
        surviving segment (the consumer rebuilds from exactly them)."""
        segs = self._scan()
        if not segs:
            # an empty dir after we tailed something = swept: reset so
            # the consumer drops rows that no longer exist on disk
            reset = bool(self._offsets)
            self._offsets = {}
            return [], reset
        top_epoch = segs[-1][0]
        live_stems = {stem for _e, _s, stem, _p in segs}
        reset = False
        if self._epoch is not None and top_epoch != self._epoch:
            reset = True                     # anchor_full bumped the epoch
        elif any(stem not in live_stems for stem in self._offsets):
            reset = True                     # tailed segment vanished
        self._epoch = top_epoch
        if reset:
            self._offsets = {}
        records: List[Tuple[int, bytes]] = []
        for _epoch, _seq, stem, path in segs:
            try:
                recs, off = self._read_from(
                    path, self._offsets.get(stem, 0))
            except FileNotFoundError:
                continue                     # sealed/swept between scan+read
            for kind, payload in recs:
                if kind == KIND_HEADER:
                    hdr = json.loads(payload.decode())
                    if (self.header is not None and not reset
                            and hdr.get("width") != self.header.get("width")):
                        # layout changed mid-tail: the derived state is
                        # meaningless — rebuild from scratch next poll
                        self._offsets = {}
                        self.header = hdr
                        return [], True
                    self.header = hdr
            records.extend(recs)
            self._offsets[stem] = off
        return records, reset
