"""The touched-row journal: the delta side of the checkpoint plane.

Counterpart of paddlebox_tpu/train/journal.py, writing the same segment
files (utils/journal_format.py) byte for byte for the same appends. Every
pass, ``end_pass`` knows exactly which store rows changed and writes them
back; the journal persists that same delta, with the promote's and the
full build's rows (which may have just been created) and the few
deterministic store mutations of the day cadence outside the pass
(save-time stat rewrites, aging, shrink) as event records, into rotated
segment files. Two consumers:

  * ``CheckpointManager.save_base(mode='touched')``: the snapshot is {the
    previous full base's parts (hard-linked) + the journal's segments since
    that base}; replaying the segments over the base gives bit for bit
    what a full save at the same instant would have written;
  * ``train/recovery.py``: each completed pass saves in mode 'auto', so a
    restarted job resumes from the newest pass at the cost of its delta.

What makes replay bit-exact, and when it refuses:

  * ROWS records carry the exact f32 rows handed to the store, and replay
    assigns them verbatim (no creation draws);
  * EVENT records cover ``update_stat_after_save`` (params 1 and 3),
    ``age_unseen_days`` and ``shrink``: deterministic functions of the
    rows and the table config, replayed through the same accessor code;
  * MOVE records carry the exact keys that crossed between the resident
    rows and the SSD tier (``append_move``, the store's journal sink): a
    replay runs the same spill (``spill_exact``) and fault-in
    (``fault_in_keys``) cadence on its scratch store's memory-mode tier,
    so every stat rewrite, shrink and aging event sees the resident set
    the live store saw; EV_TICK_SPILL_AGE is the tier's own day tick
    (``tick_spill_age``). A full save's anchor opens the epoch with one
    MV_SPILL of every spilled key;
  * the epoch is TAINTED (touched saves fall back to full, loudly, and
    replay refuses) by segment loss to the rotation bound and by a store
    load that bypasses the checkpoint plane.

``publish`` (the streaming runner's micro-pass boundary) seals the active
segment, so a serving-side tailer picks the window's rows up as durable
bytes; given the window's born span it first writes a KIND_WATERMARK record
under the same lock (replay skips watermarks, as the reference's does).

Records are flushed per append (a killed process leaves a parseable
prefix); segments fsync when sealed. Appends come from the trainer's
thread and from the checkpoint manager; one lock orders them, and a seal
(which fsyncs) runs under it so that no record lands between a seal and
the snapshot that names the sealed file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
from typing import Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch.config.flags import CkptFlags
from paddlebox_tpu_torch.utils.journal_format import (
    EV_AGE_DAYS, EV_SHRINK, EV_STAT_SAVE_AGE, EV_STAT_SAVE_DELTA, EV_TAINT,
    EV_TICK_SPILL_AGE, FRAME, KIND_EVENT, KIND_HEADER, KIND_MOVE, KIND_ROWS,
    KIND_WATERMARK, MOVE_HEAD, MV_FAULT_IN, MV_SPILL, SEG_MAGIC,
    decode_rows_payload, iter_segment, pack_watermark)
from paddlebox_tpu_torch.utils.lockwatch import make_lock


class JournalIncompleteError(RuntimeError):
    """Replay or a snapshot refused: the journal cannot reconstruct the
    store (a tainted epoch, dropped segments, or no base anchor)."""


def apply_stat_after_save(store, table_cfg, param: int) -> None:
    """The save-time stat rewrite on a store-shaped object: its in-place
    ``update_stat_after_save`` where it has one, else snapshot, rewrite,
    write back (the same accessor arithmetic on the same floats)."""
    fast = getattr(store, "update_stat_after_save", None)
    if fast is not None:
        fast(table_cfg, param)
        return
    keys, values = store.state_items()
    if keys.size:
        store.layout.update_stat_after_save(values, table_cfg, param)
        store.write_back(keys, values)


def replay_record(store, table_cfg, kind: int, payload: bytes) -> None:
    """Apply one journal record to a store (the assign / state_items /
    write_back / age_unseen_days / shrink / tick_spill_age / spill_exact /
    fault_in_keys protocol). Kinds replay does not know (the watermark)
    apply nothing."""
    if kind == KIND_ROWS:
        keys, vals = decode_rows_payload(payload)
        store.assign(keys, vals)
    elif kind == KIND_EVENT:
        (code,) = struct.unpack_from("<I", payload)
        if code in (EV_STAT_SAVE_DELTA, EV_STAT_SAVE_AGE):
            apply_stat_after_save(store, table_cfg, int(code))
        elif code == EV_AGE_DAYS:
            store.age_unseen_days()
        elif code == EV_SHRINK:
            store.shrink()
        elif code == EV_TICK_SPILL_AGE:
            store.tick_spill_age()
        elif code == EV_TAINT:
            raise JournalIncompleteError(
                "journal epoch tainted (a store mutation outside the "
                "journaled cadence): replay cannot reconstruct the store; "
                "resume from the next full base")
        else:
            raise ValueError(f"unknown journal event code {code}")
    elif kind == KIND_MOVE:
        op, _pad, n = MOVE_HEAD.unpack_from(payload)
        keys = np.frombuffer(payload, np.uint64, n, MOVE_HEAD.size)
        if op == MV_SPILL:
            store.spill_exact(keys)
        elif op == MV_FAULT_IN:
            store.fault_in_keys(keys)
        else:
            raise ValueError(f"unknown journal move op {op}")


def replay_segments(store, table_cfg, segment_paths,
                    expect_width: Optional[int] = None) -> int:
    """Apply segments in order onto ``store``; returns the records applied.
    Raises JournalIncompleteError on a taint."""
    applied = 0
    for path in segment_paths:
        for kind, payload in iter_segment(path):
            if kind == KIND_HEADER:
                hdr = json.loads(payload.decode())
                if expect_width is not None and hdr["width"] != expect_width:
                    raise ValueError(
                        f"{path}: journal width {hdr['width']} != store "
                        f"width {expect_width}")
                continue
            if kind == KIND_WATERMARK:
                continue  # freshness lineage, not store state
            replay_record(store, table_cfg, kind, payload)
            applied += 1
    return applied


def reconstruct_blob(base_blob: Dict, segment_paths, layout,
                     table_cfg) -> Dict:
    """base blob + journal segments -> the blob a full save at the
    journal's head would have written (in another row order: compare as
    key -> row maps), resident and tier rows. Replays onto a scratch plain
    store, so every event runs the accessor code the live store ran; no
    creation draw is made (the base install and the ROWS upserts are
    verbatim assigns). The scratch store's tier is in memory (its
    ``ssd_dir`` stripped): replay never writes into, or reads, the live
    store's spill directory."""
    from paddlebox_tpu_torch.embedding.host_store import HostEmbeddingStore
    scratch_cfg = dataclasses.replace(table_cfg, ssd_dir=None)
    st = HostEmbeddingStore(layout, scratch_cfg)
    st.load_blob(base_blob)
    replay_segments(st, scratch_cfg, segment_paths,
                    expect_width=layout.width)
    keys, values = st.state_items()
    skeys, svalues = st.spilled_snapshot()
    if skeys.size:
        keys = np.concatenate([keys, skeys])
        values = np.vstack([values, svalues])
    return {"keys": keys, "values": values,
            "embedx_dim": layout.embedx_dim, "optimizer": layout.optimizer}


class TouchedRowJournal:
    """One rank's persistent journal. Thread-safe appends; segments rotate
    at ``segment_bytes`` with at most ``max_segments`` sealed files kept:
    past the bound the OLDEST is dropped and the epoch marked incomplete
    (touched saves then fall back to full, which re-anchors)."""

    def __init__(self, dirpath: str, layout, table_cfg,
                 segment_bytes: Optional[int] = None,
                 max_segments: Optional[int] = None) -> None:
        defaults = CkptFlags()
        self.dir = dirpath
        self.layout = layout
        self.table_cfg = table_cfg
        self.segment_bytes = int(
            segment_bytes if segment_bytes is not None
            else defaults.ckpt_journal_segment_bytes)
        self.max_segments = int(
            max_segments if max_segments is not None
            else defaults.ckpt_journal_segments)
        os.makedirs(dirpath, exist_ok=True)
        # a new journal cannot replay a previous process's segments (their
        # anchor is gone): sweep them so that restarts leave no orphans; a
        # snapshot that needed their bytes holds hard links to them
        for name in os.listdir(dirpath):
            if name.startswith("seg-") and name.endswith((".jrnl", ".open")):
                try:
                    os.remove(os.path.join(dirpath, name))
                except OSError:
                    pass
        self._lock = make_lock("TouchedRowJournal._lock")
        self._epoch = 0
        self._seq = 0
        # all below guarded by _lock
        self._f = None
        self._open_path: Optional[str] = None
        self._bytes = 0
        self._sealed: List[str] = []
        self._complete = True
        self._taint_reason: Optional[str] = None
        self._anchor: Optional[Dict] = None
        self._dirty_rows = 0

    # ------------------------------------------------------------- records
    def _header_bytes(self) -> bytes:
        hdr = json.dumps({
            "version": 1, "width": int(self.layout.width),
            "embedx_dim": int(self.layout.embedx_dim),
            "optimizer": str(self.layout.optimizer),
            "epoch": self._epoch, "seq": self._seq}).encode()
        return FRAME.pack(KIND_HEADER, len(hdr)) + hdr

    # the *_locked helpers run only under _lock
    def _open_segment_locked(self) -> None:
        self._open_path = os.path.join(
            self.dir, f"seg-{self._epoch:04d}-{self._seq:06d}.open")
        self._seq += 1
        self._f = open(self._open_path, "wb")
        self._f.write(SEG_MAGIC)
        self._f.write(self._header_bytes())
        self._bytes = self._f.tell()

    def _seal_locked(self, fsync: bool = True) -> None:
        if self._f is None:
            return
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        final = self._open_path[:-len(".open")] + ".jrnl"
        os.replace(self._open_path, final)
        self._f = None
        self._open_path = None
        self._sealed.append(final)
        # the bound: drop the OLDEST segment past the cap; the epoch then
        # no longer replays from its anchor
        while len(self._sealed) > self.max_segments:
            victim = self._sealed.pop(0)
            try:
                os.remove(victim)
            except OSError:
                pass
            self._complete = False

    def _append_locked(self, kind: int, payload: bytes) -> None:
        if self._f is None:
            self._open_segment_locked()
        self._f.write(FRAME.pack(kind, len(payload)))
        self._f.write(payload)
        self._f.flush()  # a killed process leaves a parseable prefix
        self._bytes += FRAME.size + len(payload)
        if self._bytes >= self.segment_bytes:
            self._seal_locked()

    def append_rows(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Rows handed to the store (a promote's misses, a full build, a
        write-back), exactly as handed."""
        keys = np.ascontiguousarray(keys, np.uint64)
        values = np.ascontiguousarray(values, np.float32)
        if keys.size == 0:
            return
        head = struct.pack("<qq", keys.size, values.shape[1])
        with self._lock:
            self._append_locked(KIND_ROWS,
                                head + keys.tobytes() + values.tobytes())
            self._dirty_rows += int(keys.size)

    def append_event(self, code: int) -> None:
        with self._lock:
            self._append_locked(KIND_EVENT, struct.pack("<I", code))

    def append_move(self, op: int, keys: np.ndarray) -> None:
        """One move between the resident rows and the SSD tier (MV_SPILL,
        MV_FAULT_IN) with the exact keys that crossed: the store's journal
        sink, called where the move happens, so that records keep the
        order of the mutations."""
        keys = np.ascontiguousarray(keys, np.uint64)
        if keys.size == 0:
            return
        head = MOVE_HEAD.pack(op, 0, keys.size)
        with self._lock:
            self._append_locked(KIND_MOVE, head + keys.tobytes())

    def taint(self, reason: str) -> None:
        """Mark the epoch unsound (a store load outside the checkpoint
        plane, or any mutation the journal did not record); recorded in
        the segment too, so that a raw replay refuses."""
        with self._lock:
            if self._taint_reason is None:
                self._taint_reason = reason
                self._append_locked(KIND_EVENT, struct.pack("<I", EV_TAINT))

    # ------------------------------------------------------------- anchors
    def anchor_full(self, parts: List[str], segments: List[str] = ()
                    ) -> None:
        """Start a new epoch at a FULL base: ``parts`` are its part files
        (and ``segments`` those of a journal-mode snapshot that was loaded,
        which keeps snapshot chains one deep). The previous epoch's
        segment files are deleted: snapshots hold links to what they
        need."""
        with self._lock:
            if self._f is not None:
                self._f.close()
                try:
                    os.remove(self._open_path)
                except OSError:
                    pass
                self._f = None
                self._open_path = None
            self._remove_sealed_locked()
            self._epoch += 1
            self._complete = True
            self._taint_reason = None
            self._dirty_rows = 0
            self._anchor = {"parts": list(parts),
                            "segments": list(segments)}

    def rebase(self, parts: List[str], segments: List[str]) -> None:
        """Move the anchor onto a journal-mode snapshot's own links (its
        base parts and segments): the epoch goes on, but later snapshots
        no longer need the original base directory, which retention may
        prune. The journal directory's sealed files are deleted (the
        snapshot's links keep their bytes)."""
        with self._lock:
            self._remove_sealed_locked()
            self._anchor = {"parts": list(parts),
                            "segments": list(segments)}

    def _remove_sealed_locked(self) -> None:
        for path in self._sealed:
            try:
                os.remove(path)
            except OSError:
                pass
        self._sealed = []

    def snapshot_ready(self) -> bool:
        with self._lock:
            return (self._anchor is not None and self._complete
                    and self._taint_reason is None)

    def snapshot_refs(self) -> Dict:
        """Seal the open segment and return the snapshot's references: the
        anchor's base parts, then every segment from the anchor to now in
        replay order, and the rows appended since the anchor. Raises
        JournalIncompleteError when the epoch cannot reconstruct."""
        with self._lock:
            if self._anchor is None:
                raise JournalIncompleteError(
                    "no full base anchored yet: save a full base first")
            if self._taint_reason is not None:
                raise JournalIncompleteError(
                    f"journal epoch tainted: {self._taint_reason}")
            # seal BEFORE the completeness check: the seal can itself drop
            # the oldest segment past the bound
            self._seal_locked()
            if not self._complete:
                raise JournalIncompleteError(
                    "journal dropped segments past the rotation bound "
                    f"({self.max_segments} x {self.segment_bytes} B)")
            return {"parts": list(self._anchor["parts"]),
                    "segments": (list(self._anchor["segments"])
                                 + list(self._sealed)),
                    "dirty_rows": self._dirty_rows}

    def publish(self, born_min: Optional[float] = None,
                born_max: Optional[float] = None,
                trace: Optional[int] = None) -> Optional[str]:
        """Seal the active segment and return its sealed path (None when
        nothing is pending) (reference journal.py:411-440). Given
        ``born_min`` (and ``born_max``, else born_min), a KIND_WATERMARK
        record of the window's source-file mtime span, the publish time
        and ``trace`` lands just before the seal, in the same fsync.
        Sealing is the rotation path, so the segment bound applies."""
        with self._lock:
            if self._f is None:
                return None
            if born_min is not None:
                bmax = born_max if born_max is not None else born_min
                self._append_locked(
                    KIND_WATERMARK,
                    pack_watermark(born_min, bmax, time.time(), trace or 0))
            self._seal_locked()
            return self._sealed[-1] if self._sealed else None

    @property
    def dirty_rows(self) -> int:
        with self._lock:
            return self._dirty_rows

    def close(self) -> None:
        """Seal the open segment (without an fsync)."""
        with self._lock:
            self._seal_locked(fsync=False)
