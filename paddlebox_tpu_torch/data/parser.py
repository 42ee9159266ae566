"""MultiSlot text parser.

Counterpart of paddlebox_tpu/data/parser.py (the record path): one instance
per line, slots in feed-config order, each ``<count> <v_1> ... <v_count>``;
the float slot named "click" is the label, a used float slot's values are
float32 dense inputs, and the first value of a ``task_label_slots`` slot is
that task's label. Under the feed's ``parse_ins_id`` a line leads with the
instance id. Malformed lines are dropped, as in the reference parser.

``parse_file`` reads plain text, a ``.gz`` file through gzip, or, under the
feed's ``pipe_command``, the command's output with the file on its stdin
(a ``.gz`` file piped from ``zcat``), as the reference does
(paddlebox_tpu/data/parser.py:83-115). A command that ends with 141 or
-13 (SIGPIPE: the reader stopped early) is not an error; any other
non-zero code raises IOError naming the command and the file.
"""

from __future__ import annotations

import gzip
import shlex
import subprocess
from typing import Iterator, Optional

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.slot_record import SlotRecord


class MultiSlotParser:
    label_slot = "click"

    def __init__(self, feed: DataFeedConfig) -> None:
        self.feed = feed
        self._all_slots = list(feed.slots)
        self._task_by_slot = {slot: task
                              for task, slot in feed.task_label_slots}

    def parse_line(self, line: str) -> Optional[SlotRecord]:
        toks = line.split()
        if not toks:
            return None
        rec = SlotRecord()
        pos = 0
        if self.feed.parse_ins_id:
            rec.ins_id = toks[0]
            pos = 1
        u_idx = 0
        f_idx = 0
        try:
            for slot in self._all_slots:
                n = int(toks[pos])
                pos += 1
                vals = toks[pos:pos + n]
                if len(vals) != n:
                    raise ValueError("slot %s: expected %d values"
                                     % (slot.name, n))
                pos += n
                task = self._task_by_slot.get(slot.name)
                if (not slot.is_used and slot.name != self.label_slot
                        and task is None):
                    continue
                if slot.type == "uint64":
                    if task is not None and n >= 1:
                        rec.extra_labels[task] = int(vals[0])
                    if slot.is_used:
                        rec.uint64_slots[u_idx] = np.array(
                            [int(v) for v in vals], dtype=np.uint64)
                        u_idx += 1
                else:
                    arr = np.array([float(v) for v in vals],
                                   dtype=np.float32)
                    if slot.name == self.label_slot and n >= 1:
                        rec.label = int(arr[0])
                    if task is not None and n >= 1:
                        rec.extra_labels[task] = int(arr[0])
                    if slot.is_used:
                        rec.float_slots[f_idx] = arr
                        f_idx += 1
        except (ValueError, IndexError):
            return None
        return rec

    def parse_file(self, path: str) -> Iterator[SlotRecord]:
        for line in open_lines(path, self.feed.pipe_command):
            rec = self.parse_line(line)
            if rec is not None:
                yield rec


def open_lines(path: str, pipe_command: str = "") -> Iterator[str]:
    """The text lines of one input file: through ``pipe_command`` when it
    is set, else the file itself (gunzipped when it ends in .gz)."""
    if pipe_command:
        gz = path.endswith(".gz")
        src = None if gz else open(path, "rb")
        cmd = ("zcat %s | %s" % (shlex.quote(path), pipe_command) if gz
               else pipe_command)
        proc = subprocess.Popen(cmd, shell=True, stdin=src,
                                stdout=subprocess.PIPE, text=True)
        try:
            yield from proc.stdout
        finally:
            if src is not None:
                src.close()
            proc.stdout.close()
            rc = proc.wait()
            if rc not in (0, 141, -13):
                raise IOError("pipe_command %r failed (rc=%d) on %s"
                              % (pipe_command, rc, path))
        return
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            yield from fh
    else:
        with open(path, "r") as fh:
            yield from fh
