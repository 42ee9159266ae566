"""The dump writer: one text line per instance of each batch, and the
dense parameters at a pass end.

Counterpart of paddlebox_tpu/train/dump.py (BoxPSTrainer's dump threads,
boxps_trainer.cc:112-163, and BoxPSWorker::DumpField / DumpParam): the
trainer hands each batch's fields to ``DumpWriter.dump_batch`` when
TrainerConfig has ``dump_fields`` and ``dump_fields_path``; the lines of
a batch go as one chunk through a queue to ``thread_num`` writer threads,
each appending to its own files ``dump-rank<r>-t<i>-NNNNN.txt``, which
rotate before a chunk would take one past ``max_bytes`` (HostFlags'
dump_file_max_bytes when 0). A line is ``<ins_id>\\t<field>:<v>,<v>...``
with the fields sorted by name and the values as ``%g``. With more than
one thread, chunks interleave across the files in no fixed order.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.obs import log
from paddlebox_tpu_torch.utils.lockwatch import make_lock

# close() waits at most this long for each writer thread
CLOSE_TIMEOUT_S = 60.0


def build_dump_tensors(dump_fields: Sequence[str], labels: np.ndarray,
                       preds_np: Dict[str, np.ndarray],
                       main_task: str) -> Dict[str, np.ndarray]:
    """The dump's fields of one batch: ``label``, ``pred_<task>`` for each
    task and ``pred`` (the main task's), filtered to ``dump_fields``."""
    avail = {"label": labels}
    for t, p in preds_np.items():
        avail["pred_" + t] = np.asarray(p)
    avail["pred"] = avail["pred_" + main_task]
    return {f: avail[f] for f in dump_fields if f in avail}


class DumpWriter:
    def __init__(self, path: str, thread_num: int = 1,
                 max_bytes: int = 0, rank: int = 0) -> None:
        self.path = path
        self.rank = rank
        self.max_bytes = max_bytes or HostFlags().dump_file_max_bytes
        os.makedirs(path, exist_ok=True)
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue(1024)
        self.files: List[str] = []  # guarded by _files_lock
        self._files_lock = make_lock("DumpWriter._files_lock")
        self._threads = [
            threading.Thread(target=self._writer_loop, args=(i,),
                             daemon=True, name="dump-writer-%d" % i)
            for i in range(max(1, thread_num))]
        for t in self._threads:
            t.start()

    def dump_batch(self, tensors: Dict[str, np.ndarray],
                   ins_ids: Optional[Sequence[str]] = None,
                   mask: Optional[np.ndarray] = None) -> None:
        """One line per instance whose ``mask`` is set; ``tensors`` maps a
        field to [B] or [B, d]; the instance's position stands for its id
        without ``ins_ids``."""
        fields = sorted(tensors)
        n = len(tensors[fields[0]])
        lines = []
        for i in range(n):
            if mask is not None and not mask[i]:
                continue
            parts = [ins_ids[i] if ins_ids is not None else str(i)]
            for f in fields:
                v = np.atleast_1d(np.asarray(tensors[f][i]))
                parts.append("%s:%s" % (f, ",".join("%g" % x for x in v)))
            lines.append("\t".join(parts))
        if lines:
            self._queue.put("\n".join(lines) + "\n")

    def dump_param(self, params: Dict[str, np.ndarray], step: int) -> None:
        """The dense parameters as text: ``param_step:<step>``, then a line
        ``<name>:<v>,...`` per parameter by name (its first 1024 values)."""
        lines = ["param_step:%d" % step]
        for name in sorted(params):
            v = np.asarray(params[name]).reshape(-1)
            lines.append("%s:%s" % (name,
                                    ",".join("%g" % x for x in v[:1024])))
        self._queue.put("\n".join(lines) + "\n")

    def _writer_loop(self, tid: int) -> None:
        f = None
        written = 0
        idx = 0
        while True:
            chunk = self._queue.get()
            if chunk is None:
                break
            data = chunk.encode("utf-8")
            if f is None or written + len(data) > self.max_bytes:
                if f is not None:
                    f.close()
                p = os.path.join(self.path, "dump-rank%d-t%d-%05d.txt"
                                 % (self.rank, tid, idx))
                idx += 1
                f = open(p, "wb")
                written = 0
                with self._files_lock:
                    self.files.append(p)
            f.write(data)
            written += len(data)
        if f is not None:
            f.close()

    def close(self) -> None:
        """Write what is queued and stop the threads, waiting at most
        CLOSE_TIMEOUT_S for each; one still writing then is logged."""
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(CLOSE_TIMEOUT_S)
            if t.is_alive():
                log.warning("dump writer thread still draining after %.0f s;"
                            " its last file may be short" % CLOSE_TIMEOUT_S)
