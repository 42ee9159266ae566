"""Pass-scoped in-memory dataset (the record path).

Counterpart of paddlebox_tpu/data/dataset.py with ``columnar=False``: files
are read in list order, every 512 parsed records register their keys with
the table's feed pass (``add_keys_fn``, the MergeInsKeys -> AddKeys step),
``local_shuffle`` permutes the records with ``RandomState(seed).shuffle`` as
the JAX dataset does, and ``split_batches`` packs equal per-worker batch
lists. One reader thread reads the files in list order
(``preload_into_memory``; ``wait_preload_done`` joins it and raises its
error, and ``load_into_memory`` is the two in a row): a JAX dataset built
with ``read_threads=1, columnar=False`` yields the same records in the same
order, whether or not the load overlaps a pass that trains
(train/preload.py).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.data.packer import BatchPacker, PackedBatch
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.data.slot_record import SlotRecord

AddKeysFn = Callable[[np.ndarray], None]

_MERGE_CHUNK = 512


class BoxDataset:
    def __init__(self, feed: DataFeedConfig) -> None:
        self.feed = feed
        self.parser = MultiSlotParser(feed)
        self.packer = BatchPacker(feed)
        self._files: List[str] = []
        self._records: List[SlotRecord] = []
        self._reader: Optional[threading.Thread] = None
        self._load_error: Optional[Exception] = None

    def set_filelist(self, files: Sequence[str]) -> None:
        self._files = list(files)

    def load_into_memory(self, add_keys_fn: Optional[AddKeysFn] = None) -> None:
        self.preload_into_memory(add_keys_fn)
        self.wait_preload_done()

    def preload_into_memory(self,
                            add_keys_fn: Optional[AddKeysFn] = None) -> None:
        """Start the reader thread over the file list; returns at once.
        ``add_keys_fn`` is called on that thread."""
        if self._reader is not None:
            raise RuntimeError("preload already running")
        self._records = []
        self._load_error = None
        files = list(self._files)
        self._reader = threading.Thread(
            target=self._read, args=(files, add_keys_fn), daemon=True,
            name="dataset-reader")
        self._reader.start()

    def _read(self, files: List[str],
              add_keys_fn: Optional[AddKeysFn]) -> None:
        try:
            for path in files:
                chunk: List[SlotRecord] = []
                for rec in self.parser.parse_file(path):
                    chunk.append(rec)
                    if len(chunk) >= _MERGE_CHUNK:
                        self._merge(chunk, add_keys_fn)
                        chunk = []
                if chunk:
                    self._merge(chunk, add_keys_fn)
        except Exception as e:  # raised again by wait_preload_done
            self._load_error = e

    def wait_preload_done(self) -> None:
        """Join the reader; raise the error it hit, if any."""
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.join()
        err, self._load_error = self._load_error, None
        if err is not None:
            raise err

    def release_memory(self) -> None:
        self._records = []

    def _merge(self, recs: List[SlotRecord],
               add_keys_fn: Optional[AddKeysFn]) -> None:
        if add_keys_fn is not None:
            keys = [k for k in (r.all_keys() for r in recs) if k.size]
            if keys:
                add_keys_fn(np.concatenate(keys))
        self._records.extend(recs)

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        np.random.RandomState(seed).shuffle(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def split_batches(self, num_workers: int = 1) -> List[List[PackedBatch]]:
        """Equal per-worker batch lists; short workers wrap around."""
        bs = self.feed.batch_size
        n = len(self._records)
        per_worker = (n + num_workers - 1) // num_workers
        target = (per_worker + bs - 1) // bs if n else 0
        out: List[List[PackedBatch]] = []
        for w in range(num_workers):
            recs = self._records[w * per_worker:min((w + 1) * per_worker, n)]
            batches = []
            for b in range(target):
                chunk = recs[b * bs:(b + 1) * bs] or recs[:bs] \
                    or self._records[:bs]
                batches.append(self.packer.pack(chunk))
            out.append(batches)
        return out
