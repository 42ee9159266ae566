"""Pass-scoped in-memory dataset.

Counterpart of paddlebox_tpu/data/dataset.py with one reader thread. Two
paths, which give byte-identical batches and the same key stream:

  columnar (the default, as in the reference)  the native parser
        (data/native_parser.py) reads each file to one ColumnarBlock and
        registers its keys with the table's feed pass (``add_keys_fn``, the
        MergeInsKeys -> AddKeys step) once a file; the blocks are
        concatenated when the load ends. ``local_shuffle`` draws
        ``RandomState(seed).permutation(n)`` and ``split_batches`` packs in
        that order with ``pack_columnar``.
  record (``columnar=False``, the plain version)  the Python parser yields
        SlotRecords, every 512 of which register their keys;
        ``local_shuffle`` permutes them with ``RandomState(seed).shuffle``
        and ``split_batches`` packs them with ``BatchPacker``.

The join phase's feeds take the record path whatever ``columnar`` says,
where the reference's dataset does (paddlebox_tpu/data/dataset.py:84-93):
a feed with ``rank_offset`` or ``parse_ins_id``, or an ``input_table`` or
``use_cache_idx`` (the packer's aux-offset sources); the pv fields, the
ins_id and the cache index live on SlotRecords, which the columnar blocks
do not carry. So does an explicit record ``parser`` (a plugin's,
data/plugin.py); a parser that only parses to blocks (a native plugin
library) is the columnar path's parser instead. ``columnar`` then reads
False. ``records`` are the loaded records of the record path, in load
order until ``local_shuffle``.

A load whose input the native parser cannot read takes the record path
for that load only, as the reference's does (dataset.py:137-161): a feed
with ``pipe_command``, a ``.gz`` file, an archive shard (data/archive.py,
sniffed by its magic), or a spill to disk (``preload_into_disk`` /
``load_into_disk``: the records go to rotating archive shards, listed in
``disk_files`` when the load ends, and no key is registered; load the
shards back with ``set_filelist(disk_files)`` to train). The reference's
columnar load reads a file directly and so skips ``pipe_command``; the
port does not copy that (ROADMAP.md C).

``flags`` (HostFlags(), made at construction): under
``dataset_disable_shuffle`` ``local_shuffle`` keeps the load order.
``slots_shuffle`` permutes slots' feasign lists across the records (the
AUC runner's probe), on the record path only.

The reader reads the files in list order (``preload_into_memory``;
``wait_preload_done`` joins it and raises ``RuntimeError("dataset load
failed")`` from any error it hit, and ``load_into_memory`` is the two in a
row), so a JAX dataset built with ``read_threads=1`` and the same
``columnar`` yields the same records in the same order, whether or not the
load overlaps a pass that trains (train/preload.py).

The host planes (under the reference's names): the counters
ingest_ins_parsed, ingest_keys_parsed (columnar) and dataset_ins_merged, the
spans ingest_parse (columnar), ingest_merge and ingest_quality, and the drift
monitor's ``observe_block`` on the merged block (metrics/drift.py; it feeds
the active monitor, if any). The reference's ingest_shuffle span times its
cross-host shuffle, which the port does not have; here it times
``local_shuffle``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.data.archive import (BinaryArchiveWriter,
                                              is_archive, read_archive)
from paddlebox_tpu_torch.data.columnar import ColumnarBlock, pack_columnar
from paddlebox_tpu_torch.data.packer import BatchPacker, PackedBatch
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.metrics import drift
from paddlebox_tpu_torch.obs.tracer import span
from paddlebox_tpu_torch.utils.stats import stat_add

AddKeysFn = Callable[[np.ndarray], None]

_MERGE_CHUNK = 512


class BoxDataset:
    def __init__(self, feed: DataFeedConfig,
                 columnar: Optional[bool] = None,
                 input_table=None, use_cache_idx: bool = False,
                 parser=None, flags: Optional[HostFlags] = None) -> None:
        """``columnar`` None: the columnar path unless ``parser`` is a
        record parser."""
        # a task label slot the feed lacks fails on both paths (the record
        # path would quietly train the task on the click label)
        names = {s.name for s in feed.slots}
        for task, slot_name in feed.task_label_slots:
            if slot_name not in names:
                raise ValueError(
                    "task_label_slots: slot %r (task %r) not in the feed "
                    "config" % (slot_name, task))
        self.feed = feed
        self.flags = flags or HostFlags()
        block_parser = parser is not None and not hasattr(parser,
                                                          "parse_file")
        if columnar is None:
            columnar = parser is None or block_parser
        self.columnar = columnar and not (
            feed.rank_offset or feed.parse_ins_id
            or input_table is not None or use_cache_idx)
        if block_parser and not self.columnar:
            raise ValueError("parser %r parses to columnar blocks only; "
                             "this dataset loads on the record path"
                             % (parser,))
        self.packer = BatchPacker(feed, input_table=input_table,
                                  use_cache_idx=use_cache_idx)
        # ``parser`` parses this dataset's loads: the native parser on the
        # columnar path; a load that takes the record path uses
        # ``_record_parser``
        self._record_parser = (parser if parser is not None
                               and not block_parser
                               else MultiSlotParser(feed))
        self.parser = self._record_parser
        if self.columnar:
            if block_parser:
                self.parser = parser
            else:
                # builds the native host library at its first use
                from paddlebox_tpu_torch.data.native_parser import \
                    NativeMultiSlotParser
                self.parser = NativeMultiSlotParser(feed)
        self._load_columnar = self.columnar
        self._disk_writer: Optional[BinaryArchiveWriter] = None
        self.disk_files: List[str] = []
        self._max_lens = np.array(
            [s.max_len for s in self.packer.sparse_slots], np.int64)
        self._files: List[str] = []
        self._records: List[SlotRecord] = []
        self._block: Optional[ColumnarBlock] = None
        self._perm: Optional[np.ndarray] = None
        self._reader: Optional[threading.Thread] = None
        self._load_error: Optional[BaseException] = None

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
        self.release_memory()
        self._load_error = None
        files = list(self._files)
        self._load_columnar = (
            self.columnar and self._disk_writer is None
            and not self.feed.pipe_command
            and not any(f.endswith(".gz") or is_archive(f) for f in files))
        self._reader = threading.Thread(
            target=self._read, args=(files, add_keys_fn, self._disk_writer),
            daemon=True, name="dataset-reader")
        self._reader.start()

    def _read(self, files: List[str], add_keys_fn: Optional[AddKeysFn],
              disk_writer: Optional[BinaryArchiveWriter]) -> None:
        try:
            if self._load_columnar:
                self._read_columnar(files, add_keys_fn)
            else:
                self._read_records(files, add_keys_fn, disk_writer)
        except BaseException as e:  # raised again by wait_preload_done
            self._load_error = e

    def _read_columnar(self, files: List[str],
                       add_keys_fn: Optional[AddKeysFn]) -> None:
        blocks = []
        for path in files:
            with span("ingest_parse"):
                block = self.parser.parse_file_columnar(path)
            stat_add("ingest_ins_parsed", block.n_recs)
            stat_add("ingest_keys_parsed", block.n_keys)
            with span("ingest_merge"):
                if add_keys_fn is not None and block.n_keys:
                    add_keys_fn(block.keys)
                blocks.append(block)
            stat_add("dataset_ins_merged", block.n_recs)
        self._block = ColumnarBlock.concat(blocks)
        if self._block.n_recs:
            with span("ingest_quality"):
                drift.observe_block(self._block)

    def _read_records(self, files: List[str],
                      add_keys_fn: Optional[AddKeysFn],
                      disk_writer: Optional[BinaryArchiveWriter]) -> None:
        for path in files:
            if is_archive(path):
                for recs in read_archive(path):
                    self._merge(recs, add_keys_fn, disk_writer)
                continue
            chunk: List[SlotRecord] = []
            for rec in self._record_parser.parse_file(path):
                chunk.append(rec)
                if len(chunk) >= _MERGE_CHUNK:
                    self._merge(chunk, add_keys_fn, disk_writer)
                    chunk = []
            if chunk:
                self._merge(chunk, add_keys_fn, disk_writer)

    def _merge(self, recs: List[SlotRecord],
               add_keys_fn: Optional[AddKeysFn],
               disk_writer: Optional[BinaryArchiveWriter] = None) -> None:
        stat_add("ingest_ins_parsed", len(recs))
        if disk_writer is not None:
            # the spill registers no key: the shards' load does
            disk_writer.write_records(recs)
            stat_add("dataset_ins_spilled", len(recs))
            return
        with span("ingest_merge"):
            if add_keys_fn is not None:
                keys = [k for k in (r.all_keys() for r in recs) if k.size]
                if keys:
                    add_keys_fn(np.concatenate(keys))
            self._records.extend(recs)
        stat_add("dataset_ins_merged", len(recs))

    def wait_preload_done(self) -> None:
        """Join the reader; raise RuntimeError from the error it hit, if
        any (the reference's wait, paddlebox_tpu/data/dataset.py:355-358).
        """
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.join()
        if self._disk_writer is not None:
            self.disk_files = self._disk_writer.close()
            self._disk_writer = None
        err, self._load_error = self._load_error, None
        if err is not None:
            raise RuntimeError("dataset load failed") from err

    def preload_into_disk(self, out_prefix: str, max_bytes: int = 0) -> None:
        """Start a load that spills the pass's records to rotating archive
        shards ``<out_prefix>-NNNNN.bin`` (``max_bytes`` each, HostFlags'
        dump_file_max_bytes when 0) instead of memory; the shards are
        ``disk_files`` after ``wait_preload_done``."""
        if self._reader is not None:
            raise RuntimeError("preload already running")
        self._disk_writer = BinaryArchiveWriter(out_prefix, max_bytes)
        self.disk_files = []
        try:
            self.preload_into_memory(None)
        except BaseException:
            self._disk_writer = None
            raise

    def load_into_disk(self, out_prefix: str, max_bytes: int = 0) -> None:
        self.preload_into_disk(out_prefix, max_bytes)
        self.wait_preload_done()

    def slots_shuffle(self, slot_indices: Sequence[int],
                      seed: Optional[int] = None) -> None:
        """Permute the feasign lists of each used sparse slot ordinal in
        ``slot_indices`` across the records, one RandomState(seed)
        permutation a slot in order, every other slot in place
        (BoxHelper::SlotsShuffle, reference dataset.py:386-405)."""
        if self._load_columnar:
            raise RuntimeError("slots_shuffle needs the record path "
                               "(construct the dataset with columnar=False)")
        rng = np.random.RandomState(seed)
        n = len(self._records)
        for si in slot_indices:
            vals = [r.uint64_slots.get(si) for r in self._records]
            perm = rng.permutation(n)
            for r, j in zip(self._records, perm):
                v = vals[j]
                if v is None:
                    r.uint64_slots.pop(si, None)
                else:
                    r.uint64_slots[si] = v

    def release_memory(self) -> None:
        self._records = []
        self._block = None
        self._perm = None

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        if self.flags.dataset_disable_shuffle:
            return
        rng = np.random.RandomState(seed)
        with span("ingest_shuffle"):
            if not self._load_columnar:
                rng.shuffle(self._records)
            elif len(self):
                self._perm = rng.permutation(len(self))

    @property
    def records(self) -> List[SlotRecord]:
        return self._records

    @property
    def block(self) -> Optional[ColumnarBlock]:
        """The loaded pass's merged ColumnarBlock (None on the record path
        or before a load): what the streaming runner's admission gate
        scores."""
        return self._block

    def all_keys(self) -> np.ndarray:
        """Every feasign of the loaded pass, in load order."""
        if self._load_columnar:
            return (self._block.keys if self._block is not None
                    else np.empty(0, np.uint64))
        if not self._records:
            return np.empty(0, np.uint64)
        return np.concatenate([r.all_keys() for r in self._records])

    def __len__(self) -> int:
        if self._load_columnar:
            return 0 if self._block is None else self._block.n_recs
        return len(self._records)

    def split_batches(self, num_workers: int = 1) -> List[List[PackedBatch]]:
        """Equal per-worker batch lists; short workers wrap around."""
        bs = self.feed.batch_size
        n = len(self)
        per_worker = (n + num_workers - 1) // num_workers
        target = (per_worker + bs - 1) // bs if n else 0
        if self._load_columnar:
            order = (self._perm if self._perm is not None
                     else np.arange(n, dtype=np.int64))
            pk = self.packer

            def pack(idx):
                return pack_columnar(self._block, idx, self.feed, pk.kcap,
                                     pk.num_slots, self._max_lens)
        else:
            order, pack = self._records, self.packer.pack
        out: List[List[PackedBatch]] = []
        for w in range(num_workers):
            mine = order[w * per_worker:min((w + 1) * per_worker, n)]
            batches = []
            for b in range(target):
                chunk = mine[b * bs:(b + 1) * bs]
                if len(chunk) == 0:
                    chunk = mine[:bs] if len(mine) else order[:bs]
                batches.append(pack(chunk))
            out.append(batches)
        return out
