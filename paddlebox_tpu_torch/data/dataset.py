"""Pass-scoped in-memory dataset.

Counterpart of paddlebox_tpu/data/dataset.py. Two paths, which give
byte-identical batches and the same key stream:

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

``shuffler`` (data/shuffle.py, Fleet.make_shuffler's): the cross-host
instance shuffle. Each file's block (columnar path) or each 512 records
(record path) go through its ``scatter_block`` or ``scatter``: this
rank's instances merge at once, the others travel to their ranks;
``wait_preload_done`` flushes it, merging the frames this rank received
after its own (by source rank, then frame), and finishes the load even
when the flush fails (a dead peer), then raises. Under
``shuffle_block_codec=False`` a shuffled dataset loads on the record
path, as the reference's does. Received frames of the other codec (a
peer on the other path) convert at the merge with a loud warning, once a
load (stat ingest_codec_mix_converted). ``dataset_disable_shuffle``
turns the cross-host shuffle off too.

``flags`` (HostFlags(), made at construction): under
``dataset_disable_shuffle`` ``local_shuffle`` keeps the load order.
``slots_shuffle`` permutes slots' feasign lists across the records (the
AUC runner's probe), on the record path only.

The reader pool (``preload_into_memory``): ``read_threads`` threads (the
reference's keyword and default, 4; below 1 reads with one, as the
reference's ``max(1, read_threads)``) parse the files concurrently, at most
2 x read_threads files ahead of the merge (the native parser's ctypes
call releases the interpreter lock), and one merge thread takes each
file's output in FILE-LIST order: ``add_keys_fn``, the cross-host
shuffle's scatter, the archive spill and the merged block or records see
the files in list order whatever ``read_threads`` is, so a load at any
``read_threads`` is the load at 1, byte for byte (records, block,
``all_keys()``, the drift monitor's observation). The reference merges in
arrival order, so its loads above one thread do not repeat; a JAX
dataset built with ``read_threads=1`` and the same ``columnar`` yields
the port's records in the port's order (ROADMAP.md C).
``wait_preload_done`` joins the pool and raises ``RuntimeError("dataset
load failed")`` from the first failed file (its readers stop; none
outlives the call), and ``load_into_memory`` is the two in a row; the
load may overlap a pass that trains (train/preload.py).

The host planes (under the reference's names): the counters
ingest_ins_parsed, ingest_keys_parsed (columnar) and dataset_ins_merged, the
spans ingest_parse (columnar), ingest_merge and ingest_quality, and the drift
monitor's ``observe_block`` on the merged block (metrics/drift.py; it feeds
the active monitor, if any). The span ingest_shuffle times
``local_shuffle`` and each scatter of the cross-host shuffle,
ingest_shuffle_flush its flush.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.data.archive import (BinaryArchiveWriter,
                                              is_archive, read_archive)
from paddlebox_tpu_torch.data.block_shuffle import (block_to_records,
                                                    records_to_block)
from paddlebox_tpu_torch.data.columnar import ColumnarBlock, pack_columnar
from paddlebox_tpu_torch.data.packer import BatchPacker, PackedBatch
from paddlebox_tpu_torch.data.parser import MultiSlotParser
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.metrics import drift
from paddlebox_tpu_torch.obs import log as obs_log
from paddlebox_tpu_torch.obs.tracer import span
from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed
from paddlebox_tpu_torch.utils.stats import stat_add

AddKeysFn = Callable[[np.ndarray], None]

_MERGE_CHUNK = 512


class _ReaderPool:
    """``n`` threads run ``parse(path)`` over ``files``, taking the file
    indices from a Channel, at most ``2 * n`` files ahead of the consumer.
    Iterating yields each file's output in list order and raises the
    error of the first failed file it reaches. ``close`` stops the
    workers (each ends its current file) and joins them."""

    def __init__(self, files: Sequence[str], parse: Callable, n: int) -> None:
        self._files = list(files)
        self._parse = parse
        self._window = 2 * max(1, int(n))
        self._done: dict = {}        # file index -> (ok, output or error)
        self._next = 0               # the index the consumer waits for
        self._stop = False
        self._cv = threading.Condition()
        self._work: Channel = Channel()
        self._work.put_many(range(len(self._files)))
        self._work.close()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name="dataset-reader-%d" % k)
            for k in range(min(max(1, int(n)), len(self._files)))]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            try:
                i = self._work.get()
            except ChannelClosed:
                return
            with self._cv:
                while not self._stop and i >= self._next + self._window:
                    self._cv.wait()
                if self._stop:
                    return
            try:
                out = (True, self._parse(self._files[i]))
            except BaseException as e:  # raised on the consumer's thread
                out = (False, e)
            with self._cv:
                self._done[i] = out
                self._cv.notify_all()

    def __iter__(self):
        for i in range(len(self._files)):
            with self._cv:
                while i not in self._done:
                    self._cv.wait()
                ok, out = self._done.pop(i)
                self._next = i + 1
                self._cv.notify_all()
            if not ok:
                raise out
            yield out

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._done.clear()
            self._cv.notify_all()
        self._work.drain()
        for t in self._threads:
            t.join()


class BoxDataset:
    def __init__(self, feed: DataFeedConfig, read_threads: int = 4,
                 parser=None, shuffler=None,
                 columnar: Optional[bool] = None,
                 input_table=None, use_cache_idx: bool = False,
                 flags: Optional[HostFlags] = None) -> None:
        """``read_threads``: the reader pool's threads (module
        docstring). ``columnar`` None: the columnar path unless ``parser``
        is a record parser. ``shuffler``: the cross-host instance shuffle
        (module docstring)."""
        self.read_threads = int(read_threads)
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
        self.shuffler = shuffler
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
        self._blocks: List[ColumnarBlock] = []
        self._add_keys_fn: Optional[AddKeysFn] = None
        self._mix_warned = False

    def set_filelist(self, files: Sequence[str]) -> None:
        self._files = list(files)

    def my_shard_files(self, rank: int, world: int) -> List[str]:
        """This rank's files of the list, those at i % world == rank
        (data_set.cc:1961-1973; reference dataset.py:115-117)."""
        return [f for i, f in enumerate(self._files) if i % world == rank]

    def load_into_memory(self, add_keys_fn: Optional[AddKeysFn] = None) -> None:
        self.preload_into_memory(add_keys_fn)
        self.wait_preload_done()

    def preload_into_memory(self,
                            add_keys_fn: Optional[AddKeysFn] = None) -> None:
        """Start the reader pool and its merge thread over the file list;
        returns at once. ``add_keys_fn`` is called on the merge thread, a
        file at a time in list order."""
        if self._reader is not None:
            raise RuntimeError("preload already running")
        self.release_memory()
        self._load_error = None
        files = list(self._files)
        self._load_columnar = (
            self.columnar and self._disk_writer is None
            and not self.feed.pipe_command
            and not any(f.endswith(".gz") or is_archive(f) for f in files)
            and not (self._shuffling and not self.flags.shuffle_block_codec))
        self._blocks = []
        self._add_keys_fn = add_keys_fn
        self._mix_warned = False
        self._reader = threading.Thread(
            target=self._read, args=(files, add_keys_fn, self._disk_writer),
            daemon=True, name="dataset-merge")
        self._reader.start()

    def _read(self, files: List[str], add_keys_fn: Optional[AddKeysFn],
              disk_writer: Optional[BinaryArchiveWriter]) -> None:
        """The merge thread: the pool's outputs in file-list order."""
        try:
            pool = _ReaderPool(files, self._parse_file,
                               max(1, self.read_threads))
            try:
                for out in pool:
                    if self._load_columnar:
                        self._merge_block(out)
                    else:
                        for recs in out:
                            self._put_records(recs, add_keys_fn,
                                              disk_writer)
            finally:
                pool.close()
            if self._load_columnar and not self._shuffling:
                self._finish_columnar()
        except BaseException as e:  # raised again by wait_preload_done
            self._load_error = e

    def _parse_file(self, path: str):
        """A reader's work: one file's block (the columnar path), or its
        records in chunks of _MERGE_CHUNK (the record path; an archive
        shard's as its frames hold them)."""
        if self._load_columnar:
            with span("ingest_parse"):
                return self.parser.parse_file_columnar(path)
        if is_archive(path):
            return list(read_archive(path))
        chunks: List[List[SlotRecord]] = []
        chunk: List[SlotRecord] = []
        for rec in self._record_parser.parse_file(path):
            chunk.append(rec)
            if len(chunk) >= _MERGE_CHUNK:
                chunks.append(chunk)
                chunk = []
        if chunk:
            chunks.append(chunk)
        return chunks

    @property
    def _shuffling(self) -> bool:
        return (self.shuffler is not None
                and not self.flags.dataset_disable_shuffle)

    # the merge: what the reader and the shuffle's flush hand over
    def put(self, block: ColumnarBlock) -> None:
        """Merge one block (the columnar path; a record-path load converts
        it)."""
        if not self._load_columnar:
            self._warn_mix("columnar block frames in a record-path pass")
            stat_add("ingest_codec_mix_converted", block.n_recs)
            self._merge(block_to_records(block, self.feed),
                        self._add_keys_fn, self._disk_writer)
            return
        with span("ingest_merge"):
            if self._add_keys_fn is not None and block.n_keys:
                self._add_keys_fn(block.keys)
            self._blocks.append(block)
        stat_add("dataset_ins_merged", block.n_recs)

    def put_many(self, recs: List[SlotRecord]) -> None:
        """Merge records (the record path; a columnar load converts
        them)."""
        if self._load_columnar:
            self._warn_mix("record frames in a columnar pass")
            stat_add("ingest_codec_mix_converted", len(recs))
            self.put(records_to_block(recs, self.feed))
            return
        self._merge(list(recs), self._add_keys_fn, self._disk_writer)

    def _warn_mix(self, kind: str) -> None:
        if not self._mix_warned:
            self._mix_warned = True
            obs_log.warning(
                "shuffle codec mix: " + kind + " — a peer runs the other "
                "ingest mode (archive shard? split shuffle_block_codec "
                "flag?); converting at the merge, throughput degraded")

    def _merge_block(self, block: ColumnarBlock) -> None:
        """One file's block to the merge, through the cross-host shuffle
        when there is one."""
        stat_add("ingest_ins_parsed", block.n_recs)
        stat_add("ingest_keys_parsed", block.n_keys)
        if self._shuffling:
            with span("ingest_shuffle"):
                self.shuffler.scatter_block(block, self)
        else:
            self.put(block)

    def _finish_columnar(self) -> None:
        """The merged blocks as the pass's one block, and the drift
        monitor's look at it."""
        self._block = ColumnarBlock.concat(self._blocks)
        self._blocks = []
        if self._block.n_recs:
            with span("ingest_quality"):
                drift.observe_block(self._block)

    def _put_records(self, recs: List[SlotRecord],
                     add_keys_fn: Optional[AddKeysFn],
                     disk_writer: Optional[BinaryArchiveWriter]) -> None:
        """Parsed records to the merge, through the cross-host shuffle when
        there is one."""
        stat_add("ingest_ins_parsed", len(recs))
        if self._shuffling:
            with span("ingest_shuffle"):
                self.shuffler.scatter(recs, self)
        else:
            self._merge(recs, add_keys_fn, disk_writer)

    def _merge(self, recs: List[SlotRecord],
               add_keys_fn: Optional[AddKeysFn],
               disk_writer: Optional[BinaryArchiveWriter] = None) -> None:
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
        """Join the reader; with a shuffler, flush it (span
        ingest_shuffle_flush) and merge what it received, then finish the
        load even where the flush failed (reference :331-350). Raises
        RuntimeError from the reader's error, which comes first, or from
        the flush's."""
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.join()
        flush_error: Optional[BaseException] = None
        try:
            if reader is not None and self._shuffling:
                with span("ingest_shuffle_flush"):
                    self.shuffler.flush(self)
        except BaseException as e:
            flush_error = e
        finally:
            if reader is not None and self._shuffling \
                    and self._load_columnar:
                self._finish_columnar()
            self._add_keys_fn = None
            if self._disk_writer is not None:
                self.disk_files = self._disk_writer.close()
                self._disk_writer = None
        err, self._load_error = self._load_error, None
        if err is not None:
            raise RuntimeError("dataset load failed") from err
        if flush_error is not None:
            raise RuntimeError(
                "cross-host shuffle flush failed") from flush_error

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
        self._blocks = []
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

    def split_batches(self, num_workers: int = 1,
                      equalize: Optional[Callable[[int], int]] = None
                      ) -> List[List[PackedBatch]]:
        """Equal per-worker batch lists; short workers wrap around
        (compute_paddlebox_thread_batch, data_set.cc:2690-2755; reference
        dataset.py:447-480). ``equalize`` (fleet.equalize_batches()) takes
        the local batch count and returns the cluster's largest, so every
        rank steps the same number of times."""
        bs = self.feed.batch_size
        n = len(self)
        per_worker = (n + num_workers - 1) // num_workers
        target = (per_worker + bs - 1) // bs if n else 0
        if equalize is not None:
            target = int(equalize(target))
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
