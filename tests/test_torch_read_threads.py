"""BoxDataset's reader pool (read_threads): N threads parse the files and
one merge takes them in file-list order, so a load at read_threads 1, 2,
4 and 8 is the same load byte for byte, on the columnar path, the record
path, .gz files and archive shards (and the archive spill): the merged
block or records, all_keys(), the add_keys_fn calls in order, the packed
batches after local_shuffle, the drift monitor's observation and a
cross-host shuffle's partition. A slow first file (its parse delayed) is
still merged first. One failing file raises RuntimeError("dataset load
failed") and leaves no reader thread running. The JAX dataset at
read_threads=1 loads what the port's does at 4. The default is the
reference's, 4, and 0 or -1 read with one thread, as in the reference.
"""

import gzip
import os
import shutil
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.shuffle import LocalShuffleGroup
from paddlebox_tpu_torch.metrics import drift

THREADS = (1, 2, 4, 8)
NUM_FILES = 9


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """9 files of 700 lines (more than one 512-record merge chunk each)."""
    out = tmp_path_factory.mktemp("read_threads")
    paths, feed = write_synthetic_ctr_files(
        str(out), num_files=NUM_FILES, lines_per_file=700, num_slots=4,
        vocab_per_slot=200, max_len=3, seed=5)
    return paths, type(feed)(slots=feed.slots, batch_size=64)


def gz_copies(paths, out):
    gzs = []
    for p in paths:
        dst = os.path.join(out, os.path.basename(p) + ".gz")
        with open(p, "rb") as src, gzip.open(dst, "wb") as g:
            shutil.copyfileobj(src, g)
        gzs.append(dst)
    return gzs


def load(feed, paths, n, columnar=True, slow_first=False, **kw):
    """(the dataset, its add_keys_fn calls) of a load at read_threads=n;
    ``slow_first`` delays the first file's parse past the others'."""
    calls = []
    ds = BoxDataset(feed, read_threads=n, columnar=columnar, **kw)
    if slow_first:
        parse = ds._parse_file

        def delayed(path):
            if path == paths[0]:
                time.sleep(0.3)
            return parse(path)

        ds._parse_file = delayed
    ds.set_filelist(paths)
    ds.load_into_memory(add_keys_fn=lambda k: calls.append(k.copy()))
    return ds, calls


def signature(ds, calls):
    """Every byte of a load: keys in load order, the add_keys_fn calls in
    order, the block's columns or the records' slots, and the batches of
    a shuffled split."""
    parts = [ds.all_keys().tobytes(), len(calls)]
    parts += [c.tobytes() for c in calls]
    if ds.block is not None:
        b = ds.block
        parts += [b.keys.tobytes(), b.key_slot.tobytes(),
                  b.labels.tobytes(), b.rec_offsets.tobytes()]
    else:
        for r in ds.records:
            parts.append((int(r.label), tuple(
                (s, r.uint64_slots[s].tobytes())
                for s in sorted(r.uint64_slots))))
    ds.local_shuffle(seed=3)
    for batch in ds.split_batches(1)[0]:
        parts += [getattr(batch, f).tobytes()
                  for f in ("keys", "segments", "valid", "labels")]
    return parts


def no_reader_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("dataset-")]


def test_default_is_four_and_zero_is_refused(files):
    """The default is the reference's 4; read_threads 0 and -1 read with
    one thread, as the reference's max(1, read_threads) does: each loads
    byte for byte what read_threads=1 loads."""
    paths, feed = files
    assert BoxDataset(feed).read_threads == 4
    want = signature(*load(feed, paths, 1))
    for n in (0, -1):
        assert signature(*load(feed, paths, n)) == want, n
    assert no_reader_threads()


@pytest.mark.parametrize("kind", ["columnar", "record", "gz"])
def test_load_is_byte_identical_at_any_read_threads(files, kind, tmp_path):
    paths, feed = files
    if kind == "gz":
        paths = gz_copies(paths, str(tmp_path))
    columnar = kind == "columnar"
    want = None
    for n in THREADS:
        ds, calls = load(feed, paths, n, columnar=columnar,
                         slow_first=n > 1)
        assert ds.columnar == columnar or kind == "gz"
        assert (ds.block is not None) == columnar
        assert len(ds) == NUM_FILES * 700
        got = signature(ds, calls)
        if want is None:
            want = got
        assert got == want, (kind, n)
    assert no_reader_threads()


def test_archive_spill_and_its_shards_at_any_read_threads(files, tmp_path):
    """load_into_disk writes the same shards at every read_threads, and a
    load of the shards is the same load at every read_threads."""
    paths, feed = files
    shard_bytes, want = None, None
    for n in THREADS:
        ds = BoxDataset(feed, read_threads=n)
        ds.set_filelist(paths)
        ds.load_into_disk(str(tmp_path / ("spill%d" % n)), max_bytes=40000)
        assert len(ds.disk_files) > 2
        data = []
        for f in ds.disk_files:
            with open(f, "rb") as fh:
                data.append(fh.read())
        if shard_bytes is None:
            shard_bytes, shards = data, ds.disk_files
        assert data == shard_bytes, n
    for n in THREADS:
        got = signature(*load(feed, shards, n, slow_first=n > 1))
        if want is None:
            want = got
        assert got == want, n


def test_drift_observation_is_the_same(files):
    paths, feed = files
    records = []
    prev = drift.active()
    try:
        for n in (1, 4):
            m = drift.set_active_new()
            load(feed, paths, n, slow_first=n > 1)
            rec = m.roll()
            rec.pop("ts")           # the roll's wall-clock stamp
            records.append(rec)
    finally:
        drift.set_active(prev)
    assert records[0] == records[1]


def test_shuffled_partition_is_the_same(files):
    """Two ranks under a LocalShuffleGroup: each rank's merged block at
    read_threads 4 is its block at 1 (the scatter runs in file order)."""
    paths, feed = files
    runs = []
    for n in (1, 4):
        group = LocalShuffleGroup(2)
        dss = [BoxDataset(feed, read_threads=n, shuffler=group[r])
               for r in range(2)]
        errs = []

        def run(r):
            try:
                dss[r].set_filelist(paths[r::2])
                dss[r].load_into_memory()
            except BaseException as e:  # raised below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs, errs
        runs.append([(d.block.keys.tobytes(), d.block.labels.tobytes())
                     for d in dss])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "record"])
def test_a_failing_file_fails_the_load_and_stops_the_readers(files,
                                                              columnar,
                                                              tmp_path):
    paths, feed = files
    bad = list(paths[:3]) + [str(tmp_path / "missing.txt")] + list(paths[3:])
    ds = BoxDataset(feed, read_threads=4, columnar=columnar)
    ds.set_filelist(bad)
    with pytest.raises(RuntimeError, match="dataset load failed") as info:
        ds.load_into_memory()
    assert isinstance(info.value.__cause__, (FileNotFoundError, OSError))
    assert no_reader_threads()
    # the dataset loads again afterwards
    ds.set_filelist(paths[:2])
    ds.load_into_memory()
    assert len(ds) == 1400


@pytest.mark.parametrize("columnar", [True, False],
                         ids=["columnar", "record"])
def test_jax_dataset_at_one_thread_equals_the_port_at_four(files, columnar):
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    paths, feed = files
    jfeed = JFeed(slots=tuple(JSlot(s.name, s.type, s.is_used, s.max_len)
                              for s in feed.slots), batch_size=feed.batch_size)
    jcalls = []
    jds = JDataset(jfeed, read_threads=1, columnar=columnar)
    jds.set_filelist(paths)
    jds.load_into_memory(add_keys_fn=lambda k: jcalls.append(k.copy()))
    ds, calls = load(feed, paths, 4, columnar=columnar, slow_first=True)
    np.testing.assert_array_equal(ds.all_keys(), jds.all_keys())
    np.testing.assert_array_equal(np.concatenate(calls),
                                  np.concatenate(jcalls))
    assert len(ds) == len(jds)
    ds.local_shuffle(seed=7)
    jds.local_shuffle(seed=7)
    # the packers pad to their own key capacities: the real key slots
    for a, b in zip(ds.split_batches(1)[0], jds.split_batches(1)[0],
                    strict=True):
        for f in ("labels", "ins_valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("keys", "segments"):
            np.testing.assert_array_equal(getattr(a, f)[a.valid],
                                          getattr(b, f)[b.valid])
