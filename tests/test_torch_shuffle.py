"""The cross-host instance shuffle against the JAX package's: both
codecs byte-identical to the reference's and decoded across the packages,
block_record_hash and split_block, LocalShuffleGroup's partition, a
2-rank TcpShuffler, the named error of a dead peer within
shuffle_connect_secs, a codec mix converted loudly, BoxDataset with a
shuffler giving each rank the reference's record multiset (on both
paths, both codecs), the port's deterministic merge order, and the
fleet's make_shuffler (None at world 1).
"""

import socket
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu_torch.config.configs import DataFeedConfig, SlotConfig
from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.data import block_shuffle as bs
from paddlebox_tpu_torch.data.archive import (deserialize_records,
                                              serialize_records)
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.data.generator import write_synthetic_ctr_files
from paddlebox_tpu_torch.data.shuffle import (LocalShuffleGroup,
                                              ShufflePeerUnreachable,
                                              TcpShuffler)
from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.utils.stats import stat_peek


def feed_of(dense=False, tasks=False, pkg="port"):
    if pkg == "port":
        cfg, slot = DataFeedConfig, SlotConfig
    else:
        from paddlebox_tpu.config.configs import DataFeedConfig as cfg
        from paddlebox_tpu.config.configs import SlotConfig as slot
    slots = [slot("click", type="float", dim=1, is_used=False),
             slot("s0", type="uint64", max_len=3),
             slot("s1", type="uint64", max_len=2),
             slot("s2", type="uint64", max_len=2)]
    if dense:
        slots.append(slot("d0", type="float", dim=2))
    kw = {}
    if tasks:
        slots.append(slot("conv", type="uint64", max_len=1, is_used=False))
        kw["task_label_slots"] = (("cvr", "conv"),)
    return cfg(slots=tuple(slots), batch_size=16, **kw)


def records(n, seed=0, dense=False, tasks=False, pkg="port"):
    """Seeded records (every seventh key-less: its hash is its label)."""
    if pkg == "port":
        rec_cls = SlotRecord
    else:
        from paddlebox_tpu.data.slot_record import SlotRecord as rec_cls
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        u64 = {0: rng.randint(0, 1000, rng.randint(1, 4)).astype(np.uint64),
               1: rng.randint(0, 1000, 2).astype(np.uint64)}
        if i % 7 == 3:
            u64 = {}
        f32 = {0: rng.rand(2).astype(np.float32)} if dense else {}
        extra = {"cvr": int(rng.rand() < 0.3)} if tasks else {}
        out.append(rec_cls(label=int(rng.rand() < 0.5), uint64_slots=u64,
                           float_slots=f32, ins_id="i%d" % i, rank=i % 5,
                           cmatch=i, qvalue=0.5 * i, search_id=i // 3,
                           extra_labels=extra))
    return out


def rec_sig(r):
    return (int(r.label), tuple(sorted((int(s), tuple(v.tolist()))
                                       for s, v in r.uint64_slots.items())))


def block_sig(block):
    """The multiset of a block's records (label, (slot, key) pairs)."""
    out = []
    for r in range(block.n_recs):
        lo, hi = block.rec_offsets[r], block.rec_offsets[r + 1]
        out.append((int(block.labels[r]),
                    tuple(zip(block.key_slot[lo:hi].tolist(),
                              block.keys[lo:hi].tolist()))))
    return sorted(out)


def jblock(b):
    """The port's block as the reference's ColumnarBlock."""
    from paddlebox_tpu.data.columnar import ColumnarBlock as JBlock
    return JBlock(keys=b.keys, key_slot=b.key_slot, labels=b.labels,
                  rec_offsets=b.rec_offsets, dense=b.dense,
                  task_labels=b.task_labels)


# ---------------------------------------------------------------- codecs

@pytest.mark.parametrize("dense,tasks", [(False, False), (True, False),
                                         (True, True)])
def test_codecs_byte_identical_and_cross_decode(dense, tasks):
    """The record and block frames equal the reference's bytes for the
    same records; each package decodes the other's frames."""
    from paddlebox_tpu.data import block_shuffle as jbs
    from paddlebox_tpu.data import shuffle as jshuffle
    feed, jfeed = feed_of(dense, tasks), feed_of(dense, tasks, "ref")
    recs = records(41, 3, dense, tasks)
    jrecs = records(41, 3, dense, tasks, "ref")
    frame = serialize_records(recs)
    assert frame == jshuffle.serialize_records(jrecs)
    for a, b in zip(deserialize_records(frame),
                    jshuffle.deserialize_records(frame)):
        assert rec_sig(a) == rec_sig(b)
        assert (a.ins_id, a.rank, a.cmatch, a.qvalue, a.search_id,
                a.extra_labels) == (b.ins_id, b.rank, b.cmatch, b.qvalue,
                                    b.search_id, b.extra_labels)
    block = bs.records_to_block(recs, feed)
    jb = jbs.records_to_block(jrecs, jfeed)
    for col in ("keys", "key_slot", "labels", "rec_offsets"):
        np.testing.assert_array_equal(getattr(block, col), getattr(jb, col))
    bframe = bs.serialize_block(block)
    assert bframe == jbs.serialize_block(jb)
    assert bframe[:4] == np.uint32(bs.BLOCK_MAGIC).tobytes()
    for back in (bs.deserialize_block(bframe),
                 jbs.deserialize_block(bframe)):
        assert block_sig(back) == block_sig(block)
        if dense:
            np.testing.assert_array_equal(back.dense, block.dense)
        if tasks:
            np.testing.assert_array_equal(back.task_labels["cvr"],
                                          block.task_labels["cvr"])
    # block_to_records against the reference's
    for a, b in zip(bs.block_to_records(block, feed),
                    jbs.block_to_records(jb, jfeed)):
        assert rec_sig(a) == rec_sig(b)
        assert a.extra_labels == b.extra_labels
    with pytest.raises(ValueError, match="magic"):
        bs.deserialize_block(b"\x00" * 64)


def test_empty_block_round_trip():
    from paddlebox_tpu.data import block_shuffle as jbs
    block = bs.records_to_block([], feed_of())
    frame = bs.serialize_block(block)
    assert frame == jbs.serialize_block(jbs.records_to_block(
        [], feed_of(pkg="ref")))
    back = bs.deserialize_block(frame)
    assert back.n_recs == 0 and back.rec_offsets.shape == (1,)


@pytest.mark.parametrize("world", [1, 2, 3, 5, 8])
def test_hash_and_split_match_the_reference(world):
    from paddlebox_tpu.data import block_shuffle as jbs
    recs = records(97, 5)
    block = bs.records_to_block(recs, feed_of())
    h = bs.block_record_hash(block)
    np.testing.assert_array_equal(h, jbs.block_record_hash(jblock(block)))
    np.testing.assert_array_equal(
        h, np.array([r.shuffle_hash() for r in recs], np.int64))
    np.testing.assert_array_equal(
        h, np.array([r.shuffle_hash() for r in records(97, 5, pkg="ref")],
                    np.int64))
    dests = bs.block_shuffle_dests(block, world)
    np.testing.assert_array_equal(dests, h % world)
    subs = bs.split_block(block, dests, world)
    jsubs = jbs.split_block(jblock(block), dests, world)
    for d, (a, b) in enumerate(zip(subs, jsubs)):
        assert (a is None) == (b is None)
        if a is not None:
            assert bs.serialize_block(a) == jbs.serialize_block(b)
            assert (dests[np.flatnonzero(dests == d)] == d).all()
    assert sum(a.n_recs for a in subs if a is not None) == block.n_recs


# ------------------------------------------------------------- transports

class Sink:
    """A merge channel: the items in the order they came."""

    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)

    def put_many(self, items):
        self.items.extend(items)

    def sig(self):
        out = []
        for it in self.items:
            out.extend(block_sig(it) if hasattr(it, "rec_offsets")
                       else [(it.label, tuple(
                           (s, k) for s in sorted(it.uint64_slots)
                           for k in it.uint64_slots[s].tolist()))])
        return sorted(out)


def partition_want(recs, world):
    block = bs.records_to_block(recs, feed_of())
    dests = bs.block_shuffle_dests(block, world)
    return [block_sig(block.select(np.flatnonzero(dests == d)))
            for d in range(world)]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("codec", ["record", "block"])
def test_local_group_partitions_as_the_reference(world, codec):
    """Each rank scatters its part; after the flushes every rank holds the
    hash partition of all records, the same multiset as the reference's
    LocalShuffleGroup (its merge channel drained the same way)."""
    from paddlebox_tpu.data import block_shuffle as jbs
    from paddlebox_tpu.data.shuffle import LocalShuffleGroup as JGroup
    recs = records(300, 11)
    parts = [recs[r::world] for r in range(world)]
    feed = feed_of()
    out = {}
    for pkg in ("port", "ref"):
        group = (LocalShuffleGroup if pkg == "port" else JGroup)(
            world, batch_records=16)
        sinks = [Sink() for _ in range(world)]
        for r in range(world):
            if codec == "block":
                block = bs.records_to_block(parts[r], feed)
                group[r].scatter_block(block if pkg == "port"
                                       else jblock(block), sinks[r])
            else:
                group[r].scatter(parts[r] if pkg == "port" else records(
                    300, 11, pkg="ref")[r::world], sinks[r])
        threads = [threading.Thread(target=group[r].flush, args=(sinks[r],))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        out[pkg] = [s.sig() for s in sinks]
        assert all(g.epoch == 1 for g in group.members)
    want = partition_want(recs, world)
    assert out["port"] == out["ref"] == want
    del jbs


def tcp_pair(world=2, **kw):
    eps = [("127.0.0.1", 0)] * world
    shs = []
    for r in range(world):
        sh = TcpShuffler(r, world, eps, **kw)
        shs.append(sh)
    eps = [("127.0.0.1", sh.port) for sh in shs]
    for sh in shs:
        sh.endpoints = eps
    return shs


def test_tcp_shuffler_two_ranks_and_the_merge_order():
    """Blocks scattered by two TcpShufflers: each rank's merge holds its
    partition, its own records first then the peer's frames in send
    order, the frame bytes counted; a second pass (epoch 1) too; NODELAY
    is set on the connections."""
    recs = records(400, 17)
    feed = feed_of()
    shs = tcp_pair(batch_records=32)
    try:
        for epoch in range(2):
            sinks = [Sink(), Sink()]
            files = [[bs.records_to_block(recs[i::4], feed)
                      for i in range(r, 4, 2)] for r in range(2)]
            for r in range(2):
                for b in files[r]:
                    shs[r].scatter_block(b, sinks[r])
            threads = [threading.Thread(target=shs[r].flush,
                                        args=(sinks[r],)) for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert [s.sig() for s in sinks] == partition_want(recs, 2)
            for r in range(2):
                own = [b.select(np.flatnonzero(
                    bs.block_shuffle_dests(b, 2) == r)) for b in files[r]]
                peer = [b.select(np.flatnonzero(
                    bs.block_shuffle_dests(b, 2) == r))
                    for b in files[1 - r]]
                got = [block_sig(x) for x in sinks[r].items]
                assert got == [block_sig(x) for x in own + peer]
        assert shs[0].bytes_sent == shs[1].bytes_received > 0
        assert shs[0]._conns[1].getsockopt(socket.IPPROTO_TCP,
                                           socket.TCP_NODELAY) == 1
    finally:
        for sh in shs:
            sh.close()


def test_dead_peer_raises_the_named_error_within_connect_secs():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    sh = TcpShuffler(0, 2, [("127.0.0.1", 0), ("127.0.0.1", dead)],
                     connect_secs=1.0)
    assert TcpShuffler.__mro__[1].__name__ == "ShufflerBase"
    t0 = time.monotonic()
    try:
        with pytest.raises(ShufflePeerUnreachable, match="peer 1"):
            sh.scatter_block(bs.records_to_block(records(50, 2), feed_of()),
                             Sink())
        assert time.monotonic() - t0 < 1.0 + 2.0
    finally:
        sh.close()


def test_connect_secs_comes_from_host_flags(monkeypatch):
    monkeypatch.setenv("PBTPU_SHUFFLE_CONNECT_SECS", "3.5")
    sh = TcpShuffler(0, 1, [("127.0.0.1", 0)])
    try:
        assert sh.connect_secs == 3.5
    finally:
        sh.close()
    assert HostFlags().shuffle_block_codec is True


def test_flush_times_out_naming_the_peers_done():
    group = LocalShuffleGroup(3)
    with pytest.raises(TimeoutError, match="0/2 peers done"):
        group[0].flush(Sink(), timeout=0.2)


# --------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_shuffle")
    paths, feed = write_synthetic_ctr_files(
        str(out), num_files=4, lines_per_file=96, num_slots=4,
        vocab_per_slot=200, max_len=3, seed=5)
    return paths, feed


def load_ranks(make_ds, world, files_of, add_keys=False):
    """Each rank's dataset loaded on a thread of its own (the flush waits
    for the peers); the datasets and each rank's registered keys."""
    dss = [make_ds(r) for r in range(world)]
    keys = [[] for _ in range(world)]
    errs = []

    def run(r):
        try:
            dss[r].set_filelist(files_of(r))
            dss[r].load_into_memory(keys[r].append if add_keys else None)
        except BaseException as e:  # raised in the test
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    return dss, keys


def ds_sig(ds):
    if ds.block is not None:
        return block_sig(ds.block)
    return sorted((int(r.label), tuple((s, k) for s in sorted(r.uint64_slots)
                                       for k in r.uint64_slots[s].tolist()))
                  for r in ds.records)


@pytest.mark.parametrize("columnar,codec", [(True, True), (True, False),
                                            (False, True)],
                         ids=["columnar-block", "columnar-record-codec",
                              "record-path"])
def test_dataset_partition_matches_the_reference(files, columnar, codec):
    """Two ranks' BoxDatasets over their files with a LocalShuffleGroup:
    each rank's records (and keys registered) are the reference's
    dataset's under its LocalShuffleGroup, the hash partition of all the
    files; the spans and counters of the cross-host shuffle."""
    from paddlebox_tpu.config import flags as jflags
    from paddlebox_tpu.config.configs import DataFeedConfig as JFeed
    from paddlebox_tpu.config.configs import SlotConfig as JSlot
    from paddlebox_tpu.data.dataset import BoxDataset as JDataset
    from paddlebox_tpu.data.shuffle import LocalShuffleGroup as JGroup
    paths, feed = files
    world = 2
    group = LocalShuffleGroup(world)
    flags = HostFlags(shuffle_block_codec=codec)
    sent0 = stat_peek("shuffle_bytes_sent")
    dss, keys = load_ranks(
        lambda r: BoxDataset(feed, columnar=columnar, flags=flags,
                             shuffler=group[r]),
        world, lambda r: paths[r::world], add_keys=True)
    assert stat_peek("shuffle_bytes_sent") > sent0
    assert [d.block is not None for d in dss] == [columnar and codec] * 2
    jfeed = JFeed(slots=tuple(JSlot(s.name, s.type, s.is_used, s.max_len)
                              for s in feed.slots),
                  batch_size=feed.batch_size)
    old = jflags.get_flag("shuffle_block_codec")
    jflags.set_flag("shuffle_block_codec", codec)
    try:
        jgroup = JGroup(world)
        jdss, jkeys = load_ranks(
            lambda r: JDataset(jfeed, read_threads=1, columnar=columnar,
                               shuffler=jgroup[r]),
            world, lambda r: paths[r::world], add_keys=True)
    finally:
        jflags.set_flag("shuffle_block_codec", old)
    for r in range(world):
        assert ds_sig(dss[r]) == ds_sig(jdss[r])
        np.testing.assert_array_equal(
            np.sort(np.concatenate(keys[r])),
            np.sort(np.concatenate(jkeys[r])))
    unshuffled = BoxDataset(feed, columnar=columnar)
    unshuffled.set_filelist(paths)
    unshuffled.load_into_memory()
    total = sorted(ds_sig(dss[0]) + ds_sig(dss[1]))
    assert total == ds_sig(unshuffled)


def test_shuffled_load_is_the_same_from_run_to_run(files):
    """The port's merge order: two loads of the same files give the same
    records in the same order (the local part first, then by source)."""
    paths, feed = files
    runs = []
    for _ in range(2):
        group = LocalShuffleGroup(2)
        dss, _ = load_ranks(lambda r: BoxDataset(feed, shuffler=group[r]), 2,
                            lambda r: paths[r::2])
        runs.append([(d.block.keys.copy(), d.block.labels.copy())
                     for d in dss])
    for (k0, l0), (k1, l1) in zip(*runs):
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_array_equal(l0, l1)


def test_codec_mix_converts_loudly(files, monkeypatch):
    """Rank 0 on the block codec, rank 1 on the record codec: each rank
    converts the other codec's frames at the merge with one warning, and
    both hold their hash partition."""
    from paddlebox_tpu_torch.data import dataset as dsmod
    paths, feed = files
    group = LocalShuffleGroup(2)
    before = stat_peek("ingest_codec_mix_converted")
    warned = []
    monkeypatch.setattr(dsmod.obs_log, "warning",
                        lambda msg, **kw: warned.append(msg))
    dss, _ = load_ranks(lambda r: BoxDataset(
        feed, flags=HostFlags(shuffle_block_codec=(r == 0)),
        shuffler=group[r]), 2, lambda r: paths[r::2])
    assert stat_peek("ingest_codec_mix_converted") > before
    assert sorted(m.split(" — ")[0] for m in warned) == [
        "shuffle codec mix: columnar block frames in a record-path pass",
        "shuffle codec mix: record frames in a columnar pass"]
    assert dss[0].block is not None and dss[1].block is None
    unshuffled = BoxDataset(feed)
    unshuffled.set_filelist(paths)
    unshuffled.load_into_memory()
    block = unshuffled.block
    dests = bs.block_shuffle_dests(block, 2)
    for r in range(2):
        assert ds_sig(dss[r]) == block_sig(block.select(
            np.flatnonzero(dests == r)))


def test_disable_shuffle_keeps_the_load_local(files):
    paths, feed = files
    group = LocalShuffleGroup(2)
    ds = BoxDataset(feed, flags=HostFlags(dataset_disable_shuffle=True),
                    shuffler=group[0])
    ds.set_filelist(paths[:2])
    ds.load_into_memory()
    plain = BoxDataset(feed)
    plain.set_filelist(paths[:2])
    plain.load_into_memory()
    assert ds_sig(ds) == ds_sig(plain)
    assert group[0].epoch == 0


def test_a_failed_flush_finishes_the_load_and_raises(files):
    """A peer that never finishes: the flush times out, the dataset still
    ends its load (a later preload starts) and raises the flush's
    error."""
    paths, feed = files
    group = LocalShuffleGroup(2)
    group[0].flush_timeout = 0.3
    ds = BoxDataset(feed, shuffler=group[0])
    ds.set_filelist(paths[:1])
    with pytest.raises(RuntimeError, match="shuffle flush failed"):
        ds.load_into_memory()
    assert ds.block is not None and len(ds) > 0
    ds.shuffler = None
    ds.load_into_memory()
    assert len(ds) == 96
